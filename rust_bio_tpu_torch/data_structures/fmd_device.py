"""Batched FMD-index SMEM search (port of
``rust_bio_tpu.data_structures.fmd_device``; reference: fmindex.rs:367-495).

The index is a ``DeviceFMIndex`` over the BWT of ``T$revcomp(T)$``, so one
index covers both strands. ``smems_batch`` answers, for each (pattern,
position i), the reference's ``FMDIndex::smems(pattern, i, l)``: the
super-maximal exact matches of length >= l that overlap position i, with
their bi-intervals, starts and lengths. The search is kernel K-SMEM
(``ops.fmd.smems``): every query's forward phase and backward sweep in
one launch, ``E`` candidate slots and ``MC`` matches a query. A query
that overflows either cap is answered by the host oracle
(``fmindex.FMDIndex``) when one is given, else ``smems_collect`` raises;
results are never silently truncated. ``mapper_mode`` skips the reverse
interval's updates in the backward sweep (the read mapper only locates the
forward interval): lower, size, start and length stay exact, the results'
``lower_rev`` is then phase 1's. Results equal the JAX class's and the
host oracle's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from rust_bio_tpu_torch.alphabets import dna
from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
from rust_bio_tpu_torch.data_structures.fmindex import BiInterval
from rust_bio_tpu_torch.ops import fmd
from rust_bio_tpu_torch.utils.text import to_array

Smems = List[Tuple[BiInterval, int, int]]


def pad_batch(patterns: Sequence):
    """(pats (B, L) uint8 left-aligned, plens (B,) int32, the patterns as
    arrays) of a pattern list; L >= 1. Patterns of one length are one
    copy (the read mapper's batches)."""
    pats = [to_array(p) for p in patterns]
    B = len(pats)
    plens = np.fromiter((len(p) for p in pats), np.int32, count=B)
    L = int(plens.max()) if B else 0
    L = L or 1
    if B and int(plens.min()) == L:
        return np.concatenate(pats).reshape(B, L), plens, pats
    pb = np.zeros((B, L), np.uint8)
    for i, p in enumerate(pats):
        pb[i, : len(p)] = p
    return pb, plens, pats


def _pack(outs) -> torch.Tensor:
    """K-SMEM's seven outputs as one (B, 5 MC + 2) int32 tensor on the
    device, so that a batch costs one copy to the host."""
    B = outs[0].shape[0]
    return torch.cat([o.to(torch.int32).reshape(B, -1) for o in outs], dim=1)


def _unpack(packed: np.ndarray, MC: int):
    """The seven outputs, as numpy, of a pulled ``_pack``."""
    m = [packed[:, k * MC : (k + 1) * MC] for k in range(5)]
    return (*m, packed[:, 5 * MC], packed[:, 5 * MC + 1].astype(bool))


def _lane(outs, b: int) -> Smems:
    m_lo, m_lor, m_sz, m_st, m_ml, mcnt, _ = outs
    return [
        (BiInterval(int(m_lo[b, t]), int(m_lor[b, t]), int(m_sz[b, t]), int(m_ml[b, t])), int(m_st[b, t]), int(m_ml[b, t]))
        for t in range(int(mcnt[b]))
    ]


class DeviceFMDIndex:
    """FMD index (over a ``T$revcomp(T)$`` text) with batched SMEM search.

    ``device_fm``: the ``DeviceFMIndex`` of that text's BWT, int32 (a
    uint32 index, from 2^31 symbols on, raises ``ValueError``)."""

    def __init__(self, device_fm: DeviceFMIndex) -> None:
        if device_fm._big:
            raise ValueError("DeviceFMDIndex needs an FMD text below 2^31 symbols (an int32 index)")
        self.fm = device_fm
        dev = device_fm.device
        sym_of = device_fm.sym_of.cpu().numpy()
        ext_pos, ext_sym, KE = fmd.ext_tables(sym_of)
        self.KE = KE
        self.ext_syms = torch.from_numpy(np.maximum(ext_sym, 0)).to(dev)
        self.ext_valid = torch.from_numpy(ext_sym >= 0).to(dev)
        self.ext_pos = torch.from_numpy(ext_pos).to(dev)
        self.comp = torch.from_numpy(dna.COMPLEMENT.copy()).to(dev)
        self.less_b = device_fm.less  # (257,) by byte
        self.tables = fmd.FmdTables(
            device_fm._fused, device_fm.ensure_row_layout(), self.less_b, device_fm.sym_of, self.comp,
            self.ext_pos, torch.from_numpy(ext_sym).to(dev), KE,
        )

    @property
    def device(self) -> torch.device:
        return self.fm.device

    # -- the bidirectional extensions, batched (plain PyTorch) ------------
    def _backward_ext(self, lo, lor, sz, a):
        """(lo', lor', sz') of the backward extensions of the (N,) int32
        bi-intervals (lo, lor, sz) by the (N,) bytes ``a``."""
        return fmd._backward_ext(self.tables, lo, lor, sz, a)

    def _forward_ext(self, lo, lor, sz, a):
        return fmd._forward_ext(self.tables, lo, lor, sz, a)

    def _backward_ext_nolor(self, lo, sz, a):
        """(lo', sz'), ranking only the queried symbol: the reverse interval
        is not updated."""
        return fmd._backward_ext_nolor(self.tables, lo, sz, a)

    # -- batched SMEMs -----------------------------------------------------
    def _upload(self, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]

    def _smems_kernel(self, pats, plens, iis, E: int, MC: int, l_min: int, mapper_mode: bool = False):
        """K-SMEM on tensors already on the device: the seven outputs."""
        return fmd.smems(self.tables, pats, plens, iis, l_min, E, MC, mapper_mode)

    def smems_batch(
        self, patterns: Sequence, positions: Sequence[int], l: int, max_slots: int = 32, max_matches: int = 16,
        host_oracle=None, host_oracle_fn=None, mapper_mode: bool = False,
    ) -> List[Smems]:
        """Per (pattern, position): the reference's ``smems(pattern, i, l)``.
        A query past the device caps takes ``host_oracle`` (an ``FMDIndex``,
        or one from ``host_oracle_fn``, built at first need), else raises."""
        return self.smems_collect(
            self.smems_dispatch(patterns, positions, l, max_slots, max_matches, mapper_mode),
            host_oracle=host_oracle, host_oracle_fn=host_oracle_fn,
        )

    def smems_dispatch(
        self, patterns: Sequence, positions: Sequence[int], l: int, max_slots: int = 32, max_matches: int = 16,
        mapper_mode: bool = False,
    ):
        """Launch the search and return a handle without waiting for it
        (``smems_collect`` pulls it, once). Positions must lie inside their
        patterns (``ValueError``, checked on the host)."""
        pb, plens, pats = pad_batch(patterns)
        iis = np.asarray(positions, np.int32).reshape(-1)
        if iis.shape[0] != len(pats):
            raise ValueError(f"{iis.shape[0]} positions for {len(pats)} patterns")
        if iis.size and (iis.min() < 0 or (iis >= np.maximum(plens, 1)).any()):
            raise ValueError("a position lies outside its pattern")
        outs = self._smems_kernel(*self._upload(pb, plens, iis), max_slots, max_matches, int(l), mapper_mode)
        return pats, iis, int(l), int(max_matches), _pack(outs)

    def smems_collect(self, handle, host_oracle=None, host_oracle_fn=None) -> List[Smems]:
        """Pull a dispatch handle (one copy to the host) and decode it."""
        pats, iis, l, MC, packed = handle
        outs = _unpack(packed.cpu().numpy(), MC)
        ovf = outs[6]
        out: List[Smems] = []
        for b in range(len(pats)):
            if ovf[b]:
                if host_oracle is None and host_oracle_fn is not None:
                    host_oracle = host_oracle_fn()
                if host_oracle is None:
                    raise RuntimeError("a query overflowed the device SMEM caps: pass host_oracle")
                out.append(host_oracle.smems(bytes(pats[b]), int(iis[b]), l))
            else:
                out.append(_lane(outs, b))
        return out

    def all_smems_batch(
        self, patterns: Sequence, l: int, max_slots: int = 32, max_matches: int = 16, host_oracle=None,
    ) -> List[Smems]:
        """Per pattern: the reference's ``all_smems(pattern, l)``. The cursor
        loop (fmindex.rs:477-495) runs on the host, one K-SMEM launch a round
        over the whole batch (finished patterns ride along and are not
        read), until every cursor passes its pattern's end."""
        pb, plens, pats = pad_batch(patterns)
        pb_d, pl_d = self._upload(pb, plens)
        B = len(pats)
        out: List[Smems] = [[] for _ in range(B)]
        cursor = np.zeros(B, np.int64)
        while True:
            active = np.nonzero(cursor < plens)[0]
            if active.size == 0:
                return out
            iis = np.minimum(cursor, np.maximum(plens - 1, 0)).astype(np.int32)
            outs = self._smems_kernel(pb_d, pl_d, *self._upload(iis), max_slots, max_matches, int(l))
            outs = _unpack(_pack(outs).cpu().numpy(), max_matches)
            for b in active.tolist():
                if outs[6][b]:
                    if host_oracle is None:
                        raise RuntimeError("a query overflowed the device SMEM caps: pass host_oracle")
                    lane = host_oracle.smems(bytes(pats[b]), int(iis[b]), l)
                else:
                    lane = _lane(outs, b)
                nxt = cursor[b] + 1
                for _, p, ln in lane:
                    nxt = max(nxt, p + ln)
                cursor[b] = nxt
                out[b].extend(lane)
