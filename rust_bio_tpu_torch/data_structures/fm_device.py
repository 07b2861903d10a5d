"""Device-resident FM-index with batched backward search and locate (port of
``rust_bio_tpu.data_structures.fm_device``, slice 1).

The BWT is stored as per-symbol bit-planes packed into 32-bit words with
per-word exclusive checkpoint counts, fused into one (S, nw, 2) int32 table,
so that

    rank(r, a) = ckpt[a, r >> 5] + popcount(bits[a, r >> 5] & mask(r & 31))

is one 8-byte gather. Backward search over a pattern batch is kernel K4
(``ops.fm.backward_search``); locate is kernel K4-locate
(``ops.fm.locate``), a batched LF-walk on the device to the nearest sampled
suffix-array row (or a sentinel row, whose value is stored exactly).

Positions are int32: texts of 2^31 symbols or more raise (the uint32
kernels are ROADMAP Queue 1 item 2). Results are bit-identical to the JAX
``DeviceFMIndex`` and to the host ``FMIndex``.
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.alphabets import Alphabet
from rust_bio_tpu_torch.data_structures.bwt import bwt as _bwt
from rust_bio_tpu_torch.data_structures.fmindex import (
    BackwardSearchResult,
    Interval,
)
from rust_bio_tpu_torch.data_structures.suffix_array import (
    as_text_tensor,
    suffix_array,
)
from rust_bio_tpu_torch.ops.fm import (
    COMPLETE,
    PARTIAL,
    backward_search,
    locate,
)
from rust_bio_tpu_torch.utils.text import to_array

_MAX_N = 2**31 - 1


def _pack_bitplanes(b: torch.Tensor, symbols: Sequence[int]):
    """(S, nw) int32 bit-planes (the uint32 words' bits) and (S, nw) int32
    exclusive per-word counts of the uint8 BWT ``b``, on ``b``'s device."""
    n = b.numel()
    nw = (n + 31) // 32 or 1
    weights = torch.ones(32, dtype=torch.int64, device=b.device) << torch.arange(
        32, device=b.device
    )
    padded = torch.zeros(nw * 32, dtype=torch.uint8, device=b.device)
    padded[:n] = b
    padded = padded.view(nw, 32)
    bits = torch.empty((len(symbols), nw), dtype=torch.int32, device=b.device)
    ckpt = torch.zeros((len(symbols), nw), dtype=torch.int32, device=b.device)
    for si, sym in enumerate(symbols):
        is_sym = padded == sym
        word = (is_sym.to(torch.int64) * weights).sum(dim=1)
        bits[si] = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
        ckpt[si, 1:] = torch.cumsum(is_sym.sum(dim=1), 0)[:-1].to(torch.int32)
    return bits, ckpt


class DeviceFMIndex:
    """Packed FM-index resident in device memory, with batched search and
    locate. ``device=None`` means the CUDA device (``RuntimeError``
    without one); ``device="cpu"`` runs the plain PyTorch versions."""

    def __init__(
        self,
        bwt_arr,
        alphabet: Alphabet,
        sa=None,
        sampling_rate: int = 32,
        device=None,
    ) -> None:
        dev = resolve_device(device)
        b = as_text_tensor(bwt_arr, dev)
        n = b.numel()
        if n > _MAX_N:
            raise NotImplementedError(
                f"n = {n} >= 2^31: the uint32 index is ROADMAP Queue 1 item 2"
            )
        present = torch.unique(b).cpu().tolist()
        symbols = sorted(set(alphabet.symbols()) | set(present))
        bits, ckpt = _pack_bitplanes(b, symbols)
        counts = torch.bincount(b.long(), minlength=257).cpu().numpy().astype(np.int64)
        less = np.zeros(257, dtype=np.int64)
        np.cumsum(counts[:-1], out=less[1:])
        sym_of = np.full(256, -1, dtype=np.int32)
        sym_of[symbols] = np.arange(len(symbols), dtype=np.int32)
        sentinel = int(b.min()) if n else 0
        arrays = {
            "bits": bits,
            "ckpt": ckpt,
            "less": less.astype(np.int32),
            "sym_of": sym_of,
            "bwt_bytes": b,
        }
        if sa is not None:
            if not isinstance(sa, torch.Tensor):
                sa = torch.from_numpy(np.asarray(sa))
            sa = sa.to(dev, torch.int32)
            sent_rows = torch.nonzero(b == sentinel).flatten()
            arrays["sa_sample"] = sa[:: int(sampling_rate)]
            arrays["sent_rows"] = sent_rows.to(torch.int32)
            arrays["sent_vals"] = sa[sent_rows]
        self._set_tables(arrays, n, int(sampling_rate), sentinel, symbols, dev)

    @classmethod
    def from_text(
        cls,
        text,
        alphabet: Alphabet | None = None,
        sampling_rate: int = 32,
        device=None,
    ) -> "DeviceFMIndex":
        """Build the index of a sentinel-terminated text on the device:
        suffix array and BWT there, then the packed tables."""
        dev = resolve_device(device)
        t = as_text_tensor(text, dev)
        sa = suffix_array(t, device=dev)
        b = _bwt(t, sa)
        if alphabet is None:
            alphabet = Alphabet(torch.unique(t).cpu().numpy().tobytes())
        return cls(b, alphabet, sa=sa, sampling_rate=sampling_rate, device=dev)

    def _set_tables(self, arrays: dict, n: int, s: int, sentinel: int, symbols, dev) -> None:
        """Install the index from the arrays of the JAX package's npz layout
        (``bits``, ``ckpt``, ``less`` (257,), ``sym_of``, ``bwt_bytes`` and
        optionally ``sa_sample``, ``sent_rows``, ``sent_vals``), given as
        numpy arrays or tensors."""

        def to_dev(a, dtype):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(dev).to(dtype).contiguous()

        if n > _MAX_N:
            raise NotImplementedError(
                f"n = {n} >= 2^31: the uint32 index is ROADMAP Queue 1 item 2"
            )
        bits = arrays["bits"]
        if isinstance(bits, np.ndarray):
            bits = bits.astype(np.uint32).view(np.int32)
        self.device = dev
        self.n = int(n)
        self.s = int(s)
        self.sentinel = int(sentinel)
        self.symbols = [int(v) for v in symbols]
        bits = to_dev(bits, torch.int32)
        ckpt = to_dev(arrays["ckpt"], torch.int32)
        self._fused = torch.stack([bits, ckpt], dim=-1).contiguous()  # (S, nw, 2)
        self.less = to_dev(arrays["less"], torch.int32)  # (257,) by byte
        self._less256 = self.less[:256].contiguous()
        self.sym_of = to_dev(arrays["sym_of"], torch.int32)
        self.less_sym = self.less[torch.tensor(self.symbols, dtype=torch.int64, device=dev)]
        self.bwt_bytes = to_dev(arrays["bwt_bytes"], torch.uint8)
        self.bwt_sym = self.sym_of[self.bwt_bytes.long()].to(torch.uint8)
        if "sa_sample" in arrays:
            self.sa_sample = to_dev(arrays["sa_sample"], torch.int32)
            self.sent_rows = to_dev(arrays["sent_rows"], torch.int32)
            self.sent_vals = to_dev(arrays["sent_vals"], torch.int32)
        else:
            self.sa_sample = None

    def to(self, device) -> "DeviceFMIndex":
        """A copy of this index with every table on ``device``."""
        dev = resolve_device(device)
        twin = copy.copy(self)
        for name, value in vars(self).items():
            if isinstance(value, torch.Tensor):
                setattr(twin, name, value.to(dev))
        twin.device = dev
        return twin

    @property
    def bits(self) -> torch.Tensor:
        """(S, nw) int32 bit-plane words."""
        return self._fused[..., 0]

    @property
    def ckpt(self) -> torch.Tensor:
        """(S, nw) int32 exclusive word checkpoints."""
        return self._fused[..., 1]

    # ------------------------------------------------------------------
    def search_arrays(self, pats: torch.Tensor, plens: torch.Tensor):
        """Backward search of a padded batch already on the device:
        ``pats`` (B, L) uint8, ``plens`` (B,) int32. Returns (status, lower,
        upper, mlen), each (B,) int32 on the device (K4)."""
        return backward_search(
            self._fused, self._less256, self.sym_of, pats, plens, self.n
        )

    def backward_search_batch(self, patterns) -> List[BackwardSearchResult]:
        """Batch of backward searches; exact reference result objects."""
        pats = [to_array(p) for p in patterns]
        B = len(pats)
        L = max((len(p) for p in pats), default=1) or 1
        pb = np.zeros((B, L), dtype=np.uint8)
        plens = np.zeros(B, dtype=np.int32)
        for i, p in enumerate(pats):
            pb[i, : len(p)] = p
            plens[i] = len(p)
        outs = self.search_arrays(
            torch.from_numpy(pb).to(self.device), torch.from_numpy(plens).to(self.device)
        )
        status, lower, upper, mlen = (o.cpu().numpy() for o in outs)
        out = []
        for i in range(B):
            if status[i] == COMPLETE:
                out.append(
                    BackwardSearchResult.complete(Interval(int(lower[i]), int(upper[i])))
                )
            elif status[i] == PARTIAL:
                out.append(
                    BackwardSearchResult.partial(
                        Interval(int(lower[i]), int(upper[i])), int(mlen[i])
                    )
                )
            else:
                out.append(BackwardSearchResult.absent())
        return out

    # ------------------------------------------------------------------
    def locate_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Text positions (int32, on the device) of suffix-array rows
        ``rows`` (a tensor): the LF-walk of each row to a sampled row or a
        sentinel row (K4-locate; fm_device.py ``_locate_impl``,
        suffix_array.rs:157-184). Rows outside [0, n) raise ``ValueError``
        (one host sync)."""
        rows = rows.to(self.device)
        if rows.numel() and bool(((rows < 0) | (rows >= self.n)).any()):
            raise ValueError(f"suffix-array rows must lie in [0, {self.n})")
        return self._locate(rows.to(torch.int32).contiguous())

    def _locate(self, rows: torch.Tensor) -> torch.Tensor:
        if self.sa_sample is None:
            raise ValueError("index built without suffix array")
        return locate(
            self._fused, self.bwt_sym, self.less_sym, self.sa_sample,
            self.sent_rows, self.sent_vals, rows.flatten(), self.s,
        ).view(rows.shape)

    def locate_batch(self, rows) -> np.ndarray:
        """Text positions (int32) for a batch of suffix-array row indices."""
        handle, nb = self.locate_batch_async(rows)
        if handle is None:
            return np.asarray(rows, np.int32)
        return handle.cpu().numpy()[:nb]

    def locate_batch_async(self, rows):
        """Start the locate of a batch of suffix-array rows without waiting
        for it: returns (device tensor, row count), ``(None, 0)`` for an empty
        batch; ``tensor.cpu().numpy()[:nb]`` collects. Rows outside [0, n)
        raise ``ValueError`` (checked on the host, before the upload)."""
        rows = np.asarray(rows)
        nb = rows.shape[0]
        if nb == 0:
            return None, 0
        if rows.min() < 0 or rows.max() >= self.n:
            raise ValueError(f"suffix-array rows must lie in [0, {self.n})")
        rows = torch.from_numpy(np.ascontiguousarray(rows, np.int32))
        return self._locate(rows.to(self.device)), nb

    def locate_interval(self, interval: Interval) -> np.ndarray:
        return self.locate_batch(np.arange(interval.lower, interval.upper))
