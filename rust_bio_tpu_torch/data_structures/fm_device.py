"""Device-resident FM-index with batched backward search and locate (port of
``rust_bio_tpu.data_structures.fm_device``).

The BWT is stored as per-symbol bit-planes packed into 32-bit words with
per-word exclusive checkpoint counts, fused into one (S, nw, 2) int32 table,
so that

    rank(r, a) = ckpt[a, r >> 5] + popcount(bits[a, r >> 5] & mask(r & 31))

is one 8-byte gather. Backward search over a pattern batch is kernel K4
(``ops.fm.backward_search``); with a q-mer table (``build_kmer_lut``) it is
kernel K4-LUT (``ops.fm.search_lut``), which answers a pattern's first q
steps with one gather; locate is kernel K4-locate (``ops.fm.locate``), a
batched LF-walk on the device to the nearest sampled suffix-array row (or
a sentinel row, whose value is stored exactly).

Positions are int32 below 2^31 symbols. From 2^31 to below 2^32 - 1 (a
human genome), or with ``force_u32``, the index is the uint32 one of the
JAX package: ``less``, ``less_sym``, ``sa_sample``, ``sent_rows``,
``sent_vals`` and the LUT hold uint32 values (as int32 bit patterns, which
the kernels read as uint32), ``ckpt`` stays int32 per symbol, and search
and locate hand positions back as int64. ``from_text`` builds the suffix
array on the host by the native SA-IS from 2^27 symbols on (or with
``host=True``), else by prefix doubling on the index's device. Results
are bit-identical to the JAX ``DeviceFMIndex`` and to the host
``FMIndex``.
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
    suffix_array_host,
)
from rust_bio_tpu_torch.ops.fm import (
    COMPLETE,
    PARTIAL,
    U32_MASK,
    _popcount32,
    backward_search,
    locate,
    rank_plain,
    search_lut,
    u32,
)
from rust_bio_tpu_torch.utils.text import to_array

_MAX_N = 2**32 - 2  # the uint32 index's 0xFFFFFFFF is its -1
_U32_FROM = 2**31
_HOST_SA_FROM = 2**27  # from_text: the device's prefix doubling stops short of genome scale
_CHUNK = 1 << 25  # symbols a pass of the table builds (a multiple of 32)
DNA_BYTES = (65, 67, 71, 84)  # A, C, G, T: the q-mer table's symbols, in rank order


def _pack_bitplanes(b: torch.Tensor, symbols: Sequence[int]):
    """(S, nw) int32 bit-planes (the uint32 words' bits) and (S, nw) int32
    exclusive per-word counts of the uint8 BWT ``b``, on ``b``'s device,
    built ``_CHUNK`` symbols at a time (peak a small multiple of a chunk
    beside the tables)."""
    n = b.numel()
    nw = (n + 31) // 32 or 1
    dev = b.device
    # bit k's weight as int32: bit 31 is -2^31, so the sum is the word's bits
    weights = (torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(32, device=dev))
    weights = torch.where(weights >= 2**31, weights - 2**32, weights).to(torch.int32)
    bits = torch.empty((len(symbols), nw), dtype=torch.int32, device=dev)
    ckpt = torch.empty((len(symbols), nw), dtype=torch.int32, device=dev)
    total = torch.zeros(len(symbols), dtype=torch.int64, device=dev)
    for lo in range(0, nw * 32, _CHUNK):
        hi = min(lo + _CHUNK, nw * 32)
        chunk = torch.zeros(hi - lo, dtype=torch.uint8, device=dev)
        chunk[: max(min(hi, n) - lo, 0)] = b[lo:min(hi, n)]
        words = chunk.view(-1, 32)
        w0, w1 = lo // 32, hi // 32
        for si, sym in enumerate(symbols):
            is_sym = (words == sym).to(torch.int32)
            bits[si, w0:w1] = (is_sym * weights).sum(dim=1, dtype=torch.int32)
            cnt = is_sym.sum(dim=1)
            run = torch.cumsum(cnt, 0)
            ckpt[si, w0:w1] = (total[si] + run - cnt).to(torch.int32)
            total[si] += run[-1]
    if bool((total >= 2**31).any()):
        raise ValueError("a symbol occurs 2^31 times or more: the int32 checkpoints cannot hold its count")
    return bits, ckpt


def _index_values(a, dev, big: bool) -> torch.Tensor:
    """An int32 tensor on ``dev`` of index values given as numpy or a
    tensor: the values themselves, or in big mode their uint32 bit
    patterns."""
    if isinstance(a, np.ndarray):
        a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int64)
        a = torch.from_numpy(np.ascontiguousarray(a))
    a = a.to(dev)
    if a.dtype == torch.int64:
        if not big and a.numel() and bool(((a < -(2**31)) | (a >= 2**31)).any()):
            raise ValueError("index values past int32 in an int32 index")
        a = (a & U32_MASK).to(torch.int32) if big else a.to(torch.int32)
    return a.to(torch.int32).contiguous()


class DeviceFMIndex:
    """Packed FM-index resident in device memory, with batched search and
    locate. ``device=None`` means the CUDA device (``RuntimeError``
    without one); ``device="cpu"`` runs the plain PyTorch versions.
    ``force_u32`` builds the uint32 index below 2^31 symbols too."""

    def __init__(
        self,
        bwt_arr,
        alphabet: Alphabet,
        sa=None,
        sampling_rate: int = 32,
        device=None,
        force_u32: bool = False,
    ) -> None:
        dev = resolve_device(device)
        b = as_text_tensor(bwt_arr, dev)
        n = b.numel()
        if n > _MAX_N:
            raise ValueError(f"n = {n}: a single-card index stops below 2^32 - 1 symbols")
        counts = torch.zeros(257, dtype=torch.int64, device=dev)
        for lo in range(0, n, _CHUNK):
            counts += torch.bincount(b[lo : lo + _CHUNK], minlength=257)
        counts = counts.cpu().numpy()
        present = np.nonzero(counts[:256])[0].tolist()
        symbols = sorted(set(alphabet.symbols()) | set(present))
        bits, ckpt = _pack_bitplanes(b, symbols)
        less = np.zeros(257, dtype=np.int64)
        np.cumsum(counts[:-1], out=less[1:])
        sym_of = np.full(256, -1, dtype=np.int32)
        sym_of[symbols] = np.arange(len(symbols), dtype=np.int32)
        sentinel = int(b.min()) if n else 0
        arrays = {"bits": bits, "ckpt": ckpt, "less": less, "sym_of": sym_of, "bwt_bytes": b}
        if sa is not None:
            if isinstance(sa, np.ndarray):
                sa = torch.from_numpy(sa.view(np.int32) if sa.dtype == np.uint32 else sa)
            sa = sa.to(dev)
            sent_rows = torch.nonzero(b == sentinel).flatten()
            arrays["sa_sample"] = sa[:: int(sampling_rate)]
            arrays["sent_rows"] = sent_rows
            arrays["sent_vals"] = sa[sent_rows]
        big = bool(force_u32) or n >= _U32_FROM
        self._set_tables(arrays, n, int(sampling_rate), sentinel, symbols, dev, big)

    @classmethod
    def from_text(
        cls,
        text,
        alphabet: Alphabet | None = None,
        sampling_rate: int = 32,
        device=None,
        host: bool | None = None,
        force_u32: bool = False,
    ) -> "DeviceFMIndex":
        """Build the index of a sentinel-terminated text: the suffix array
        and BWT on the host by the native SA-IS from 2^27 symbols on (or
        with ``host=True``), else on the index's device by prefix doubling;
        then the packed tables on the device."""
        dev = resolve_device(device)
        if host is None:
            host = len(text) >= _HOST_SA_FROM
        if host:
            arr = to_array(text.cpu().numpy() if isinstance(text, torch.Tensor) else text)
            sa = suffix_array_host(arr)
            prev = sa.astype(np.int64) - 1 if sa.dtype == np.uint32 else sa - 1
            b = arr[prev]  # sa == 0 reads the last symbol (index -1)
            if alphabet is None:
                alphabet = Alphabet(np.unique(arr).tobytes())
            return cls(b, alphabet, sa=sa, sampling_rate=sampling_rate, device=dev, force_u32=force_u32)
        t = as_text_tensor(text, dev)
        sa = suffix_array(t, device=dev)
        b = _bwt(t, sa)
        if alphabet is None:
            alphabet = Alphabet(torch.unique(t).cpu().numpy().tobytes())
        return cls(b, alphabet, sa=sa, sampling_rate=sampling_rate, device=dev, force_u32=force_u32)

    def _set_tables(self, arrays: dict, n: int, s: int, sentinel: int, symbols, dev, big=None) -> None:
        """Install the index from the arrays of the JAX package's npz layout
        (``bits``, ``ckpt``, ``less`` (257,), ``sym_of``, ``bwt_bytes`` and
        optionally ``sa_sample``, ``sent_rows``, ``sent_vals``, ``lut``,
        ``lut_rank``), given as numpy arrays or tensors. ``big`` None: the
        uint32 index from 2^31 symbols on, or where the arrays are the JAX
        uint32 index's (``less`` saved as uint32)."""
        if n > _MAX_N:
            raise ValueError(f"n = {n}: a single-card index stops below 2^32 - 1 symbols")
        if big is None:
            less = arrays["less"]
            big = n >= _U32_FROM or (isinstance(less, np.ndarray) and less.dtype == np.uint32)
        bits = arrays["bits"]
        if isinstance(bits, np.ndarray):
            bits = torch.from_numpy(bits.astype(np.uint32).view(np.int32))
        ckpt = arrays["ckpt"]
        if isinstance(ckpt, np.ndarray):
            ckpt = torch.from_numpy(np.ascontiguousarray(ckpt, np.int32))
        self.device = dev
        self.n = int(n)
        self.s = int(s)
        self.sentinel = int(sentinel)
        self.symbols = [int(v) for v in symbols]
        self._big = bool(big)
        self._fused = torch.stack([bits.to(dev, torch.int32), ckpt.to(dev, torch.int32)], dim=-1).contiguous()
        del bits, ckpt
        self.less = _index_values(arrays["less"], dev, big)  # (257,) by byte
        self._less256 = self.less[:256].contiguous()
        sym_of = arrays["sym_of"]
        self.sym_of = (torch.from_numpy(np.asarray(sym_of)) if isinstance(sym_of, np.ndarray) else sym_of).to(dev, torch.int32)
        self.less_sym = self.less[torch.tensor(self.symbols, dtype=torch.int64, device=dev)].contiguous()
        self.bwt_bytes = as_text_tensor(np.asarray(arrays["bwt_bytes"]) if isinstance(arrays["bwt_bytes"], np.ndarray) else arrays["bwt_bytes"], dev)
        self._bwt_sym = None
        if "sa_sample" in arrays:
            self.sa_sample = _index_values(arrays["sa_sample"], dev, big)
            self.sent_rows = _index_values(arrays["sent_rows"], dev, big)
            self.sent_vals = _index_values(arrays["sent_vals"], dev, big)
        else:
            self.sa_sample = None
        self._lut_q = None
        if "lut" in arrays:
            self._lut_q = int(arrays.get("lut_q", 12))
            self._lut = _index_values(np.asarray(arrays["lut"]), dev, big).view(-1, 2)
            self._lut_rank = torch.from_numpy(np.asarray(arrays["lut_rank"], np.int32)).to(dev)

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

    @property
    def bwt_sym(self) -> torch.Tensor:
        """(n,) uint8 symbol index of each BWT row (built at first use,
        ``_CHUNK`` rows a pass: only locate reads it)."""
        if self._bwt_sym is None:
            lut = self.sym_of.to(torch.uint8)
            out = torch.empty_like(self.bwt_bytes)
            for lo in range(0, self.n, _CHUNK):
                out[lo : lo + _CHUNK] = lut[self.bwt_bytes[lo : lo + _CHUNK].long()]
            self._bwt_sym = out
        return self._bwt_sym

    def bwt_host(self) -> np.ndarray:
        """The BWT bytes as host numpy (fm_device.py ``bwt_host``)."""
        return self.bwt_bytes.cpu().numpy()

    # ------------------------------------------------------------------
    def _positions(self, r) -> torch.Tensor:
        """int64 positions on the device; in big mode 0xFFFFFFFF is -1."""
        r = torch.as_tensor(r).to(self.device).long()
        return torch.where(r == U32_MASK, -1, r) if self._big else r

    def occ(self, r, a) -> torch.Tensor:
        """Occurrences of byte ``a`` in bwt[..r+1] (``Occ::get``; 0 where r is
        -1, or 0xFFFFFFFF in the uint32 index), int32; shapes broadcast
        (fm_device.py ``occ``)."""
        sym = self.sym_of[torch.as_tensor(a).to(self.device).long()]
        return rank_plain(self._fused, self._positions(r), sym)

    def ensure_row_layout(self) -> torch.Tensor:
        """(nw, 2S) int32 row-major twin of the fused table, every symbol's
        word then every symbol's checkpoint a row: one row gather a
        position ranks all symbols (fm_device.py ``ensure_row_layout``;
        built once, on demand)."""
        if getattr(self, "_fused_rows", None) is None:
            self._fused_rows = torch.cat([self.bits.T, self.ckpt.T], dim=1).contiguous()
        return self._fused_rows

    def _rank_all(self, r, fused_rows) -> torch.Tensor:
        """(Q, S) int32 rank of every symbol at positions ``r`` ((Q,), >= -1)
        by one row gather a position (fm_device.py ``_rank_all``)."""
        S = len(self.symbols)
        r = self._positions(r)
        p = r.clamp(min=0)
        rows = fused_rows[p >> 5]  # (Q, 2S)
        mask = (1 << ((p & 31) + 1)) - 1
        cnt = rows[:, S:] + _popcount32((rows[:, :S].long() & U32_MASK) & mask[:, None]).to(torch.int32)
        return torch.where((r < 0)[:, None], 0, cnt)

    # ------------------------------------------------------------------
    def search_arrays(self, pats: torch.Tensor, plens: torch.Tensor):
        """Backward search of a padded batch already on the device:
        ``pats`` (B, L) uint8, ``plens`` (B,) int32. Returns (status, lower,
        upper, mlen), each (B,) on the device (K4): int32, lower and upper
        int64 in the uint32 index."""
        return backward_search(
            self._fused, self._less256, self.sym_of, pats, plens, self.n, self._big
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
    # the q-mer table: (4^q, 2) backward-search intervals of every DNA
    # q-mer, so that one gather answers a pattern's first q steps (bwa's
    # k-mer interval table; the reference walks every symbol)
    def build_kmer_lut(self, q: int = 12) -> None:
        """Build the (4^q, 2) table on the index's device from the fused
        rank table, in q - 1 rounds of rank gathers over the 4^k intervals
        (k = 1 .. q - 1): bit for bit the JAX host build, without its (n,
        4) cumulative-count array (49.6 GB at 3.1 Gbp). Code ci * 4^k + old
        prepends the k-th step's symbol, as the JAX build orders it."""
        if not 1 <= q <= 15:
            raise ValueError(f"LUT q = {q}: expected 1 <= q <= 15")
        dev = self.device
        less = u32(self.less) if self._big else self.less.long()
        dna = torch.tensor(DNA_BYTES, device=dev)
        syms = self.sym_of[dna]  # (4,), -1 for a byte outside the index: rank 0
        lessv = less[dna]
        l = lessv.clone()
        r = less[dna + 1] - 1
        for _ in range(1, q):

            def ranks(pos, ok):
                got = rank_plain(self._fused, pos[None, :].clamp(min=0), syms.clamp(min=0)[:, None])
                return torch.where(ok[None, :] & (syms >= 0)[:, None], got, 0).long()

            occ_l = ranks(l - 1, l > 0)  # (4, sz)
            occ_r = ranks(r, r >= 0)
            l = (lessv[:, None] + occ_l).reshape(-1)
            r = (lessv[:, None] + occ_r - 1).reshape(-1)
        self._lut_q = q
        self._lut = _index_values(torch.stack([l, r], dim=1).reshape(-1), dev, self._big).view(-1, 2)
        lut_rank = torch.full((256,), -1, dtype=torch.int32)
        lut_rank[list(DNA_BYTES)] = torch.arange(4, dtype=torch.int32)
        self._lut_rank = lut_rank.to(dev)

    def _search_kernel_lut(self, pats: torch.Tensor, plens: torch.Tensor):
        """K4-LUT on a padded batch already on the device: (status, lower,
        upper, mlen, miss). Unlike the JAX function's, whose miss lanes
        carry garbage for the host to re-run, every lane holds K4's result;
        ``miss`` marks the lanes that ran K4's whole loop."""
        if self._lut_q is None:
            raise ValueError("build_kmer_lut first")
        return search_lut(
            self._fused, self._less256, self.sym_of, self._lut_rank, self._lut, self._lut_q,
            pats, plens, self.n, self._big,
        )

    def search_arrays_lut(self, pats: torch.Tensor, plens: torch.Tensor):
        """``search_arrays`` through K4-LUT: the same (status, lower, upper,
        mlen) on the device, one launch, no host sync."""
        return self._search_kernel_lut(pats, plens)[:4]

    def search_batch_lut(self, pats, plens):
        """(status, lower, upper, mlen) as host numpy arrays, K4's on every
        lane (fm_device.py ``search_batch_lut``: there the miss lanes re-run
        in a second search; here they ran in the same launch)."""
        if isinstance(pats, np.ndarray):
            pats = torch.from_numpy(np.ascontiguousarray(pats, np.uint8))
        if isinstance(plens, np.ndarray):
            plens = torch.from_numpy(np.ascontiguousarray(plens, np.int32))
        return tuple(o.cpu().numpy() for o in self.search_arrays_lut(pats.to(self.device), plens.to(self.device)))

    # ------------------------------------------------------------------
    def _row_tensor(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows as the kernels take them: int32, uint32 bit patterns in big
        mode."""
        return (rows.long() & U32_MASK).to(torch.int32) if self._big else rows.to(torch.int32)

    def locate_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Text positions (on the device: int32, int64 in the uint32 index)
        of suffix-array rows ``rows`` (a tensor): the LF-walk of each row to a
        sampled row or a sentinel row (K4-locate; fm_device.py
        ``_locate_impl``, suffix_array.rs:157-184). Rows outside [0, n)
        raise ``ValueError`` (one host sync)."""
        rows = rows.to(self.device)
        if rows.numel() and bool(((rows < 0) | (rows >= self.n)).any()):
            raise ValueError(f"suffix-array rows must lie in [0, {self.n})")
        return self._locate(self._row_tensor(rows).contiguous())

    def _locate(self, rows: torch.Tensor, out=None) -> torch.Tensor:
        if self.sa_sample is None:
            raise ValueError("index built without suffix array")
        return locate(
            self._fused, self.bwt_sym, self.less_sym, self.sa_sample,
            self.sent_rows, self.sent_vals, rows.flatten(), self.s, self._big, out,
        ).view(rows.shape)

    def locate_batch(self, rows) -> np.ndarray:
        """Text positions (int32; int64 in the uint32 index) for a batch of
        suffix-array row indices."""
        handle, nb = self.locate_batch_async(rows)
        if handle is None:
            return np.asarray(rows, np.int64 if self._big else np.int32)
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
        rows = torch.from_numpy(np.ascontiguousarray(rows, np.int64))
        return self._locate(self._row_tensor(rows).to(self.device)), nb

    def locate_interval(self, interval: Interval) -> np.ndarray:
        return self.locate_batch(np.arange(interval.lower, interval.upper))
