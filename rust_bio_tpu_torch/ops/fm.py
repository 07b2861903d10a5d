"""Batched FM-index backward search and locate: kernels K4, K4-LUT and
K4-locate, CUDA source in ``csrc/fm_search.cu``. K4 replaces
``rust_bio_tpu/ops/fm_pallas.py`` ``backward_search_fused``; K4-LUT the XLA
search ``rust_bio_tpu/data_structures/fm_device.py`` ``_search_lut_impl``
with its host re-run of the miss lanes (``search_batch_lut``); K4-locate
the XLA LF-walk ``fm_device.py`` ``_locate_impl``.

Inputs: ``fused`` (S, nw, 2) int32, per symbol index and 32-bit word the
bit-plane word (its bits as int32) and the exclusive checkpoint count;
``less`` (256,) keyed by byte; ``sym_of`` (256,) int32 keyed by byte
(-1 outside the alphabet); ``pats`` (B, L) uint8 left-aligned patterns and
``plens`` (B,) int32 (``0 <= plens <= L``); ``n`` the text
length. Outputs (B,) each: status (ABSENT 0 / PARTIAL 1 / COMPLETE 2),
lower, upper (exclusive) and the matched length, int32.

K4-LUT also takes ``lut_rank`` (256,) int32 (the DNA rank 0-3 of the bytes
A, C, G, T, -1 else) and ``lut`` (4^q, 2), the interval {l0, r0} of every
DNA q-mer by its q-suffix code; it returns K4's outputs and the (B,) bool
miss mask (lanes that ran K4's whole loop).

Locate takes ``bwt_sym`` (n,) uint8, the symbol index of each BWT row,
``less_sym`` (S,) keyed by symbol index, the sampled suffix array
``sa_sample`` (sa[::s]), the sorted sentinel rows ``sent_rows`` and their
values ``sent_vals`` (k,), and ``rows`` (B,); it returns the (B,) text
positions, -1 for a row outside [0, n).

``big`` selects the uint32 index (``DeviceFMIndex`` from 2^31 symbols on,
or ``force_u32``): ``less``, ``less_sym``, ``lut``, ``sa_sample``,
``sent_rows``, ``sent_vals`` and ``rows`` are then int32 tensors holding
uint32 bit patterns (0xFFFFFFFF in the role of -1), and the positions come
back as int64 tensors of those uint32 values (lower and upper; locate's
positions, 0xFFFFFFFF for a row outside [0, n)). Without ``big`` every
index value is int32, as before. The plain versions compute in int64.
"""

from __future__ import annotations

import torch

from rust_bio_tpu_torch.ops._build import (
    I64,
    INT,
    PTR,
    CudaKernel,
    check,
    check_lengths,
    same_device,
)

ABSENT, PARTIAL, COMPLETE = 0, 1, 2
U32_MASK = 0xFFFFFFFF

_SEARCH_ARGS = [PTR, PTR, PTR, PTR, PTR, INT, INT, INT]
FM_BACKWARD_SEARCH = CudaKernel("fm_search", "fm_backward_search", _SEARCH_ARGS + [INT] + [PTR] * 4)
FM_BACKWARD_SEARCH_U32 = CudaKernel("fm_search", "fm_backward_search_u32", _SEARCH_ARGS + [I64] + [PTR] * 4)
_LUT_ARGS = [PTR, PTR, PTR, PTR, PTR, INT, PTR, PTR, INT, INT, INT]
FM_SEARCH_LUT = CudaKernel("fm_search", "fm_search_lut", _LUT_ARGS + [INT] + [PTR] * 5)
FM_SEARCH_LUT_U32 = CudaKernel("fm_search", "fm_search_lut_u32", _LUT_ARGS + [I64] + [PTR] * 5)
_LOCATE_ARGS = [PTR, PTR, PTR, INT, PTR, PTR, PTR, INT, PTR, INT, INT]
FM_LOCATE = CudaKernel("fm_search", "fm_locate", _LOCATE_ARGS + [INT, INT, PTR])
FM_LOCATE_U32 = CudaKernel("fm_search", "fm_locate_u32", _LOCATE_ARGS + [I64, INT, PTR])
# csrc/fm_search.cu's THREADS: queries or rows a block
FM_THREADS = 128


def u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values of the uint32 bit patterns in an int32 tensor."""
    return t.long() & U32_MASK


def _check_text(fused, n: int, big: bool) -> tuple:
    """(S, nw) of ``fused``, checked, for a text of length ``n``."""
    if fused.dim() != 3:
        raise ValueError("fused must be (S, nw, 2)")
    S, nw, _ = fused.shape
    check(fused, "fused", torch.int32, (S, nw, 2))
    top = 2**32 - 1 if big else 2**31
    if not 0 <= n < top or nw * 32 < n or nw >= 2**27:
        kind = "uint32" if big else "int32"
        raise ValueError(f"text length {n} does not fit the {kind} kernel / a {nw}-word table")
    return S, nw


def _check_search(fused, less, sym_of, pats, plens, n: int, big: bool):
    dev = same_device(fused, less, sym_of, pats, plens)
    if pats.dim() != 2:
        raise ValueError("pats must be (B, L)")
    _check_text(fused, n, big)
    B, L = pats.shape
    check(less, "less", torch.int32, (256,))
    check(sym_of, "sym_of", torch.int32, (256,))
    check(pats, "pats", torch.uint8, (B, L))
    check(plens, "plens", torch.int32, (B,))
    check_lengths(plens, "plens", L)
    return dev, B, L


def _widen(outs, big: bool):
    """The wrapper's (status, lower, upper, mlen): lower and upper as the
    int64 values of their uint32 bit patterns in big mode."""
    status, lower, upper, mlen = outs
    if big:
        lower, upper = u32(lower), u32(upper)
    return status, lower, upper, mlen


def backward_search(fused, less, sym_of, pats, plens, n: int, big: bool = False):
    """K4. Returns (status, lower, upper, mlen), each (B,); lower and upper
    int32, or int64 in big mode."""
    dev, B, L = _check_search(fused, less, sym_of, pats, plens, n, big)
    if dev.type == "cpu":
        return backward_search_plain(fused, less, sym_of, pats, plens, n, big)
    outs = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)]
    if B:
        (FM_BACKWARD_SEARCH_U32 if big else FM_BACKWARD_SEARCH).launch(
            dev, fused.data_ptr(), less.data_ptr(), sym_of.data_ptr(),
            pats.data_ptr(), plens.data_ptr(), B, L, fused.shape[1], n,
            *(o.data_ptr() for o in outs),
        )
    return _widen(outs, big)


def search_lut(fused, less, sym_of, lut_rank, lut, q: int, pats, plens, n: int, big: bool = False):
    """K4-LUT. Returns (status, lower, upper, mlen, miss): K4's outputs on
    every lane, and the (B,) bool mask of the lanes that missed the LUT
    (plen < q, a byte outside A, C, G, T in the q-suffix, or an empty
    q-mer interval) and ran K4's whole loop."""
    dev, B, L = _check_search(fused, less, sym_of, pats, plens, n, big)
    same_device(fused, lut_rank, lut)
    if not 1 <= q <= 15:
        raise ValueError(f"LUT q = {q}: expected 1 <= q <= 15")
    check(lut_rank, "lut_rank", torch.int32, (256,))
    check(lut, "lut", torch.int32, (4**q, 2))
    if dev.type == "cpu":
        return search_lut_plain(fused, less, sym_of, lut_rank, lut, q, pats, plens, n, big)
    outs = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)]
    miss = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        (FM_SEARCH_LUT_U32 if big else FM_SEARCH_LUT).launch(
            dev, fused.data_ptr(), less.data_ptr(), sym_of.data_ptr(), lut_rank.data_ptr(), lut.data_ptr(), q,
            pats.data_ptr(), plens.data_ptr(), B, L, fused.shape[1], n,
            *(o.data_ptr() for o in outs), miss.data_ptr(),
        )
    return (*_widen(outs, big), miss)


def locate(fused, bwt_sym, less_sym, sa_sample, sent_rows, sent_vals, rows, s: int, big: bool = False, out=None):
    """K4-locate. Returns the (B,) text positions of suffix-array rows
    ``rows`` (int32; int64 in big mode), -1 (0xFFFFFFFF in big mode) for a
    row outside [0, n) (no sync: the callers check). ``out``: a contiguous
    (B,) int32 tensor to write the positions into (the read mapper's packed
    seed rows), in place of a new one."""
    dev = same_device(fused, bwt_sym, less_sym, sa_sample, sent_rows, sent_vals, rows)
    n = bwt_sym.numel()
    S, nw = _check_text(fused, n, big)
    k = sent_rows.numel()
    check(bwt_sym, "bwt_sym", torch.uint8, (n,))
    check(less_sym, "less_sym", torch.int32, (S,))
    check(sent_rows, "sent_rows", torch.int32, (k,))
    check(sent_vals, "sent_vals", torch.int32, (k,))
    check(rows, "rows", torch.int32, (rows.numel(),))
    if not 1 <= S <= 256:
        raise ValueError(f"{S} symbols: not an index of bytes")
    if not 1 <= s < 2**31:
        raise ValueError(f"sampling rate {s} < 1")
    check(sa_sample, "sa_sample", torch.int32, ((n + s - 1) // s,))
    B = rows.numel()
    if out is not None:
        same_device(rows, out)
        check(out, "out", torch.int32, (B,))
    if dev.type == "cpu":
        pos = locate_plain(fused, bwt_sym, less_sym, sa_sample, sent_rows, sent_vals, rows, s, big)
        if out is None:
            return pos
        out.copy_(pos)  # in big mode the uint32 values' bit patterns
        return u32(out) if big else out
    if out is None:
        out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        (FM_LOCATE_U32 if big else FM_LOCATE).launch(
            dev, fused.data_ptr(), bwt_sym.data_ptr(), less_sym.data_ptr(), S,
            sa_sample.data_ptr(), sent_rows.data_ptr(), sent_vals.data_ptr(), k,
            rows.data_ptr(), B, nw, n, s, out.data_ptr(),
        )
    return u32(out) if big else out


# ---------------------------------------------------------------------------
# plain PyTorch versions (queries vectorized, pattern steps in a Python loop)
# ---------------------------------------------------------------------------


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 >> 24) & 0xFF


def rank_plain(fused: torch.Tensor, pos: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Occurrences of symbol index ``sym`` (>= 0) in bwt[..pos+1]; 0 where
    ``pos < 0`` (fm_device.py ``_rank``). int32, shapes broadcast; ``pos``
    any integer type (int64 for the uint32 index)."""
    p = pos.clamp(min=0).long()
    pair = fused[sym.long(), p >> 5]  # (..., 2)
    word = pair[..., 0].long() & U32_MASK
    mask = (1 << ((p & 31) + 1)) - 1
    cnt = pair[..., 1] + _popcount32(word & mask).to(torch.int32)
    return torch.where(pos < 0, 0, cnt)


def _values(t: torch.Tensor, big: bool) -> torch.Tensor:
    """int64 index values of an int32 table: uint32 bit patterns in big mode."""
    return u32(t) if big else t.long()


def _search_plain(fused, less, sym_of, pats, plens, t0, l, r, mlen):
    """K4's loop from step ``t0`` (a tensor or an int) on int64 intervals
    [l, r] with ``mlen`` matched steps: (status, lower, upper, mlen), the
    positions int64."""
    B, L = pats.shape
    dev = pats.device
    pl, pr = l.clone(), r.clone()
    complete = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    for t in range(L):
        active = (t < plens) & (t >= t0) & ~done
        a = pats[rows, (plens - 1 - t).clamp(min=0).long()].long()
        sym = sym_of[a]
        less_a = less[a]
        valid = sym >= 0
        sym_m = sym.clamp(min=0)
        pl = torch.where(active, l, pl)
        pr = torch.where(active, r, pr)
        occ_r = torch.where(valid, rank_plain(fused, r, sym_m), 0)
        occ_lm1 = torch.where((l > 0) & valid, rank_plain(fused, l - 1, sym_m), 0)
        l_new = less_a + occ_lm1
        r_new = less_a + occ_r - 1
        fail = (occ_r == 0) | (l_new > r_new)
        upd = active & ~fail
        l = torch.where(upd, l_new, l)
        r = torch.where(upd, r_new, r)
        mlen = torch.where(upd, mlen + 1, mlen)
        complete = complete & ~(active & fail)
        done = done | (active & fail)
    status = torch.where(
        mlen > 0,
        torch.where(complete, COMPLETE, PARTIAL),
        ABSENT,
    ).to(torch.int32)
    lower = torch.where(complete, l, pl)
    upper = torch.where(complete, r, pr) + 1
    return status, lower, upper, mlen


def _narrow(status, lower, upper, mlen, big: bool):
    """The plain versions' outputs in the wrappers' types: positions int32,
    or the int64 uint32 values in big mode (upper wraps at 2^32 as the
    kernel's uint32 does)."""
    if big:
        return status, lower & U32_MASK, upper & U32_MASK, mlen
    return status, lower.to(torch.int32), upper.to(torch.int32), mlen


def backward_search_plain(fused, less, sym_of, pats, plens, n: int, big: bool = False):
    """Plain version of K4 (the scan of fm_device.py ``_search_impl``), in
    int64."""
    B = pats.shape[0]
    dev = pats.device
    l = torch.zeros(B, dtype=torch.int64, device=dev)
    r = torch.full((B,), n - 1, dtype=torch.int64, device=dev)
    mlen = torch.zeros(B, dtype=torch.int32, device=dev)
    return _narrow(*_search_plain(fused, _values(less, big), sym_of, pats, plens, 0, l, r, mlen), big)


def lut_codes_plain(lut_rank, q: int, pats, plens):
    """(code, miss) of each pattern's q-suffix: sum_t lut_rank[byte_t] * 4^t
    over steps t < q (step t reads pats[b, plen-1-t]); ``miss`` where plen <
    q or a byte has no DNA rank (fm_device.py ``_search_lut_impl``)."""
    B = pats.shape[0]
    rows = torch.arange(B, device=pats.device)
    code = torch.zeros(B, dtype=torch.int64, device=pats.device)
    miss = plens < q
    for t in range(q):
        lr = lut_rank[pats[rows, (plens - 1 - t).clamp(min=0).long()].long()]
        miss = miss | (lr < 0)
        code = code + (lr.clamp(min=0).long() << (2 * t))
    return torch.where(miss, 0, code), miss


def search_lut_plain(fused, less, sym_of, lut_rank, lut, q: int, pats, plens, n: int, big: bool = False):
    """Plain version of K4-LUT: the LUT jump of fm_device.py
    ``_search_lut_impl`` for the lanes that hit, K4's loop from step 0 for
    the miss lanes, in one pass; int64 positions."""
    code, miss = lut_codes_plain(lut_rank, q, pats, plens)
    pair = _values(lut, big)[code]
    l0, r0 = pair[:, 0], pair[:, 1]
    miss = miss | (l0 > r0)
    B = pats.shape[0]
    dev = pats.device
    l = torch.where(miss, 0, l0)
    r = torch.where(miss, n - 1, r0)
    mlen = torch.where(miss, 0, q).to(torch.int32)
    t0 = torch.where(miss, 0, q)
    outs = _search_plain(fused, _values(less, big), sym_of, pats, plens, t0, l, r, mlen)
    return (*_narrow(*outs, big), miss)


def locate_walk_plain(fused, bwt_sym, less_sym, rows, s: int, big: bool = False):
    """The LF-walk of K4-locate's plain version (fm_device.py
    ``_locate_impl``'s loop): for each row in [0, n), the row where the walk
    stops (sampled, or a sentinel row) and its steps; a host sync a step.
    int64 rows in big mode."""
    pos = rows.long() if big else rows.to(torch.int32)
    less_v = _values(less_sym, big)
    offset = torch.zeros_like(pos)
    done = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    while not bool(done.all()):
        sym = bwt_sym[pos.long()].to(torch.int32)
        # the sentinel is the smallest symbol, index 0
        done = done | (pos % s == 0) | (sym == 0)
        nxt = (less_v[sym.long()] + rank_plain(fused, pos - 1, sym)).to(pos.dtype)
        pos = torch.where(done, pos, nxt)
        offset = torch.where(done, offset, offset + 1)
    return pos, offset


def locate_plain(fused, bwt_sym, less_sym, sa_sample, sent_rows, sent_vals, rows, s: int, big: bool = False):
    """Plain version of K4-locate: the walk, then the base at its stop, the
    sampled value or a sentinel row's exact one (suffix_array.rs:157-184);
    -1 for a row outside [0, n) (0xFFFFFFFF in big mode, int64)."""
    rows = _values(rows, big)
    valid = (rows >= 0) & (rows < bwt_sym.numel())
    pos, offset = locate_walk_plain(fused, bwt_sym, less_sym, torch.where(valid, rows, 0), s, big)
    pos = pos.long()
    sampled = pos % s == 0
    # non-sampled stops are sentinel rows: exact values from sent_vals
    if sent_rows.numel():
        srows = _values(sent_rows, big)
        si = torch.searchsorted(srows, pos).clamp(0, sent_rows.numel() - 1)
        sent_base = torch.where(srows[si] == pos, _values(sent_vals, big)[si], 0)
    else:
        sent_base = torch.zeros_like(pos)
    base = torch.where(sampled, _values(sa_sample, big)[(pos // s)], sent_base)
    out = torch.where(valid, base + offset, -1)
    return out & U32_MASK if big else out.to(torch.int32)
