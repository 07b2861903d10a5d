"""Batched FM-index backward search and locate: kernels K4 and K4-locate,
CUDA source in ``csrc/fm_search.cu``. K4 replaces
``rust_bio_tpu/ops/fm_pallas.py`` ``backward_search_fused``; K4-locate
replaces the XLA LF-walk ``rust_bio_tpu/data_structures/fm_device.py``
``_locate_impl``.

Inputs: ``fused`` (S, nw, 2) int32, per symbol index and 32-bit word the
bit-plane word (its bits as int32) and the exclusive checkpoint count;
``less`` (256,) int32 keyed by byte; ``sym_of`` (256,) int32 keyed by byte
(-1 outside the alphabet); ``pats`` (B, L) uint8 left-aligned patterns and
``plens`` (B,) int32 (``0 <= plens <= L``); ``n`` the text
length. Outputs (B,) int32 each: status (ABSENT 0 / PARTIAL 1 /
COMPLETE 2), lower, upper (exclusive) and the matched length.

Locate takes ``bwt_sym`` (n,) uint8, the symbol index of each BWT row,
``less_sym`` (S,) int32 keyed by symbol index, the sampled suffix array
``sa_sample`` (sa[::s]), the sorted sentinel rows ``sent_rows`` and their
values ``sent_vals`` (k,) int32, and ``rows`` (B,) int32; it returns the
(B,) int32 text positions, -1 for a row outside [0, n).
"""

from __future__ import annotations

import torch

from rust_bio_tpu_torch.ops._build import (
    INT,
    PTR,
    CudaKernel,
    check,
    check_lengths,
    same_device,
)

ABSENT, PARTIAL, COMPLETE = 0, 1, 2

FM_BACKWARD_SEARCH = CudaKernel(
    "fm_search", "fm_backward_search",
    [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, PTR, PTR, PTR, PTR],
)
FM_LOCATE = CudaKernel(
    "fm_search", "fm_locate",
    [PTR, PTR, PTR, INT, PTR, PTR, PTR, INT, PTR, INT, INT, INT, INT, PTR],
)
# csrc/fm_search.cu's THREADS: queries or rows a block
FM_THREADS = 128


def backward_search(fused, less, sym_of, pats, plens, n: int):
    """K4. Returns (status, lower, upper, mlen), each (B,) int32."""
    dev = same_device(fused, less, sym_of, pats, plens)
    if fused.dim() != 3 or pats.dim() != 2:
        raise ValueError("fused must be (S, nw, 2) and pats (B, L)")
    S, nw, _ = fused.shape
    B, L = pats.shape
    check(fused, "fused", torch.int32, (S, nw, 2))
    check(less, "less", torch.int32, (256,))
    check(sym_of, "sym_of", torch.int32, (256,))
    check(pats, "pats", torch.uint8, (B, L))
    check(plens, "plens", torch.int32, (B,))
    check_lengths(plens, "plens", L)
    if not 0 <= n < 2**31 or nw * 32 < n:
        raise ValueError(f"text length {n} does not fit the int32 kernel / a {nw}-word table")
    if dev.type == "cpu":
        return backward_search_plain(fused, less, sym_of, pats, plens, n)
    outs = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)]
    if B:
        FM_BACKWARD_SEARCH.launch(
            dev, fused.data_ptr(), less.data_ptr(), sym_of.data_ptr(),
            pats.data_ptr(), plens.data_ptr(), B, L, nw, n,
            *(o.data_ptr() for o in outs),
        )
    return tuple(outs)


def locate(fused, bwt_sym, less_sym, sa_sample, sent_rows, sent_vals, rows, s: int):
    """K4-locate. Returns the (B,) int32 text positions of suffix-array rows
    ``rows``, -1 for a row outside [0, n) (no sync: the callers check)."""
    dev = same_device(fused, bwt_sym, less_sym, sa_sample, sent_rows, sent_vals, rows)
    if fused.dim() != 3:
        raise ValueError("fused must be (S, nw, 2)")
    S, nw, _ = fused.shape
    n = bwt_sym.numel()
    k = sent_rows.numel()
    check(fused, "fused", torch.int32, (S, nw, 2))
    check(bwt_sym, "bwt_sym", torch.uint8, (n,))
    check(less_sym, "less_sym", torch.int32, (S,))
    check(sent_rows, "sent_rows", torch.int32, (k,))
    check(sent_vals, "sent_vals", torch.int32, (k,))
    check(rows, "rows", torch.int32, (rows.numel(),))
    if not 1 <= S <= 256 or nw * 32 < n or n >= 2**31:
        raise ValueError(f"{S} symbols, text length {n}: not an index of bytes in a {nw}-word table")
    if s < 1:
        raise ValueError(f"sampling rate {s} < 1")
    check(sa_sample, "sa_sample", torch.int32, ((n + s - 1) // s,))
    if dev.type == "cpu":
        return locate_plain(fused, bwt_sym, less_sym, sa_sample, sent_rows, sent_vals, rows, s)
    B = rows.numel()
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        FM_LOCATE.launch(
            dev, fused.data_ptr(), bwt_sym.data_ptr(), less_sym.data_ptr(), S,
            sa_sample.data_ptr(), sent_rows.data_ptr(), sent_vals.data_ptr(), k,
            rows.data_ptr(), B, nw, n, s, out.data_ptr(),
        )
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version (queries vectorized, pattern steps in a Python loop)
# ---------------------------------------------------------------------------


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 >> 24) & 0xFF


def rank_plain(fused: torch.Tensor, pos: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Occurrences of symbol index ``sym`` (>= 0) in bwt[..pos+1]; 0 where
    ``pos < 0`` (fm_device.py ``_rank``). int32, shapes broadcast."""
    p = pos.clamp(min=0).long()
    pair = fused[sym.long(), p >> 5]  # (..., 2)
    word = pair[..., 0].long() & 0xFFFFFFFF
    mask = (1 << ((p & 31) + 1)) - 1
    cnt = pair[..., 1] + _popcount32(word & mask).to(torch.int32)
    return torch.where(pos < 0, 0, cnt)


def backward_search_plain(fused, less, sym_of, pats, plens, n: int):
    """Plain version of K4 (the scan of fm_device.py ``_search_impl``)."""
    B, L = pats.shape
    dev = pats.device
    i32 = torch.int32
    l = torch.zeros(B, dtype=i32, device=dev)
    r = torch.full((B,), n - 1, dtype=i32, device=dev)
    pl, pr = l.clone(), r.clone()
    mlen = torch.zeros(B, dtype=i32, device=dev)
    complete = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    for t in range(L):
        active = (t < plens) & ~done
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
    ).to(i32)
    lower = torch.where(complete, l, pl)
    upper = torch.where(complete, r, pr) + 1
    return status, lower, upper, mlen


def locate_walk_plain(fused, bwt_sym, less_sym, rows, s: int):
    """The LF-walk of K4-locate's plain version (fm_device.py
    ``_locate_impl``'s loop): for each row in [0, n), the row where the walk
    stops (sampled, or a sentinel row) and its steps; a host sync a step."""
    pos = rows.to(torch.int32)
    offset = torch.zeros_like(pos)
    done = torch.zeros(pos.shape, dtype=torch.bool, device=pos.device)
    while not bool(done.all()):
        sym = bwt_sym[pos.long()].to(torch.int32)
        # the sentinel is the smallest symbol, index 0
        done = done | (pos % s == 0) | (sym == 0)
        nxt = less_sym[sym.long()] + rank_plain(fused, pos - 1, sym)
        pos = torch.where(done, pos, nxt)
        offset = torch.where(done, offset, offset + 1)
    return pos, offset


def locate_plain(fused, bwt_sym, less_sym, sa_sample, sent_rows, sent_vals, rows, s: int):
    """Plain version of K4-locate: the walk, then the base at its stop, the
    sampled value or a sentinel row's exact one (suffix_array.rs:157-184);
    -1 for a row outside [0, n)."""
    valid = (rows >= 0) & (rows < bwt_sym.numel())
    pos, offset = locate_walk_plain(fused, bwt_sym, less_sym, torch.where(valid, rows, 0), s)
    sampled = pos % s == 0
    # non-sampled stops are sentinel rows: exact values from sent_vals
    if sent_rows.numel():
        si = torch.searchsorted(sent_rows, pos).clamp(0, sent_rows.numel() - 1)
        sent_base = torch.where(sent_rows[si] == pos, sent_vals[si], 0)
    else:
        sent_base = torch.zeros_like(pos)
    base = torch.where(sampled, sa_sample[(pos // s).long()], sent_base)
    return torch.where(valid, base + offset, -1).to(torch.int32)
