"""Batched banded alignment on the device (port of
``rust_bio_tpu.alignment.pairwise.banded_device``; banded.rs parity).

``BatchBandedAligner`` mirrors ``banded.Aligner``'s API. Its path:

1. Host band rasterization: one threaded native call
   (``native.band_build_batch``) runs k-mer matches, the sdpkpp chain and
   the band raster per pair, and, when the y clips are free, crops each band
   to its column window plus the one or two empty tail columns that keep
   the final column's two-buffer parity (the long-target regime: a read in
   a 20 kb target computes a window of its own width).
2. K16 (``ops.sw.scan_banded``), the banded DP over the window.
3. Device glue in torch: ``_init_column_banded`` (column 0's cells and
   x-suffix clip length) and ``_banded_suffix_fixups`` (the j = n fixups of
   banded.rs:677-766 with the score and tb effects of the final row-0 /
   column-0 rewrite loops).
4. K16-walk (``ops.walk.walk_banded``), the lockstep walk with the row-0 /
   column-0 s-bit rewrites and the out-of-band ending fixups, packed by
   ``_pack_steps`` into one uint16 tensor; one pull; the host decode
   (``_decode_ops_batch``) and the crop's y patch-back.

Results equal ``banded.Aligner`` (the host oracle) and the JAX package's
``BatchBandedAligner`` field for field. Routes, each chosen by an explicit
predicate: a band over ``MAX_CELLS`` gives the host's empty MIN_SCORE
alignment; a pair with an empty x or y, or a crop window wider than
``wcap``, runs the host oracle while the batch's other pairs stay on the
card; a scoring that is not ``MatchParams``, gap_open > gap_extend, or
M < 2 send the whole batch to the host oracle, pair by pair (the JAX package
sends the batch to its threaded native ``banded_batch``, whose outputs are
the oracle's, whenever one of these holds). There is no shared-memory
limit to model: every pair the JAX package sends to the host for its VMEM
model runs on the card. The dense tb of a batch, Nc x (M + 1) x B x 2 bytes,
is kept under the smaller of 8 GiB and half the card's free memory by
splitting the device lanes into sub-batches, each with its
own K16 launch, fixups, walk and pull; the result is the same for every
split.

``semiglobal_async`` does the band build and the upload and leaves the
device work in flight (no synchronizing call: lengths are checked on the
host, uploads are pinned and asynchronous); ``semiglobal_finish`` pulls. The
band build releases the GIL, so a one-thread executor running
``semiglobal_async`` for batch i + 1 overlaps batch i's device work.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from rust_bio_tpu_torch import native
from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.alignment.pairwise import banded as _banded
from rust_bio_tpu_torch.alignment.pairwise.banded import MAX_CELLS
from rust_bio_tpu_torch.alignment.pairwise.batched import _OP_ARR, _pack_steps, _unpack_steps
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE, MatchParams, Scoring
from rust_bio_tpu_torch.alignment.pairwise.tb import (
    TB_DEL,
    TB_INS,
    TB_START,
    TB_XCLIP_PREFIX,
    TB_XCLIP_SUFFIX,
    TB_YCLIP_PREFIX,
    TB_YCLIP_SUFFIX,
)
from rust_bio_tpu_torch.alignment.types import Alignment, AlignmentMode, Xclip, Yclip
from rust_bio_tpu_torch.ops import sw, walk
from rust_bio_tpu_torch.utils.text import to_bytes

_SENT = -(2**31) + 1
TB_BUDGET_MAX = 8 << 30  # bytes of dense tb a sub-batch may hold


def _i32(v, dev):
    return torch.tensor(int(v), dtype=torch.int32, device=dev)


def _init_column_banded(B, M, rows, mlens, nlens, pens, st0, en0):
    """Torch twin of K16's banded j = 0 column (banded.py:503-539; JAX
    ``_init_column_banded``): (tb_col0 (B, M+1) int32 packed cells, Lx0
    (B,) int32). ``rows`` is (1, M+1), ``pens`` (go, ge, xcp, xcs, ycp,
    ycs)."""
    dev = mlens.device
    go, ge, xcp, xcs, ycp, ycs = (_i32(v, dev) for v in pens)
    MIN = _i32(MIN_SCORE, dev)
    mlens_c = mlens[:, None]
    st0c = st0[:, None]
    en0c = en0[:, None]
    row_ge1 = rows >= 1
    in_b0 = row_ge1 & (rows >= st0c) & (rows < en0c)
    is_row_m = (rows == mlens_c) & (mlens_c >= 1)
    shape = (B, M + 1)

    gap_i = go + ge * (rows - 1)
    clip_i = xcp + go
    ins_wins = gap_i > clip_i
    I0v = torch.where(rows == 1, go, torch.where(ins_wins, gap_i, clip_i)).expand(shape)
    ib0 = torch.where(rows == 1, TB_START, torch.where(ins_wins, TB_INS, TB_XCLIP_PREFIX)).to(torch.int32).expand(shape)
    S0 = torch.full(shape, MIN_SCORE, dtype=torch.int32, device=dev)
    sb0 = torch.full(shape, TB_START, dtype=torch.int32, device=dev)
    tkI = I0v > S0
    S0 = torch.where(tkI, I0v, S0)
    sb0 = torch.where(tkI, TB_INS, sb0)
    tkX = xcp > S0
    S0 = torch.where(tkX, xcp, S0)
    sb0 = torch.where(tkX, TB_XCLIP_PREFIX, sb0)
    vals = torch.where(in_b0 & (rows <= mlens_c - 1), S0 + xcs, _SENT)
    A = vals.amax(dim=1)
    updA = A > MIN
    first = torch.argmax((vals == A[:, None]).to(torch.uint8), dim=1).to(torch.int32)
    Lx0 = torch.where(updA, mlens - first, 0).to(torch.int32)
    m_in_b0 = (mlens >= st0) & (mlens < en0) & (mlens >= 1)
    idx_m = mlens_c.long()

    def take_m(a):
        return a.gather(1, idx_m)[:, 0]

    S_m = torch.where(updA, A, MIN)
    sb_m = torch.full((B,), TB_XCLIP_SUFFIX, dtype=torch.int32, device=dev)
    I0_m = take_m(torch.where(in_b0, I0v, MIN))
    tkIm = I0_m > S_m
    sb_m = torch.where(tkIm, TB_INS, sb_m)
    S_m = torch.where(tkIm, I0_m, S_m)
    sb_m = torch.where(xcp > S_m, TB_XCLIP_PREFIX, sb_m)
    sb_m = torch.where(m_in_b0, sb_m, torch.where(updA, TB_XCLIP_SUFFIX, TB_START))
    ib_m = torch.where(m_in_b0, take_m(torch.where(in_b0, ib0, TB_START)), TB_START)
    sb0 = torch.where(in_b0, sb0, TB_START)
    ib0 = torch.where(in_b0, ib0, TB_START)
    sb0 = torch.where(is_row_m, sb_m[:, None], sb0)
    ib0 = torch.where(is_row_m, ib_m[:, None], ib0)
    sb0 = torch.where(rows == 0, TB_START, sb0)
    ib0 = torch.where(rows == 0, TB_START, ib0)
    return (ib0 | (sb0 << 8)).to(torch.int32), Lx0


def _banded_suffix_fixups(S_f, I_f, Sn_f, Ly_f, tbk, B, M, mlens, nlens, pens, st_n, en_n):
    """Torch twin of banded.py's j = n fixups (banded.rs:677-766) plus the
    score and tb effects of the final row-0 / column-0 rewrite loops (JAX
    ``_banded_suffix_fixups``). Returns (score (B,), tbfix_cells (B, M+1)
    packed 12-bit, Ly_fixed (B, M+1), Lx_n (B,), lx_n_set (B,) bool)."""
    dev = S_f.device
    go, ge, xcp, xcs, ycp, ycs = (_i32(v, dev) for v in pens)
    MIN = _i32(MIN_SCORE, dev)
    i32 = torch.int32
    rows = torch.arange(M + 1, dtype=i32, device=dev)[None, :].expand(B, M + 1)
    mlens_c = mlens[:, None]
    is_row_m = (rows == mlens_c) & (mlens_c >= 1)
    idx_m = mlens_c.long()

    def take_m(a):
        return a.gather(1, idx_m)[:, 0]

    def first_of(vals, best):
        return torch.argmax((vals == best[:, None]).to(torch.uint8), dim=1).to(i32)

    def shift_right(a, fill):
        return torch.cat([torch.full((B, 1), fill, dtype=a.dtype, device=dev), a[:, :-1]], dim=1)

    i_bits = tbk & 0xF
    d_bits = (tbk >> 4) & 0xF
    s_bits = (tbk >> 8) & 0xF

    # out-of-band mask (the host's exact off-by-one: `i > ends[n]` unmasked)
    masked = ~is_row_m & ((rows < st_n[:, None]) | (rows > en_n[:, None]))
    S0 = torch.where(masked, MIN, S_f)

    # loop 1: per-row Sn merge, then the x-suffix clip into S[m]
    y_take = Sn_f > S0
    S1 = torch.where(y_take, Sn_f, S0)
    sb1 = torch.where(y_take, TB_YCLIP_SUFFIX, s_bits)
    S_m_base = take_m(S0)
    vals = torch.where(rows <= mlens_c - 1, S1 + xcs, _SENT)
    A = vals.amax(dim=1)
    x_upd = A > S_m_base
    acc = torch.where(x_upd, A, S_m_base)
    sb_m = torch.where(x_upd, TB_XCLIP_SUFFIX, take_m(sb1))
    Lx_n = torch.where(x_upd, mlens - first_of(vals, A), 0).to(i32)
    lx_n_set = x_upd
    Sn_m = take_m(Sn_f)
    y_take_m = Sn_m > acc
    acc = torch.where(y_take_m, Sn_m, acc)
    sb_m = torch.where(y_take_m, TB_YCLIP_SUFFIX, sb_m)
    S1 = torch.where(is_row_m, acc[:, None], S1)
    sb1 = torch.where(is_row_m, sb_m[:, None], sb1)

    # loop 2: the late insertion sweep over [max(1, st_n), en_n)
    in_sweep = (rows >= torch.clamp(st_n, min=1)[:, None]) & (rows < en_n[:, None])
    U = torch.where(rows >= st_n[:, None] - 1, S1 - rows * go, _SENT)
    C = torch.cummax(U, dim=1).values
    s_score = shift_right(C, _SENT) + rows * go
    upd2 = in_sweep & (s_score > S1) & ~is_row_m
    S2 = torch.where(upd2, s_score, S1)
    sb2 = torch.where(upd2, TB_INS, sb1)
    i_take = in_sweep & (s_score > I_f) & ~is_row_m
    sb2_prev = shift_right(sb2, TB_START)
    ib2 = torch.where(i_take, sb2_prev, i_bits)
    vals3 = torch.where(upd2 & (rows <= mlens_c - 1), S2 + xcs, _SENT)
    A3 = vals3.amax(dim=1)
    acc_m = take_m(S1)
    x_upd3 = A3 > acc_m
    acc3 = torch.where(x_upd3, A3, acc_m)
    sb_m3 = torch.where(x_upd3, TB_XCLIP_SUFFIX, take_m(sb2))
    Lx_n = torch.where(x_upd3, mlens - first_of(vals3, A3), Lx_n).to(i32)
    lx_n_set = lx_n_set | x_upd3
    # row m's own sweep statements (only when m is inside the sweep)
    m_in_sweep = (mlens >= torch.clamp(st_n, min=1)) & (mlens < en_n)
    sm_score = take_m(s_score)
    m_take = m_in_sweep & (sm_score > acc3)
    S_final_m = torch.where(m_take, sm_score, acc3)
    sb_final_m = torch.where(m_take, TB_INS, sb_m3)
    i_take_m = m_in_sweep & (sm_score > take_m(I_f))
    ib2 = torch.where(is_row_m & i_take_m[:, None], take_m(sb2_prev)[:, None], ib2)
    S2 = torch.where(is_row_m, S_final_m[:, None], S2)
    sb2 = torch.where(is_row_m, sb_final_m[:, None], sb2)

    # the final rewrite loops' score/tb effects (banded.py:695-725):
    # j-loop at j = n ...
    d_n = go + ge * (nlens - 1)
    best0 = torch.maximum(d_n, ycp)
    sb_0n = torch.where(d_n > ycp, TB_DEL, TB_YCLIP_PREFIX)
    y_best = ycs > best0
    best0 = torch.where(y_best, ycs, best0)
    sb_0n = torch.where(y_best, TB_YCLIP_SUFFIX, sb_0n)
    S_m_now = take_m(S2)
    bump1 = (xcs + best0 > S_m_now) & (nlens >= 1)
    S_m_now = torch.where(bump1, xcs + best0, S_m_now)
    Lx_n = torch.where(bump1, mlens, Lx_n).to(i32)
    lx_n_set = lx_n_set | bump1
    sb_mn = torch.where(bump1, TB_XCLIP_SUFFIX, take_m(sb2))
    # ... and the i-loop at i = m
    c_m = go + ge * (mlens - 1)
    bestm = torch.maximum(c_m, xcp)
    bestm = torch.where(xcs > bestm, xcs, bestm)
    bump2 = (ycs + bestm > S_m_now) & (mlens >= 1)
    S_m_now = torch.where(bump2, ycs + bestm, S_m_now)
    Ly_m = torch.where(bump2, nlens, take_m(Ly_f))
    sb_mn = torch.where(bump2, TB_YCLIP_SUFFIX, sb_mn)

    sb2 = torch.where(is_row_m, sb_mn[:, None], sb2)
    # row 0 of the fixed column: the rewritten (0, n) s-bits
    sb2 = torch.cat([torch.where(nlens >= 1, sb_0n, sb2[:, 0])[:, None], sb2[:, 1:]], dim=1)
    Ly_fixed = torch.where(is_row_m, Ly_m[:, None], Ly_f)
    tbfix_cells = ((ib2 & 0xF) | ((d_bits & 0xF) << 4) | ((sb2 & 0xF) << 8)).to(i32)
    return S_m_now, tbfix_cells, Ly_fixed, Lx_n, lx_n_set


def _walk_inputs(scan, mlens, nlens, pens8, starts, ends):
    """K16-walk's inputs from a K16 scan: the fixups, column 0's twin and
    the clip lengths of every column with the fixed one at nlens. Returns
    (score (B,), (tb, tb0, tbfix, lx_full, mlens, nlens, pens))."""
    tb, lx, S_f, I_f, Sn_f, Ly_f, tbk = scan
    B, X = S_f.shape
    pens = tuple(int(v) for v in pens8[:6])
    bidx = torch.arange(B, device=S_f.device)
    nl64 = nlens.long()
    score, tbfix_cells, Ly_fixed, Lx_n, lx_n_set = _banded_suffix_fixups(
        S_f, I_f, Sn_f, Ly_f, tbk, B, X - 1, mlens, nlens, pens, starts[bidx, nl64], ends[bidx, nl64]
    )
    rows = torch.arange(X, dtype=torch.int32, device=S_f.device)[None, :]
    tb_col0, Lx0 = _init_column_banded(B, X - 1, rows, mlens, nlens, pens, starts[:, 0], ends[:, 0])
    tbfix = (tbfix_cells & 0xFFF) | (Ly_fixed << 12)
    Lx_full = torch.cat([Lx0[:, None], lx.t()], dim=1)
    Lx_full[bidx, nl64] = torch.where(lx_n_set, Lx_n, Lx_full[bidx, nl64])
    return score, (tb, tb_col0, tbfix, Lx_full, mlens, nlens, pens)


def _align_batch_device_banded_mp(xb, yb, mlens, nlens, pens8, starts, ends):
    """The banded batch on tensors of one device (JAX
    ``_align_batch_device_banded_mp``): K16, the fixups, column 0's twin,
    K16-walk and ``_pack_steps``. Returns the (6 + 2T, B) uint16 packed
    tensor (T = M + N + 8) on the device; nothing here waits for it."""
    scan = sw.scan_banded(xb, yb, mlens, nlens, pens8, starts, ends)
    score, inputs = _walk_inputs(scan, mlens, nlens, pens8, starts, ends)
    return _pack_steps(score, *walk.walk_banded(*inputs))


def _decode_ops_batch(codes: np.ndarray, lens: np.ndarray):
    """Whole-batch decode of (T, B) walk buffers (JAX ``_decode_ops_batch``):
    codes are 0 after a lane finishes; a clip entry is one op of its length,
    an Ins or Del entry with a length (an ending fixup) that many ops, any
    other entry one op; each lane's list is reversed (the walk emits end ->
    start)."""
    c = codes.T.astype(np.intp)  # (B, T)
    ln = lens.T.astype(np.int64)
    valid = c != 0
    is_clip = (c >= TB_XCLIP_PREFIX) & valid
    reps = np.where(valid, np.where(is_clip, 1, np.maximum(ln, 1)), 0)
    flat_reps = reps.ravel()
    flat_c = c.ravel()
    expanded = _OP_ARR[np.repeat(flat_c, flat_reps)]
    offs = np.zeros(flat_reps.size + 1, np.int64)
    np.cumsum(flat_reps, out=offs[1:])
    flat_l = ln.ravel()
    for idx in np.nonzero(is_clip.ravel())[0]:
        code = int(flat_c[idx])
        n = int(flat_l[idx])
        expanded[offs[idx]] = Xclip(n) if code in (TB_XCLIP_PREFIX, TB_XCLIP_SUFFIX) else Yclip(n)
    lane_tot = reps.sum(axis=1)
    lane_offs = np.zeros(len(lane_tot) + 1, np.int64)
    np.cumsum(lane_tot, out=lane_offs[1:])
    flat_ops = expanded.tolist()
    out = []
    for b in range(c.shape[0]):
        ops = flat_ops[int(lane_offs[b]) : int(lane_offs[b + 1])]
        ops.reverse()
        out.append(ops)
    return out


def _clip_group_yclip(ops, idx) -> int:
    """The index of the Yclip among the clip ops at one end of ``ops``
    (``idx`` the end's indices, outward first), or -1."""
    for k in idx:
        if ops[k].kind == "Yclip":
            return k
        if ops[k].kind != "Xclip":
            return -1
    return -1


def _uncrop_ops(ops, c0: int, tail: int, ystart_w: int) -> None:
    """A cropped window's op list back to the whole target, in place: the
    y-prefix clip grows by the ``c0`` columns before the window and the
    y-suffix clip becomes the ``tail`` columns after the alignment's end.
    Each clip is looked for among all the clip ops at its end of the list
    (the x clip of that end may stand on either side of it); in a list of
    clips only, one Yclip of the window's ``ystart_w`` columns is the
    prefix's. A missing clip is added at its end of the list. The JAX
    package looks at the outermost op only, so an x-suffix clip after the
    y-suffix clip leaves the window's y clip in place and appends a second
    one (ROADMAP Queue 3)."""
    kp = _clip_group_yclip(ops, range(len(ops)))
    ks = _clip_group_yclip(ops, range(len(ops) - 1, -1, -1))
    if kp >= 0 and kp == ks:
        if ops[kp].len == ystart_w:
            ks = -1
        else:
            kp = -1
    if kp >= 0:
        ops[kp] = Yclip(ops[kp].len + c0)
    elif c0 > 0:
        ops.insert(0, Yclip(c0))
        ks += ks >= 0
    if ks >= 0:
        ops[ks] = Yclip(tail)
    elif tail > 0:
        ops.append(Yclip(tail))


def _empty_alignment(mode: AlignmentMode) -> Alignment:
    """The host's alignment of a band over MAX_CELLS (banded.rs:407)."""
    aln = Alignment(score=MIN_SCORE, ystart=0, xstart=0, yend=0, xend=0, ylen=0, xlen=0, operations=[],
                    mode=AlignmentMode.Custom)
    aln.mode = mode
    return aln


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without a synchronizing copy: through pinned
    memory, asynchronously, on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


class BatchBandedAligner:
    """Batched banded aligner (banded.rs API, device DP).

    ``device=None`` means CUDA (``RuntimeError`` without a card);
    ``device="cpu"`` runs K16's and K16-walk's plain versions. A pair whose
    host-oracle traceback never ends (an empty y whose column 0 ends in a
    clip) raises ``ValueError`` for the batch."""

    def __init__(self, scoring: Scoring, k: int, w: int, device=None) -> None:
        self.scoring = scoring
        self.k = k
        self.w = w
        self.device = resolve_device(device)

    # ---- mode wrappers ----

    def custom(self, xs: Sequence, ys: Sequence) -> List[Alignment]:
        return self._run(xs, ys, self.scoring, AlignmentMode.Custom, False)

    def global_(self, xs, ys) -> List[Alignment]:
        sc = self.scoring.with_clips(*((MIN_SCORE,) * 4))
        return self._run(xs, ys, sc, AlignmentMode.Global, False)

    def semiglobal(self, xs, ys) -> List[Alignment]:
        sc = self.scoring.with_clips(MIN_SCORE, MIN_SCORE, 0, 0)
        return self._run(xs, ys, sc, AlignmentMode.Semiglobal, True)

    def local(self, xs, ys) -> List[Alignment]:
        sc = self.scoring.with_clips(0, 0, 0, 0)
        return self._run(xs, ys, sc, AlignmentMode.Local, True)

    def semiglobal_async(self, xs, ys):
        """Start a semiglobal batch without waiting for the device: the band
        build and the upload run now, the device work is left in flight.
        Pass the handle to ``semiglobal_finish``."""
        sc = self.scoring.with_clips(MIN_SCORE, MIN_SCORE, 0, 0)
        return self._run_async(xs, ys, sc, AlignmentMode.Semiglobal, True)

    def semiglobal_finish(self, handle) -> List[Alignment]:
        return self._run_finish(handle)

    # ---- engine ----

    def _host_one(self, sc, x, y, mode, filter_clips) -> Alignment:
        """One pair on the host oracle."""
        aln = _banded.Aligner(sc, self.k, self.w).custom(x, y)
        aln.mode = mode
        if filter_clips:
            aln.filter_clip_operations()
        return aln

    def _budget(self) -> int:
        """Bytes of dense tb a sub-batch may hold: the smaller of
        ``TB_BUDGET_MAX`` and half the card's free memory (on the CPU
        ``TB_BUDGET_MAX``)."""
        if self.device.type != "cuda":
            return TB_BUDGET_MAX
        free, _total = torch.cuda.mem_get_info(self.device)
        return min(TB_BUDGET_MAX, free // 2)

    def _run(self, xs, ys, sc, mode, filter_clips) -> List[Alignment]:
        return self._run_finish(self._run_async(xs, ys, sc, mode, filter_clips))

    def _band_batch(self, xs, ys, sc, mode, filter_clips):
        """The host half of a batch (``xs``/``ys`` as bytes): the routes,
        the band build and the device lanes' arrays. Returns (out, run_idx,
        crop, c0s, arrays): ``out`` holds the alignments already made on the
        host, ``run_idx`` the pairs for the device, ``c0s`` their window
        origins, ``arrays`` their (xb, yb, mlens, nlens, starts, ends,
        pens8) as numpy (None when no pair runs there)."""
        B = len(xs)
        M = max((len(x) for x in xs), default=1) or 1
        N = max((len(y) for y in ys), default=1) or 1
        on_device = isinstance(sc.match_fn, MatchParams) and sc.gap_open <= sc.gap_extend and M >= 2
        if not on_device:
            return [self._host_one(sc, x, y, mode, filter_clips) for x, y in zip(xs, ys)], [], False, None, None

        clips = (int(sc.xclip_prefix), int(sc.xclip_suffix), int(sc.yclip_prefix), int(sc.yclip_suffix))
        ml_h = np.array([len(x) for x in xs], np.int64)
        nl_h = np.array([len(y) for y in ys], np.int64)
        if (ml_h == M).all():
            xb_h = np.frombuffer(b"".join(xs), np.uint8).reshape(B, M)
        else:
            xb_h = np.zeros((B, M), np.uint8)
            for i, x in enumerate(xs):
                xb_h[i, : len(x)] = np.frombuffer(x, np.uint8)
        if (nl_h == N).all():
            yb_h = np.frombuffer(b"".join(ys), np.uint8).reshape(B, N)
        else:
            yb_h = np.zeros((B, N), np.uint8)
            for i, y in enumerate(ys):
                yb_h[i, : len(y)] = np.frombuffer(y, np.uint8)

        # free y clips: each band occupies a narrow column window of a long
        # target; the DP outside it is row-0 only, so the batch runs on the
        # window plus the tail columns that keep the final column's parity
        # (y coordinates and y clips are patched back in _run_finish)
        crop = clips[2] == 0 and clips[3] == 0
        if crop:
            wcap = min(max(N, 8), max(1024, 1 << (M + 8 * (self.k + self.w) + 16).bit_length()))
        else:
            wcap = max(N, 8)
        mp = sc.match_fn
        stw, enw, c0_all, nle_all, cells_all, _jwin = native.band_build_batch(
            xb_h, ml_h, yb_h, nl_h, self.k, self.w, clips, mp.match_score, -sc.gap_open, -sc.gap_extend,
            crop, wcap,
        )

        out: List = [None] * B
        run_idx = []
        for i in range(B):
            if int(cells_all[i]) > MAX_CELLS:
                out[i] = _empty_alignment(mode)
            elif not (xs[i] and ys[i]) or int(nle_all[i]) < 0:  # an empty x or y; a window wider than wcap
                out[i] = self._host_one(sc, xs[i], ys[i], mode, filter_clips)
            else:
                run_idx.append(i)
        if not run_idx:
            return out, run_idx, crop, None, None

        ri = np.asarray(run_idx, np.int64)
        nb = len(ri)
        c0s = c0_all[ri]
        nl_effs = nle_all[ri]
        Nc = int(nl_effs.max())
        xb = xb_h[ri]
        yidx = np.minimum(c0s[:, None] + np.arange(Nc)[None, :], N - 1)
        ymask = np.arange(Nc)[None, :] < nl_effs[:, None]
        yb = np.where(ymask, yb_h[ri[:, None], yidx], 0).astype(np.uint8)
        mlens = ml_h[ri].astype(np.int32)
        nlens = nl_effs.astype(np.int32)
        starts = np.ascontiguousarray(stw[ri, : Nc + 1])
        ends = np.ascontiguousarray(enw[ri, : Nc + 1])
        pens8 = (sc.gap_open, sc.gap_extend, *clips, mp.match_score, mp.mismatch_score)
        return out, run_idx, crop, c0s, (xb, yb, mlens, nlens, starts, ends, pens8)

    def _run_async(self, xs, ys, sc, mode, filter_clips):
        xs = [to_bytes(x) for x in xs]
        ys = [to_bytes(y) for y in ys]
        if len(xs) != len(ys):
            raise ValueError(f"{len(xs)} x sequences against {len(ys)} y sequences")
        out, run_idx, crop, c0s, arrays = self._band_batch(xs, ys, sc, mode, filter_clips)
        if arrays is None:
            return ("done", out)
        *host, pens8 = arrays
        nb, M = host[0].shape
        Nc = host[1].shape[1]
        # sub-batches whose dense tb (K16's pair-major rows of Xp = M + 1
        # rounded up to 8) fits the budget, each in flight
        lanes = max(1, self._budget() // (Nc * sw.pair_major_pitch(M) * 2))
        parts = []
        for lo in range(0, nb, lanes):
            hi = min(nb, lo + lanes)
            args = [_upload(a[lo:hi], self.device) for a in host]
            packed = _align_batch_device_banded_mp(*args[:4], pens8, *args[4:])
            parts.append((packed, lo, hi))
        return ("dev", parts, out, run_idx, xs, ys, crop, c0s, mode, filter_clips)

    def _run_finish(self, handle) -> List[Alignment]:
        if handle[0] == "done":
            return handle[1]
        _, parts, out, run_idx, xs, ys, crop, c0s, mode, filter_clips = handle
        for packed, lo, hi in parts:
            scores, up = _unpack_steps(packed.cpu().numpy())  # JAX _unpack_banded's layout
            ops_all = _decode_ops_batch(up["op_codes"], up["op_lens"])
            for r in range(hi - lo):
                i = run_idx[lo + r]
                ops = ops_all[r]
                ystart, yend = int(up["ystart"][r]), int(up["yend"][r])
                if crop:
                    c0 = int(c0s[lo + r])
                    _uncrop_ops(ops, c0, len(ys[i]) - yend - c0, ystart)
                    ystart += c0
                    yend += c0
                aln = Alignment(
                    score=int(scores[r]), ystart=ystart, xstart=int(up["xstart"][r]), yend=yend,
                    xend=int(up["xend"][r]), ylen=len(ys[i]), xlen=len(xs[i]), operations=ops,
                    mode=AlignmentMode.Custom,
                )
                aln.mode = mode
                if filter_clips:
                    aln.filter_clip_operations()
                out[i] = aln
        return out
