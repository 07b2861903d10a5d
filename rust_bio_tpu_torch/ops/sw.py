"""Affine-gap DP kernels: K1 (``scan_global``: score + traceback cells, one
warp a pair over row stripes with a pair-major tb), CUDA source
``csrc/sw_warp.cu``; K3 (``scores_global``: score only, one
warp a pair over row stripes at short x, ``csrc/sw_warp.cu``, one block a
pair at long x, ``csrc/sw_global_rows.cu``; ``scores_route`` picks); K5
(``scan_semiglobal``: traceback cells + the finals of the y-clip
machinery), K9 (``scan_custom``: all four clip penalties live) and K7
(``scan_local``: K9 at clips 0), one warp a pair over row stripes with a
pair-major tb, ``csrc/sw_warp.cu``;
K13 (``scan_global_rows``: K1's DP for long x, a row-stripe wavefront
over one pair a block, with a pair-major tb), ``csrc/sw_global_rows.cu``;
K15 (``scan_columns``: K9's DP without the run nibble, the clip-mode engine
of long x, a row-stripe wavefront over one pair a block, with a pair-major
tb), ``csrc/sw_columns.cu``; K16
(``scan_banded``: the banded aligner's DP over per-column row bands, one
warp a pair over a column's band rows, with a pair-major tb),
``csrc/sw_banded.cu``.

Each takes constant match/mismatch scores. Its ``*_lut`` twin takes a
(256, 256) int32 substitution LUT in their place and gives the same
outputs: K11 ``scan_global_lut``, K18 ``scores_global_lut``, K7-LUT
``scan_local_lut``, K9-LUT ``scan_custom_lut`` and K12
``scan_semiglobal_lut`` (K1, K3, K7, K9 and K5 fed by the LUT, one warp a
pair over row stripes, all but K18 with a pair-major tb,
``csrc/sw_warp.cu``), ``scan_global_rows_lut`` (K13 fed by the LUT) and
``scan_columns_lut`` (K15-LUT). The
kernels read ``lut[x, y]`` per cell; the Match/Subst traceback bit is byte
equality (``x == y``) whatever the LUT says.

They replace ``rust_bio_tpu/ops/sw_pallas.py`` ``scan_global_pallas_mp``,
``scan_semiglobal_pallas_mp``, ``scan_custom_pallas_mp`` and
``scan_local_pallas_mp`` (all ``runs="ins"``), ``sw_scores_global_matchparams``,
``scan_global_pallas_subs``, ``scan_semiglobal_pallas_subs``,
``sw_scores_global``, ``scan_global_rows_pallas_mp``,
``scan_columns_pallas_mp`` and ``scan_banded_pallas_mp`` (and, under a LUT,
the XLA engine
``batched._align_batch_device``). The plain versions
below follow the Pallas kernels' column formulation (rows vectorized, the
insertion recurrence as a (max,+) prefix scan, in wrapping int32 like every
sum: the CUDA kernels carry the same prefix maximum, so they agree where a
sum passes 2^31 too), one column core per kernel
fed column by column with (substitution scores, equality bits): from the
bytes for constant scores, and, for a LUT, by a gather per column on the
wrappers' CPU path, or, in the ``*_lut_plain`` versions that the tests
hold against the JAX subs kernels, from the (N, M, B) stream
``lut[x, y] * 2 | (x == y)`` (``subs2_stream_plain``) those kernels read,
or for K18 from the (B, M, N) tensor of ``sw_scores_global``
(``subs_tensor_plain``). In the CUDA kernels one block sweeps a pair's
columns as a wavefront over stripes of its rows in K13, K15 and K3 at long x
(``rows_geometry``, ``columns_geometry``), one warp does in K1, K11, K18,
K3 at short x, K5, K12, K7, K7-LUT, K9 and K9-LUT (``warp_geometry``), and
one warp computes each column's band rows in K16 (``banded_geometry``).
All are exact in int32.

Inputs: ``xb`` (B, M) and ``yb`` (B, N) uint8, ``mlens``/``nlens`` (B,)
int32 with ``0 <= mlens <= M`` and ``0 <= nlens <= N``; ``lut`` (256, 256)
int32 on the same device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE
from rust_bio_tpu_torch.alignment.pairwise.tb import (
    TB_DEL,
    TB_INS,
    TB_REREAD,
    TB_START,
    TB_SUBST,
    TB_XCLIP_PREFIX,
    TB_XCLIP_SUFFIX,
    TB_YCLIP_PREFIX,
    TB_YCLIP_SUFFIX,
)
from rust_bio_tpu_torch.ops._build import (
    INT,
    PTR,
    CudaKernel,
    check,
    check_lengths,
    same_device,
)

NEG = -(2**30)  # final-reduction sentinel (and K3's -inf)
_SENT = -(2**31) + 1  # the empty x-suffix accumulator of K7/K9
_SMEM_MAX = 232_448  # dynamic shared memory a block may opt into on Hopper

SCAN_GLOBAL = CudaKernel("sw_warp", "sw_scan_global", [PTR] * 4 + [INT] * 8 + [PTR] * 4)
# K3's two launches: K18's lanes (short x) and K13's blocks (long x)
SCORES_GLOBAL_WARP = CudaKernel("sw_warp", "sw_scores_global_warp", [PTR] * 4 + [INT] * 7 + [PTR] * 2)
SCORES_GLOBAL_ROWS = CudaKernel("sw_global_rows", "sw_scores_global_rows", [PTR] * 4 + [INT] * 7 + [PTR] * 2)
SCAN_SEMIGLOBAL = CudaKernel("sw_warp", "sw_scan_semiglobal", [PTR] * 4 + [INT] * 10 + [PTR] * 7)
SCAN_CUSTOM = CudaKernel("sw_warp", "sw_scan_custom", [PTR] * 4 + [INT] * 12 + [PTR] * 8)
SCAN_LOCAL = CudaKernel("sw_warp", "sw_scan_local", [PTR] * 4 + [INT] * 8 + [PTR] * 8)
# the LUT twins: the table's pointer in place of (match, mismatch)
SCAN_GLOBAL_LUT = CudaKernel("sw_warp", "sw_scan_global_lut", [PTR] * 4 + [INT] * 6 + [PTR] * 5)
SCORES_GLOBAL_LUT = CudaKernel("sw_warp", "sw_scores_global_lut", [PTR] * 4 + [INT] * 5 + [PTR] * 3)
SCAN_SEMIGLOBAL_LUT = CudaKernel("sw_warp", "sw_scan_semiglobal_lut", [PTR] * 4 + [INT] * 6 + [PTR, INT, INT] + [PTR] * 7)
SCAN_CUSTOM_LUT = CudaKernel("sw_warp", "sw_scan_custom_lut", [PTR] * 4 + [INT] * 6 + [PTR] + [INT] * 4 + [PTR] * 8)
SCAN_LOCAL_LUT = CudaKernel("sw_warp", "sw_scan_local_lut", [PTR] * 4 + [INT] * 6 + [PTR] * 9)
SCAN_GLOBAL_ROWS = CudaKernel("sw_global_rows", "sw_scan_global_rows", [PTR] * 4 + [INT] * 9 + [PTR] * 3)
SCAN_GLOBAL_ROWS_LUT = CudaKernel("sw_global_rows", "sw_scan_global_rows_lut", [PTR] * 4 + [INT] * 7 + [PTR] * 4)
SCAN_COLUMNS = CudaKernel("sw_columns", "sw_scan_columns", [PTR] * 4 + [INT] * 12 + [PTR] * 8)
SCAN_COLUMNS_LUT = CudaKernel("sw_columns", "sw_scan_columns_lut", [PTR] * 4 + [INT] * 6 + [PTR] + [INT] * 4 + [PTR] * 8)
SCAN_BANDED = CudaKernel("sw_banded", "sw_scan_banded", [PTR] * 6 + [INT] * 13 + [PTR] * 8)
# K16's per-pair column state: S and D in two parity buffers, I, Sn, Ly and
# the s-bits stamped with their column (csrc/sw_banded.cu head note); one
# warp a pair, at most 8 pairs a block; the state stays in the warp's slice
# of shared memory up to this M (8 * 7,264 * 4 = 232,448 bytes, one pair a
# block), else in a (B, 8, M + 1) device scratch
BANDED_LAYERS = 8
_BANDED_WARPS_MAX = 8
BANDED_SHARED_MAX_M = 7263
_BAND_SENT = -1_500_000_000  # K16's chain sentinel: below every reachable value, no int32 wrap
# K13's seam period rb: its tb marks the rows r * rb (r >= 1) where a
# block-row engine's blocks meet (csrc/sw_global_rows.cu head note); the
# default and the range 1..605 are those of the port's first K13, whose row
# blocks they were
ROWS_RB = 128
_ROWS_RB_MAX = 605
# K13's launch (csrc/sw_global_rows.cu): one block a pair, at most this many
# threads, each over a stripe of R rows, R a multiple of 8 (a thread stores
# 8 cells at once); four int32 carries a thread in two shared buffers; three
# int32 layers of row state a row
_ROWS_STRIPES = 256
_ROWS_GROUP = 8
_ROWS_CARRIES = 4
_ROWS_LAYERS = 3
# the largest M at which K13 keeps its row state in shared memory (beside
# the carries and x's bytes: 221,184 bytes at M = 16,383, R = 64, T = 256);
# above it the state goes to a (B, 3, R, T) device scratch
ROWS_SHARED_MAX_M = 16383
# K3's launch at long x (csrc/sw_global_rows.cu scores_global_rows_kernel):
# K13's stripes with three carries (S, P, S~) and two layers (S, D); in
# shared memory up to this M (227,328 bytes at M = 24,575, R = 96, T =
# 256), else a (B, 2, R, T) device scratch
_SCORES_ROWS_CARRIES = 3
_SCORES_ROWS_LAYERS = 2
SCORES_ROWS_SHARED_MAX_M = 24575
# K3's route (scores_route): the warp launch below M + 1 = SCORES_ROWS_MIN
# (K13's limit T_ROWS); from there on the block launch, unless the batch
# holds SCORES_WARP_PAIRS pairs or more (the warp launch then fills the
# card) and M + 1 <= SCORES_WARP_MAX_ROWS (two of its blocks still fit an
# SM). On an H100 (scripts/time_rows.py --routes, PERF.md) the block launch
# took 0.28-0.67x the warp launch's time at 128 pairs of 600 bp-5.6 kb and
# 0.82-0.95x at 512, 1.27-1.52x at 2048 and 8192 pairs of 300 bp-2 kb, and
# 0.77-0.81x at 3.5 and 5.6 kb
SCORES_ROWS_MIN = 606
SCORES_WARP_PAIRS = 1024
SCORES_WARP_MAX_ROWS = 3072
# K15's launch (csrc/sw_columns.cu): one block a pair, at most this many
# threads, each over a stripe of R rows, R a multiple of 8 (a thread stores
# 8 cells at once); six int32 carries a thread in two shared buffers; five
# int32 layers of row state a row
_COLUMNS_STRIPES = 1024
_COLUMNS_GROUP = 8
_COLUMNS_CARRIES = 6
_COLUMNS_LAYERS = 5
# the largest M at which K15 keeps its row state in shared memory (beside
# the carries and x's bytes: 221,184 bytes at M = 9,215, R = 16, T = 576);
# above it the state goes to a (B, 5, R, T) device scratch
COLUMNS_SHARED_MAX_M = 9215
# K1's, K11's, K18's, K3's (short x), K5's, K12's, K7's, K7-LUT's, K9's and K9-LUT's launch
# (csrc/sw_warp.cu): one warp a pair, 4 pairs a block; lane t over a stripe of
# R rows, R a multiple of 8 (a lane stores 8 cells at once) with 32 * R >= M +
# 1; the x bytes of a warp's stripes in its slice of shared memory, beside its
# row state (three int32 layers a row for K1 and K11, two for K18 and K3, five for
# K5, K12, K7, K7-LUT, K9 and K9-LUT) while
# that slice stays within WARP_SHARED_MAX bytes (two blocks an SM at least),
# else the state in a (B, layers, R, 32) device scratch
_WARP_LANES = 32
_WARP_PAIRS = 4
_WARP_GROUP = 8
GLOBAL_WARP_LAYERS = 3
SCORE_WARP_LAYERS = 2
LOCAL_WARP_LAYERS = 5
WARP_SHARED_MAX = 28_672
# K18 has no tb to store and keeps its slice in shared memory up to a
# quarter of a block's (one block of four warps an SM): at the long
# proteins' M = 4,978 that is 46,080 bytes a warp, 28.9 ms against 45.8 in
# the scratch (scripts/placement_trial.py, H100)
SCORE_WARP_SHARED_MAX = _SMEM_MAX // _WARP_PAIRS


def _check_shapes(xb, yb, mlens, nlens) -> Tuple[int, int, int, torch.device]:
    """(B, M, N, device) of a batch; raises on a wrong dtype, shape or
    device (reads nothing back from the card)."""
    dev = same_device(xb, yb, mlens, nlens)
    B, M = xb.shape
    N = yb.shape[1] if yb.dim() == 2 else -1
    check(xb, "xb", torch.uint8, (B, M))
    check(yb, "yb", torch.uint8, (B, N))
    check(mlens, "mlens", torch.int32, (B,))
    check(nlens, "nlens", torch.int32, (B,))
    return B, M, N, dev


def _check_pairs(xb, yb, mlens, nlens) -> Tuple[int, int, int, torch.device]:
    """``_check_shapes``, then lengths outside [0, M] / [0, N] raise."""
    B, M, N, dev = _check_shapes(xb, yb, mlens, nlens)
    check_lengths(mlens, "mlens", M)
    check_lengths(nlens, "nlens", N)
    return B, M, N, dev


def _subst(subst, dev) -> tuple:
    """The C arguments of a substitution source: ``(match, mismatch)`` as
    two ints, or a (256, 256) int32 LUT on ``dev`` as its pointer."""
    if isinstance(subst, torch.Tensor):
        if subst.device != dev:
            raise ValueError(f"lut on {subst.device}, the pairs on {dev}")
        check(subst, "lut", torch.int32, (256, 256))
        return (subst.data_ptr(),)
    return tuple(int(v) for v in subst)


def _plain_feed(xb, yb, subst):
    """The wrappers' column feeder of a substitution source on the CPU: from
    the bytes for ``(match, mismatch)``; for a LUT one int32 gather per
    column, as the kernels read it (the values of ``subs2_stream_plain``
    without its (N, M, B) tensor or its ``* 2`` packing)."""
    if not isinstance(subst, torch.Tensor):
        return _mp_feed(xb, yb, *(int(v) for v in subst))
    xt = xb.t().to(torch.int64)  # (M, B)
    flat = subst.reshape(-1)

    def feed(j):
        yj = yb[:, j - 1].to(torch.int64)[None, :]
        return flat[(xt << 8) | yj], (xt == yj).to(torch.int32)

    return feed


def columns_geometry(M: int) -> Tuple[int, int, str, int]:
    """K15's launch at x length ``M``, as csrc/sw_columns.cu computes it:
    (T threads a block, R rows a thread, where the row state lives:
    ``"shared"`` or ``"scratch"``, dynamic shared bytes). Thread t owns rows
    [t * R, t * R + R); T is a multiple of 32, R of 8."""
    rows = M + 1
    R = -(-rows // (_COLUMNS_GROUP * _COLUMNS_STRIPES)) * _COLUMNS_GROUP
    stripes = -(-rows // R)
    T = -(-stripes // 32) * 32
    placement = "shared" if M <= COLUMNS_SHARED_MAX_M else "scratch"
    smem = 2 * _COLUMNS_CARRIES * T * 4 + R * T
    if placement == "shared":
        smem += _COLUMNS_LAYERS * R * T * 4
    return T, R, placement, smem


def rows_geometry(M: int, score_only: bool = False) -> Tuple[int, int, str, int]:
    """K13's launch at x length ``M`` (``score_only``: K3's at long x), as
    csrc/sw_global_rows.cu computes it: (T threads a block, R rows a
    thread, where the row state lives: ``"shared"`` or ``"scratch"``,
    dynamic shared bytes). Thread t owns rows [t * R, t * R + R); T is a
    multiple of 32, R of 8."""
    rows = M + 1
    R = -(-rows // (_ROWS_GROUP * _ROWS_STRIPES)) * _ROWS_GROUP
    stripes = -(-rows // R)
    T = -(-stripes // 32) * 32
    carries, layers, shared_max = (
        (_SCORES_ROWS_CARRIES, _SCORES_ROWS_LAYERS, SCORES_ROWS_SHARED_MAX_M) if score_only
        else (_ROWS_CARRIES, _ROWS_LAYERS, ROWS_SHARED_MAX_M)
    )
    placement = "shared" if M <= shared_max else "scratch"
    smem = 2 * carries * T * 4 + R * T
    if placement == "shared":
        smem += layers * R * T * 4
    return T, R, placement, smem


def scores_route(M: int, B: int) -> str:
    """K3's launch for ``B`` pairs at x length ``M``: ``"warp"`` (K18's
    lanes, ``warp_geometry(M, SCORE_WARP_LAYERS, SCORE_WARP_SHARED_MAX)``)
    or ``"rows"`` (one block a pair, ``rows_geometry(M, True)``), by the
    limits above."""
    if M + 1 < SCORES_ROWS_MIN:
        return "warp"
    return "warp" if B >= SCORES_WARP_PAIRS and M + 1 <= SCORES_WARP_MAX_ROWS else "rows"


def warp_geometry(M: int, layers: int, budget: int | None = None) -> Tuple[int, str, int]:
    """K1's and K11's (``layers`` 3), K18's and K3's (2) or K5's, K12's, K7's, K7-LUT's, K9's and K9-LUT's (5) launch at x
    length ``M``, as csrc/sw_warp.cu computes it: (R rows a lane, where the
    row state lives: ``"shared"`` or ``"scratch"``, dynamic shared bytes a
    warp). Lane t owns rows [t * R, t * R + R); R is a multiple of 8. The
    state stays in shared memory while a warp's slice fits ``budget``
    bytes (``WARP_SHARED_MAX`` when None; K18 passes
    ``SCORE_WARP_SHARED_MAX``)."""
    budget = WARP_SHARED_MAX if budget is None else budget
    R = -(-(M + 1) // (_WARP_GROUP * _WARP_LANES)) * _WARP_GROUP
    x_bytes = R * _WARP_LANES
    state = layers * R * _WARP_LANES * 4
    if x_bytes + state <= budget:
        return R, "shared", x_bytes + state
    if _WARP_PAIRS * x_bytes > _SMEM_MAX:
        raise ValueError(f"M = {M}: a block's x bytes exceed its shared memory")
    return R, "scratch", x_bytes


def banded_geometry(M: int, B: int, sms: int = 132) -> Tuple[int, str, int]:
    """K16's launch at x length ``M`` and ``B`` pairs on a card of ``sms``
    SMs, as ops/csrc/sw_banded.cu takes it: (warps, that is pairs, a block,
    where the state lives: ``"shared"`` or ``"scratch"``, dynamic shared
    bytes a block). One warp a block while a card holds every pair at 32
    blocks an SM (the blocks spread evenly over the SMs), more up to what
    the shared memory and 8 warps allow beyond that."""
    per_pair = BANDED_LAYERS * (M + 1) * 4
    shared = M <= BANDED_SHARED_MAX_M
    fit = _SMEM_MAX // per_pair if shared else _BANDED_WARPS_MAX
    warps = max(1, min(fit, _BANDED_WARPS_MAX, -(-B // (32 * sms))))
    return warps, "shared" if shared else "scratch", warps * per_pair if shared else 0


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def pair_major_pitch(M: int) -> int:
    """Xp: M + 1 rounded up to a multiple of 8, the row pitch of a
    pair-major tb."""
    return -(-(M + 1) // _WARP_GROUP) * _WARP_GROUP


def _warp_scratch(layers: int, B: int, M: int, dev, budget: int | None = None) -> torch.Tensor | None:
    """None when a warp's row state fits its share of shared memory, else
    the (B, layers, R, 32) device scratch of csrc/sw_warp.cu."""
    R, placement, _ = warp_geometry(M, layers, budget)
    if placement == "shared":
        return None
    return torch.empty((B, layers, R, _WARP_LANES), dtype=torch.int32, device=dev)


def _pair_major(B: int, cols: int, M: int, dev) -> torch.Tensor:
    """The pair-major (B, cols, Xp) uint16 tb of K1 / K11 / K5 / K12 / K7 / K7-LUT / K9 / K9-LUT /
    K15 / K15-LUT, Xp = M + 1 rounded up to a multiple of 8."""
    return torch.empty((B, cols, pair_major_pitch(M)), dtype=torch.uint16, device=dev)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def scan_global(xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score):
    """K1. Returns (score (B,) int32, tb (N, M+1, B) uint16, tbk (B, M+1)
    int32).

    ``tb[j-1, i, b]`` is the traceback cell of DP cell (i, j):
    ``i_bits | d_bits << 4 | s_bits << 8 | min(ins_run, 15) << 12``; only
    ``1 <= j <= nlens[b]``, ``0 <= i <= mlens[b]`` is defined. ``tbk[b]``
    holds the cells of column ``nlens[b]`` (rows ``<= mlens[b]``). On the
    card one warp a pair computes it over row stripes
    (``warp_geometry(M, GLOBAL_WARP_LAYERS)``), and ``tb`` is the (N, M+1,
    B) view of a pair-major (B, N, Xp) tensor, Xp = M + 1 rounded up to a
    multiple of 8, which ``ops.walk.sweep_walk_global`` reads in place."""
    return _scan_global(SCAN_GLOBAL, xb, yb, mlens, nlens, gap_open, gap_extend, (match_score, mismatch_score))


def scan_global_lut(xb, yb, mlens, nlens, gap_open, gap_extend, lut, traceback=True):
    """K11: K1 with the substitution score ``lut[x, y]``; same outputs, tb
    None with ``traceback=False`` (score only)."""
    return _scan_global(SCAN_GLOBAL_LUT, xb, yb, mlens, nlens, gap_open, gap_extend, lut, traceback)


def _scan_global(kernel, xb, yb, mlens, nlens, go, ge, subst, traceback=True):
    """K1's or K11's wrapper: ``subst`` is (match, mismatch) or the LUT."""
    B, M, N, dev = _check_pairs(xb, yb, mlens, nlens)
    go, ge = int(go), int(ge)
    sub = _subst(subst, dev)
    if dev.type == "cpu":
        score, tb, tbk = _scan_global_core(_plain_feed(xb, yb, subst), M, N, mlens, nlens, go, ge)
        return score, tb if traceback else None, tbk
    score = torch.empty(B, dtype=torch.int32, device=dev)
    tb = _pair_major(B, N, M, dev) if traceback else None
    tbk = torch.empty((B, M + 1), dtype=torch.int32, device=dev)
    if B:
        scratch = _warp_scratch(GLOBAL_WARP_LAYERS, B, M, dev)
        kernel.launch(
            dev, xb.data_ptr(), yb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, M, N,
            0 if tb is None else tb.shape[2], go, ge, *sub, score.data_ptr(), _ptr(tb), tbk.data_ptr(),
            _ptr(scratch),
        )
    return score, tb[:, :, : M + 1].permute(1, 2, 0) if traceback else None, tbk


def scan_global_rows(xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score, rb=ROWS_RB,
                     traceback=True):
    """K13: K1's DP for long x. Returns (score (B,) int32, tb (N, M+1, B)
    uint16), tb None with ``traceback=False`` (score only).

    ``tb[j-1, i, b]`` is defined where K1's is and equals K1's there, but
    for two things: no run nibble (bits 12-15 are 0), and at each row
    ``r * rb`` (r >= 1) the i-bits are ``TB_INS`` where the extend candidate
    won, else ``TB_REREAD`` (the s-bits of the cell above). On the card it
    is a view of a pair-major (B, N, Xp) tensor, Xp = M + 1 rounded up to a
    multiple of 8. Walk it with ``ops.walk.sweep_walk_global_seg``."""
    return _scan_global_rows(
        SCAN_GLOBAL_ROWS, xb, yb, mlens, nlens, gap_open, gap_extend, (match_score, mismatch_score), rb,
        traceback,
    )


def scan_global_rows_lut(xb, yb, mlens, nlens, gap_open, gap_extend, lut, rb=ROWS_RB, traceback=True):
    """K13 with the substitution score ``lut[x, y]``; same outputs."""
    return _scan_global_rows(SCAN_GLOBAL_ROWS_LUT, xb, yb, mlens, nlens, gap_open, gap_extend, lut, rb, traceback)


def _scan_global_rows(kernel, xb, yb, mlens, nlens, go, ge, subst, rb, traceback):
    B, M, N, dev = _check_pairs(xb, yb, mlens, nlens)
    go, ge, rb = int(go), int(ge), int(rb)
    if not 1 <= rb <= _ROWS_RB_MAX:
        raise ValueError(f"rb = {rb}: the seam period lies in 1..{_ROWS_RB_MAX}")
    sub = _subst(subst, dev)
    if dev.type == "cpu":
        score, tb, _ = _scan_global_core(_plain_feed(xb, yb, subst), M, N, mlens, nlens, go, ge, rb=rb)
        return score, tb if traceback else None
    score = torch.empty(B, dtype=torch.int32, device=dev)
    Xp = -(-(M + 1) // _ROWS_GROUP) * _ROWS_GROUP
    tb = torch.empty((B, N, Xp), dtype=torch.uint16, device=dev) if traceback else None
    if B:
        T, R, placement, _ = rows_geometry(M)
        scratch = None if placement == "shared" else torch.empty(
            (B, _ROWS_LAYERS, R, T), dtype=torch.int32, device=dev
        )
        kernel.launch(
            dev, xb.data_ptr(), yb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(),
            B, M, N, Xp, rb, go, ge, *sub, score.data_ptr(), _ptr(tb), _ptr(scratch),
        )
    return score, tb[:, :, : M + 1].permute(1, 2, 0) if traceback else None


def scores_global(xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score):
    """K3. Global alignment scores (B,) int32: on the card the launch
    ``scores_route(M, B)`` names (``scores_global_warp`` or
    ``scores_global_rows``)."""
    return _scores_global(None, xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score)


def scores_global_warp(xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score):
    """K3's launch at short x: K18's kernel, one warp a pair over row
    stripes, under match / mismatch scores."""
    return _scores_global("warp", xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score)


def scores_global_rows(xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score):
    """K3's launch at long x: one block a pair, a wavefront over row
    stripes (``rows_geometry(M, True)``), K3's insertion chain."""
    return _scores_global("rows", xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score)


def _scores_global(route, xb, yb, mlens, nlens, go, ge, ma, mi):
    """K3 on the launch ``route`` names, ``scores_route``'s where None."""
    B, M, N, dev = _check_pairs(xb, yb, mlens, nlens)
    go, ge, ma, mi = (int(v) for v in (go, ge, ma, mi))
    if dev.type == "cpu":
        return scores_global_plain(xb, yb, mlens, nlens, go, ge, ma, mi)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        if (route or scores_route(M, B)) == "warp":
            kernel, scratch = SCORES_GLOBAL_WARP, _warp_scratch(SCORE_WARP_LAYERS, B, M, dev, SCORE_WARP_SHARED_MAX)
        else:
            T, R, placement, _ = rows_geometry(M, score_only=True)
            kernel, scratch = SCORES_GLOBAL_ROWS, None if placement == "shared" else torch.empty(
                (B, _SCORES_ROWS_LAYERS, R, T), dtype=torch.int32, device=dev
            )
        kernel.launch(
            dev, xb.data_ptr(), yb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, M, N, go, ge, ma, mi,
            score.data_ptr(), _ptr(scratch),
        )
    return score


def scores_global_lut(xb, yb, mlens, nlens, gap_open, gap_extend, lut):
    """K18: K3 with the substitution score ``lut[x, y]``, one warp a pair
    over row stripes (``warp_geometry(M, 2, SCORE_WARP_SHARED_MAX)``)."""
    B, M, N, dev = _check_pairs(xb, yb, mlens, nlens)
    go, ge = int(gap_open), int(gap_extend)
    sub = _subst(lut, dev)
    if dev.type == "cpu":
        return scores_global_lut_plain(subs_tensor_plain(xb, yb, lut), mlens, nlens, go, ge)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        scratch = _warp_scratch(SCORE_WARP_LAYERS, B, M, dev, SCORE_WARP_SHARED_MAX)
        SCORES_GLOBAL_LUT.launch(
            dev, xb.data_ptr(), yb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, M, N, go, ge, *sub,
            score.data_ptr(), _ptr(scratch),
        )
    return score


def scan_semiglobal(xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score,
                    yclip_prefix, yclip_suffix, traceback=True):
    """K5: the DP of the semiglobal family (x-clips disabled, y-clip
    penalties ``yclip_prefix``/``yclip_suffix`` live). Returns (tb (N, M+1,
    B) uint16, S_f, I_f, Sn_f, Ly_f, tbk), the finals (B, M+1) int32; tb
    None with ``traceback=False`` (the finals are the full call's).

    ``tb`` is laid out and packed as K1's, with y-clip codes in the s- and
    d-bits. The finals are the column-``nlens[b]`` state that
    ``_suffix_fixups`` reads: S, I (the insertion score of that column),
    Sn/Ly (best y-suffix-clip score per row and its clip length) and the
    cells ``tbk``. Defined for rows ``<= mlens[b]`` and, in ``tb``, columns
    ``1 <= j <= nlens[b]``. On the card one warp a pair computes it over
    row stripes (``warp_geometry(M, LOCAL_WARP_LAYERS)``, K12's kernel
    under match / mismatch scores), and ``tb`` is the (N, M+1, B) view of a
    pair-major (B, N, Xp) tensor, Xp = M + 1 rounded up to a multiple of 8,
    which ``ops.walk.sweep_walk_semiglobal`` reads in place."""
    return _scan_semiglobal(
        SCAN_SEMIGLOBAL, xb, yb, mlens, nlens, gap_open, gap_extend, (match_score, mismatch_score),
        yclip_prefix, yclip_suffix, traceback,
    )


def scan_semiglobal_lut(xb, yb, mlens, nlens, gap_open, gap_extend, lut, yclip_prefix, yclip_suffix,
                        traceback=True):
    """K12: K5 with the substitution score ``lut[x, y]``; same outputs, the
    same pair-major view on the card."""
    return _scan_semiglobal(
        SCAN_SEMIGLOBAL_LUT, xb, yb, mlens, nlens, gap_open, gap_extend, lut, yclip_prefix, yclip_suffix, traceback
    )


def _scan_semiglobal(kernel, xb, yb, mlens, nlens, go, ge, subst, ycp, ycs, traceback):
    """K5's or K12's wrapper: ``subst`` is (match, mismatch) or the LUT."""
    B, M, N, dev = _check_pairs(xb, yb, mlens, nlens)
    go, ge, ycp, ycs = (int(v) for v in (go, ge, ycp, ycs))
    sub = _subst(subst, dev)
    if dev.type == "cpu":
        tb, *finals = _scan_semiglobal_core(_plain_feed(xb, yb, subst), M, N, mlens, nlens, go, ge, ycp, ycs)
        return (tb if traceback else None, *finals)
    tb = _pair_major(B, N, M, dev) if traceback else None
    finals = [torch.empty((B, M + 1), dtype=torch.int32, device=dev) for _ in range(5)]
    if B:
        scratch = _warp_scratch(LOCAL_WARP_LAYERS, B, M, dev)
        kernel.launch(
            dev, xb.data_ptr(), yb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, M, N,
            0 if tb is None else tb.shape[2], go, ge, *sub, ycp, ycs, _ptr(tb), *(f.data_ptr() for f in finals),
            _ptr(scratch),
        )
    return (tb[:, :, : M + 1].permute(1, 2, 0) if traceback else None, *finals)


def scan_custom(xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score,
                xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix, traceback=True):
    """K9: the DP with all four clip penalties live. Returns (tb (N+1, M+1,
    B) uint16, lx (N+1, B) int32, S_f, I_f, Sn_f, Ly_f, tbk), the finals
    (B, M+1) int32 as K5's; ``tb`` and ``lx`` are None when ``traceback`` is
    False (the score-only call).

    ``tb[j, i, b]`` is the cell of DP cell (i, j), packed as K1's, for
    ``0 <= j <= nlens[b]`` (column 0, the init column, at index 0) and
    ``0 <= i <= mlens[b]``; ``lx[j, b]`` is the x-suffix clip length of
    column j's row ``mlens[b]`` (0 when it has none). Clip codes sit in the
    s-bits (and the x-prefix clip in column 0's i-bits).

    On the card one warp computes a pair (csrc/sw_warp.cu, K9-LUT's kernel
    under match / mismatch scores) and ``tb`` is the (N+1, M+1, B) view of a
    pair-major (B, N+1, Xp) tensor, Xp = M + 1 rounded up to a multiple of
    8, which ``ops.walk.sweep_walk_custom`` reads in place."""
    clips = (xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix)
    return _scan_clip(
        SCAN_CUSTOM, xb, yb, mlens, nlens, gap_open, gap_extend, (match_score, mismatch_score), clips, traceback
    )


def scan_custom_lut(xb, yb, mlens, nlens, gap_open, gap_extend, lut,
                    xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix, traceback=True):
    """K9-LUT: K9 with the substitution score ``lut[x, y]``; same outputs.
    On the card ``tb`` is the (N+1, M+1, B) view of a pair-major (B, N+1,
    Xp) tensor, as K7-LUT's, which ``ops.walk.sweep_walk_custom`` reads in
    place."""
    clips = (xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix)
    return _scan_clip(SCAN_CUSTOM_LUT, xb, yb, mlens, nlens, gap_open, gap_extend, lut, clips, traceback)


def scan_local(xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score, traceback=True):
    """K7: ``scan_custom`` at clips (0, 0, 0, 0), the local preset; same
    outputs, byte for byte. On the card ``tb`` is the (N+1, M+1, B) view of
    a pair-major (B, N+1, Xp) tensor, as K7-LUT's, which
    ``ops.walk.sweep_walk_local`` and ``sweep_walk_custom`` read in place."""
    return _scan_clip(
        SCAN_LOCAL, xb, yb, mlens, nlens, gap_open, gap_extend, (match_score, mismatch_score), (0, 0, 0, 0),
        traceback,
    )


def scan_local_lut(xb, yb, mlens, nlens, gap_open, gap_extend, lut, traceback=True):
    """K7-LUT: K7 with the substitution score ``lut[x, y]``; same outputs.
    On the card ``tb`` is the (N+1, M+1, B) view of a pair-major (B, N+1,
    Xp) tensor, Xp = M + 1 rounded up to a multiple of 8, which
    ``ops.walk.sweep_walk_local`` and ``sweep_walk_custom`` read in place."""
    return _scan_clip(SCAN_LOCAL_LUT, xb, yb, mlens, nlens, gap_open, gap_extend, lut, (0, 0, 0, 0), traceback)


def scan_columns(xb, yb, mlens, nlens, gap_open, gap_extend, match_score, mismatch_score,
                 xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix, traceback=True):
    """K15: the clip-mode column scan (sw_pallas.py ``scan_columns_pallas_mp``,
    batched.py ``_column_body``) for any clips: semiglobal is clips (MIN,
    MIN, 0, 0), local (0, 0, 0, 0), custom the scoring's. Outputs as
    ``scan_custom``'s, with 12-bit cells: ``tb`` (N+1, M+1, B) uint16 holds
    ``i | d << 4 | s << 8`` and no run nibble, ``tbk`` likewise; ``lx``
    (N+1, B) int32 is each column's x-suffix clip length in full (the
    Pallas kernel packs it in tb nibbles, which caps M below 4096).

    On the card one block computes a pair (``columns_geometry``) and
    ``tb`` is the (N+1, M+1, B) view of a pair-major (B, N+1, Xp) tensor,
    Xp = M + 1 rounded up to a multiple of 8, which ``ops.walk.walk_steps``
    reads in place and ``batched._columns_fixups`` writes the fixed column
    into through the view; never copy it (9 GB at phase 3e's 128 STR
    pairs)."""
    clips = (xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix)
    return _scan_clip(
        SCAN_COLUMNS, xb, yb, mlens, nlens, gap_open, gap_extend, (match_score, mismatch_score), clips, traceback
    )


def scan_columns_lut(xb, yb, mlens, nlens, gap_open, gap_extend, lut,
                     xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix, traceback=True):
    """K15-LUT: K15 with the substitution score ``lut[x, y]`` (in place of
    the XLA engine batched.py ``_align_batch_device``); same outputs, the
    same pair-major view on the card."""
    clips = (xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix)
    return _scan_clip(SCAN_COLUMNS_LUT, xb, yb, mlens, nlens, gap_open, gap_extend, lut, clips, traceback)


def scan_banded(xb, yb, mlens, nlens, pens8, starts, ends):
    """K16: the banded clip-mode DP (sw_pallas.py ``scan_banded_pallas_mp``,
    the host oracle banded.py ``compute_alignment``) over per-column row
    bands. ``pens8`` is (gap_open, gap_extend, xclip_prefix, xclip_suffix,
    yclip_prefix, yclip_suffix, match, mismatch) as ints; ``starts`` /
    ``ends`` (B, N+1) int32 the band rows [start, end) of columns 0..N, with
    ``starts <= mlens + 1`` and ``ends <= mlens + 1`` (``banded.Band``'s
    rows); ``1 <= mlens``.

    Returns (tb (N, M+1, B) uint16, lx (N, B) int32, S_f, I_f, Sn_f, Ly_f,
    tbk (B, M+1) int32). ``tb[j-1]`` holds column j's 12-bit cells ``i | d
    << 4 | s << 8``, 0 outside the cells the host writes (on the card the
    (N, M+1, B) view of a zero-filled pair-major (B, N, Xp) tensor, Xp = M
    + 1 rounded up to a multiple of 8, which ``ops.walk.walk_banded`` reads
    in place); defined for
    ``1 <= j <= nlens[b]`` (the plain version also fills later columns from
    the frozen state, the kernel leaves them 0). ``lx[j-1]`` is column j's
    x-suffix clip length (0 where none, and past nlens). The finals are the
    state after column nlens[b]: S, I (one buffer, as in the Pallas
    kernel), Sn, Ly and the cells ``tbk`` (column 0's own cells when nlens
    is 0). The caller checks the lengths and the bands on the host: the
    wrapper reads nothing back (no synchronizing call), and the kernel clamps
    them into the tensors."""
    B, M, N, dev = _check_shapes(xb, yb, mlens, nlens)
    check(starts, "starts", torch.int32, (B, N + 1))
    check(ends, "ends", torch.int32, (B, N + 1))
    if starts.device != dev or ends.device != dev:
        raise ValueError(f"starts/ends must lie on {dev}")
    pens8 = tuple(int(v) for v in pens8)
    if len(pens8) != 8 or pens8[0] > 0 or pens8[1] > 0:
        raise ValueError("pens8: 8 ints, gap_open and gap_extend <= 0")
    if dev.type == "cpu":
        return scan_banded_plain(xb, yb, mlens, nlens, pens8, starts, ends)
    tb = torch.zeros((B, N, pair_major_pitch(M)), dtype=torch.uint16, device=dev)
    lx = torch.zeros((N, B), dtype=torch.int32, device=dev)
    finals = [torch.empty((B, M + 1), dtype=torch.int32, device=dev) for _ in range(5)]
    if B:
        scan_banded_launch((tb, lx, *finals), xb, yb, mlens, nlens, pens8, starts, ends)
    return (tb[:, :, : M + 1].permute(1, 2, 0), lx, *finals)


def scan_banded_launch(outs, xb, yb, mlens, nlens, pens8, starts, ends):
    """The launch of K16 alone, on CUDA tensors ``scan_banded`` has checked,
    into ``outs``: the pair-major (B, N, Xp) tb and lx, zeroed (or as an
    earlier launch on the same inputs left them: it writes the same cells),
    and the five finals."""
    tb, lx, *finals = outs
    B, M = xb.shape
    N = yb.shape[1]
    dev = xb.device
    warps, placement, _ = banded_geometry(M, B, _sm_count(dev))
    scratch = None if placement == "shared" else torch.empty((B, BANDED_LAYERS, M + 1), dtype=torch.int32, device=dev)
    SCAN_BANDED.launch(
        dev, xb.data_ptr(), yb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), starts.data_ptr(),
        ends.data_ptr(), B, M, N, tb.shape[2], warps, *(int(v) for v in pens8), tb.data_ptr(), lx.data_ptr(),
        *(f.data_ptr() for f in finals), _ptr(scratch),
    )


def scan_banded_plain(xb, yb, mlens, nlens, pens8, starts, ends):
    """Plain version of K16: the Pallas kernel's column recurrence
    (sw_pallas.py ``_kernel_scan_banded_mp``), rows vectorized over (M+1,
    B), the insertion chain a cummax, the host's two S and D parity
    buffers carried as (current, stale) pairs. Same outputs as
    ``scan_banded``."""
    B, M = xb.shape
    N = yb.shape[1]
    dev = xb.device
    i32 = torch.int32
    go, ge, xcp, xcs, ycp, ycs, ma, mi = (torch.tensor(int(v), dtype=i32, device=dev) for v in pens8)
    MIN = torch.tensor(MIN_SCORE, dtype=i32, device=dev)
    SENT = torch.tensor(_SENT, dtype=i32, device=dev)
    SENT2 = torch.tensor(_BAND_SENT, dtype=i32, device=dev)
    rows = torch.arange(M + 1, dtype=i32, device=dev)[:, None]  # (M+1, 1)
    row0 = rows == 0
    row_ge1 = rows >= 1
    ml = mlens[None, :]
    nl = nlens[None, :]
    is_row_m = (rows == ml) & (ml >= 1)
    xt = xb.t().to(i32)
    rge = rows * ge
    yclip_row = ycp + go + ge * (rows - 1)
    neg_row = torch.full((1, B), MIN_SCORE, dtype=i32, device=dev)
    start_row = torch.full((1, B), TB_START, dtype=i32, device=dev)

    def take_m(a):
        return torch.where(is_row_m, a, SENT).amax(dim=0, keepdim=True)

    def take(s, bits, cand, cbits):
        tk = cand > s
        return torch.where(tk, cand, s), torch.where(tk, cbits, bits)

    # column 0 (sw_pallas.py:2567-2638)
    st0 = starts[:, 0][None, :]
    en0 = ends[:, 0][None, :]
    in_b0 = row_ge1 & (rows >= st0) & (rows < en0)
    gap_i = go + ge * (rows - 1)
    clip_i = xcp + go
    ins_wins = gap_i > clip_i
    I0v = torch.where(rows == 1, go, torch.where(ins_wins, gap_i, clip_i)).expand(M + 1, B)
    ib0 = torch.where(rows == 1, TB_START, torch.where(ins_wins, TB_INS, TB_XCLIP_PREFIX)).to(i32).expand(M + 1, B)
    S0 = torch.full((M + 1, B), MIN_SCORE, dtype=i32, device=dev)
    sb0 = torch.full((M + 1, B), TB_START, dtype=i32, device=dev)
    S0, sb0 = take(S0, sb0, I0v, TB_INS)
    S0, sb0 = take(S0, sb0, xcp, TB_XCLIP_PREFIX)
    vals = torch.where(in_b0 & (rows <= ml - 1), S0 + xcs, SENT)
    A = vals.amax(dim=0, keepdim=True)
    updA = A > MIN
    m_in_b0 = (ml >= st0) & (ml < en0) & (ml >= 1)
    S_m = torch.where(updA, A, MIN)
    sb_m = torch.full((1, B), TB_XCLIP_SUFFIX, dtype=i32, device=dev)
    S_m, sb_m = take(S_m, sb_m, take_m(torch.where(in_b0, I0v, MIN)), TB_INS)
    S_m, sb_m = take(S_m, sb_m, xcp, TB_XCLIP_PREFIX)
    S_m = torch.where(m_in_b0, S_m, MIN)
    sb_m = torch.where(m_in_b0, sb_m, torch.where(updA, TB_XCLIP_SUFFIX, TB_START))
    S0 = torch.where(in_b0, S0, MIN)
    sb0 = torch.where(in_b0, sb0, TB_START)
    S0 = torch.where(is_row_m, S_m, S0)
    sb0 = torch.where(is_row_m, sb_m, sb0)
    S0 = torch.where(row0, torch.where(st0 == 0, 0, MIN), S0)
    sb0 = torch.where(row0, TB_START, sb0)
    S, Ss = S0, torch.full_like(S0, MIN_SCORE)
    D, Ds = torch.full_like(S0, MIN_SCORE), torch.full_like(S0, MIN_SCORE)
    SB = sb0
    I = torch.where(in_b0, I0v, MIN)
    TBK = torch.where(in_b0, ib0, TB_START) | (TB_START << 4) | (sb0 << 8)
    SN = torch.where(row0, torch.where(ycp > ycs, ycp, ycs), MIN).expand(M + 1, B)
    LY = torch.where(row0 & ~(ycp > ycs), nl, 0).to(i32)

    tb = torch.empty((N, M + 1, B), dtype=torch.uint16, device=dev)
    lx = torch.empty((N, B), dtype=i32, device=dev)
    ends_t = ends.t()  # (N+1, B)
    bidx = torch.arange(B, device=dev)
    for j in range(1, N + 1):
        active = j <= nl
        is_last = j == nl
        stj = starts[:, j][None, :]
        enj = ends[:, j][None, :]
        enx = ends_t[torch.minimum(torch.full_like(nlens, j + 1), nlens).long(), bidx][None, :]
        in_band = row_ge1 & (rows >= stj) & (rows < enj)
        m_in_band = (ml >= stj) & (ml < enj) & (ml >= 1)
        r0_comp = stj == 0

        eq = (xt == yb[:, j - 1].to(i32)[None, :]).to(i32)
        subs = mi + (ma - mi) * eq
        m_val = torch.cat([neg_row, S[:-1] + subs])
        m_bits = torch.cat([start_row, TB_SUBST + eq])
        d_ext = D + ge
        d_open = S + go
        d_wins = d_ext > d_open
        bestD = torch.where(d_wins, d_ext, d_open)
        d_bits = torch.where(d_wins, TB_DEL, SB)

        # row 0: computed iff the band starts at 0; no Sn merge into S
        d_gap = go + ge * (j - 1)
        d_clip = ycp + go
        del_wins0 = d_gap > d_clip
        Dj0 = go if j == 1 else torch.where(del_wins0, d_gap, d_clip)
        db0 = torch.tensor(TB_START, dtype=i32, device=dev) if j == 1 else torch.where(del_wins0, TB_DEL, TB_YCLIP_PREFIX).to(i32)
        d_gt = Dj0 > ycp
        S0j = torch.where(d_gt, Dj0, ycp)
        sb0j = torch.where(d_gt, TB_DEL, TB_YCLIP_PREFIX).to(i32)
        sn0_old = SN[0:1]
        upd_sn0 = (S0j + ycs > sn0_old) & active & r0_comp
        sn0_new = torch.where(upd_sn0, S0j + ycs, sn0_old)
        ly0_new = torch.where(upd_sn0, nl - j, LY[0:1])
        bestD = torch.where(row0, torch.where(r0_comp, Dj0, MIN), bestD)
        d_bits = torch.where(row0, torch.where(r0_comp, db0, TB_START), d_bits)

        # xclip_score: at j == n the ycp term is max(ycp, Sn[0] after row 0)
        yterm = torch.where(is_last, torch.maximum(ycp, sn0_new), ycp)
        xclip_vec = xcp + torch.maximum(yterm, d_gap)  # (1, B)
        s_tilde = torch.maximum(torch.maximum(m_val, bestD), yclip_row)
        s_tilde = torch.maximum(s_tilde, xclip_vec)
        s_tilde = torch.where(row0, torch.where(r0_comp, S0j, MIN), s_tilde)

        # insertion chain: opens from S~(i-1) + go, at j == n also from
        # Sn(i-1) + go; row st-1 is reset, rows above it feed nothing
        sn_for_i = torch.cat([sn0_new, SN[1:]])
        s_tilde_eff = torch.where(rows >= stj, s_tilde, torch.where(rows == stj - 1, MIN, SENT2))
        T_s = torch.cat([neg_row, s_tilde_eff[:-1] + go])
        T_sn = torch.cat([neg_row, sn_for_i[:-1] + go])
        T_sn = torch.where(is_last, T_sn, SENT2)
        T_seed = torch.where(rows == torch.clamp(stj, min=1), MIN + ge, SENT2)
        T = torch.maximum(torch.maximum(T_s, T_sn), T_seed)
        bestI = torch.cummax(T - rge, dim=0).values + rge
        i_ext = torch.cat([neg_row, bestI[:-1] + ge])

        # priority: M/S > I > D > XCLIP_PREFIX > YCLIP_PREFIX
        cands = ((bestI, TB_INS), (bestD, TB_DEL), (xclip_vec, TB_XCLIP_PREFIX), (yclip_row, TB_YCLIP_PREFIX))
        S_col, s_bits = m_val, m_bits
        for cand, cbits in cands:
            S_col, s_bits = take(S_col, s_bits, cand, cbits)
        S_col = torch.where(row0, S0j, S_col)
        s_bits = torch.where(row0, sb0j, s_bits)

        # row m: the x-suffix accumulator over in-band rows < m, then the
        # cell's own candidates when m is in band
        vals = torch.where(in_band & (rows <= ml - 1), S_col + xcs, SENT)
        A = vals.amax(dim=0, keepdim=True)
        updA = A > MIN
        first = torch.where(vals == A, rows, 2**30).amin(dim=0, keepdim=True)
        Lx_j = torch.where(updA & active, ml - first, 0)
        S_m = torch.where(updA, A, MIN)
        sb_m = torch.full((1, B), TB_XCLIP_SUFFIX, dtype=i32, device=dev)
        S_m, sb_m = take(S_m, sb_m, take_m(m_val), take_m(m_bits))
        for cand, cbits in cands:
            S_m, sb_m = take(S_m, sb_m, take_m(cand.expand(M + 1, B)), cbits)
        S_col = torch.where(is_row_m & m_in_band, S_m, S_col)
        s_bits = torch.where(is_row_m & m_in_band, sb_m, s_bits)

        # i-bits: chained extend vs fresh open (the s-bits above) vs the
        # j == n Sn open
        prev_sbits = torch.cat([start_row, s_bits[:-1]])
        i_score_eff = torch.maximum(i_ext, T_seed)
        i_bits = torch.where(
            T_sn > torch.maximum(i_score_eff, T_s),
            TB_YCLIP_SUFFIX,
            torch.where(i_score_eff > T_s, TB_INS, prev_sbits),
        )
        i_bits = torch.where(row0, TB_START, i_bits)

        upd_sn = (S_col + ycs > SN) & in_band & active
        Sn_new = torch.where(upd_sn, S_col + ycs, SN)
        Ly_new = torch.where(upd_sn, nl - j, LY)
        Sn_new = torch.where(row0, sn0_new, Sn_new)
        Ly_new = torch.where(row0, ly0_new, Ly_new)

        # after the rows: Sn[m] from the accumulated S[m], then the
        # out-of-band row-m override (S[m] = MIN, s-bits x-suffix clip)
        S_m_acc = torch.where(m_in_band, take_m(S_col), torch.where(updA, A, MIN))
        upd_snm = (S_m_acc + ycs > take_m(Sn_new)) & active & (ml >= 1)
        Sn_new = torch.where(is_row_m & upd_snm, S_m_acc + ycs, Sn_new)
        Ly_new = torch.where(is_row_m & upd_snm, nl - j, Ly_new)
        S_col = torch.where(is_row_m & ~m_in_band, MIN, S_col)
        s_bits = torch.where(is_row_m & ~m_in_band, TB_XCLIP_SUFFIX, s_bits)

        # the host's buffers: write mask and fringe resets on the stale base
        W = in_band | (row0 & r0_comp) | is_row_m
        R_pre = (rows == stj - 1) | is_row_m
        R_post = (rows >= enj) & (rows < torch.minimum(ml + 1, enx))
        S_full = torch.where(W, S_col, torch.where(R_pre | R_post, MIN, Ss))
        W_id = in_band | (row0 & r0_comp)
        R_id = (rows == stj - 1) | R_post
        D_full = torch.where(W_id, bestD, torch.where(R_id, MIN, Ds))
        I_col = torch.where(W_id, bestI, torch.where(R_id, MIN, I))
        I_col = torch.where(row0 & r0_comp, MIN, I_col)
        SB_col = torch.where(W, s_bits, TB_START)
        cell = torch.where(W_id, i_bits, TB_START) | (torch.where(W_id, d_bits, TB_START) << 4) | (SB_col << 8)
        tb[j - 1] = cell.to(torch.uint16)
        lx[j - 1] = Lx_j[0]

        S, Ss = torch.where(active, S_full, S), torch.where(active, S, Ss)
        D, Ds = torch.where(active, D_full, D), torch.where(active, D, Ds)
        SB = torch.where(active, SB_col, SB)
        I = torch.where(active, I_col, I)
        SN = torch.where(active, Sn_new, SN)
        LY = torch.where(active, Ly_new, LY)
        TBK = torch.where(active, cell, TBK)

    finals = (S, I, SN, LY, TBK)
    return (tb, lx, *(f.t().contiguous() for f in finals))


def _scan_clip(kernel, xb, yb, mlens, nlens, go, ge, subst, clips, traceback):
    B, M, N, dev = _check_pairs(xb, yb, mlens, nlens)
    go, ge = int(go), int(ge)
    clips = tuple(int(v) for v in clips)
    if go > 0 or ge > 0:
        raise ValueError("gap_open and gap_extend must be <= 0")
    sub = _subst(subst, dev)
    local = kernel in (SCAN_LOCAL, SCAN_LOCAL_LUT)
    columns = kernel in (SCAN_COLUMNS, SCAN_COLUMNS_LUT)
    if dev.type == "cpu":
        feed = _plain_feed(xb, yb, subst)
        return _scan_clip_core(feed, M, N, mlens, nlens, go, ge, *clips, traceback, not columns)
    # every kernel writes a pair-major (B, N+1, Xp) tb, returned as its
    # (N+1, M+1, B) view
    tb = _pair_major(B, N + 1, M, dev) if traceback else None
    lx = torch.empty((N + 1, B), dtype=torch.int32, device=dev) if traceback else None
    finals = [torch.empty((B, M + 1), dtype=torch.int32, device=dev) for _ in range(5)]
    Xp = 0 if tb is None else tb.shape[2]
    if B and columns:
        T, R, placement, _ = columns_geometry(M)
        scratch = None if placement == "shared" else torch.empty(
            (B, _COLUMNS_LAYERS, R, T), dtype=torch.int32, device=dev
        )
        xt = xb.t().contiguous()
        yt = yb.t().contiguous()
        kernel.launch(
            dev, xt.data_ptr(), yt.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, M, N, Xp,
            go, ge, *sub, *clips, _ptr(tb), _ptr(lx), *(f.data_ptr() for f in finals), _ptr(scratch),
        )
    elif B:
        scratch = _warp_scratch(LOCAL_WARP_LAYERS, B, M, dev)
        kernel.launch(
            dev, xb.data_ptr(), yb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, M, N, Xp,
            go, ge, *sub, *(() if local else clips), _ptr(tb), _ptr(lx), *(f.data_ptr() for f in finals),
            _ptr(scratch),
        )
    return (tb[:, :, : M + 1].permute(1, 2, 0) if traceback else None, lx, *finals)


# ---------------------------------------------------------------------------
# plain PyTorch versions (rows vectorized, columns in a Python loop)
# ---------------------------------------------------------------------------


def _shift_down(a: torch.Tensor, fill: int, k: int = 1) -> torch.Tensor:
    """out[r] = a[r-k] along dim 0; the first k rows are ``fill``."""
    head = torch.full((k,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
    return torch.cat([head, a[:-k]], dim=0)


def _ins_run_nib(i_bits: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """min(run of Ins i-bits ending at each row, 15) << 12 (sw_pallas.py
    ``_ins_run_nib``); row 0 is never Ins."""
    is_ins = i_bits == TB_INS
    z = torch.where(is_ins, NEG, rows).expand_as(i_bits)
    for k in (1, 2, 4, 8):
        if k < z.shape[0]:
            z = torch.maximum(z, _shift_down(z, NEG, k))
    return torch.where(is_ins, torch.clamp(rows - z, max=15), 0) << 12


def _wrapping(dev, *penalties):
    """The penalties as 0-dim int32 tensors: their sums and products wrap in
    int32, as in the kernels (Python ints would grow, or fail to convert)."""
    return tuple(torch.as_tensor(v, dtype=torch.int32, device=dev) for v in penalties)


def _mp_feed(xb, yb, ma, mi):
    """Column feeder of constant scores: ``feed(j)`` is column j's (subs,
    eq), each (M, B) int32 (``ma``/``mi`` ints or 0-dim int32 tensors)."""
    xt = xb.t().to(torch.int32)
    yt = yb.t().to(torch.int32)

    def feed(j):
        eq = xt == yt[j - 1][None, :]
        return torch.where(eq, ma, mi).to(torch.int32), eq.to(torch.int32)

    return feed


def _stream_feed(subs2):
    """Column feeder of an (N, M, B) ``subs * 2 | eq`` stream (sw_pallas.py
    ``_kernel_scan_global_subs``: the arithmetic shift restores negative
    scores)."""

    def feed(j):
        packed = subs2[j - 1]
        return packed >> 1, packed & 1

    return feed


def subs2_stream_plain(xb, yb, lut):
    """(N, M, B) int32 ``lut[x, y] * 2 | (x == y)``: the stream the JAX
    package's subs kernels read (batched.py ``_subs2_stream``), by an integer
    gather, exact for every byte (the JAX one-hot einsum covers the
    distinct bytes of its ``n_syms`` bucket, float32-exact below 2^24)."""
    B, M = xb.shape
    N = yb.shape[1]
    xi = xb.t().to(torch.int64) << 8  # (M, B): row offsets into the LUT
    flat = lut.reshape(-1)
    out = torch.empty((N, M, B), dtype=torch.int32, device=xb.device)
    for j in range(N):  # one column at a time: no (N, M, B) int64 index
        yj = yb[:, j].to(torch.int64)[None, :]
        out[j] = flat[xi | yj] * 2 + ((xi >> 8) == yj).to(torch.int32)
    return out


def subs_tensor_plain(xb, yb, lut):
    """(B, M, N) int32 ``lut[x, y]``, the input of sw_pallas.py
    ``sw_scores_global`` (``subs_tensor``), by an integer gather."""
    B, M = xb.shape
    N = yb.shape[1]
    xi = xb.to(torch.int64) << 8  # (B, M)
    flat = lut.reshape(-1)
    out = torch.empty((B, M, N), dtype=torch.int32, device=xb.device)
    for j in range(N):
        out[:, :, j] = flat[xi | yb[:, j].to(torch.int64)[:, None]]
    return out


def scan_global_plain(xb, yb, mlens, nlens, go, ge, ma, mi):
    """Plain version of K1 (sw_pallas.py ``_kernel_scan_global_mp``)."""
    return _scan_global_core(_mp_feed(xb, yb, ma, mi), xb.shape[1], yb.shape[1], mlens, nlens, go, ge)


def scan_global_lut_plain(subs2, mlens, nlens, go, ge):
    """Plain version of K11 on its (N, M, B) stream (sw_pallas.py
    ``scan_global_pallas_subs``, ``runs="ins"``)."""
    N, M, _ = subs2.shape
    return _scan_global_core(_stream_feed(subs2), M, N, mlens, nlens, go, ge)


def scan_global_rows_plain(xb, yb, mlens, nlens, go, ge, ma, mi, rb=ROWS_RB):
    """Plain version of K13 (sw_pallas.py ``_kernel_scan_global_rows_mp``):
    K1's column core with the block seams rewritten. Returns (score, tb)."""
    return _scan_global_core(_mp_feed(xb, yb, ma, mi), xb.shape[1], yb.shape[1], mlens, nlens, go, ge, rb=rb)[:2]


def scan_global_rows_lut_plain(xb, yb, mlens, nlens, go, ge, lut, rb=ROWS_RB):
    """Plain version of K13 fed by the LUT: the same core fed one gathered
    column at a time (``_plain_feed``). Returns (score, tb)."""
    return _scan_global_core(_plain_feed(xb, yb, lut), xb.shape[1], yb.shape[1], mlens, nlens, go, ge, rb=rb)[:2]


def _scan_global_core(feed, M, N, mlens, nlens, go, ge, rb=None):
    """K1's column core; with ``rb`` K13's cells instead: no run nibble, and
    at every row ``r * rb`` (r >= 1) the open candidate points at
    ``TB_REREAD`` where K1 copies the s-bits of the cell above (the
    extend-vs-open decision ``i_ext > T`` is the one K13 carries across the
    seam); and K13's insertion chain (``_block_prefix``)."""
    B = mlens.shape[0]
    dev = mlens.device
    i32 = torch.int32
    go, ge = _wrapping(dev, go, ge)
    rows = torch.arange(M + 1, dtype=i32, device=dev)[:, None]  # (M+1, 1)
    row0 = rows == 0
    rge = rows * ge
    neg_row = torch.full((1, B), MIN_SCORE, dtype=i32, device=dev)
    start_row = torch.full((1, B), TB_START, dtype=i32, device=dev)

    S = torch.where(row0, 0, go + ge * (rows - 1)).expand(M + 1, B).contiguous()
    D = torch.full((M + 1, B), MIN_SCORE, dtype=i32, device=dev)
    SB = torch.where(row0, TB_START, TB_INS).to(i32).expand(M + 1, B).contiguous()
    ib0 = torch.where(rows <= 1, TB_START, TB_INS).to(i32)
    TBK = (ib0 | (TB_START << 4) | (SB << 8)).contiguous()
    tb = torch.empty((N, M + 1, B), dtype=torch.uint16, device=dev)
    seam = (rows % rb == 0) & (rows > 0) if rb else None

    for j in range(1, N + 1):
        subs, eq = feed(j)
        m_val = torch.cat([neg_row, S[:-1] + subs])
        m_bits = torch.cat([start_row, TB_SUBST + eq])
        d_ext = D + ge
        d_open = S + go
        d_wins = d_ext > d_open
        dj0 = go + ge * (j - 1)
        best_d = torch.where(row0, dj0, torch.where(d_wins, d_ext, d_open))
        d_bits = torch.where(
            row0, TB_START if j == 1 else TB_DEL, torch.where(d_wins, TB_DEL, SB)
        )
        s_tilde = torch.where(row0, dj0, torch.maximum(m_val, best_d))

        # I via (max,+) prefix scan; T is also the open candidate
        T = torch.cat([neg_row, s_tilde[:-1] + go])
        best_i = _block_prefix(T, ge, rb) if rb else torch.cummax(T - rge, dim=0).values + rge
        i_ext = torch.cat([neg_row, best_i[:-1] + ge])

        # S selection, priority Match/Subst > Ins > Del (strict >)
        take_i = best_i > m_val
        s_col = torch.where(take_i, best_i, m_val)
        s_bits = torch.where(take_i, TB_INS, m_bits)
        take_d = best_d > s_col
        s_col = torch.where(row0, dj0, torch.where(take_d, best_d, s_col))
        s_bits = torch.where(row0, TB_DEL, torch.where(take_d, TB_DEL, s_bits))

        above = torch.cat([start_row, s_bits[:-1]])
        if rb:
            above = torch.where(seam, TB_REREAD, above)
        i_bits = torch.where(i_ext > T, TB_INS, above)
        i_bits = torch.where(row0, TB_START, i_bits)
        cell = i_bits | (d_bits << 4) | (s_bits << 8)
        if not rb:
            cell = cell | _ins_run_nib(i_bits, rows)
        tb[j - 1] = cell.to(torch.uint16)

        keep = (j <= nlens)[None, :]
        S = torch.where(keep, s_col, S)
        D = torch.where(keep, best_d, D)
        SB = torch.where(keep, s_bits, SB)
        TBK = torch.where(keep, cell, TBK)

    score = torch.where(rows == mlens[None, :], S, NEG).amax(dim=0)
    return score, tb, TBK.t().contiguous()


def _block_prefix(T, ge, rb):
    """K13's insertion scores from the open candidates T (M+1, B), as the
    JAX block-row kernel (sw_pallas.py ``_kernel_scan_global_rows_mp``)
    computes them: in each block of ``rb`` rows a prefix maximum of
    T[k] - k * ge over the block's rows k >= 1 (k counted from the block's
    first row), seeded by the block's first row and floored at NEG (its
    scan's fill), plus k * ge; the seed is NEG in the first block, else the
    carried I = max(I[i-1] + ge, T[i]) of the seam row i. Equal to K1's
    prefix maximum while no sum wraps int32."""
    X, B = T.shape
    nb = -(-X // rb)
    local = torch.arange(nb * rb, dtype=torch.int32, device=T.device).view(nb, rb, 1) % rb
    lge = local * ge
    U = torch.cat([T, torch.full((nb * rb - X, B), NEG, dtype=T.dtype, device=T.device)]).view(nb, rb, B)
    Q = torch.cummax(torch.where(local == 0, NEG, U - lge), dim=1).values
    seeds = [torch.full((B,), NEG, dtype=T.dtype, device=T.device)]
    for r in range(1, nb):
        i_prev = torch.maximum(seeds[-1], Q[r - 1, rb - 1]) + lge[0, rb - 1]
        seeds.append(torch.clamp(torch.maximum(i_prev + ge, U[r, 0]), min=NEG))
    P = torch.maximum(torch.stack(seeds)[:, None, :], Q)
    return (P + lge).view(nb * rb, B)[:X]


def scores_global_plain(xb, yb, mlens, nlens, go, ge, ma, mi):
    """Plain version of K3 (sw_pallas.py ``_kernel_mp``)."""
    return _scores_global_core(_mp_feed(xb, yb, ma, mi), xb.shape[1], yb.shape[1], mlens, nlens, go, ge)


def scores_global_lut_plain(subs, mlens, nlens, go, ge):
    """Plain version of K18 on its (B, M, N) substitution tensor
    (sw_pallas.py ``sw_scores_global``)."""
    _, M, N = subs.shape
    return _scores_global_core(lambda j: (subs[:, :, j - 1].t(), None), M, N, mlens, nlens, go, ge)


def _scores_global_core(feed, M, N, mlens, nlens, go, ge):
    B = mlens.shape[0]
    dev = mlens.device
    i32 = torch.int32
    go, ge = _wrapping(dev, go, ge)
    rows = torch.arange(M + 1, dtype=i32, device=dev)[:, None]
    row0 = rows == 0
    rge = rows * ge
    neg_row = torch.full((1, B), NEG, dtype=i32, device=dev)

    S = torch.where(row0, 0, go + ge * (rows - 1)).expand(M + 1, B).contiguous()
    D = torch.full((M + 1, B), NEG, dtype=i32, device=dev)
    for j in range(1, N + 1):
        subs, _eq = feed(j)
        m_score = torch.cat([neg_row, S[:-1] + subs])
        best_d = torch.maximum(D + ge, S + go)
        s0j = go + ge * (j - 1)
        s_tilde = torch.where(row0, s0j, torch.maximum(m_score, best_d))
        T = torch.cat([neg_row, s_tilde[:-1] + go])
        best_i = torch.cummax(T - rge, dim=0).values + rge
        s_col = torch.maximum(torch.maximum(m_score, best_i), best_d)
        s_col = torch.where(row0, s0j, s_col)
        active = (j <= nlens)[None, :]
        S = torch.where(active, s_col, S)
        D = torch.where(active, best_d, D)
    return torch.where(rows == mlens[None, :], S, NEG).amax(dim=0)


def scan_semiglobal_plain(xb, yb, mlens, nlens, go, ge, ma, mi, ycp, ycs):
    """Plain version of K5 (sw_pallas.py ``_kernel_scan_semiglobal_mp``)."""
    return _scan_semiglobal_core(_mp_feed(xb, yb, ma, mi), xb.shape[1], yb.shape[1], mlens, nlens, go, ge, ycp, ycs)


def scan_semiglobal_lut_plain(subs2, mlens, nlens, go, ge, ycp, ycs):
    """Plain version of K12 on its (N, M, B) stream (sw_pallas.py
    ``scan_semiglobal_pallas_subs``, ``runs="ins"``)."""
    N, M, _ = subs2.shape
    return _scan_semiglobal_core(_stream_feed(subs2), M, N, mlens, nlens, go, ge, ycp, ycs)


def _scan_semiglobal_core(feed, M, N, mlens, nlens, go, ge, ycp, ycs):
    B = mlens.shape[0]
    dev = mlens.device
    i32 = torch.int32
    go, ge, ycp, ycs = _wrapping(dev, go, ge, ycp, ycs)
    rows = torch.arange(M + 1, dtype=i32, device=dev)[:, None]  # (M+1, 1)
    row0 = rows == 0
    rge = rows * ge
    in_x = (rows >= 1) & (rows <= mlens[None, :])
    yclip_row = ycp + go + ge * (rows - 1)
    neg_row = torch.full((1, B), MIN_SCORE, dtype=i32, device=dev)
    start_row = torch.full((1, B), TB_START, dtype=i32, device=dev)

    S0 = torch.where(row0, 0, go + ge * (rows - 1))
    S = S0.expand(M + 1, B).contiguous()
    D = torch.full((M + 1, B), MIN_SCORE, dtype=i32, device=dev)
    I = torch.full((M + 1, B), MIN_SCORE, dtype=i32, device=dev)
    SB = torch.where(row0, TB_START, TB_INS).to(i32).expand(M + 1, B).contiguous()
    ib0 = torch.where(rows <= 1, TB_START, TB_INS).to(i32)
    TBK = (ib0 | (TB_START << 4) | (SB << 8)).contiguous()
    # y-suffix accumulators: row 0 = (ycs, nlens), rows in x = (S0 + ycs, nlens)
    SN = torch.where(row0, ycs, torch.where(in_x, S0 + ycs, MIN_SCORE)).to(i32)
    LY = torch.where(row0 | in_x, nlens[None, :], 0).to(i32)
    tb = torch.empty((N, M + 1, B), dtype=torch.uint16, device=dev)

    for j in range(1, N + 1):
        active = (j <= nlens)[None, :]
        is_last = (j == nlens)[None, :]
        subs, eq = feed(j)
        m_val = torch.cat([neg_row, S[:-1] + subs])
        m_bits = torch.cat([start_row, TB_SUBST + eq])
        d_ext = D + ge
        d_open = S + go
        d_wins = d_ext > d_open
        best_d = torch.where(d_wins, d_ext, d_open)
        d_bits = torch.where(d_wins, TB_DEL, SB)

        # row 0: Del against the y-prefix clip; in the lane's last column the
        # y-suffix accumulator may take it over
        d_gap = go + ge * (j - 1)
        d_clip = ycp + go
        dj0 = go if j == 1 else max(d_gap, d_clip)
        db0 = TB_START if j == 1 else (TB_DEL if d_gap > d_clip else TB_YCLIP_PREFIX)
        s0j = dj0 if dj0 > ycp else ycp
        sb0 = TB_DEL if dj0 > ycp else TB_YCLIP_PREFIX
        sn0 = SN[0:1]
        take_sn = is_last & (sn0 > s0j)
        s0j = torch.where(take_sn, sn0, s0j)
        sb0 = torch.where(take_sn, TB_YCLIP_SUFFIX, torch.full_like(sn0, sb0))
        upd_sn0 = ~take_sn & (s0j + ycs > sn0) & active
        sn0_new = torch.where(upd_sn0, s0j + ycs, sn0)
        ly0_new = torch.where(upd_sn0, nlens[None, :] - j, LY[0:1])

        best_d = torch.where(row0, dj0, best_d)
        d_bits = torch.where(row0, db0, d_bits)
        s_tilde = torch.where(row0, s0j, torch.maximum(torch.maximum(m_val, best_d), yclip_row))

        T = torch.cat([neg_row, s_tilde[:-1] + go])
        best_i = torch.cummax(T - rge, dim=0).values + rge
        i_ext = torch.cat([neg_row, best_i[:-1] + ge])

        # S selection, priority Match/Subst > Ins > Del > Yclip-prefix
        take_i = best_i > m_val
        s_col = torch.where(take_i, best_i, m_val)
        s_bits = torch.where(take_i, TB_INS, m_bits)
        take_d = best_d > s_col
        s_col = torch.where(take_d, best_d, s_col)
        s_bits = torch.where(take_d, TB_DEL, s_bits)
        take_y = yclip_row > s_col
        s_col = torch.where(row0, s0j, torch.where(take_y, yclip_row, s_col))
        s_bits = torch.where(row0, sb0, torch.where(take_y, TB_YCLIP_PREFIX, s_bits))

        i_bits = torch.where(i_ext > T, TB_INS, torch.cat([start_row, s_bits[:-1]]))
        i_bits = torch.where(row0, TB_START, i_bits)

        upd_sn = (s_col + ycs > SN) & in_x & active
        SN = torch.where(row0, sn0_new, torch.where(upd_sn, s_col + ycs, SN))
        LY = torch.where(row0, ly0_new, torch.where(upd_sn, nlens[None, :] - j, LY))

        cell = i_bits | (d_bits << 4) | (s_bits << 8) | _ins_run_nib(i_bits, rows)
        tb[j - 1] = cell.to(torch.uint16)
        S = torch.where(active, s_col, S)
        D = torch.where(active, best_d, D)
        SB = torch.where(active, s_bits, SB)
        I = torch.where(active, best_i, I)
        TBK = torch.where(active, cell, TBK)

    finals = (S, I, SN, LY, TBK)
    return (tb, *(f.t().contiguous() for f in finals))


def scan_custom_plain(xb, yb, mlens, nlens, go, ge, ma, mi, xcp, xcs, ycp, ycs, traceback=True):
    """Plain version of K9 (sw_pallas.py ``_kernel_scan_custom_mp``)."""
    feed = _mp_feed(xb, yb, ma, mi)
    return _scan_clip_core(feed, xb.shape[1], yb.shape[1], mlens, nlens, go, ge, xcp, xcs, ycp, ycs, traceback)


def scan_local_plain(xb, yb, mlens, nlens, go, ge, ma, mi, traceback=True):
    """Plain version of K7: the K9 recurrence at clips 0. The terms that
    clip 0 leaves dead while no sum wraps (the y-prefix clip, the x-prefix
    clip's gap) stay in: where a gap sum wraps int32 they are live, as in
    the Pallas custom kernel (the Pallas local kernel drops them)."""
    feed = _mp_feed(xb, yb, ma, mi)
    return _scan_clip_core(feed, xb.shape[1], yb.shape[1], mlens, nlens, go, ge, 0, 0, 0, 0, traceback)


def scan_custom_lut_plain(subs2, mlens, nlens, go, ge, xcp, xcs, ycp, ycs, traceback=True):
    """Plain version of K9 fed by the LUT, on its (N, M, B) stream."""
    N, M, _ = subs2.shape
    return _scan_clip_core(_stream_feed(subs2), M, N, mlens, nlens, go, ge, xcp, xcs, ycp, ycs, traceback)


def scan_local_lut_plain(subs2, mlens, nlens, go, ge, traceback=True):
    """Plain version of K7 fed by the LUT, on its (N, M, B) stream."""
    N, M, _ = subs2.shape
    return _scan_clip_core(_stream_feed(subs2), M, N, mlens, nlens, go, ge, 0, 0, 0, 0, traceback)


def scan_columns_plain(xb, yb, mlens, nlens, go, ge, ma, mi, xcp, xcs, ycp, ycs, traceback=True):
    """Plain version of K15 (sw_pallas.py ``_kernel_scan_full_mp``): K9's
    column core without the run nibble."""
    feed = _mp_feed(xb, yb, ma, mi)
    return _scan_clip_core(
        feed, xb.shape[1], yb.shape[1], mlens, nlens, go, ge, xcp, xcs, ycp, ycs, traceback, False
    )


def scan_columns_lut_plain(xb, yb, mlens, nlens, go, ge, lut, xcp, xcs, ycp, ycs, traceback=True):
    """Plain version of K15-LUT (batched.py ``_scan_columns_xla``): the same
    core fed one gathered column at a time (``_plain_feed``; the (N, M, B)
    stream of ``subs2_stream_plain`` would not fit at long x)."""
    feed = _plain_feed(xb, yb, lut)
    return _scan_clip_core(
        feed, xb.shape[1], yb.shape[1], mlens, nlens, go, ge, xcp, xcs, ycp, ycs, traceback, False
    )


def _scan_clip_core(feed, M, N, mlens, nlens, go, ge, xcp, xcs, ycp, ycs, traceback, runs=True):
    """K9's column core (K7's at clips 0); ``runs`` False gives K15's: no
    run nibble, and S chosen from MIN_SCORE (Xclip-suffix bits) up, as the
    JAX column body (batched.py ``_column_body``) chooses it, where K9 starts
    from the substitution candidate (the two differ only where every
    candidate wrapped below MIN_SCORE). The final I of a lane with nlens = 0
    is column 0's I0, as the reference's column 0 holds it (rows >= 1)."""
    B = mlens.shape[0]
    dev = mlens.device
    i32 = torch.int32
    go, ge, xcp, xcs, ycp, ycs = _wrapping(dev, go, ge, xcp, xcs, ycp, ycs)
    rows = torch.arange(M + 1, dtype=i32, device=dev)[:, None]  # (M+1, 1)
    row0 = rows == 0
    row_ge1 = rows >= 1
    ml = mlens[None, :]
    in_x = row_ge1 & (rows <= ml)
    is_row_m = (rows == ml) & (ml >= 1)
    mid = row_ge1 & (rows <= ml - 1)
    rge = rows * ge
    yclip_row = ycp + go + ge * (rows - 1)
    neg_row = torch.full((1, B), MIN_SCORE, dtype=i32, device=dev)
    start_row = torch.full((1, B), TB_START, dtype=i32, device=dev)

    def take(s, bits, cand, cbits):
        tk = cand > s
        return torch.where(tk, cand, s), torch.where(tk, cbits, bits)

    def row_m(S_col, s_bits, cands):
        """Row m replaced by the x-suffix clip (the maximum of S + xcs over
        rows 1..m-1, the first row on ties) unless one of the cell's own
        candidates is strictly greater; and the clip length (B,)."""
        vals = torch.where(mid, S_col + xcs, _SENT)
        A = vals.amax(dim=0, keepdim=True)
        upd = A > MIN_SCORE
        first = torch.argmax((vals == A).to(torch.uint8), dim=0).to(i32)
        s_m = torch.where(upd, A, MIN_SCORE).expand_as(S_col)
        sb_m = torch.full_like(s_bits, TB_XCLIP_SUFFIX)
        for cand, cbits in cands:
            s_m, sb_m = take(s_m, sb_m, cand, cbits)
        lx_j = torch.where(upd[0], mlens - first, 0)
        return torch.where(is_row_m, s_m, S_col), torch.where(is_row_m, sb_m, s_bits), lx_j

    # column 0 (sw_pallas.py:1648-1711)
    gap_i = go + ge * (rows - 1)
    clip_i = xcp + go
    ins_wins = gap_i > clip_i
    I0 = torch.where(rows == 1, go, torch.where(ins_wins, gap_i, clip_i))
    I0 = torch.where(row_ge1, I0, MIN_SCORE).expand(M + 1, B)
    ib0 = torch.where(rows == 1, TB_START, torch.where(ins_wins, TB_INS, TB_XCLIP_PREFIX))
    ib0 = torch.where(row_ge1, ib0, TB_START).to(i32).expand(M + 1, B)
    S0 = torch.full((M + 1, B), MIN_SCORE, dtype=i32, device=dev)
    sb0 = torch.full((M + 1, B), TB_START, dtype=i32, device=dev)
    S0, sb0 = take(S0, sb0, I0, TB_INS)
    S0, sb0 = take(S0, sb0, torch.where(row_ge1, xcp, MIN_SCORE), TB_XCLIP_PREFIX)
    S0, sb0, lx0 = row_m(S0, sb0, [(I0, TB_INS), (xcp, TB_XCLIP_PREFIX)])
    S = torch.where(row0, 0, S0)
    SB = torch.where(row0, TB_START, sb0)
    D = torch.full((M + 1, B), MIN_SCORE, dtype=i32, device=dev)
    I = I0.contiguous()  # column 1 overwrites it in every lane with nlens >= 1
    TBK = ib0 | (TB_START << 4) | (SB << 8)
    sn_live = in_x & (S + ycs > MIN_SCORE)
    SN = torch.where(row0, ycs, torch.where(sn_live, S + ycs, MIN_SCORE))
    LY = torch.where(row0 | sn_live, nlens[None, :], 0).to(i32)
    tb = lx = None
    if traceback:
        tb = torch.empty((N + 1, M + 1, B), dtype=torch.uint16, device=dev)
        lx = torch.empty((N + 1, B), dtype=i32, device=dev)
        tb[0] = (TBK | _ins_run_nib(ib0, rows) if runs else TBK).to(torch.uint16)
        lx[0] = lx0

    d_clip = ycp + go
    for j in range(1, N + 1):
        active = (j <= nlens)[None, :]
        is_last = (j == nlens)[None, :]
        subs, eq = feed(j)
        m_val = torch.cat([neg_row, S[:-1] + subs])
        m_bits = torch.cat([start_row, TB_SUBST + eq])
        d_ext = D + ge
        d_open = S + go
        d_wins = d_ext > d_open
        best_d = torch.where(d_wins, d_ext, d_open)
        d_bits = torch.where(d_wins, TB_DEL, SB)

        # row 0: Del against the y-prefix clip; in the lane's last column
        # the y-suffix accumulator may take it over
        d_gap = go + ge * (j - 1)
        if j == 1:
            dj0, db0 = go, torch.tensor(TB_START, dtype=i32, device=dev)
        else:
            dj0 = torch.where(d_gap > d_clip, d_gap, d_clip)
            db0 = torch.where(d_gap > d_clip, TB_DEL, TB_YCLIP_PREFIX).to(i32)
        s0j = torch.where(dj0 > ycp, dj0, ycp)
        sb0 = torch.where(dj0 > ycp, TB_DEL, TB_YCLIP_PREFIX).to(i32)
        sn0 = SN[0:1]
        take_sn = is_last & (sn0 > s0j)
        s0j = torch.where(take_sn, sn0, s0j)
        sb0 = torch.where(take_sn, TB_YCLIP_SUFFIX, sb0)
        upd_sn0 = ~take_sn & (s0j + ycs > sn0) & active
        sn0_new = torch.where(upd_sn0, s0j + ycs, sn0)
        ly0_new = torch.where(upd_sn0, nlens[None, :] - j, LY[0:1])
        best_d = torch.where(row0, dj0, best_d)
        d_bits = torch.where(row0, db0, d_bits)

        # the column's x-prefix clip score
        xclip = xcp + torch.maximum(ycp, d_gap)
        s_tilde = torch.maximum(torch.maximum(torch.maximum(m_val, best_d), xclip), yclip_row)
        s_tilde = torch.where(row0, s0j, s_tilde)
        T = torch.cat([neg_row, s_tilde[:-1] + go])
        best_i = torch.cummax(T - rge, dim=0).values + rge
        i_ext = torch.cat([neg_row, best_i[:-1] + ge])

        # priority Match/Subst > Ins > Del > Xclip-prefix > Yclip-prefix
        cands = [(best_i, TB_INS), (best_d, TB_DEL), (xclip, TB_XCLIP_PREFIX), (yclip_row, TB_YCLIP_PREFIX)]
        s_col, s_bits = m_val, m_bits
        if not runs:
            s_col, s_bits = take(torch.full_like(m_val, MIN_SCORE), torch.full_like(m_bits, TB_XCLIP_SUFFIX), m_val, m_bits)
        for cand, cbits in cands:
            s_col, s_bits = take(s_col, s_bits, cand, cbits)
        s_col = torch.where(row0, s0j, s_col)
        s_bits = torch.where(row0, sb0, s_bits)
        s_col, s_bits, lx_j = row_m(s_col, s_bits, [(m_val, m_bits)] + cands)

        i_bits = torch.where(i_ext > T, TB_INS, torch.cat([start_row, s_bits[:-1]]))
        i_bits = torch.where(row0, TB_START, i_bits)
        upd_sn = (s_col + ycs > SN) & in_x & active
        SN = torch.where(row0, sn0_new, torch.where(upd_sn, s_col + ycs, SN))
        LY = torch.where(row0, ly0_new, torch.where(upd_sn, nlens[None, :] - j, LY))

        cell = i_bits | (d_bits << 4) | (s_bits << 8)
        if traceback:  # the run nibble, in tbk too (as in the Pallas kernel)
            if runs:
                cell = cell | _ins_run_nib(i_bits, rows)
            tb[j] = cell.to(torch.uint16)
            lx[j] = torch.where(active[0], lx_j, 0)
        S = torch.where(active, s_col, S)
        D = torch.where(active, best_d, D)
        SB = torch.where(active, s_bits, SB)
        I = torch.where(active, best_i, I)
        TBK = torch.where(active, cell, TBK)

    finals = (S, I, SN, LY, TBK)
    return (tb, lx, *(f.t().contiguous() for f in finals))
