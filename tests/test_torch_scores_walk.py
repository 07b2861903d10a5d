"""K3's two launches and K14's tiles, on the CPU.

The Python mirrors of their geometries (``sw.warp_geometry`` for K3's warp
launch, ``sw.rows_geometry(M, True)`` for its block launch,
``walk.seg_walk_geometry`` for K14) against the constants of their CUDA
sources, K3's route limit ``sw.SCORES_ROWS_MIN``, K14's test for 16-byte
row loads (``walk._vector_rows``), and ``BatchAligner(device="cpu")
.scores(..., "global")`` at x long enough for the block route against the
JAX package's ``sw_scores_global_matchparams`` (interpret mode) where int32
wraps. Integers throughout: every comparison is exact.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.ops import sw_pallas
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
from rust_bio_tpu_torch.alignment.pairwise.batched import T_ROWS
from rust_bio_tpu_torch.ops import sw, walk

CSRC = Path(sw.__file__).resolve().parent / "csrc"
MS = [0, 1, 7, 255, 256, 604, 605, 2047, 2048, 5588, 16383, 24575, 24576, 65534]


def _constants(source: str) -> dict:
    """The ``constexpr int`` values of a CUDA source."""
    text = (CSRC / source).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_mirrors_match_the_sources():
    rows = _constants("sw_global_rows.cu")
    assert (rows["SCORE_CARRIES"], rows["SCORE_LAYERS"]) == (sw._SCORES_ROWS_CARRIES, sw._SCORES_ROWS_LAYERS)
    assert (rows["T_STRIPES"], rows["GROUP"]) == (sw._ROWS_STRIPES, sw._ROWS_GROUP)
    warp = _constants("sw_warp.cu")
    assert (warp["SCORE_LAYERS"], warp["WARPS"], warp["LANES"]) == (sw.SCORE_WARP_LAYERS, sw._WARP_PAIRS, sw._WARP_LANES)
    seg = _constants("walk_global_seg.cu")
    g = walk.seg_walk_geometry()
    assert (seg["WARPS"], seg["LANES"], seg["TILE_ROWS"], seg["AHEAD"]) == (
        g["warps"], g["tile_columns"], g["tile_rows"], g["ahead_rows"]
    )
    assert re.search(r"constexpr int PITCH = TILE_ROWS \+ (\d+);", (CSRC / "walk_global_seg.cu").read_text()).group(1) == str(
        walk.SEG_TILE_PITCH - walk.SEG_TILE_ROWS
    )


@pytest.mark.parametrize("M", MS)
def test_rows_geometry_of_k3_owns_every_row_once(M):
    """K3's block launch: stripes of R rows (a multiple of 8) cover rows
    0..M once, T a multiple of 32 up to 256, the shared bytes within a
    block's, the state in shared memory exactly up to
    ``SCORES_ROWS_SHARED_MAX_M``."""
    T, R, placement, smem = sw.rows_geometry(M, score_only=True)
    stripes = -(-(M + 1) // R)
    assert R % 8 == 0 and T % 32 == 0 and stripes <= T <= sw._ROWS_STRIPES and T - stripes < 32
    assert R * (stripes - 1) < M + 1 <= R * stripes
    assert smem <= sw._SMEM_MAX
    assert placement == ("shared" if M <= sw.SCORES_ROWS_SHARED_MAX_M else "scratch")
    assert sw.rows_geometry(M, score_only=True)[:2] == sw.rows_geometry(M)[:2]  # K13's stripes


def test_k3_shared_limit_is_the_largest_that_fits():
    T, R, _, smem = sw.rows_geometry(sw.SCORES_ROWS_SHARED_MAX_M, True)
    assert smem <= sw._SMEM_MAX
    T2, R2, placement, smem2 = sw.rows_geometry(sw.SCORES_ROWS_SHARED_MAX_M + 1, True)
    assert placement == "scratch"
    assert smem2 + sw._SCORES_ROWS_LAYERS * R2 * T2 * 4 > sw._SMEM_MAX


@pytest.mark.parametrize("M", MS[:-3])
def test_warp_geometry_of_k3(M):
    """K3's warp launch (K18's): lane stripes of R rows cover rows 0..M
    once, a warp's slice within ``SCORE_WARP_SHARED_MAX`` where the state
    stays in shared memory, four warps' x bytes within a block's."""
    R, placement, nbytes = sw.warp_geometry(M, sw.SCORE_WARP_LAYERS, sw.SCORE_WARP_SHARED_MAX)
    assert R % 8 == 0 and R * 32 >= M + 1 > (R - 8) * 32
    assert nbytes == R * 32 + (sw.SCORE_WARP_LAYERS * R * 32 * 4 if placement == "shared" else 0)
    assert (placement == "shared") == (R * 32 * (1 + 4 * sw.SCORE_WARP_LAYERS) <= sw.SCORE_WARP_SHARED_MAX)
    assert sw._WARP_PAIRS * nbytes <= sw._SMEM_MAX


@pytest.mark.parametrize("B", [1, 128, sw.SCORES_WARP_PAIRS - 1, sw.SCORES_WARP_PAIRS, 8192])
@pytest.mark.parametrize("limit", [2, 151, sw.SCORES_ROWS_MIN, 10_000])
def test_k3_route_at_and_around_its_limits(monkeypatch, limit, B):
    """The block route from M + 1 = ``SCORES_ROWS_MIN`` on, except for
    ``SCORES_WARP_PAIRS`` pairs or more up to M + 1 =
    ``SCORES_WARP_MAX_ROWS``."""
    monkeypatch.setattr(sw, "SCORES_ROWS_MIN", limit)
    many = B >= sw.SCORES_WARP_PAIRS
    for M in list(range(max(0, limit - 4), limit + 3)) + list(range(sw.SCORES_WARP_MAX_ROWS - 3, sw.SCORES_WARP_MAX_ROWS + 2)):
        rows = M + 1 >= limit and not (many and M + 1 <= sw.SCORES_WARP_MAX_ROWS)
        assert sw.scores_route(M, B) == ("rows" if rows else "warp")


def test_k3_route_limits():
    """K3 takes the block route where the global path takes K13, for
    fewer than ``SCORES_WARP_PAIRS`` pairs; with more, while two blocks of
    the warp route fit an SM (the last M + 1 at which they do)."""
    assert sw.SCORES_ROWS_MIN == T_ROWS
    assert sw.scores_route(T_ROWS - 2, 128) == "warp" and sw.scores_route(T_ROWS - 1, 128) == "rows"
    assert sw.scores_route(5588, 128) == "rows" and sw.scores_route(149, 8192) == "warp"
    fits = lambda M: 2 * sw.warp_geometry(M, sw.SCORE_WARP_LAYERS, 1 << 30)[2] * sw._WARP_PAIRS <= sw._SMEM_MAX  # noqa: E731
    assert fits(sw.SCORES_WARP_MAX_ROWS - 1) and not fits(sw.SCORES_WARP_MAX_ROWS)


def test_seg_walk_geometry():
    """K14's tiles: rows a multiple of 8 (16-byte copies of aligned row
    groups), a column pitch of an odd number of 16-byte units (a quarter
    warp's stores in distinct banks), the tile fetched ahead ending inside
    the rows a diagonal path reaches across a tile's columns, a block's
    two tiles a warp within 48 KB of static shared memory."""
    g = walk.seg_walk_geometry()
    assert g["tile_rows"] % 8 == 0 and g["tile_columns"] == 32
    assert g["pitch_bytes"] % 16 == 0 and (g["pitch_bytes"] // 16) % 2 == 1
    assert g["pitch_bytes"] >= 2 * g["tile_rows"]
    assert 0 <= g["ahead_rows"] < g["tile_columns"] and g["tile_rows"] - g["ahead_rows"] >= 2 * g["tile_columns"]
    assert g["shared_bytes"] == g["warps"] * 2 * g["tile_columns"] * g["pitch_bytes"] <= 48 * 1024


def _pair_major(tb, pad=8):
    N, X, B = tb.shape
    pm = torch.zeros((B, N, -(-X // pad) * pad), dtype=torch.uint16)
    pm[:, :, :X] = tb.permute(2, 0, 1)
    return pm.permute(1, 2, 0)[:, :X, :]


@pytest.mark.parametrize("X", [1, 7, 8, 13, 16])
def test_vector_rows_takes_aligned_stride_one_rows_only(X):
    """16-byte row loads on the pair-major view and on a contiguous tb of
    one pair whose X is a multiple of 8; cell loads on a contiguous tb of
    several pairs, on a view whose storage ends at row X - 1 of its last
    column, and on a view 2 bytes off 16-byte alignment."""
    tb = torch.zeros((5, X, 3), dtype=torch.uint16)
    assert walk._vector_rows(_pair_major(tb))
    assert not walk._vector_rows(tb)
    one = torch.zeros((5, X, 1), dtype=torch.uint16)
    assert walk._vector_rows(one) == (X % 8 == 0)
    Xp = -(-X // 8) * 8
    flat = torch.zeros(2 * 5 * Xp - (Xp - X), dtype=torch.uint16)  # the last column holds X rows only
    short = flat.as_strided((5, X, 2), (Xp, 1, 5 * Xp))
    assert walk._walk_strides(short) == (Xp, 1, 5 * Xp)
    assert walk._vector_rows(short) == (X % 8 == 0)
    off = torch.zeros(1 + 3 * 5 * Xp, dtype=torch.uint16)[1:].as_strided((5, X, 3), (Xp, 1, 5 * Xp))
    assert not walk._vector_rows(off)
    assert not walk._vector_rows(torch.zeros((0, X, 3), dtype=torch.uint16))


W = 2**26  # at M > 32, M * W passes 2^31
WRAP_CASES = [(-5, -1, 2, -2), (-W, -W, 2 * W, -2 * W), (-2 * W, -W // 2, 8 * W, -8 * W), (-(2**30), -(2**29), 2**30, -(2**30))]


@pytest.mark.parametrize("case", WRAP_CASES, ids=lambda c: "_".join(map(str, c)))
def test_aligner_scores_at_long_x_match_jax(case):
    """``BatchAligner(device="cpu").scores(..., "global")`` at M + 1 >=
    ``T_ROWS`` (x of 600-640, where the card takes K3's block route) and
    8 pairs (empty x and y lanes, lanes whose x holds y) against the JAX
    ``sw_scores_global_matchparams`` in interpret mode, the batch 16 times
    over (its 128-lane blocks), at gap costs and scores whose sums pass
    2^31."""
    go, ge, ma, mi = case
    rng = np.random.default_rng(abs(ge) % 1000 + 7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    xs = [acgt[rng.integers(0, 4, size=int(rng.integers(600, 641)))].tobytes() for _ in range(6)] + [b"", b"A" * 610]
    ys = [x[5:45] if k % 2 else acgt[rng.integers(0, 4, size=int(rng.integers(1, 50)))].tobytes() for k, x in enumerate(xs)]
    ys[6], ys[7] = b"ACGTACGT", b""
    ba = BatchAligner(Scoring.from_scores(go, ge, ma, mi), device="cpu")
    xb, yb, mlens, nlens = (np.asarray(a) for a in ba._pad(xs, ys))
    assert xb.shape[1] + 1 >= T_ROWS and sw.scores_route(xb.shape[1], 8) == "rows"
    rep = [np.tile(a, (16,) + (1,) * (a.ndim - 1)) for a in (xb, yb, mlens, nlens)]
    want = np.asarray(sw_pallas.sw_scores_global_matchparams(*(jnp.asarray(a) for a in rep), ma, mi, go, ge, block_b=128))
    got = ba.scores(xs, ys, "global")
    np.testing.assert_array_equal(got, want[:8])
    if ge != -1:  # the case reaches int32 overflow
        assert xb.shape[1] * np.int64(ge) < -(2**31)
