"""The port's DP plain versions against the JAX package where int32 wraps.

The JAX kernels take the insertion score as a prefix maximum,
``I[i] = max_k (T[k] - k * ge) + i * ge`` in wrapping int32, and so do the
port's plain versions (and the CUDA kernels, held to those on the card in
``test_torch_cuda.py``). Here the gap costs, scores and clips are large
enough that ``i * ge``, the clip sums and S pass 2^31 at the batch's M: the
plain K1, K3, K5, K7, K9, K11 and K12 against the Pallas kernels in
interpret mode, the plain K13 against ``scan_global_rows_pallas_mp`` with
16-row blocks forced, and the plain K15 against the Pallas K15. The batches
hold lanes with an empty x and an empty y. Integers throughout: every
comparison is exact (tolerance 0). The final I of an empty-y lane is held to
column 0's I, which the port keeps and the JAX kernels leave at MIN_SCORE.
Last, ``BatchAligner(device="cpu").global_`` where int32 wraps: the port
routes a batch to K1 or K13 by its padded M, where the JAX package routes
by its VMEM model, so one pair's answer depends on its batch there; pinned
with the JAX package's answer beside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.ops import sw_pallas
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE
from rust_bio_tpu_torch.ops import sw
from test_torch_long_clip import _jax_columns

MIN = MIN_SCORE
W = 2**26  # at M = 40, 40 * W passes 2^31
B, M, N = 8, 40, 44
# (go, ge, match, mismatch)
MP_CASES = [
    (-W, -W, 2 * W, -2 * W),
    (-2 * W, -W // 2, 8 * W, -8 * W),
    (0, -W, W, -W),
    (-(2**30), -(2**29), 2**30, -(2**30)),
]
# (go, ge, (xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix)), the
# scores 2 * W and -2 * W: local, semiglobal, clips whose sums with the gap
# costs wrap, and MIN_SCORE beside large clips
CLIP_CASES = [
    (-W, -W, (0, 0, 0, 0)),
    (-W, -W, (MIN, MIN, 0, 0)),
    (-W, -W, (-4 * W, -W, -2 * W, -8 * W)),
    (-(2**30), -(2**28), (-(2**30) - 2**28, -(2**29), MIN, -(2**30))),
    (-2 * W, -W, (MIN, -3 * W, -W, MIN)),
    (0, -W, (-W, 0, -(2**30), 0)),
]
# K11 / K12 under a LUT: (go, ge, table) with a random table of +-2^27 (the
# JAX subs kernels read lut * 2 | eq) or BLOSUM62
LUT_CASES = [(-11, -1, "big"), (0, 0, "big"), (-(2**28), -(2**27), "blosum62"), (-(2**22), -(2**21), "big")]


def _id(case):
    return "_".join(str(v) if not isinstance(v, tuple) else "-".join(map(str, v)) for v in case)


def _wrap(a):
    """int64 values wrapped to int32, as the kernels' sums wrap."""
    return ((np.asarray(a, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def _batch(seed, m=M, n=N, b=B, alphabet=b"ACGT"):
    """Ragged pairs with an empty-x lane, an empty-y lane, one-symbol lanes,
    and lanes whose x holds a stretch of y (long matching runs, so S grows
    by the match score)."""
    rng = np.random.default_rng(seed)
    syms = np.frombuffer(alphabet, np.uint8)
    xb = syms[rng.integers(0, len(syms), size=(b, m))]
    yb = syms[rng.integers(0, len(syms), size=(b, n))]
    mlens = rng.integers(m // 2, m + 1, size=b).astype(np.int32)
    nlens = rng.integers(n // 2, n + 1, size=b).astype(np.int32)
    mlens[:4] = [m, 0, m, 1]
    nlens[:4] = [n, n, 0, 1]
    for k in range(4, b):
        xb[k, 2 : m - 2] = yb[k, 3 : m - 1]
    return xb, yb, mlens, nlens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _column0_i(go, ge, xcp, X):
    """Column 0's I in wrapping int32: MIN_SCORE, go, then the better of
    the gap and the x-prefix clip."""
    rows = np.arange(X, dtype=np.int64)
    i0 = np.maximum(_wrap(go + _wrap(ge * (rows - 1))), _wrap(xcp + go))
    i0[: min(X, 2)] = [MIN, go][: min(X, 2)]
    return i0.astype(np.int32)


def _assert_cells(got, want, mlens, nlens, first, what):
    """(n, X, B) cells of columns ``first``..nlens (index j - first) and rows
    0..mlens."""
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    for b in range(len(mlens)):
        m, n = mlens[b], nlens[b]
        c = n + 1 - first
        np.testing.assert_array_equal(got[:c, : m + 1, b], want[:c, : m + 1, b], err_msg=f"{what} lane {b}")


def _assert_finals(got, want, mlens, nlens, i0=None):
    """(B, X) finals S, I, Sn, Ly, tbk over rows 0..mlens; the final I of an
    empty-y lane against ``i0`` (when given)."""
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g).astype(np.int32), np.asarray(w).astype(np.int32)
        for b in range(len(mlens)):
            m = mlens[b]
            ref = i0 if k == 1 and nlens[b] == 0 and i0 is not None else w[b]
            if k == 1 and nlens[b] == 0 and i0 is None:
                continue
            np.testing.assert_array_equal(g[b, : m + 1], ref[: m + 1], err_msg=f"final {k} lane {b}")


def _wraps(*values):
    """True when a value passed int32 on the way: the case reaches overflow."""
    return any(np.any(np.asarray(v, np.int64) != _wrap(v)) for v in values)


@pytest.mark.parametrize("case", MP_CASES, ids=_id)
def test_k1_and_k3_plain_match_pallas_under_wrap(case):
    go, ge, ma, mi = case
    xb, yb, mlens, nlens = _batch(1 + abs(ge) % 97)
    assert _wraps(M * np.int64(ge), M * np.int64(ma))
    pens8 = np.array([go, ge, MIN, MIN, MIN, MIN, ma, mi], np.int32)
    js, jtb, jtbk = sw_pallas.scan_global_pallas_mp(*(jnp.asarray(a) for a in (xb, yb, mlens, nlens, pens8)), runs="ins")
    score, tb, tbk = sw.scan_global(*_torch(xb, yb, mlens, nlens), go, ge, ma, mi)
    np.testing.assert_array_equal(score.numpy(), np.asarray(js))
    _assert_cells(tb, np.asarray(jtb)[:N], mlens, nlens, 1, "K1 tb")
    _assert_finals([tbk], [np.asarray(jtbk)], mlens, nlens)
    # K3 takes whole 128-lane blocks: the batch 16 times over
    rep = [np.tile(a, (16,) + (1,) * (a.ndim - 1)) for a in (xb, yb, mlens, nlens)]
    want = sw_pallas.sw_scores_global_matchparams(*(jnp.asarray(a) for a in rep), ma, mi, go, ge, block_b=128)
    got = sw.scores_global(*_torch(*rep), go, ge, ma, mi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ycp,ycs", [(0, 0), (-W, -3 * W), (-(2**30), -(2**30))])
@pytest.mark.parametrize("case", MP_CASES[:2], ids=_id)
def test_k5_plain_matches_pallas_under_wrap(case, ycp, ycs):
    go, ge, ma, mi = case
    xb, yb, mlens, nlens = _batch(2 + abs(ycs) % 89)
    pens8 = np.array([go, ge, MIN, MIN, ycp, ycs, ma, mi], np.int32)
    want = sw_pallas.scan_semiglobal_pallas_mp(*(jnp.asarray(a) for a in (xb, yb, mlens, nlens, pens8)), runs="ins")
    got = sw.scan_semiglobal(*_torch(xb, yb, mlens, nlens), go, ge, ma, mi, ycp, ycs)
    _assert_cells(got[0], np.asarray(want[0])[:N], mlens, nlens, 1, "K5 tb")
    _assert_finals(got[1:], want[1:], mlens, nlens)


@pytest.mark.parametrize("case", CLIP_CASES, ids=_id)
def test_k7_and_k9_plain_match_pallas_under_wrap(case):
    go, ge, clips = case
    ma, mi = 2 * W, -2 * W
    xb, yb, mlens, nlens = _batch(3 + abs(clips[0]) % 83)
    pens8 = np.array([go, ge, *clips, ma, mi], np.int32)
    local = clips == (0, 0, 0, 0)
    # at clips 0 against the custom kernel: the JAX local kernel's column 0
    # and row 0 take S = 0 and D = go as given, which a wrapped gap sum
    # breaks (ROADMAP Queue 3), as at go = ge = 0 (test_torch_custom.py)
    want = sw_pallas.scan_custom_pallas_mp(*(jnp.asarray(a) for a in (xb, yb, mlens, nlens, pens8)), runs="ins")
    args = _torch(xb, yb, mlens, nlens)
    got = sw.scan_local(*args, go, ge, ma, mi) if local else sw.scan_custom(*args, go, ge, ma, mi, *clips)
    _assert_cells(got[0], np.asarray(want[0])[: N + 1], mlens, nlens, 0, "tb")
    for b in range(B):
        np.testing.assert_array_equal(got[1][: nlens[b] + 1, b].numpy(), np.asarray(want[1])[: nlens[b] + 1, b])
    _assert_finals(got[2:], want[2:], mlens, nlens, i0=_column0_i(go, ge, clips[0], M + 1))


def _big_lut(seed):
    return np.random.default_rng(seed).integers(-(2**27), 2**27, size=(256, 256)).astype(np.int32)


@pytest.mark.parametrize("case", LUT_CASES, ids=_id)
def test_k11_and_k12_plain_match_pallas_under_wrap(case):
    from rust_bio_tpu_torch import scores

    go, ge, table = case
    m, n = 24, 28
    xb, yb, mlens, nlens = _batch(4, m, n, 16, b"ARNDCQEGHILKMFPSTWYV")
    lut = _big_lut(5) if table == "big" else scores.dense_matrix("blosum62")
    subs2 = sw.subs2_stream_plain(*_torch(xb, yb, lut)).numpy()
    j2 = jnp.asarray(subs2)
    jm, jn = jnp.asarray(mlens), jnp.asarray(nlens)
    ws, wtb, wtbk = sw_pallas.scan_global_pallas_subs(
        j2, jm, jn, jnp.asarray([go, ge, MIN, MIN, MIN, MIN], jnp.int32), runs="ins"
    )
    args = _torch(xb, yb, mlens, nlens)
    score, tb, tbk = sw.scan_global_lut(*args, go, ge, torch.from_numpy(lut))
    np.testing.assert_array_equal(score.numpy(), np.asarray(ws))
    _assert_cells(tb, np.asarray(wtb)[:n], mlens, nlens, 1, "K11 tb")
    _assert_finals([tbk], [np.asarray(wtbk)], mlens, nlens)
    ycp, ycs = -(2**28), -(2**29)
    want = sw_pallas.scan_semiglobal_pallas_subs(j2, jm, jn, jnp.asarray([go, ge, MIN, MIN, ycp, ycs], jnp.int32), runs="ins")
    got = sw.scan_semiglobal_lut(*args, go, ge, torch.from_numpy(lut), ycp, ycs)
    _assert_cells(got[0], np.asarray(want[0])[:n], mlens, nlens, 1, "K12 tb")
    _assert_finals(got[1:], want[1:], mlens, nlens)


@pytest.mark.parametrize("case", MP_CASES, ids=_id)
def test_k13_plain_matches_pallas_rows_under_wrap(monkeypatch, case):
    """16-row blocks of 8 columns on the JAX side, seams every 16 rows in
    the port's cells."""
    go, ge, ma, mi = case
    rb, m, n = 16, 45, 50
    xb, yb, mlens, nlens = _batch(6 + abs(go) % 79, m, n)
    monkeypatch.setattr(sw_pallas, "_pick_block_rows", lambda B_, M_, N_: (min(B_, 128), rb, 8, -(-N_ // 8) * 8))
    pens8 = np.array([go, ge, MIN, MIN, MIN, MIN, ma, mi], np.int32)
    js, jtb, _ = sw_pallas.scan_global_rows_pallas_mp(*(jnp.asarray(a) for a in (xb, yb, mlens, nlens, pens8)))
    score, tb = sw.scan_global_rows(*_torch(xb, yb, mlens, nlens), go, ge, ma, mi, rb=rb)
    np.testing.assert_array_equal(score.numpy(), np.asarray(js))
    _assert_cells(tb, np.asarray(jtb)[:n], mlens, nlens, 1, "K13 tb")


@pytest.mark.parametrize("case", CLIP_CASES, ids=_id)
def test_k15_plain_matches_pallas_under_wrap(case):
    go, ge, clips = case
    ma, mi = 2 * W, -2 * W
    xb, yb, mlens, nlens = _batch(7 + abs(clips[1]) % 73, M, N)
    lut = np.full((256, 256), mi, np.int32)
    np.fill_diagonal(lut, ma)
    pens8 = np.array([go, ge, *clips, ma, mi], np.int32)
    scan, tb_col0, Lx0, *_ = _jax_columns(*(jnp.asarray(a) for a in (xb, yb, mlens, nlens, pens8, lut)), engine="pallas")
    S_f, I_f, Sn_f, Ly_f, tb_f, tb_cols, Lx_cols = (np.asarray(v) for v in scan)
    want_tb = np.concatenate([np.asarray(tb_col0)[None].astype(np.int32), tb_cols[:N].astype(np.int32) & 0xFFF])
    want_lx = np.concatenate([np.asarray(Lx0)[None], Lx_cols[:N]])
    got = sw.scan_columns(*_torch(xb, yb, mlens, nlens), go, ge, ma, mi, *clips)
    _assert_cells(got[0], want_tb.transpose(0, 2, 1), mlens, nlens, 0, "K15 tb")
    for b in range(B):
        np.testing.assert_array_equal(got[1][: nlens[b] + 1, b].numpy(), want_lx[: nlens[b] + 1, b])
    _assert_finals(got[2:], (S_f, I_f, Sn_f, Ly_f, tb_f), mlens, nlens, i0=_column0_i(go, ge, clips[0], M + 1))


# ---- global alignment's engine where int32 wraps: the port routes by padded M ----

# the smallest input of the departure: M = 424, N = 434, scores whose sums
# wrap int32. Alone in its batch (padded M + 1 = 425 < T_ROWS) it runs K1;
# beside a 700 bp pair (padded M + 1 = 691) K13 with 128-row seams. The JAX
# package leaves K1 for its block-row engine here by its VMEM model
# (``transposed_feasible``, ``_pick_block_rows``), which the port does not
# carry: its answer depends on the batch's padded M, as the JAX package's
# depends on its padded shape.
Q3_PENS = (-(2**30), -(2**29), 2**30, -(2**30))


def _q3_pairs():
    y = np.random.default_rng(1).choice(list(b"ACGT"), size=434).astype(np.uint8).tobytes()
    y2 = np.random.default_rng(2).choice(list(b"ACGT"), size=700).astype(np.uint8).tobytes()
    return (y[5:429], y), (y2[:690], y2)


def _port_global(pens, pairs):
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring

    return BatchAligner(Scoring.from_scores(*pens), device="cpu").global_([p[0] for p in pairs], [p[1] for p in pairs])


def test_global_wrap_alone_takes_k1_and_parts_from_jax():
    """Alone, the M = 424 pair takes K1 (padded M + 1 below ``T_ROWS``):
    score 1,825,361,101 and 616 operations. The JAX package, computed here,
    takes its block-row engine: 1,610,612,736 and 705. The port keeps its
    own routing (pinned)."""
    from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
    from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
    from rust_bio_tpu_torch.alignment.pairwise.batched import T_ROWS

    (x, y), _ = _q3_pairs()
    assert len(x) + 1 < T_ROWS
    got = _port_global(Q3_PENS, [(x, y)])[0]
    jax = JaxBatchAligner(JaxScoring.from_scores(*Q3_PENS)).global_([x], [y])[0]
    assert (got.score, len(got.operations)) == (1_825_361_101, 616)
    assert (jax.score, len(jax.operations)) == (1_610_612_736, 705)


def test_global_wrap_beside_a_long_pair_takes_k13():
    """The same pair beside a 700 bp pair: the padded M + 1 = 691 passes
    ``T_ROWS`` and the batch runs K13, whose seams give 1,610,612,736 and
    705 operations for it (the JAX package's answer alone); the long pair
    its own."""
    pairs = _q3_pairs()
    got = _port_global(Q3_PENS, pairs)
    assert (got[0].score, len(got[0].operations)) == (1_610_612_736, 705)
    alone = _port_global(Q3_PENS, pairs[1:])[0]
    assert (got[1].score, got[1].operations) == (alone.score, alone.operations)


def test_global_without_wrap_does_not_depend_on_the_batch():
    """Under (-5, -1, 2, -2), where no sum wraps, both batches give the M =
    424 pair one answer (score 830), as the JAX package does."""
    pairs = _q3_pairs()
    alone = _port_global((-5, -1, 2, -2), pairs[:1])[0]
    beside = _port_global((-5, -1, 2, -2), pairs)[0]
    assert alone.score == beside.score == 830
    assert (alone.xstart, alone.xend, alone.ystart, alone.yend, alone.operations) == (
        beside.xstart, beside.xend, beside.ystart, beside.yend, beside.operations
    )
