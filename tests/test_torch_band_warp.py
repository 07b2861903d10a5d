"""K16 (``ops/csrc/sw_banded.cu``: one warp a pair over each column's band
rows) and K12 (``ops/csrc/sw_warp.cu``: one warp a pair over row stripes),
both with a pair-major tb, and the walks that read that tb, on the CPU.

``banded_geometry``, the launch K16's wrapper sizes its scratch with, and
the pair-major row pitch; the plain K16-walk and K6 on a pair-major view of
the CPU scans' tb against the same on the contiguous tb; the plain
K16-walk on a poisoned pair-major view of synthetic cells that step every
op code against the JAX ``_walk_banded``; the layout check
the two walks share; K12's score-only call; and ``BatchAligner(device=
"cpu")`` under BLOSUM62 in semiglobal mode and ``BatchBandedAligner(device=
"cpu")`` in its four modes against the JAX classes. Integers throughout:
every comparison is exact (tolerance 0). The kernels themselves run in
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu import scores as jax_scores
from rust_bio_tpu.alignment.pairwise import banded_device as jax_bd
from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu_torch import scores
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, BatchBandedAligner, Scoring
from rust_bio_tpu_torch.alignment.pairwise import banded_device as bd
from rust_bio_tpu_torch.alignment.pairwise.batched import _fixed_column
from rust_bio_tpu_torch.ops import sw, walk
from test_torch_cuda import _poisoned_view, _walk_cells, _walk_path

MIN = -858_993_459  # MIN_SCORE: a clip switched off
# the card tests' penalty sets (go, ge, xcp, xcs, ycp, ycs, match, mismatch):
# semiglobal, local, custom, global, and mixed clips
BANDED_PENS = [
    (-5, -1, MIN, MIN, 0, 0, 2, -2),
    (-5, -1, 0, 0, 0, 0, 2, -2),
    (-2, -2, -3, -7, -2, -5, 2, -2),
    (-4, -2, MIN, MIN, MIN, MIN, 1, -1),
    (-3, -1, -1, MIN, -7, 0, 2, -2),
]
AA = b"ARNDCQEGHILKMFPSTWYV"


def _bands(rng, B, M, N):
    """B DNA pairs with jittered-diagonal bands [starts, ends) (empty
    columns, row 0 in band in every third pair, row m out of band in every
    fourth), starts, ends <= mlens + 1. Torch (xb, yb, mlens, nlens, starts,
    ends)."""
    syms = np.frombuffer(b"ACGT", np.uint8)
    xb = syms[rng.integers(0, 4, size=(B, M))]
    yb = syms[rng.integers(0, 4, size=(B, N))]
    mlens = rng.integers(2, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(1, N + 1, size=B).astype(np.int32)
    mlens[0], nlens[0] = M, N
    xb[1:, 3:15] = yb[1:, 5:17]
    starts = np.zeros((B, N + 1), np.int32)
    ends = np.zeros((B, N + 1), np.int32)
    for b in range(B):
        m, n = int(mlens[b]), int(nlens[b])
        for j in range(N + 1):
            if rng.random() < 0.1:
                starts[b, j], ends[b, j] = m + 1, 0
                continue
            c = j * m // max(n, 1)
            w = int(rng.integers(1, 12))
            starts[b, j] = min(max(0, c - w + int(rng.integers(-3, 4))), m + 1)
            ends[b, j] = max(0, min(m + 1, c + w + int(rng.integers(-3, 4))))
        if b % 3 == 0:
            starts[b, :2] = 0
        if b % 4 == 3:
            ends[b] = np.minimum(ends[b], m - 1)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (xb, yb, mlens, nlens, starts, ends)]


def _pair_major_view(tb, Xp):
    """``tb`` (N, X, B) copied into a zeroed pair-major (B, N, Xp) tensor,
    returned as its (N, X, B) view: K16's and K12's layout on the card."""
    N, X, B = tb.shape
    pm = torch.zeros((B, N, Xp), dtype=tb.dtype)
    pm[:, :, :X] = tb.permute(2, 0, 1)
    view = pm[:, :, :X].permute(1, 2, 0)
    assert view.stride() == (Xp, 1, N * Xp) and torch.equal(view.to(torch.int32), tb.to(torch.int32))
    return view


@pytest.mark.parametrize("m", [0, 1, 150, 1000, 5600, 7263, 7264, 9000])
@pytest.mark.parametrize("pairs", [1, 128, 256, 2048, 8192, 40_000])
def test_banded_geometry_fits_a_block(m, pairs):
    """At most 8 warps (pairs) a block, each with 8 int32 layers of M + 1
    rows in shared memory up to ``BANDED_SHARED_MAX_M`` (within a block's
    232,448 bytes), else none; one warp a block while 132 SMs at 32 blocks
    hold every pair, more only past that."""
    warps, placement, smem = sw.banded_geometry(m, pairs, 132)
    per_pair = 8 * (m + 1) * 4
    assert 1 <= warps <= 8
    assert placement == ("shared" if m <= sw.BANDED_SHARED_MAX_M else "scratch")
    assert smem == (warps * per_pair if placement == "shared" else 0) and smem <= 232_448
    if pairs <= 32 * 132:
        assert warps == 1
    else:
        assert warps == min(8, -(-pairs // (32 * 132)), 232_448 // per_pair if placement == "shared" else 8)


def test_banded_geometry_at_the_aligner_corpora():
    """One pair a block at 150 bp, 1 kb and 5.6 kb (the STR pairs' 179 KB
    of state); M = 7,263 is the last x length whose state fits a block."""
    assert sw.banded_geometry(150, 2048) == (1, "shared", 4832)
    assert sw.banded_geometry(1000, 256) == (1, "shared", 32_032)
    assert sw.banded_geometry(5600, 128) == (1, "shared", 179_232)
    assert sw.banded_geometry(7263, 1) == (1, "shared", 232_448)
    assert sw.banded_geometry(7264, 1) == (1, "scratch", 0)
    assert sw.banded_geometry(150, 5000, 66) == (3, "shared", 3 * 4832)


@pytest.mark.parametrize("m", [0, 1, 6, 7, 8, 150, 1000, 5599])
def test_pair_major_pitch(m):
    """Xp: the least multiple of 8 that holds rows 0..M."""
    xp = sw.pair_major_pitch(m)
    assert xp % 8 == 0 and m + 1 <= xp < m + 9


@pytest.mark.parametrize("pens8", BANDED_PENS)
def test_banded_walk_on_pair_major_view_equals_contiguous(pens8):
    """The plain K16-walk on a pair-major view of the plain K16's tb, at
    Xp = M + 1 and M + 1 + 7, equals the walk on the contiguous tb."""
    xb, yb, ml, nl, st, en = _bands(np.random.default_rng(20 - pens8[0]), 10, 30, 36)
    scan = sw.scan_banded_plain(xb, yb, ml, nl, pens8, st, en)
    _, inputs = bd._walk_inputs(scan, ml, nl, pens8, st, en)
    want = walk.walk_banded(*inputs)
    X = inputs[0].shape[1]
    for Xp in (X, X + 7):
        got = walk.walk_banded(_pair_major_view(inputs[0], Xp), *inputs[1:])
        for g, w in zip(got, want):
            assert torch.equal(g.to(torch.int32), w.to(torch.int32))


@pytest.mark.parametrize("pens8", BANDED_PENS)
def test_banded_walk_plain_on_poisoned_view_matches_jax(pens8):
    """The plain K16-walk on a pair-major view whose padding rows hold
    0x0ABC (a cell no walk may read) against the JAX ``_walk_banded`` on
    synthetic cells (``_walk_cells``) that step every op code: both ending
    fixups, the four clips, starts at mlens 0, nlens 0 and both, Del runs
    along row 0, Ins runs down column 0 and column nlens; the contiguous tb
    gives the same steps."""
    rng = np.random.default_rng(30 - pens8[0])
    B, M, N = 24, 40, 46
    tb, tb0, tbfix, lx, ml, nl = _walk_cells(rng, B, M, N)
    tb_xb = np.concatenate([tb0.T.astype(np.uint16)[None], tb], axis=0).reshape(-1, B)
    pens = tuple(jnp.int32(v) for v in pens8[:6])
    want = jax_bd._walk_banded(jnp.asarray(tb_xb), *(jnp.asarray(a) for a in (tbfix, lx, ml, nl)), B, M, N, pens)
    t = [torch.from_numpy(a) for a in (tb, tb0, tbfix, lx, ml, nl)]
    got = walk.walk_banded(_poisoned_view(t[0]), *t[1:], pens8[:6])
    T = M + N + 8
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want["op_codes"])[:T])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want["op_lens"])[:T])
    for g, name in zip(got[2:], ("xstart", "ystart", "xend", "yend")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[name]), err_msg=name)
    for g, c in zip(got, walk.walk_banded(*t, pens8[:6])):
        assert torch.equal(g.to(torch.int32), c.to(torch.int32))
    codes, lens = got[0].numpy(), got[1].numpy()
    steps = [s for b in range(B) for s in _walk_path(codes[:, b], lens[:, b], ml[b], nl[b])]
    assert {c for _, _, c, _ in steps} == set(range(1, 9))
    assert min(min(i, j) for i, j, _, _ in steps) >= 0
    assert any(c == 2 and k == 0 and i == 0 for i, _, c, k in steps)  # a Del run along row 0
    assert any(c == 1 and k == 0 and j == n for b, n in enumerate(nl) for _, j, c, k in _walk_path(
        codes[:, b], lens[:, b], ml[b], n) if n)  # an Ins run down column nlens
    if pens8[2] == MIN:  # no x-prefix clip: an Ins run down column 0, the x fixup as Ins x i
        assert any(c == 1 and k == 0 and j == 0 for _, j, c, k in steps)
        assert any(c == 1 and k > 0 for _, _, c, k in steps)
    if pens8[4] == MIN:  # no y-prefix clip: the y fixup as Del x j
        assert any(c == 2 and k > 0 for _, _, c, k in steps)


def _lut_pairs(rng, B, M, N):
    aa = np.frombuffer(AA, np.uint8)
    xb = aa[rng.integers(0, 20, size=(B, M))]
    yb = aa[rng.integers(0, 20, size=(B, N))]
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:3], nlens[:3] = [M, 0, M], [N, N, 0]
    xb[3:, :10] = yb[3:, 2:12]
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (xb, yb, mlens, nlens)]


@pytest.mark.parametrize("ycp,ycs", [(0, 0), (-5, -3)])
def test_semiglobal_walk_on_pair_major_view_equals_contiguous(ycp, ycs):
    """The plain K6 on a pair-major view of the plain K12's tb (BLOSUM62),
    at Xp = M + 1 and M + 1 + 7, equals the walk on the contiguous tb."""
    args = _lut_pairs(np.random.default_rng(30 - ycp), 9, 28, 34)
    lut = torch.from_numpy(scores.dense_matrix("blosum62"))
    tb, *finals = sw.scan_semiglobal_lut(*args, -11, -1, lut, ycp, ycs)
    ml, nl = args[2], args[3]
    _, tbfix = _fixed_column(*finals, ml, -11, -1)
    want = walk.sweep_walk_semiglobal(tb, tbfix, ml, nl)
    for Xp in (tb.shape[1], tb.shape[1] + 7):
        got = walk.sweep_walk_semiglobal(_pair_major_view(tb, Xp), tbfix, ml, nl)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_banded_and_semiglobal_walks_check_the_layout():
    """``_check_banded_walk`` and ``_check_semi_walk`` take a contiguous tb
    and a pair-major view, and raise ``ValueError`` on a transposed or an
    overlapping layout."""
    C, X, B = 5, 9, 4
    tb = torch.zeros((C, X, B), dtype=torch.uint16)
    view = _pair_major_view(tb, 16)
    ml = torch.full((B,), X - 1, dtype=torch.int32)
    nl = torch.full((B,), C, dtype=torch.int32)
    tb0 = torch.zeros((B, X), dtype=torch.int32)
    lx = torch.zeros((B, C + 1), dtype=torch.int32)
    transposed = tb.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    overlapping = torch.zeros(B * C * X, dtype=torch.uint16).as_strided((C, X, B), (4, 1, C * X))
    for good in (tb, view):
        assert walk._check_banded_walk(good, tb0, tb0, lx, ml, nl).type == "cpu"
        assert walk._check_semi_walk(good, tb0, ml, nl).type == "cpu"
    for bad in (transposed, overlapping):
        with pytest.raises(ValueError, match="strides"):
            walk._check_banded_walk(bad, tb0, tb0, lx, ml, nl)
        with pytest.raises(ValueError, match="strides"):
            walk._check_semi_walk(bad, tb0, ml, nl)
    with pytest.raises(TypeError):
        walk._check_semi_walk(tb.to(torch.int16), tb0, ml, nl)


@pytest.mark.parametrize("ycp,ycs", [(0, 0), (-5, -3)])
def test_semiglobal_lut_score_only(ycp, ycs):
    """K12 with ``traceback=False`` returns no tb and the full call's
    finals."""
    args = _lut_pairs(np.random.default_rng(33), 7, 25, 30)
    lut = torch.from_numpy(scores.dense_matrix("blosum62"))
    full = sw.scan_semiglobal_lut(*args, -11, -1, lut, ycp, ycs)
    only = sw.scan_semiglobal_lut(*args, -11, -1, lut, ycp, ycs, traceback=False)
    assert only[0] is None and full[0] is not None
    for g, w in zip(only[1:], full[1:]):
        assert torch.equal(g, w)


def _fields(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, [str(o) for o in a.operations])


def _domains(seed, n):
    """Protein domains of 5-30 residues at 20% substitutions in proteins of
    30-60: the semiglobal corpus's shape at a small size."""
    rng = np.random.default_rng(seed)
    aa = np.frombuffer(AA, np.uint8)
    xs, ys = [], []
    for _ in range(n):
        y = aa[rng.integers(0, 20, size=int(rng.integers(30, 61)))]
        m = int(rng.integers(5, 31))
        s = int(rng.integers(0, len(y) - m + 1))
        x = y[s : s + m].copy()
        mut = rng.random(m) < 0.2
        x[mut] = aa[rng.integers(0, 20, size=int(mut.sum()))]
        xs.append(x.tobytes())
        ys.append(y.tobytes())
    return xs, ys


def test_blosum62_semiglobal_matches_jax():
    """``semiglobal`` and ``scores(..., "semiglobal")`` under BLOSUM62: the
    port's CPU path (the plain K12 and K6) against the JAX
    ``BatchAligner``, field for field."""
    xs, ys = _domains(35, 9)
    port = BatchAligner(Scoring.new(-11, -1, scores.blosum62), device="cpu")
    ref = JaxBatchAligner(JaxScoring.new(-11, -1, jax_scores.blosum62))
    got = port.semiglobal(xs, ys)
    assert [_fields(a) for a in got] == [_fields(a) for a in ref.semiglobal(xs, ys)]
    got_s = port.scores(xs, ys, "semiglobal")
    np.testing.assert_array_equal(got_s, ref.scores(xs, ys, "semiglobal"))
    np.testing.assert_array_equal(got_s, [a.score for a in got])


def _reads(seed, n):
    """Reads of 12-40 bp cut from 30-70 bp targets with a few
    substitutions."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    xs, ys = [], []
    for _ in range(n):
        y = acgt[rng.integers(0, 4, size=int(rng.integers(30, 71)))]
        m = int(rng.integers(12, 41))
        s = int(rng.integers(0, len(y) - m + 1))
        x = y[s : s + m].copy()
        sub = rng.random(m) < 0.06
        x[sub] = acgt[rng.integers(0, 4, size=int(sub.sum()))]
        xs.append(x.tobytes())
        ys.append(y.tobytes())
    return xs, ys


@pytest.mark.parametrize("mode", ["custom", "global_", "semiglobal", "local"])
def test_batch_banded_aligner_matches_jax_and_its_sub_batches(mode, monkeypatch):
    """``BatchBandedAligner(device="cpu")`` against the JAX one, whole and
    split into sub-batches by a budget of at least two lanes' dense tb at the
    pair-major pitch (and of one byte: a lane a sub-batch)."""
    xs, ys = _reads(40, 6)
    sc_args, clips = (-5, -1, 2, -2), (-3, -7, -2, -5)
    ours = BatchBandedAligner(Scoring.from_scores(*sc_args).with_clips(*clips), 6, 8, device="cpu")
    theirs = jax_bd.BatchBandedAligner(JaxScoring.from_scores(*sc_args).with_clips(*clips), 6, 8)
    want = [_fields(a) for a in getattr(theirs, mode)(xs, ys)]
    assert [_fields(a) for a in getattr(ours, mode)(xs, ys)] == want
    M = max(len(x) for x in xs)
    for budget in (2 * max(len(y) for y in ys) * sw.pair_major_pitch(M) * 2, 1):
        monkeypatch.setattr(bd, "TB_BUDGET_MAX", budget)
        assert [_fields(a) for a in getattr(ours, mode)(xs, ys)] == want
