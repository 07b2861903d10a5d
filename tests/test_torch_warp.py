"""K11, K7-LUT and K9-LUT (``ops/csrc/sw_warp.cu``: one warp a pair over
row stripes, a pair-major tb) and the walks that read that tb, on the CPU.

``warp_geometry``, the launch the wrappers size their scratch with (K18's
two layers too); the
plain K2, K8, K10 and ``local_entry`` on a pair-major view of the CPU scan's
tb against the same on the contiguous tb, for global and local protein
pairs of 0-40 residues under BLOSUM62 (mlens = 0 and nlens = 0 lanes, and
go + ge = 0, which walks K7-LUT's tb with K10), and K10 on K9-LUT's tb under
custom clips; the layout check the walks share; and
``BatchAligner(device="cpu")`` under BLOSUM62 (global, local, custom)
against the JAX ``BatchAligner``. Integers throughout: every comparison is exact
(tolerance 0). The kernels themselves run in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from rust_bio_tpu import scores as jax_scores
from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.scoring import MIN_SCORE as JAX_MIN
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu_torch import scores
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
from rust_bio_tpu_torch.alignment.pairwise.batched import _geometry, _suffix_fixups
from rust_bio_tpu_torch.ops import sw, walk

AA = b"ARNDCQEGHILKMFPSTWYV"
B, M, N = 12, 40, 36
PENS = [(-11, -1), (0, 0), (-5, -3)]
MIN = JAX_MIN
# (xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix): semiglobal,
# BWA-MEM's soft clips with y's ends free, and MIN_SCORE, 0 and negative
# clips mixed
CLIPS = [(MIN, MIN, 0, 0), (-5, -5, 0, 0), (MIN, 0, -1, MIN), (-7, -1, -3, -7), (0, MIN, -20, 0)]


@pytest.mark.parametrize("layers", [sw.SCORE_WARP_LAYERS, sw.GLOBAL_WARP_LAYERS, sw.LOCAL_WARP_LAYERS])
@pytest.mark.parametrize("m", [0, 1, 255, 256, 450, 604, 4094, 4978])
def test_warp_geometry_covers_every_row_once(m, layers):
    """32 stripes of R rows cover rows 0..M, R a multiple of 8 and the
    least such; the state stays in shared memory while the warp's slice
    (x bytes and row state) fits ``WARP_SHARED_MAX``."""
    R, placement, smem = sw.warp_geometry(m, layers)
    assert R % 8 == 0 and 32 * R >= m + 1 > 32 * (R - 8)
    state = layers * R * 32 * 4
    assert placement == ("shared" if 32 * R + state <= sw.WARP_SHARED_MAX else "scratch")
    assert smem == 32 * R + (state if placement == "shared" else 0)


def test_warp_geometry_at_the_homolog_corpus_and_the_longest_x():
    """R = 16 at M = 450 (6,656 and 10,752 bytes a warp), 24 at K11's
    largest M (604), 128 at K7-LUT's (4,094), where its state leaves shared
    memory; lowering the budget moves it to the (B, layers, R, 32) scratch."""
    assert sw.warp_geometry(450, 3) == (16, "shared", 6656)
    assert sw.warp_geometry(450, 5) == (16, "shared", 10_752)
    assert sw.warp_geometry(604, 3) == (24, "shared", 9984)
    assert sw.warp_geometry(4094, 5) == (128, "scratch", 4096)
    assert sw._warp_scratch(5, 3, 450, "cpu") is None


def test_k18_warp_geometry_at_the_homolog_corpus_and_the_long_proteins():
    """K18's two layers (S, D): R = 16 at M = 450, 4,608 bytes a warp in
    shared memory; R = 160 at the long proteins' M = 4,978, 46,080 bytes a
    warp, within K18's budget (a quarter of a block's shared memory) and
    over K11's, under which the 40,960 bytes of state go to the (B, 2,
    160, 32) scratch and x's 5,120 bytes stay; K18's shared slice ends at
    R = 200 (M = 6,399)."""
    k18 = (sw.SCORE_WARP_LAYERS, sw.SCORE_WARP_SHARED_MAX)
    assert sw.SCORE_WARP_SHARED_MAX == 58_112
    assert sw.warp_geometry(450, *k18) == (16, "shared", 4608)
    assert sw._warp_scratch(k18[0], 5, 450, "cpu", k18[1]) is None
    assert sw.warp_geometry(4978, *k18) == (160, "shared", 46_080)
    assert sw._warp_scratch(k18[0], 5, 4978, "cpu", k18[1]) is None
    assert sw.warp_geometry(6399, *k18)[1] == "shared" and sw.warp_geometry(6400, *k18) == (208, "scratch", 6656)
    assert sw.warp_geometry(4978, sw.SCORE_WARP_LAYERS) == (160, "scratch", 5120)
    assert tuple(sw._warp_scratch(sw.SCORE_WARP_LAYERS, 5, 4978, "cpu").shape) == (5, 2, 160, 32)


def test_lowered_budget_moves_the_state_to_the_scratch(monkeypatch):
    _, _, smem = sw.warp_geometry(450, 3)
    monkeypatch.setattr(sw, "WARP_SHARED_MAX", smem - 1)
    assert sw.warp_geometry(450, 3) == (16, "scratch", 512)
    assert tuple(sw._warp_scratch(3, 7, 450, "cpu").shape) == (7, 3, 16, 32)


def _batch(seed):
    """Protein pairs of 0-40 residues: y a mutated copy of x in half the
    lanes (long alignments, Ins and Del runs), random in the rest; lanes
    with mlens 0, nlens 0 and both 1."""
    rng = np.random.default_rng(seed)
    aa = np.frombuffer(AA, np.uint8)
    xb = aa[rng.integers(0, 20, size=(B, M))]
    yb = aa[rng.integers(0, 20, size=(B, N))]
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    for b in range(4, B, 2):
        keep = rng.random(M) > 0.1
        y = xb[b][keep][: nlens[b]]
        yb[b, : y.size] = y
    mlens[:4] = [M, 0, M, 1]
    nlens[:4] = [N, N, 0, 1]
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (xb, yb, mlens, nlens)]


def _pair_major(tb, pad):
    """The cells of a contiguous (C, X, B) tb held as K11 and K7-LUT hold
    them on the card: a (B, C, Xp) tensor, Xp = X rounded up to 8 plus
    ``pad``, the rest filled with junk, returned as its (C, X, B) view."""
    C, X, Bq = tb.shape
    Xp = -(-X // 8) * 8 + pad
    store = torch.full((Bq, C, Xp), 0x7A5C, dtype=torch.uint16)
    store[:, :, :X] = tb.permute(2, 0, 1)
    view = store[:, :, :X].permute(1, 2, 0)
    assert not view.is_contiguous() and walk._walk_strides(view) == (Xp, 1, C * Xp)
    return view


def _lut():
    return torch.from_numpy(scores.dense_matrix("blosum62"))


@pytest.mark.parametrize("pad", [0, 8])
@pytest.mark.parametrize("go,ge", PENS)
def test_global_walk_reads_the_pair_major_view(go, ge, pad):
    """K2 (plain) on K11's cells as the pair-major view equals K2 on the
    contiguous tb."""
    args = _batch(10 + pad)
    _, tb, _ = sw.scan_global_lut(*args, go, ge, _lut())
    want = walk.sweep_walk_global(tb, args[2], args[3])
    for g, w in zip(walk.sweep_walk_global(_pair_major(tb, pad), args[2], args[3]), want):
        assert torch.equal(g, w)


def _clip_walk_inputs(scan, ml, nl, go, ge, clips=(0, 0, 0, 0)):
    """The fixed final column and x-suffix clip length of a local or custom
    scan (``BatchAligner._custom_device``'s steps)."""
    tb, lx, S_f, I_f, Sn_f, Ly_f, tbk = scan
    Bq, X = S_f.shape
    rows, row_ge1, mlens_c, is_row_m = _geometry(Bq, X - 1, ml)
    _, tb_fixed, Lx_n, lx_set = _suffix_fixups(
        S_f, I_f, Sn_f, tbk, Bq, X - 1, rows, row_ge1, ml, mlens_c, is_row_m, (go, ge, *clips)
    )
    tbfix = (tb_fixed.to(torch.int32) & 0xFFF) | (Ly_f << 12)
    return tbfix, torch.where(lx_set, Lx_n, lx.gather(0, nl.long()[None, :])[0])


@pytest.mark.parametrize("pad", [0, 8])
@pytest.mark.parametrize("go,ge", PENS)
def test_clip_walks_read_the_pair_major_view(go, ge, pad):
    """``local_entry``, K8 (where go + ge < 0) and K10 (plain) on K7-LUT's
    cells as the pair-major view equal the same on the contiguous tb."""
    args = _batch(20 + pad)
    ml, nl = args[2], args[3]
    scan = sw.scan_local_lut(*args, go, ge, _lut())
    tb, lx = scan[0], scan[1]
    tbfix, lx_n = _clip_walk_inputs(scan, ml, nl, go, ge)
    view = _pair_major(tb, pad)
    for g, w in zip(walk.local_entry(view, lx, tbfix, lx_n, ml, nl), walk.local_entry(tb, lx, tbfix, lx_n, ml, nl)):
        assert torch.equal(g, w)
    fns = [walk.sweep_walk_custom] + ([walk.sweep_walk_local] if go + ge < 0 else [])
    for fn in fns:
        for g, w in zip(fn(view, tbfix, lx, lx_n, ml, nl), fn(tb, tbfix, lx, lx_n, ml, nl)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("pad", [0, 8])
@pytest.mark.parametrize("clips", CLIPS)
def test_custom_walk_reads_the_k9_lut_pair_major_view(clips, pad):
    """K10 (plain) on K9-LUT's cells (the plain scan under BLOSUM62) as the
    pair-major view equals K10 on the contiguous tb, under custom clips."""
    go, ge = -11, -1
    args = _batch(50 + pad + clips[2] % 7)
    ml, nl = args[2], args[3]
    scan = sw.scan_custom_lut(*args, go, ge, _lut(), *clips)
    tb, lx = scan[0], scan[1]
    tbfix, lx_n = _clip_walk_inputs(scan, ml, nl, go, ge, clips)
    view = _pair_major(tb, pad)
    got = walk.sweep_walk_custom(view, tbfix, lx, lx_n, ml, nl)
    for g, w in zip(got, walk.sweep_walk_custom(tb, tbfix, lx, lx_n, ml, nl)):
        assert torch.equal(g, w)


def test_walks_raise_on_layouts_they_do_not_take():
    """K2, K8 and K10 take a contiguous tb or a pair-major view; pairs
    inside the columns, rows of stride > 1 and overlapping columns raise."""
    args = _batch(30)
    ml, nl = args[2], args[3]
    scan = sw.scan_local_lut(*args, -11, -1, _lut())
    tb, lx = scan[0], scan[1]
    tbfix, lx_n = _clip_walk_inputs(scan, ml, nl, -11, -1)
    C, X, _ = tb.shape
    pairs_inside_columns = tb.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    rows_strided = torch.zeros((C, 2 * X, B), dtype=torch.uint16)[:, ::2]
    overlapping = torch.zeros(B * C * X, dtype=torch.uint16).as_strided((C, X, B), (4, 1, C * X))
    for bad in (pairs_inside_columns, rows_strided, overlapping):
        for fn in (walk.sweep_walk_local, walk.sweep_walk_custom):
            with pytest.raises(ValueError, match="strides"):
                fn(bad, tbfix, lx, lx_n, ml, nl)
        with pytest.raises(ValueError, match="strides"):
            walk.sweep_walk_global(bad[1:], ml, torch.clamp(nl, max=C - 1))


def _homologs(seed, n, m_max=40):
    """Ragged protein pairs: x random, y x at 30% substitutions with 5% of
    its residues dropped and 5% inserted. Pair 0 has the longest x."""
    rng = np.random.default_rng(seed)
    aa = np.frombuffer(AA, np.uint8)
    xs, ys = [], []
    for k in range(n):
        x = aa[rng.integers(0, 20, size=m_max if k == 0 else int(rng.integers(1, m_max + 1)))]
        y = x.copy()
        mut = rng.random(y.size) < 0.3
        y[mut] = aa[rng.integers(0, 20, size=int(mut.sum()))]
        y = y[rng.random(y.size) >= 0.05]
        ins = rng.random(y.size) < 0.05
        y = np.insert(y, np.nonzero(ins)[0], aa[rng.integers(0, 20, size=int(ins.sum()))])
        xs.append(x.tobytes())
        ys.append(y.tobytes() or b"A")
    return xs, ys


def _fields(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, [str(o) for o in a.operations])


@pytest.mark.parametrize("go,ge", PENS)
def test_blosum62_global_and_local_match_jax(go, ge):
    """``global_``, ``local`` and ``scores`` in both modes under BLOSUM62:
    the port's CPU path (K11 and K7-LUT's plain versions, K2, K8 or K10 on
    their tb) against the JAX ``BatchAligner``."""
    xs, ys = _homologs(40 - go, 9)
    port = BatchAligner(Scoring.new(go, ge, scores.blosum62), device="cpu")
    ref = JaxBatchAligner(JaxScoring.new(go, ge, jax_scores.blosum62))
    for fn, mode in (("global_", "global"), ("local", "local")):
        got = getattr(port, fn)(xs, ys)
        assert [_fields(a) for a in got] == [_fields(a) for a in getattr(ref, fn)(xs, ys)], mode
        got_s = port.scores(xs, ys, mode)
        np.testing.assert_array_equal(got_s, ref.scores(xs, ys, mode))
        np.testing.assert_array_equal(got_s, [a.score for a in got])


@pytest.mark.parametrize("clips", CLIPS)
def test_blosum62_custom_matches_jax(clips):
    """``custom`` and ``scores(..., "custom")`` under BLOSUM62 and custom
    clips: the port's CPU path (K9-LUT's plain version, the suffix fixups,
    K10) against the JAX ``BatchAligner``."""
    go, ge = -11, -1
    xs, ys = _homologs(60 + clips[3] % 11, 9)
    port = BatchAligner(Scoring(go, ge, scores.blosum62, None, *clips), device="cpu")
    ref = JaxBatchAligner(JaxScoring(go, ge, jax_scores.blosum62, None, *clips))
    got = port.custom(xs, ys)
    assert [_fields(a) for a in got] == [_fields(a) for a in ref.custom(xs, ys)]
    got_s = port.scores(xs, ys, "custom")
    np.testing.assert_array_equal(got_s, ref.scores(xs, ys, "custom"))
    np.testing.assert_array_equal(got_s, [a.score for a in got])
