"""The port's ``BatchAligner`` (global mode, MatchParams scoring) against the
JAX package's ``BatchAligner`` and its scalar oracle ``Aligner``: scores,
operations and coordinates must be identical."""

import numpy as np
import pytest
import torch

from rust_bio_tpu.alignment.pairwise import Aligner as JaxScalarAligner
from rust_bio_tpu.alignment.pairwise import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
from rust_bio_tpu_torch.alignment.pairwise.batched import (
    _decode_ops_colrle,
    _pack_rle,
    _unpack_rle,
)


def _random_pairs(rng, B, M, N, ragged=False):
    xs, ys = [], []
    for _ in range(B):
        m = int(rng.integers(0, M + 1)) if ragged else M
        n = int(rng.integers(0, N + 1)) if ragged else N
        xs.append(rng.choice(list(b"ACGT"), size=m).astype(np.uint8).tobytes())
        ys.append(rng.choice(list(b"ACGT"), size=n).astype(np.uint8).tobytes())
    return xs, ys


def _diverged_pairs(rng, B, L, rate=0.02):
    """y = x with ``rate`` substitutions (the high-identity corpus)."""
    xb = rng.choice(list(b"ACGT"), size=(B, L)).astype(np.uint8)
    yb = xb.copy()
    mut = rng.random(size=(B, L)) < rate
    yb[mut] = rng.choice(list(b"ACGT"), size=int(mut.sum())).astype(np.uint8)
    return [bytes(r) for r in xb], [bytes(r) for r in yb]


def _fields(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, list(a.operations))


CASES = [
    ("random150", 1), ("random150", 3), ("random150", 9),
    ("diverged150", 1), ("diverged150", 3), ("diverged150", 9),
    ("ragged", 1), ("ragged", 3), ("ragged", 9),
]


@pytest.mark.parametrize("corpus,B", CASES)
def test_global_matches_jax_and_scalar(corpus, B):
    rng = np.random.default_rng(B * 31 + len(corpus))
    if corpus == "random150":
        xs, ys = _random_pairs(rng, B, 150, 150)
    elif corpus == "diverged150":
        xs, ys = _diverged_pairs(rng, B, 150)
    else:
        xs, ys = _random_pairs(rng, B, 40, 45, ragged=True)
        xs[0], ys[0] = xs[0] or b"A", b""
    go, ge, ma, mi = -5, -1, 2, -2
    got = BatchAligner(Scoring.from_scores(go, ge, ma, mi), device="cpu").global_(xs, ys)
    jsc = JaxScoring.from_scores(go, ge, ma, mi)
    want = JaxBatchAligner(jsc).global_(xs, ys)
    scalar = JaxScalarAligner.with_scoring(jsc)
    assert len(got) == B
    for k, (g, w) in enumerate(zip(got, want)):
        assert _fields(g) == _fields(w), k
        if corpus != "random150" or k < 2:  # the scalar oracle is slow
            assert _fields(g) == _fields(scalar.global_(xs[k], ys[k])), k


@pytest.mark.parametrize("go,ge", [(-5, -1), (-2, -2), (-1, -1)])
def test_scores_global_matches_jax(go, ge):
    rng = np.random.default_rng(abs(go) + 5 * abs(ge))
    xs, ys = _random_pairs(rng, 11, 30, 26, ragged=True)
    sc = Scoring.from_scores(go, ge, 3, -1)
    got = BatchAligner(sc, device="cpu").scores(xs, ys, "global")
    want = JaxBatchAligner(JaxScoring.from_scores(go, ge, 3, -1)).scores(xs, ys, "global")
    np.testing.assert_array_equal(got, want)
    aligned = BatchAligner(sc, device="cpu").global_(xs, ys)
    np.testing.assert_array_equal(got, [a.score for a in aligned])


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(2)
    B, N = 5, 7
    i32 = torch.int32
    score = torch.tensor([-(2**31) + 3, -1, 0, 77, 2**31 - 1], dtype=i32)
    ins_cnt = torch.from_numpy(rng.integers(0, 4096, size=(N, B)).astype(np.int32)).to(torch.uint16)
    exit_op = torch.from_numpy(rng.integers(0, 5, size=(N, B)).astype(np.int32)).to(torch.uint16)
    ins0 = torch.from_numpy(rng.integers(0, 4096, size=B).astype(np.int32)).to(torch.uint16)
    z = torch.zeros(B, dtype=i32)
    ml = torch.arange(B, dtype=i32) + 10
    nl = torch.arange(B, dtype=i32) + 20
    packed = _pack_rle(score, ins_cnt, exit_op, ins0, z, z, z, z, z, ml, nl)
    assert packed.shape == (10 + N, B) and packed.dtype == torch.uint16
    s, up = _unpack_rle(packed.numpy())
    np.testing.assert_array_equal(s, score.numpy())
    np.testing.assert_array_equal(up["ins_cnt"], ins_cnt.to(i32).numpy())
    np.testing.assert_array_equal(up["exit_op"], exit_op.to(i32).numpy())
    np.testing.assert_array_equal(up["ins0"], ins0.to(i32).numpy())
    np.testing.assert_array_equal(up["xend"], ml.numpy())
    np.testing.assert_array_equal(up["yend"], nl.numpy())
    ops = _decode_ops_colrle(np.array([0, 2, 0]), np.array([4, 3, 2]), 1, 3)
    assert [o.kind for o in ops] == ["Ins", "Match", "Subst", "Ins", "Ins", "Del"]


def test_paths_at_4096_rows_match_the_oracle():
    """At M + 1 = 4096 semiglobal, local and custom mode (K15 and K15-walk)
    and ``scores(..., "local")`` equal the scalar oracle; ``semiglobal_packed``
    raises, its layout holding 12-bit Ins counts."""
    ba = BatchAligner(Scoring.from_scores(-5, -1, 2, -2), device="cpu")
    oracle = JaxScalarAligner.with_scoring(JaxScoring.from_scores(-5, -1, 2, -2))
    x, y = b"A" * 4095, b"A"
    for mode in ("semiglobal", "local", "custom"):
        assert _fields(getattr(ba, mode)([x], [y])[0]) == _fields(getattr(oracle, mode)(x, y)), mode
    assert ba.scores([x], [y], "local").tolist() == [oracle.local(x, y).score]
    with pytest.raises(ValueError, match="12 bits"):
        ba.semiglobal_packed([x], [y])
    # global mode at M + 1 = 4096 is ported (K13 + K14, the wide pack)
    assert _fields(ba.global_([x], [y])[0]) == _fields(oracle.global_(x, y))
    # LUT scorings (a callable here) are ported: the calls that raised
    # before return what the JAX package returns
    fn = lambda a, b: 1 if a == b else -1  # noqa: E731
    lut = BatchAligner(Scoring.new(-5, -1, fn), device="cpu")
    ref = JaxBatchAligner(JaxScoring.new(-5, -1, fn))
    xs, ys = [b"ACGT", b"GATTACA"], [b"ACGT", b"TACCA"]
    for mode in ("global_", "semiglobal", "local", "custom"):
        assert [_fields(a) for a in getattr(lut, mode)(xs, ys)] == [_fields(a) for a in getattr(ref, mode)(xs, ys)], mode
    np.testing.assert_array_equal(lut.scores(xs, ys, "custom"), ref.scores(xs, ys, "custom"))
    with pytest.raises(AssertionError):
        BatchAligner(Scoring.from_scores(-1, -5, 2, -2), device="cpu")


def test_scoring_clip_builders_match_jax():
    """``xclip``, ``yclip``, the one-sided builders and ``with_clips`` set
    the same four fields as the JAX package's builders."""
    def clips(sc):
        return (sc.gap_open, sc.gap_extend, sc.match_scores, sc.xclip_prefix, sc.xclip_suffix, sc.yclip_prefix, sc.yclip_suffix)

    port, jax_sc = Scoring.from_scores(-6, -1, 1, -4), JaxScoring.from_scores(-6, -1, 1, -4)
    assert clips(port) == clips(jax_sc)
    assert clips(port.xclip(-5).yclip(0)) == clips(jax_sc.xclip(-5).yclip(0))
    for name in ("xclip_prefix_", "xclip_suffix_", "yclip_prefix_", "yclip_suffix_"):
        assert clips(getattr(port, name)(-3)) == clips(getattr(jax_sc, name)(-3)), name
    assert clips(port.with_clips(-1, -2, -3, -4)) == clips(jax_sc.with_clips(-1, -2, -3, -4))
    assert clips(port.xclip(-5)) != clips(port)  # builders return a new Scoring
    with pytest.raises(AssertionError):
        port.xclip(1)
