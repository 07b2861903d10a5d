"""The port's compact CIGAR path against the JAX package on the CPU: the
plain K-merge (``ops.walk.merge_rle_plain``) against ``_merge_rle_device``
plus ``_pack_rle_merged`` on synthetic walk streams; the compact entry
points (``global_packed_compact_async_arrays``,
``semiglobal_packed_compact_async_arrays``, ``packed_compact_finish``,
``packed_compact_finish_many``, ``PackedMergedCigars``) against the JAX
compact path and the port's dense packed CIGARs, in the geometries of
tests/test_sw_pallas.py:946-1050; and the compact route's limits.
Integers and strings throughout: every comparison is exact (tolerance
0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.batched import _merge_rle_device, _pack_rle_merged
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
from rust_bio_tpu_torch.alignment.pairwise import batched
from rust_bio_tpu_torch.ops import walk
from rust_bio_tpu_torch.scores import blosum62

PENS = (-5, -1, 2, -2)


def _stream(rng, N, B, long_runs=False):
    """A synthetic walk stream: (ins_cnt, exit_op, ins0, fix_ins, fix_exit,
    nlens, score, xend), with dropped codes (0, a clip) among the exits and,
    with ``long_runs``, Ins runs past 4095."""
    counts = [0, 0, 0, 0, 1, 2, 5] + ([4095, 4096, 9000] if long_runs else [])
    ins_cnt = rng.choice(counts, size=(N, B)).astype(np.uint16)
    exit_op = rng.choice([0, 2, 3, 4, 4, 4, 4, 7], size=(N, B)).astype(np.uint16)
    ins0 = rng.choice([0, 0, 3, 5000] if long_runs else [0, 0, 3], size=B).astype(np.uint16)
    fix_ins = rng.integers(0, 3, size=B).astype(np.int32)
    fix_exit = rng.choice([0, 1, 3, 4, 7], size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    score = rng.integers(-(2**31), 2**31, size=B).astype(np.int32)
    xend = rng.integers(0, 200, size=B).astype(np.int32)
    return ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens, score, xend


def _jax_pack(ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens, score, xend, R):
    j = [jnp.asarray(a) for a in (ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens)]
    rk, rl, nr, ovf = _merge_rle_device(*j, R)
    B = len(score)
    return np.asarray(_pack_rle_merged(jnp.asarray(score), rk, rl, nr, ovf, jnp.zeros(B, jnp.int32), jnp.asarray(xend)))


def _port_pack(ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens, score, xend, R, semi=True):
    t = torch.from_numpy
    return walk.merge_rle(
        t(score), t(ins_cnt), t(exit_op), t(ins0), t(fix_ins) if semi else None, t(fix_exit) if semi else None,
        t(nlens), None, t(xend), R,
    )


@pytest.mark.parametrize("R", [1, 3, 8, 32])
@pytest.mark.parametrize("long_runs", [False, True])
def test_plain_merge_matches_jax(R, long_runs):
    """The plain K-merge's pack equals JAX's merge and pack bit for bit on
    synthetic streams, with runs past 4095 and R small enough that lanes
    overflow it; global mode's streams (fix fields None) as zeros."""
    rng = np.random.default_rng(100 * R + long_runs)
    stream = _stream(rng, 40, 64, long_runs)
    got = _port_pack(*stream, R)
    assert got.dtype == torch.uint16 and got.shape == (5 + R, 64)
    np.testing.assert_array_equal(got.numpy(), _jax_pack(*stream, R))
    ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens, score, xend = stream
    z = np.zeros_like(fix_ins)
    glob = _port_pack(ins_cnt, exit_op, ins0, z, z, nlens, score, xend, R, semi=False)
    np.testing.assert_array_equal(glob.numpy(), _jax_pack(ins_cnt, exit_op, ins0, z, z, nlens, score, xend, R))
    ovf = got.numpy()[4] >> 15
    assert ovf.any() and (R == 1 or not ovf.all())


def test_plain_merge_at_exactly_r_runs():
    """Lanes of exactly R and R + 1 runs, and a run of exactly 4095 and
    4096: the overflow flag sets on R + 1 runs and on 4096 alone."""
    R, N = 4, 8
    B = 4
    ins_cnt = np.zeros((N, B), np.uint16)
    exit_op = np.zeros((N, B), np.uint16)
    exit_op[:, :] = 4
    # lane 0: Match x2, Subst, Match x5 -> 3 runs; + Del -> 4 runs (= R)
    exit_op[2, 0] = 3
    exit_op[7, 0] = 2
    # lane 1: lane 0 + an Ins run after column 5 -> 5 runs (R + 1)
    exit_op[:, 1] = exit_op[:, 0]
    ins_cnt[5, 1] = 2
    # lanes 2, 3: one Ins run of 4095 / 4096 in ins0 then Matches
    ins0 = np.array([0, 0, 4095, 4096], np.uint16)
    nlens = np.full(B, N, np.int32)
    z = np.zeros(B, np.int32)
    score = np.array([1, -1, 7, -(2**31)], np.int32)
    xend = np.full(B, N, np.int32)
    stream = (ins_cnt, exit_op, ins0, z, z, nlens, score, xend)
    got = _port_pack(*stream, R).numpy()
    np.testing.assert_array_equal(got, _jax_pack(*stream, R))
    assert (got[4] & 0x7FFF).tolist() == [4, 6, 2, 2]
    assert (got[4] >> 15).tolist() == [0, 1, 0, 1]


def _corpus(rng, B, M, N, p):
    xb = rng.integers(0, 4, size=(B, M)).astype(np.uint8) + ord("A")
    yb = xb[:, :N].copy() if N <= M else np.concatenate([xb, xb[:, : N - M]], 1)
    mut = rng.random(size=(B, N)) < p
    yb[mut] = rng.integers(0, 4, size=int(mut.sum())).astype(np.uint8) + ord("A")
    return xb, yb


def _aligners(pens=PENS):
    return BatchAligner(Scoring.from_scores(*pens), device="cpu"), JaxBatchAligner(JaxScoring.from_scores(*pens))


@pytest.mark.parametrize("p", [0.02, 0.9])
@pytest.mark.parametrize("mode", ["global", "semiglobal"])
def test_compact_matches_jax_and_dense(mode, p):
    """B = 64, M = N = 96 at p = 0.02 (no overflow) and 0.9 (the dense
    re-run fires): scores, runs, overflow flags, the (5 + R, B) pack and
    the CIGARs equal the JAX compact path's, and the CIGARs the port's
    dense packed ones."""
    rng = np.random.default_rng(11 if p < 0.5 else 12)
    B, M, N = 64, 96, 96
    port, jax_ba = _aligners()
    xb, yb = _corpus(rng, B, M, N, p)
    mlens = np.full(B, M, np.int32)
    nlens = np.full(B, N, np.int32)
    handle = getattr(port, f"{mode}_packed_compact_async_arrays")(xb, yb, mlens, nlens)
    jhandle = getattr(jax_ba, f"{mode}_packed_compact_async_arrays")(xb, yb, mlens, nlens)
    np.testing.assert_array_equal(handle[0].numpy(), np.asarray(jhandle[0]))
    comp = BatchAligner.packed_compact_finish(handle)
    jcomp = JaxBatchAligner.packed_compact_finish(jhandle)
    np.testing.assert_array_equal(comp.score, np.asarray(jcomp.score))
    np.testing.assert_array_equal(comp.overflow, np.asarray(jcomp.overflow))
    np.testing.assert_array_equal(comp._up["n_runs"], jcomp._up["n_runs"])
    assert comp.cigars() == jcomp.cigars()
    dense = getattr(BatchAligner, f"{mode}_packed_finish")(getattr(port, f"{mode}_packed_async_arrays")(xb, yb, mlens, nlens))
    np.testing.assert_array_equal(comp.score, dense.score)
    assert comp.cigars() == dense.cigars()
    assert comp.overflow.any() == (p > 0.5)


def test_compact_variable_lengths():
    """Per-lane lengths (test_sw_pallas.py's variable-length case): columns
    past a lane's nlens leak no runs; both modes against JAX and the dense
    path."""
    rng = np.random.default_rng(13)
    B, M, N = 32, 80, 80
    port, jax_ba = _aligners((-4, -1, 1, -1))
    mlens = rng.integers(20, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(20, N + 1, size=B).astype(np.int32)
    xb = rng.integers(0, 4, size=(B, M)).astype(np.uint8) + ord("A")
    yb = np.zeros((B, N), np.uint8) + ord("A")
    for i in range(B):
        L = int(min(mlens[i], nlens[i]))
        yb[i, :L] = xb[i, :L]
    for mode in ("global", "semiglobal"):
        comp = BatchAligner.packed_compact_finish(getattr(port, f"{mode}_packed_compact_async_arrays")(xb, yb, mlens, nlens))
        jcomp = JaxBatchAligner.packed_compact_finish(getattr(jax_ba, f"{mode}_packed_compact_async_arrays")(xb, yb, mlens, nlens))
        dense = getattr(BatchAligner, f"{mode}_packed_finish")(getattr(port, f"{mode}_packed_async_arrays")(xb, yb, mlens, nlens))
        assert comp.cigars() == jcomp.cigars() == dense.cigars(), mode
        np.testing.assert_array_equal(comp.score, dense.score)


def test_finish_many_matches_single_and_jax():
    """``packed_compact_finish_many`` over three handles, one of which
    overflows into the dense re-run, equals finishing each alone and the
    JAX package's stacked finish."""
    rng = np.random.default_rng(17)
    B, M, N = 32, 64, 64
    port, jax_ba = _aligners()
    mlens = np.full(B, M, np.int32)
    nlens = np.full(B, N, np.int32)
    batches = [_corpus(rng, B, M, N, p) for p in (0.02, 0.05, 0.9)]
    many = BatchAligner.packed_compact_finish_many(
        [port.global_packed_compact_async_arrays(xb, yb, mlens, nlens) for xb, yb in batches]
    )
    jmany = JaxBatchAligner.packed_compact_finish_many(
        [jax_ba.global_packed_compact_async_arrays(xb, yb, mlens, nlens) for xb, yb in batches]
    )
    assert [m.overflow.any() for m in many] == [False, False, True]
    for k, (xb, yb) in enumerate(batches):
        single = BatchAligner.packed_compact_finish(port.global_packed_compact_async_arrays(xb, yb, mlens, nlens))
        np.testing.assert_array_equal(many[k].score, single.score)
        np.testing.assert_array_equal(many[k].score, np.asarray(jmany[k].score))
        assert many[k].cigars() == single.cigars() == jmany[k].cigars()
    assert BatchAligner.packed_compact_finish_many([]) == []


def test_finish_many_rejects_mixed_shapes():
    """Handles of different (5 + R, B) shapes raise ``ValueError``."""
    rng = np.random.default_rng(19)
    port, _ = _aligners()
    a = _corpus(rng, 8, 30, 30, 0.02)
    b = _corpus(rng, 16, 30, 30, 0.02)
    h = [
        port.global_packed_compact_async_arrays(*a, np.full(8, 30, np.int32), np.full(8, 30, np.int32)),
        port.global_packed_compact_async_arrays(*b, np.full(16, 30, np.int32), np.full(16, 30, np.int32)),
    ]
    with pytest.raises(ValueError, match="different shapes"):
        BatchAligner.packed_compact_finish_many(h)
    h2 = [h[0], port.global_packed_compact_async_arrays(*a, np.full(8, 30, np.int32), np.full(8, 30, np.int32), max_runs=8)]
    with pytest.raises(ValueError, match="different shapes"):
        BatchAligner.packed_compact_finish_many(h2)


def test_compact_outside_its_route_raises():
    """Compact calls outside K1 (padded M + 1 < T_ROWS) and K5 (M + 1 <
    4096) with MatchParams raise ``ValueError``: a substitution matrix, a
    long global x, a semiglobal x past the 12-bit packs."""
    rng = np.random.default_rng(23)
    lut = BatchAligner(Scoring.new(-11, -1, blosum62), device="cpu")
    xb, yb = _corpus(rng, 4, 30, 30, 0.02)
    ml = np.full(4, 30, np.int32)
    for mode in ("global", "semiglobal"):
        with pytest.raises(ValueError, match="MatchParams"):
            getattr(lut, f"{mode}_packed_compact_async_arrays")(xb, yb, ml, ml)
    port, _ = _aligners()
    M = batched.T_ROWS - 1
    xl, yl = _corpus(rng, 2, M, 40, 0.02)
    with pytest.raises(ValueError, match="T_ROWS"):
        port.global_packed_compact_async_arrays(xl, yl, np.full(2, M, np.int32), np.full(2, 40, np.int32))
    xw = np.full((1, 4095), ord("A"), np.uint8)
    with pytest.raises(ValueError, match="4096"):
        port.semiglobal_packed_compact_async_arrays(xw, xw[:, :10], np.array([4095], np.int32), np.array([10], np.int32))
    # just inside the global route: M + 1 = T_ROWS - 1
    xi, yi = _corpus(rng, 2, M - 1, 20, 0.0)
    comp = BatchAligner.packed_compact_finish(
        port.global_packed_compact_async_arrays(xi, yi, np.full(2, M - 1, np.int32), np.full(2, 20, np.int32))
    )
    dense = port.global_packed(list(map(bytes, xi)), list(map(bytes, yi)))
    assert comp.cigars() == dense.cigars()
