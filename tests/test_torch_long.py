"""Long-sequence global alignment in the port: K13 (the block-row scan) and
K14 (the segmented walk) against the JAX package on the CPU.

Stage by stage, the plain versions against ``scan_global_rows_pallas_mp``
and ``_sweep_walk_global_seg`` in interpret mode on the same numpy-seeded
inputs, with 16-row blocks forced on both sides so a 45-row batch holds two
seams; and against K1 / K2 where the two engines must agree. End to end,
``BatchAligner.global_``, ``global_packed`` and ``scores(..., "global")`` at
M + 1 >= 4096 (the wide pack) against the scalar oracle and the JAX
``BatchAligner``, for MatchParams and BLOSUM62, and the block-row path
forced below 4096 against the K1 + K2 path. Integers throughout: every
comparison is exact (tolerance 0).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu import scores as jax_scores
from rust_bio_tpu.alignment.pairwise import Aligner as JaxScalarAligner
from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu.ops import sw_pallas
from rust_bio_tpu.ops.walk_pallas import _sweep_walk_global_seg
from rust_bio_tpu_torch import scores
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring, batched
from rust_bio_tpu_torch.alignment.pairwise.batched import (
    _pack_rle_wide,
    _unpack_rle_wide,
)
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE
from rust_bio_tpu_torch.alignment.pairwise.tb import TB_INS, TB_REREAD
from rust_bio_tpu_torch.ops import sw, walk

MA, MI = 2, -2
B, M, N, RB = 8, 45, 50, 16  # the stage tests' batch: rows 16 and 32 are seams
AA = b"ARNDCQEGHILKMFPSTWYV"


def _batch(seed):
    """Random DNA pairs with ragged lengths, including lengths 0 and 1."""
    rng = np.random.default_rng(seed)
    xb = rng.choice(list(b"ACGT"), size=(B, M)).astype(np.uint8)
    yb = rng.choice(list(b"ACGT"), size=(B, N)).astype(np.uint8)
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:4] = [M, 0, M, 1]
    nlens[:4] = [N, N, 0, 1]
    return xb, yb, mlens, nlens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _mp_lut():
    """The MatchParams scoring (2, -2) as a (256, 256) table."""
    lut = torch.full((256, 256), MI, dtype=torch.int32)
    lut.fill_diagonal_(MA)
    return lut


def _jax_rows(monkeypatch, xb, yb, mlens, nlens, go, ge):
    """``scan_global_rows_pallas_mp`` with 16-row blocks of 8 columns:
    (score (B,), tb (Np, RRB, B))."""
    monkeypatch.setattr(sw_pallas, "_pick_block_rows", lambda B_, M_, N_: (min(B_, 128), RB, 8, -(-N_ // 8) * 8))
    pens8 = np.array([go, ge, MIN_SCORE, MIN_SCORE, MIN_SCORE, MIN_SCORE, MA, MI], np.int32)
    score, tb, rrb = sw_pallas.scan_global_rows_pallas_mp(*(jnp.asarray(a) for a in (xb, yb, mlens, nlens, pens8)))
    assert rrb == 48
    return np.asarray(score), np.asarray(tb)


def _assert_defined_equal(tb, want, mlens, nlens):
    """(N, X, B) cells equal over columns 1..nlens[b] and rows 0..mlens[b]."""
    for b in range(tb.shape[2]):
        m, n = mlens[b], nlens[b]
        np.testing.assert_array_equal(tb[:n, : m + 1, b], want[:n, : m + 1, b], err_msg=f"pair {b}")


@pytest.mark.parametrize("go,ge,subst", [(-5, -1, "mp"), (-2, -2, "mp"), (-1, -1, "mp"), (-5, -1, "lut")])
def test_scan_global_rows_plain_matches_jax(monkeypatch, go, ge, subst):
    xb, yb, mlens, nlens = _batch(abs(go * 7 + ge))
    js, jtb = _jax_rows(monkeypatch, xb, yb, mlens, nlens, go, ge)
    args = _torch(xb, yb, mlens, nlens)
    if subst == "mp":
        score, tb = sw.scan_global_rows(*args, go, ge, MA, MI, rb=RB)
    else:
        score, tb = sw.scan_global_rows_lut(*args, go, ge, _mp_lut(), rb=RB)
    assert tb.shape == (N, M + 1, B) and tb.dtype == torch.uint16
    np.testing.assert_array_equal(score.numpy(), js)
    tb = tb.numpy()
    _assert_defined_equal(tb, jtb, mlens, nlens)
    # the seams hold both kinds of first-row i-bits, and no run nibble
    seam_bits = tb[:, [RB, 2 * RB], 0] & 0xF
    assert (seam_bits == TB_REREAD).any() and (seam_bits == TB_INS).any()
    assert not (tb[:, : M + 1, 0] >> 12).any()


@pytest.mark.parametrize("go,ge", [(-5, -1), (-1, -1)])
def test_scan_global_rows_at_one_block_is_k1_without_the_nibble(go, ge):
    xb, yb, mlens, nlens = _batch(20 + abs(go))
    args = _torch(xb, yb, mlens, nlens)
    ks, ktb, _ = sw.scan_global(*args, go, ge, MA, MI)
    for rb in (M + 1, 300):
        score, tb = sw.scan_global_rows(*args, go, ge, MA, MI, rb=rb)
        assert torch.equal(score, ks)
        _assert_defined_equal(tb.numpy(), (ktb.to(torch.int32) & 0xFFF).numpy(), mlens, nlens)
    # the LUT feeder under BLOSUM62 against K11's plain version
    lut = torch.from_numpy(scores.dense_matrix("blosum62"))
    ks, ktb, _ = sw.scan_global_lut(*args, go, ge, lut)
    score, tb = sw.scan_global_rows_lut(*args, go, ge, lut, rb=M + 1)
    assert torch.equal(score, ks)
    _assert_defined_equal(tb.numpy(), (ktb.to(torch.int32) & 0xFFF).numpy(), mlens, nlens)


@pytest.mark.parametrize("go,ge", [(-5, -1), (-2, -2)])
def test_seg_walk_plain_matches_jax(monkeypatch, go, ge):
    """K14 on the JAX block-row tb against ``_sweep_walk_global_seg``."""
    xb, yb, mlens, nlens = _batch(40 + abs(go))
    _, jtb = _jax_rows(monkeypatch, xb, yb, mlens, nlens, go, ge)
    want = [np.asarray(v) for v in _sweep_walk_global_seg(jnp.asarray(jtb), jnp.asarray(mlens), jnp.asarray(nlens))]
    tb, ml, nl = _torch(jtb[:N, : M + 1], mlens, nlens)
    got = walk.sweep_walk_global_seg(tb, ml, nl)
    assert all(g.dtype == torch.uint16 for g in got)
    np.testing.assert_array_equal(got[0].numpy(), want[0][:N])
    np.testing.assert_array_equal(got[1].numpy(), want[1][:N])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    # the port's own K13 tb walks to the same outputs
    _, ptb = sw.scan_global_rows(*_torch(xb, yb, mlens, nlens), go, ge, MA, MI, rb=RB)
    for g, w in zip(walk.sweep_walk_global_seg(ptb, ml, nl), got):
        assert torch.equal(g, w)


def test_seg_walk_on_k1_tb_equals_k2():
    """On K1's tb with the run nibble cleared (no seams) K14 gives K2's
    outputs on the full tb; runs longer than 15 cells included."""
    rng = np.random.default_rng(5)
    Bq, Mq, Nq = 12, 70, 9
    xb = rng.choice(list(b"ACGT"), size=(Bq, Mq)).astype(np.uint8)
    yb = rng.choice(list(b"ACGT"), size=(Bq, Nq)).astype(np.uint8)
    mlens = rng.integers(0, Mq + 1, size=Bq).astype(np.int32)
    nlens = rng.integers(0, Nq + 1, size=Bq).astype(np.int32)
    args = _torch(xb, yb, mlens, nlens)
    _, tb, _ = sw.scan_global(*args, -5, -1, MA, MI)
    want = walk.sweep_walk_global(tb, args[2], args[3])
    assert int(want[0].to(torch.int32).max()) > 15
    got = walk.sweep_walk_global_seg((tb.to(torch.int32) & 0xFFF).to(torch.uint16), args[2], args[3])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "m", sorted({605, 606, 4095, 5588, sw.ROWS_SHARED_MAX_M, sw.ROWS_SHARED_MAX_M + 1, 16383, 65534})
)
def test_rows_geometry_covers_every_row_once(m):
    """K13's launch (csrc/sw_global_rows.cu): the stripes [t * R, t * R + R)
    of T threads own each row 0..M exactly once, T is a multiple of 32
    within the 1,024 threads of a block, R a multiple of 8 (a thread's
    16-byte tb stores), and the dynamic shared memory fits a block's
    232,448 bytes; the row state leaves it above ``ROWS_SHARED_MAX_M``."""
    T, R, placement, smem = sw.rows_geometry(m)
    owned = np.zeros(m + 1, np.int64)
    for t in range(T):
        owned[t * R : t * R + R] += 1
    assert (owned == 1).all()
    assert T % 32 == 0 and 32 <= T <= 1024 and R % 8 == 0 and R >= 8
    assert smem <= 232_448
    assert placement == ("shared" if m <= sw.ROWS_SHARED_MAX_M else "scratch")
    # shared: the carries, x's bytes and three int32 layers of row state
    state = 3 * R * T * 4 if placement == "shared" else 0
    assert smem == 2 * 4 * T * 4 + R * T + state


def test_rows_shared_max_m_is_the_largest_that_fits(monkeypatch):
    """At ``ROWS_SHARED_MAX_M`` K13's row state fits shared memory; one more
    row, and it would not."""
    assert sw.rows_geometry(sw.ROWS_SHARED_MAX_M)[2:] == ("shared", 221_184)
    limit = sw.ROWS_SHARED_MAX_M + 1
    monkeypatch.setattr(sw, "ROWS_SHARED_MAX_M", limit)
    assert sw.rows_geometry(limit)[3] > 232_448


def _pair_major(tb, pad):
    """The cells of a contiguous (N, X, B) tb held as K13 holds them on the
    card: a (B, N, X + pad) tensor, the pad filled with junk, returned as
    its (N, X, B) view."""
    N, X, B = tb.shape
    store = torch.full((B, N, X + pad), 0x7A5C, dtype=torch.uint16)
    store[:, :, :X] = tb.permute(2, 0, 1)
    return store[:, :, :X].permute(1, 2, 0)


@pytest.mark.parametrize("pad", [0, 3, 8])
def test_seg_walk_reads_the_pair_major_view(pad):
    """K14 on the cells of K13's tb (seams every 16 rows) held contiguous
    (N, X, B) and as the pair-major (B, N, Xp) tensor's view, with Xp = X
    and padded past it: the same outputs, the view read in place."""
    xb, yb, mlens, nlens = _batch(60 + pad)
    args = _torch(xb, yb, mlens, nlens)
    _, tb = sw.scan_global_rows(*args, -5, -1, MA, MI, rb=RB)
    view = _pair_major(tb, pad)
    assert view.stride() == ((M + 1 + pad), 1, N * (M + 1 + pad)) and not view.is_contiguous()
    assert walk._walk_strides(view) == view.stride()
    want = walk.sweep_walk_global_seg(tb, args[2], args[3])
    for g, w in zip(walk.sweep_walk_global_seg(view, args[2], args[3]), want):
        assert torch.equal(g, w)


def test_global_walks_raise_on_layouts_they_do_not_take():
    """K14 and K2 take a contiguous (N, X, B) tb or a pair-major view (K2
    since K11 writes one); a view with the pairs inside the columns, rows of
    stride > 1, or columns that overlap raises."""
    xb, yb, mlens, nlens = _batch(70)
    args = _torch(xb, yb, mlens, nlens)
    _, tb = sw.scan_global_rows(*args, -5, -1, MA, MI, rb=RB)
    pairs_inside_columns = tb.permute(0, 2, 1).contiguous().permute(0, 2, 1)  # (N, B, X) storage
    rows_strided = torch.zeros((N, 2 * (M + 1), B), dtype=torch.uint16)[:, ::2]
    overlapping = torch.zeros(B * N * (M + 1), dtype=torch.uint16).as_strided((N, M + 1, B), (4, 1, N * (M + 1)))
    for fn in (walk.sweep_walk_global_seg, walk.sweep_walk_global):
        for bad in (pairs_inside_columns, rows_strided, overlapping):
            with pytest.raises(ValueError, match="strides"):
                fn(bad, args[2][: bad.shape[2]], args[3][: bad.shape[2]])
    _, k1_tb, _ = sw.scan_global(*args, -5, -1, MA, MI)
    for g, w in zip(walk.sweep_walk_global(_pair_major(k1_tb, 8), args[2], args[3]), walk.sweep_walk_global(k1_tb, args[2], args[3])):
        assert torch.equal(g, w)


def test_scan_global_rows_score_only():
    """``traceback=False`` gives the score and no tb, under MatchParams and
    a LUT."""
    xb, yb, mlens, nlens = _batch(80)
    args = _torch(xb, yb, mlens, nlens)
    score, _ = sw.scan_global_rows(*args, -5, -1, MA, MI, rb=RB)
    assert sw.scan_global_rows(*args, -5, -1, MA, MI, rb=RB, traceback=False)[1] is None
    assert torch.equal(sw.scan_global_rows(*args, -5, -1, MA, MI, rb=RB, traceback=False)[0], score)
    only = sw.scan_global_rows_lut(*args, -5, -1, _mp_lut(), traceback=False)
    assert only[1] is None and torch.equal(only[0], score)


# ---- end to end ----


def _fields(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, list(a.operations))


def _cigar(ops):
    """Runs of '=', 'X', 'I', 'D' of an op list."""
    chars = "".join({"Match": "=", "Subst": "X", "Ins": "I", "Del": "D"}[op.kind] for op in ops)
    return "".join(f"{len(m.group(0))}{m.group(1)}" for m in re.finditer(r"(.)\1*", chars))


def _max_col_run(a):
    """The longest Ins run that follows another op (the runs K2/K14 store
    per column; a run before the first other op is ins0)."""
    best = run = 0
    seen = False
    for op in a.operations:
        if op.kind == "Ins":
            run += 1
            best = max(best, run) if seen else best
        else:
            seen, run = True, 0
    return best


def test_long_insertion_follows_the_oracle():
    """x = A + C * 4199 against y = A: one Ins run of 4199 in column 1. The
    scalar oracle gives score -4201 and 4200 ops; the JAX package's global
    path packs the run in 12 bits and returns 104 ops (4199 & 0xFFF = 103
    Ins plus the Match). The port's wide pack keeps it."""
    x, y = b"A" + b"C" * 4199, b"A"
    sc = Scoring.from_scores(-5, -1, 2, -2)
    want = JaxScalarAligner.with_scoring(JaxScoring.from_scores(-5, -1, 2, -2)).global_(x, y)
    assert want.score == -4201 and len(want.operations) == 4200
    got = BatchAligner(sc, device="cpu").global_([x], [y])[0]
    assert _fields(got) == _fields(want)
    packed = BatchAligner(sc, device="cpu").global_packed([x], [y])
    assert packed.wide and packed.cigars() == ["1=4199I"]


def _long_dna_pairs(seed, n=5):
    """Ragged x of 4,100-4,300 bp against y of 1-40 bp, plus one pair whose
    insertions split into two runs under 4096 (x = C*2050 + y + C*2050)."""
    rng = np.random.default_rng(seed)
    xs = [rng.choice(list(b"ACGT"), size=int(rng.integers(4100, 4301))).astype(np.uint8).tobytes() for _ in range(n)]
    ys = [rng.choice(list(b"ACGT"), size=int(rng.integers(1, 41))).astype(np.uint8).tobytes() for _ in range(n)]
    y = rng.choice(list(b"AGT"), size=30).astype(np.uint8).tobytes()
    return xs + [b"C" * 2050 + y + b"C" * 2050], ys + [y]


def test_long_global_matches_oracle_and_jax():
    xs, ys = _long_dna_pairs(3)
    go, ge, ma, mi = -5, -1, 2, -2
    got = BatchAligner(Scoring.from_scores(go, ge, ma, mi), device="cpu").global_(xs, ys)
    jsc = JaxScoring.from_scores(go, ge, ma, mi)
    oracle = JaxScalarAligner.with_scoring(jsc)
    jax_got = JaxBatchAligner(jsc).global_(xs, ys)
    compared = 0
    for k, (x, y) in enumerate(zip(xs, ys)):
        assert _fields(got[k]) == _fields(oracle.global_(x, y)), k
        if _max_col_run(got[k]) < 4096:  # the JAX pack wraps longer runs
            assert _fields(got[k]) == _fields(jax_got[k]), k
            compared += 1
    assert compared >= 1 and _max_col_run(got[-1]) < 4096


def test_long_global_under_blosum62_matches_jax():
    """M = 4200 under BLOSUM62 (the JAX package's XLA engine, which agrees
    with the oracle there) through K13-LUT + K14 and the wide pack."""
    rng = np.random.default_rng(8)
    aa = np.frombuffer(AA, np.uint8)
    xs = [aa[rng.integers(0, 20, size=4200)].tobytes()] + [
        aa[rng.integers(0, 20, size=int(rng.integers(4000, 4201)))].tobytes() for _ in range(2)
    ]
    ys = [aa[rng.integers(0, 20, size=int(rng.integers(1, 41)))].tobytes() for _ in range(3)]
    got = BatchAligner(Scoring.new(-11, -1, scores.blosum62), device="cpu").global_(xs, ys)
    want = JaxBatchAligner(JaxScoring.new(-11, -1, jax_scores.blosum62)).global_(xs, ys)
    assert [_fields(a) for a in got] == [_fields(a) for a in want]


@pytest.mark.parametrize("kind", ["matchparams", "blosum62"])
def test_scores_at_long_m_match_jax(kind):
    rng = np.random.default_rng(9)
    alphabet = b"ACGT" if kind == "matchparams" else AA
    xs = [rng.choice(list(alphabet), size=4200).astype(np.uint8).tobytes()] + [
        rng.choice(list(alphabet), size=int(rng.integers(3000, 4201))).astype(np.uint8).tobytes() for _ in range(3)
    ]
    ys = [rng.choice(list(alphabet), size=int(rng.integers(0, 41))).astype(np.uint8).tobytes() for _ in range(4)]
    if kind == "matchparams":
        port, ref = Scoring.from_scores(-5, -1, 2, -2), JaxScoring.from_scores(-5, -1, 2, -2)
    else:
        port, ref = Scoring.new(-11, -1, scores.blosum62), JaxScoring.new(-11, -1, jax_scores.blosum62)
    ba = BatchAligner(port, device="cpu")
    got = ba.scores(xs, ys, "global")
    np.testing.assert_array_equal(got, JaxBatchAligner(ref).scores(xs, ys, "global"))
    np.testing.assert_array_equal(got, [a.score for a in ba.global_(xs, ys)])


@pytest.mark.parametrize("kind", ["matchparams", "blosum62"])
def test_rows_path_below_4096_matches_k1_path_and_jax(monkeypatch, kind):
    """``T_ROWS`` forced to 50: ragged 100-400 bp pairs take K13 + K14 and
    the narrow pack, and equal the K1 + K2 path and the JAX package."""
    rng = np.random.default_rng(11)
    alphabet = b"ACGT" if kind == "matchparams" else AA
    xs = [rng.choice(list(alphabet), size=int(rng.integers(100, 401))).astype(np.uint8).tobytes() for _ in range(4)]
    ys = [rng.choice(list(alphabet), size=int(rng.integers(100, 401))).astype(np.uint8).tobytes() for _ in range(4)]
    ys[1] = xs[1][:60] + xs[1][150:]  # a 90-residue insertion in x
    if kind == "matchparams":
        port, ref = Scoring.from_scores(-5, -1, 2, -2), JaxScoring.from_scores(-5, -1, 2, -2)
    else:
        port, ref = Scoring.new(-11, -1, scores.blosum62), JaxScoring.new(-11, -1, jax_scores.blosum62)
    ba = BatchAligner(port, device="cpu")
    k1_path = ba.global_(xs, ys)
    k1_cigars = ba.global_packed(xs, ys).cigars()
    calls = []
    seg_walk = walk.sweep_walk_global_seg

    def counted(*a):
        calls.append(1)
        return seg_walk(*a)

    monkeypatch.setattr(batched, "T_ROWS", 50)
    monkeypatch.setattr(walk, "sweep_walk_global_seg", counted)
    rows_path = ba.global_(xs, ys)
    packed = ba.global_packed(xs, ys)
    assert len(calls) == 2 and not packed.wide
    assert [_fields(a) for a in rows_path] == [_fields(a) for a in k1_path]
    assert packed.cigars() == k1_cigars
    assert [_fields(a) for a in rows_path] == [_fields(a) for a in JaxBatchAligner(ref).global_(xs, ys)]


def test_wide_packed_cigars_and_alignments():
    """``global_packed`` on the wide layout: its CIGARs spell the
    ``global_`` ops and ``alignment(k)`` is the ``global_`` alignment."""
    xs, ys = _long_dna_pairs(13, n=2)
    xs.append(b"ACGT")  # a short pair in a wide batch
    ys.append(b"AGT")
    ba = BatchAligner(Scoring.from_scores(-5, -1, 2, -2), device="cpu")
    alns = ba.global_(xs, ys)
    packed = ba.global_packed(xs, ys)
    assert packed.wide
    assert packed.cigars() == [_cigar(a.operations) for a in alns]
    for k, a in enumerate(alns):
        assert _fields(packed.alignment(k)) == _fields(a), k
    assert not ba.global_packed(xs[-1:], ys[-1:]).wide


def test_wide_pack_roundtrip():
    rng = np.random.default_rng(2)
    Bq, Nq = 5, 7
    i32 = torch.int32
    score = torch.tensor([-(2**31) + 3, -1, 0, 77, 2**31 - 1], dtype=i32)
    ins_cnt = torch.from_numpy(rng.integers(0, 65536, size=(Nq, Bq)).astype(np.int32)).to(torch.uint16)
    exit_op = torch.from_numpy(rng.integers(0, 5, size=(Nq, Bq)).astype(np.int32)).to(torch.uint16)
    ins0 = torch.from_numpy(rng.integers(0, 65535, size=Bq).astype(np.int32)).to(torch.uint16)
    z = torch.zeros(Bq, dtype=i32)
    ml = torch.arange(Bq, dtype=i32) + 65530
    nl = torch.arange(Bq, dtype=i32) + 20
    packed = _pack_rle_wide(score, ins_cnt, exit_op, ins0, z, z, z, z, z, ml, nl)
    assert packed.shape == (10 + 2 * Nq, Bq) and packed.dtype == torch.uint16
    s, up = _unpack_rle_wide(packed.numpy())
    np.testing.assert_array_equal(s, score.numpy())
    for key, t in (("ins_cnt", ins_cnt), ("exit_op", exit_op), ("ins0", ins0), ("xend", ml), ("yend", nl)):
        np.testing.assert_array_equal(up[key].astype(np.int64), t.to(i32).numpy(), err_msg=key)


def test_limits_raise():
    ba = BatchAligner(Scoring.from_scores(-5, -1, 2, -2), device="cpu")
    with pytest.raises(ValueError, match="65534"):
        ba.global_([b"A" * 65535], [b"A"])
    with pytest.raises(ValueError, match="65535"):
        ba.global_packed([b"A"], [b"A" * 65536])
    args = _torch(*_batch(1))
    for rb in (0, 606):
        with pytest.raises(ValueError, match="rb"):
            sw.scan_global_rows(*args, -5, -1, MA, MI, rb=rb)
