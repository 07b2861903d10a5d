"""The port's semiglobal path against the JAX package on the CPU: kernel K5
(semiglobal scan) against ``scan_semiglobal_pallas_mp`` and kernel K6
(semiglobal sweep walk) against ``sweep_walk_semiglobal``, both Pallas
kernels run in interpret mode; ``_suffix_fixups`` against the JAX function;
and the ``BatchAligner`` semiglobal and packed entry points against the JAX
``BatchAligner``. Integers throughout: every comparison is exact
(tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.batched import _geometry as jax_geometry
from rust_bio_tpu.alignment.pairwise.batched import _suffix_fixups as jax_suffix_fixups
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu.ops.sw_pallas import scan_semiglobal_pallas_mp
from rust_bio_tpu.ops.walk_pallas import sweep_walk_semiglobal as jax_sweep_walk_semiglobal
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
from rust_bio_tpu_torch.alignment.pairwise.batched import _geometry, _suffix_fixups
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE
from rust_bio_tpu_torch.alignment.pairwise.tb import TB_YCLIP_PREFIX
from rust_bio_tpu_torch.ops.sw import scan_semiglobal
from rust_bio_tpu_torch.ops.walk import resolve_fixed_column, sweep_walk_semiglobal, sweep_walk_semiglobal_plain
from test_torch_cuda import _poisoned_view, _sweep_inputs

MA, MI = 2, -2
# (go, ge, ycp, ycs): the three gap models of the global tests with the
# semiglobal clips (0, 0), and one nonzero y-clip pair
SCAN_CASES = [(-5, -1, 0, 0), (-2, -2, 0, 0), (-1, -1, 0, 0), (-5, -1, -3, -4)]


def _batch(rng, B, M, N):
    """Random DNA pairs with ragged lengths, including lengths 0 and 1."""
    xb = rng.choice(list(b"ACGT"), size=(B, M)).astype(np.uint8)
    yb = rng.choice(list(b"ACGT"), size=(B, N)).astype(np.uint8)
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:4] = [M, 0, M, 1]
    nlens[:4] = [N, N, 0, 1]
    return xb, yb, mlens, nlens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pens8(go, ge, ycp=0, ycs=0):
    return np.array([go, ge, MIN_SCORE, MIN_SCORE, ycp, ycs, MA, MI], np.int32)


def _jax_scan(xb, yb, mlens, nlens, pens8):
    return scan_semiglobal_pallas_mp(*(jnp.asarray(a) for a in (xb, yb, mlens, nlens, pens8)), runs="ins")


def _jax_fixed(scan, mlens, pens8):
    """JAX suffix fixups on a JAX scan: (score, tb_col_fixed, Lx_n, set,
    tbfix)."""
    _tb, S_f, I_f, Sn_f, Ly_f, tbk = scan
    B, X = S_f.shape
    ml = jnp.asarray(mlens)
    rows, row_ge1, mlens_c, is_row_m = jax_geometry(B, X - 1, ml)
    pens = tuple(jnp.int32(v) for v in pens8[:6])
    out = jax_suffix_fixups(
        S_f, I_f, Sn_f, tbk.astype(jnp.uint16), B, X - 1, rows, row_ge1, ml, mlens_c, is_row_m, pens
    )
    tbfix = (out[1].astype(jnp.int32) & 0xFFF) | (Ly_f << 12)
    return tuple(np.array(v) for v in out) + (np.array(tbfix),)


def _port_fixups(S_f, I_f, Sn_f, tbk, mlens, pens):
    B, X = S_f.shape
    rows, row_ge1, mlens_c, is_row_m = _geometry(B, X - 1, mlens)
    return _suffix_fixups(S_f, I_f, Sn_f, tbk, B, X - 1, rows, row_ge1, mlens, mlens_c, is_row_m, pens)


@pytest.mark.parametrize("go,ge,ycp,ycs", SCAN_CASES)
def test_scan_semiglobal_matches_jax(go, ge, ycp, ycs):
    rng = np.random.default_rng(abs(go * 7 + ge) + abs(ycp))
    B, M, N = 24, 31, 34
    xb, yb, mlens, nlens = _batch(rng, B, M, N)
    want = [np.asarray(v) for v in _jax_scan(xb, yb, mlens, nlens, _pens8(go, ge, ycp, ycs))]
    got = scan_semiglobal(*_torch(xb, yb, mlens, nlens), go, ge, MA, MI, ycp, ycs)
    assert got[0].shape == (N, M + 1, B) and got[0].dtype == torch.uint16
    np.testing.assert_array_equal(got[0].numpy(), want[0][:N])
    for name, g, w in zip(("S_f", "I_f", "Sn_f", "Ly_f", "tbk"), got[1:], want[1:]):
        assert g.shape == (B, M + 1) and g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("go,ge", [(-5, -1), (-2, -2)])
def test_suffix_fixups_match_jax_on_scan_finals(go, ge):
    rng = np.random.default_rng(40 + abs(go))
    xb, yb, mlens, nlens = _batch(rng, 24, 31, 34)
    pens8 = _pens8(go, ge)
    jscan = _jax_scan(xb, yb, mlens, nlens, pens8)
    want = _jax_fixed(jscan, mlens, pens8)
    _tb, S_f, I_f, Sn_f, _Ly, tbk = (torch.from_numpy(np.array(v)) for v in jscan)
    got = _port_fixups(S_f, I_f, Sn_f, tbk, torch.from_numpy(mlens), tuple(int(v) for v in pens8[:6]))
    assert got[1].dtype == torch.uint16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), w.astype(np.int32))


def test_suffix_fixups_argmax_tie_takes_the_first_row():
    """With the x-suffix clip live, two rows tying for the best S + xcs must
    give the clip length of the first (argmax's first maximum)."""
    rng = np.random.default_rng(9)
    B, X = 6, 9
    S_f = rng.integers(-20, 0, size=(B, X)).astype(np.int32)
    S_f[:, 2] = S_f[:, 5] = 10  # the tie, above every other row
    I_f = rng.integers(-30, -10, size=(B, X)).astype(np.int32)
    Sn_f = np.full((B, X), MIN_SCORE, np.int32)
    tbk = rng.integers(0, 0x500, size=(B, X)).astype(np.int32)
    mlens = np.array([8, 8, 7, 6, 3, 0], np.int32)
    pens = (-5, -1, 0, -1, 0, 0)  # xcs = -1: rows 2 and 5 tie at 9 > S[m]
    rows, row_ge1, mlens_c, is_row_m = jax_geometry(B, X - 1, jnp.asarray(mlens))
    want = jax_suffix_fixups(
        *(jnp.asarray(a) for a in (S_f, I_f, Sn_f)), jnp.asarray(tbk).astype(jnp.uint16),
        B, X - 1, rows, row_ge1, jnp.asarray(mlens), mlens_c, is_row_m,
        tuple(jnp.int32(v) for v in pens),
    )
    got = _port_fixups(*_torch(S_f, I_f, Sn_f, tbk, mlens), pens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), np.asarray(w).astype(np.int32))
    assert got[2].tolist()[:2] == [6, 6]  # mlens - 2: the first of rows 2 and 5


@pytest.mark.parametrize("go,ge", [(-5, -1), (-2, -2), (-1, -1)])
def test_sweep_walk_semiglobal_matches_jax(go, ge):
    rng = np.random.default_rng(60 + abs(go * 3 + ge))
    xb, yb, mlens, nlens = _batch(rng, 24, 31, 34)
    _check_walk(xb, yb, mlens, nlens, _pens8(go, ge))


def test_sweep_walk_semiglobal_long_insertions_and_yclip_prefix_exits():
    """x much longer than y forces Ins runs past the nibble's cap of 15,
    and reads whose best start lies inside y exit through a Yclip-prefix."""
    rng = np.random.default_rng(3)
    B, M, N = 16, 64, 12
    xb, yb, mlens, nlens = _batch(rng, B, M, N)
    mlens[4:] = M
    nlens[4:8] = [0, 1, 5, N]
    # lanes 8..15: x is a stretch of y behind a few bases, so the path
    # starts at column > 0 through the y-prefix clip
    mlens[8:] = 6
    for b in range(8, B):
        xb[b, :6] = yb[b, 4:10]
    got = _check_walk(xb, yb, mlens, nlens, _pens8(-5, -1))
    assert int(got[0].to(torch.int32).max()) > 15  # an Ins run over the cap
    assert bool((got[1].to(torch.int32) == TB_YCLIP_PREFIX).any())
    assert int(got[6].max()) > 0  # ystart


def _check_walk(xb, yb, mlens, nlens, pens8):
    N = yb.shape[1]
    jscan = _jax_scan(xb, yb, mlens, nlens, pens8)
    tbfix = _jax_fixed(jscan, mlens, pens8)[-1]
    want = [np.asarray(v) for v in jax_sweep_walk_semiglobal(jscan[0], jnp.asarray(tbfix), jnp.asarray(mlens), jnp.asarray(nlens))]
    tb = torch.from_numpy(np.array(jscan[0])[:N].copy())
    got = sweep_walk_semiglobal(tb, *_torch(tbfix, mlens, nlens))
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == (torch.uint16 if k < 3 else torch.int32), k
        w = w[:N] if w.ndim == 2 else w
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), w.astype(np.int32), err_msg=str(k))
    return got


@pytest.mark.parametrize("N,X,B", [(70, 203, 29), (24, 37, 18), (40, 1, 5)])
def test_sweep_walk_semiglobal_plain_on_synthetic_runs_matches_jax(N, X, B):
    """The plain K6 (prolog and sweep) on ``_sweep_cells`` and
    ``_fixed_cells`` against the JAX walk: Ins runs across 32- and 96-row
    edges and past the nibble's cap, diagonals past 32 columns, Del runs,
    Yclip-prefix exits in the sweep; fixed columns whose Ins run reaches
    row 1 (the exit row's neighbour -1 wraps to row X - 1) or row 0 (the
    2^20 sentinel), Yclip-prefix and Yclip-suffix exits there, mlens = 0
    lanes; X not a multiple of 8, B not a multiple of K6's warps a block;
    on the contiguous tb and on a pair-major view."""
    tb, tbfix, ml, nl = _sweep_inputs(np.random.default_rng(N + X + 1), N, X, B, "cpu")
    want = [
        np.asarray(v)
        for v in jax_sweep_walk_semiglobal(*(jnp.asarray(t.numpy()) for t in (tb, tbfix, ml, nl)))
    ]
    for t in (tb, _poisoned_view(tb)):
        got = sweep_walk_semiglobal_plain(t, tbfix, ml, nl)
        for k, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.to(torch.int32).numpy(), w.astype(np.int32), err_msg=str(k))
    if X > 200:
        assert int(got[0].to(torch.int32).max()) > 96  # an Ins run across three 32-row rounds
        assert bool((got[1].to(torch.int32) == TB_YCLIP_PREFIX).any())
        assert int(got[3].max()) > 2**20 and int(got[3][0::6].min()) >= 1  # the sentinel, the wraps


def test_resolve_fixed_column_fields():
    """The prolog's entry state on a hand-built fixed column: an Ins run of
    two above a Match exit, and a y-suffix clip of length 3 at row 0."""
    X = 5
    ins, match, yclip_suffix = 1, 4, 8
    tbfix = torch.zeros((2, X), dtype=torch.int32)
    # lane 0, mlens 4: s-bits Ins at row 4, i-bits Ins at rows 3-4, Match at row 2
    tbfix[0, 4] = ins << 8 | ins
    tbfix[0, 3] = ins
    tbfix[0, 2] = match
    # lane 1, mlens 0: s-bits y-suffix clip at row 0 with Ly = 3
    tbfix[1, 0] = yclip_suffix << 8 | 3 << 12
    out = resolve_fixed_column(tbfix, torch.tensor([4, 0], dtype=torch.int32), torch.tensor([7, 7], dtype=torch.int32))
    fix_ins, fix_exit, fix_ly, i1, j1, ca1, us1, dn1, ystart0, yend0 = (o.tolist() for o in out)
    assert (fix_ins, fix_exit, fix_ly) == ([3, 0], [match, yclip_suffix], [0, 3])
    assert (i1, j1, us1, dn1) == ([0, 0], [6, 4], [1, 1], [0, 0])
    assert (ystart0, yend0) == ([0, 0], [7, 4])


def test_semiglobal_wrappers_check_inputs():
    xb, yb, mlens, nlens = _torch(*_batch(np.random.default_rng(5), 4, 6, 5))
    with pytest.raises(TypeError):
        scan_semiglobal(xb.to(torch.int32), yb, mlens, nlens, -5, -1, MA, MI, 0, 0)
    with pytest.raises(ValueError, match="nlens"):
        scan_semiglobal(xb, yb, mlens, nlens + 6, -5, -1, MA, MI, 0, 0)
    tb = torch.zeros((5, 7, 4), dtype=torch.uint16)
    tbfix = torch.zeros((4, 7), dtype=torch.int32)
    with pytest.raises(TypeError):
        sweep_walk_semiglobal(tb, tbfix.to(torch.int64), mlens, nlens)
    with pytest.raises(ValueError):
        sweep_walk_semiglobal(tb, tbfix[:3], mlens, nlens)
    with pytest.raises(ValueError, match="mlens"):
        sweep_walk_semiglobal(tb, tbfix, mlens + 7, nlens)


# ---- entry points, on the corpora of tests/test_read_mapper.py ----


def _read_corpus(seed=67, n=24):
    """x = a stretch of y with up to three substitutions (the mapper-like
    semiglobal corpus)."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(n):
        N = int(rng.integers(30, 120))
        y = rng.choice(list(b"ACGT"), size=N).astype(np.uint8).tobytes()
        M = int(rng.integers(5, min(60, N)))
        s = int(rng.integers(0, N - M))
        x = bytearray(y[s : s + M])
        for _ in range(int(rng.integers(0, 4))):
            x[int(rng.integers(0, M))] = int(rng.choice(list(b"ACGT")))
        xs.append(bytes(x))
        ys.append(y)
    return xs, ys


def _random_corpus(seed=71, n=24):
    """Unrelated x and y of ragged lengths (the global-packed corpus)."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(n):
        N = int(rng.integers(20, 120))
        ys.append(rng.choice(list(b"ACGT"), size=N).astype(np.uint8).tobytes())
        M = int(rng.integers(5, N + 1))
        xs.append(rng.choice(list(b"ACGT"), size=M).astype(np.uint8).tobytes())
    return xs, ys


CORPORA = {
    "reads": _read_corpus,
    "random": _random_corpus,
    # empty and one-symbol sides, an x longer than y
    "edges": lambda: ([b"ACGT", b"", b"A", b"ACGTACGTAC", b"C"], [b"", b"ACG", b"TTTT", b"ACG", b"C"]),
}


def _fields(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, list(a.operations))


def _aligners():
    return (
        BatchAligner(Scoring.from_scores(-5, -1, 2, -2), device="cpu"),
        JaxBatchAligner(JaxScoring.from_scores(-5, -1, 2, -2)),
    )


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_semiglobal_and_scores_match_jax(corpus):
    xs, ys = CORPORA[corpus]()
    port, jax_ba = _aligners()
    got = port.semiglobal(xs, ys)
    want = jax_ba.semiglobal(xs, ys)
    assert [_fields(a) for a in got] == [_fields(a) for a in want]
    assert [a.cigar() for a in got] == [a.cigar() for a in want]
    np.testing.assert_array_equal(port.scores(xs, ys, "semiglobal"), jax_ba.scores(xs, ys, "semiglobal"))
    np.testing.assert_array_equal(port.scores(xs, ys, "semiglobal"), [a.score for a in got])


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("mode", ["semiglobal", "global"])
def test_packed_results_match_jax(corpus, mode):
    xs, ys = CORPORA[corpus]()
    port, jax_ba = _aligners()
    got = getattr(port, f"{mode}_packed")(xs, ys)
    want = getattr(jax_ba, f"{mode}_packed")(xs, ys)
    np.testing.assert_array_equal(got.score, want.score)
    for f in ("xstart", "xend", "ystart", "yend"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.cigars() == want.cigars()
    for k in range(len(xs)):
        assert _fields(got.alignment(k)) == _fields(want.alignment(k)), k


def test_packed_lanes_are_independent():
    """Dummy lanes appended to a batch (the JAX mapper pads its extension
    batch to a power of two with them) leave the real lanes' results as
    they were."""
    xs, ys = _read_corpus(seed=13, n=5)
    port, _ = _aligners()
    alone = port.semiglobal_packed(xs, ys)
    padded = port.semiglobal_packed(xs + [b"A"] * 3, ys + [b"A"] * 3)
    assert padded.cigars()[:5] == alone.cigars()
    np.testing.assert_array_equal(padded.score[:5], alone.score)
    for k in range(5):
        assert _fields(padded.alignment(k)) == _fields(alone.alignment(k))
