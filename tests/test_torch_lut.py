"""The port's substitution-matrix scoring (BLOSUM/PAM matrices, (256, 256)
LUTs, callables) against the JAX package on the CPU.

The port's ``scores`` module and ``Scoring.dense_lut`` against the JAX ones;
the plain feeders ``subs2_stream_plain`` / ``subs_tensor_plain`` against
``_subs2_stream`` / ``subs_tensor``; the plain versions of K11, K12 and K18
against ``scan_global_pallas_subs``, ``scan_semiglobal_pallas_subs`` and
``sw_scores_global`` (interpret mode) on the same streams; and end to end,
``BatchAligner`` in all four modes, ``scores`` in all four, and the packed
results against the JAX ``BatchAligner`` and its scalar oracle, every
``Alignment`` field. Integers throughout: every comparison is exact
(tolerance 0). The stage tests share one batch shape so JAX compiles each
interpret-mode kernel once.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu import scores as jax_scores
from rust_bio_tpu.alignment.pairwise import Aligner as JaxScalarAligner
from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.batched import _subs2_stream
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu.alphabets import protein as jax_protein
from rust_bio_tpu.ops import sw_pallas
from rust_bio_tpu_torch import scores
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE
from rust_bio_tpu_torch.alphabets import protein
from rust_bio_tpu_torch.ops import sw

MATRICES = ("blosum30", "blosum45", "blosum62", "pam40", "pam120", "pam200", "pam250")
AA = b"ARNDCQEGHILKMFPSTWYV"
B, M, N = 16, 24, 28  # the stage tests' batch shape


def _match_fn(kind, jax_side=False):
    """A match function of each kind, for the port or the JAX package."""
    mod = jax_scores if jax_side else scores
    if kind in MATRICES:
        return getattr(mod, kind)
    if kind == "matchparams":
        return None
    if kind == "callable":
        return _hydrophobic
    if kind == "ndarray":  # a table inside +-2^23, where the JAX float32 stream is exact
        return np.random.default_rng(9).integers(-(2**23), 2**23, size=(256, 256)).astype(np.int32)
    raise ValueError(kind)


def _hydrophobic(a, b):
    """A callable scorer: identity 5, both hydrophobic 1, else -3."""
    hyd = b"AVLIMFWC"
    return 5 if a == b else (1 if a in hyd and b in hyd else -3)


def _scorings(kind, go=-11, ge=-1):
    if kind == "matchparams":
        return Scoring.from_scores(go, ge, 2, -3), JaxScoring.from_scores(go, ge, 2, -3)
    return Scoring.new(go, ge, _match_fn(kind)), JaxScoring.new(go, ge, _match_fn(kind, jax_side=True))


# ---- the scores module, alphabets and dense_lut ----


@pytest.mark.parametrize("name", MATRICES)
def test_scores_module_matches_jax(name):
    np.testing.assert_array_equal(scores.matrix(name), jax_scores.matrix(name))
    np.testing.assert_array_equal(scores.dense_matrix(name), jax_scores.dense_matrix(name))
    np.testing.assert_array_equal(scores.LOOKUP, jax_scores.LOOKUP)
    port, ref = getattr(scores, name), getattr(jax_scores, name)
    assert port.matrix_name == ref.matrix_name == name
    for a, b in ((65, 65), (ord("W"), ord("C")), (0, ord("a")), (ord("*"), ord("X")), (255, ord("Z"))):
        assert port(a, b) == ref(a, b)


@pytest.mark.parametrize("kind", ["matchparams", "callable", "ndarray", "blosum62", "pam250"])
def test_dense_lut_matches_jax(kind):
    port, ref = _scorings(kind)
    lut = port.dense_lut()
    assert lut.dtype == np.int32 and lut.shape == (256, 256)
    np.testing.assert_array_equal(lut, ref.dense_lut())


def test_protein_alphabets_match_jax():
    for name in ("alphabet", "iupac_alphabet"):
        port, ref = getattr(protein, name)(), getattr(jax_protein, name)()
        assert port.symbols() == ref.symbols()
        for word in (b"MKVLA", b"mkvla", b"MKB*", b"", b"XZ"):
            assert port.is_word(word) == ref.is_word(word)


# ---- the plain feeders ----


def _bytes_batch(case, seed=3):
    """(xb, yb) uint8 of the stage shape: protein residues, with byte 0,
    with lowercase letters, or with 64 / all 256 distinct bytes."""
    rng = np.random.default_rng(seed)
    syms = {
        "protein": AA,
        "byte0": AA[:5] + b"\x00",
        "lowercase": AA + AA.lower(),
        "sigma64": bytes(range(64, 128)),
        "all256": bytes(range(256)),
    }[case]
    pool = np.frombuffer(syms, np.uint8)
    xb = pool[rng.integers(0, len(pool), size=(B, M))]
    yb = pool[rng.integers(0, len(pool), size=(B, N))]
    if case == "all256":
        xb.reshape(-1)[:256] = rng.permutation(256)
    return xb, yb


def _n_syms(xb, yb):
    """The JAX dispatcher's symbol bucket for this batch (batched.py:2156-2166)."""
    nd = len(np.union1d(np.unique(xb), np.unique(yb)))
    return next(s for s in (32, 64, 128, 256) if nd <= s)


@pytest.mark.parametrize("case", ["protein", "byte0", "lowercase", "sigma64", "all256"])
def test_subs_feeders_match_jax(case):
    xb, yb = _bytes_batch(case)
    lut = scores.dense_matrix("blosum62")
    n_syms = _n_syms(xb, yb)
    want2 = np.asarray(_subs2_stream(jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(lut), n_syms))
    got2 = sw.subs2_stream_plain(torch.from_numpy(xb), torch.from_numpy(yb), torch.from_numpy(lut))
    np.testing.assert_array_equal(got2.numpy(), want2)
    want = np.asarray(sw_pallas.subs_tensor(jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(lut), n_syms))
    got = sw.subs_tensor_plain(torch.from_numpy(xb), torch.from_numpy(yb), torch.from_numpy(lut))
    np.testing.assert_array_equal(got.numpy(), want)
    # the Match/Subst bit is byte equality: 'a' against 'A' is a Subst, and
    # under BLOSUM62 'X' against 'X' a Match scoring -1
    assert scores.blosum62(ord("a"), ord("A")) == 4 and scores.blosum62(ord("X"), ord("X")) == -1
    eq = got2.numpy() & 1
    np.testing.assert_array_equal(eq, (yb.T[:, None, :] == xb.T[None, :, :]).astype(np.int32))


# ---- K11, K12, K18 plain versions against the Pallas kernels ----


@functools.lru_cache(maxsize=None)
def _stage_batch(case="protein"):
    xb, yb = _bytes_batch(case, seed=11)
    rng = np.random.default_rng(12)
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:4] = [M, 0, M, 1]
    nlens[:4] = [N, N, 0, 1]
    lut = scores.dense_matrix("blosum62")
    subs2 = np.array(_subs2_stream(jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(lut), _n_syms(xb, yb)))
    return xb, yb, mlens, nlens, lut, subs2


def _defined(a, mlens, nlens=None):
    """``a`` with the entries no kernel defines zeroed: (B, X) finals above
    row mlens[b]; (n, X, B) cells also past column nlens[b]."""
    a = np.asarray(a).astype(np.int64)
    if a.ndim == 2:
        return np.where(np.arange(a.shape[1])[None, :] <= mlens[:, None], a, 0)
    keep = (np.arange(a.shape[0])[:, None, None] < nlens[None, None, :]) & (
        np.arange(a.shape[1])[None, :, None] <= mlens[None, None, :]
    )
    return np.where(keep, a, 0)


@pytest.mark.parametrize("chunks", ["one", "multi"])
@pytest.mark.parametrize("go,ge", [(-11, -1), (-3, -3)])
def test_k11_plain_matches_pallas(monkeypatch, chunks, go, ge):
    xb, yb, mlens, nlens, lut, subs2 = _stage_batch()
    if chunks == "multi":  # several column chunks on the JAX side only
        real_pick = sw_pallas._pick_block_global
        monkeypatch.setattr(
            sw_pallas, "_pick_block_global",
            lambda B_, M_, N_, n_state=30, stream_bytes=0: (real_pick(B_, M_, N_, n_state, stream_bytes)[0], 5),
        )
    ws, wtb, wtbk = sw_pallas.scan_global_pallas_subs(
        jnp.asarray(subs2), jnp.asarray(mlens), jnp.asarray(nlens),
        jnp.asarray([go, ge, MIN_SCORE, MIN_SCORE, MIN_SCORE, MIN_SCORE], jnp.int32), runs="ins",
    )
    score, tb, tbk = sw.scan_global_lut_plain(torch.from_numpy(subs2), torch.from_numpy(mlens), torch.from_numpy(nlens), go, ge)
    np.testing.assert_array_equal(score.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(_defined(tb, mlens, nlens), _defined(np.asarray(wtb)[:N], mlens, nlens))
    np.testing.assert_array_equal(_defined(tbk, mlens), _defined(wtbk, mlens))
    # the port's wrapper on the CPU: the feeder composed with the plain scan
    args = [torch.from_numpy(a) for a in (xb, yb, mlens, nlens)]
    for g, w in zip(sw.scan_global_lut(*args, go, ge, torch.from_numpy(lut)), (score, tb, tbk)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("ycp,ycs", [(0, 0), (-5, -3)])
def test_k12_plain_matches_pallas(ycp, ycs):
    xb, yb, mlens, nlens, lut, subs2 = _stage_batch()
    go, ge = -11, -1
    want = sw_pallas.scan_semiglobal_pallas_subs(
        jnp.asarray(subs2), jnp.asarray(mlens), jnp.asarray(nlens),
        jnp.asarray([go, ge, MIN_SCORE, MIN_SCORE, ycp, ycs], jnp.int32), runs="ins",
    )
    got = sw.scan_semiglobal_lut_plain(torch.from_numpy(subs2), torch.from_numpy(mlens), torch.from_numpy(nlens), go, ge, ycp, ycs)
    np.testing.assert_array_equal(_defined(got[0], mlens, nlens), _defined(np.asarray(want[0])[:N], mlens, nlens))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_defined(g, mlens), _defined(w, mlens))
    args = [torch.from_numpy(a) for a in (xb, yb, mlens, nlens)]
    for g, w in zip(sw.scan_semiglobal_lut(*args, go, ge, torch.from_numpy(lut), ycp, ycs), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["protein", "all256"])
def test_k18_plain_matches_pallas(case):
    """At B = 128 (``sw_scores_global`` takes whole 128-lane blocks); K18's
    scores equal K11's, the JAX package's route for global scores."""
    xb0, yb0 = _bytes_batch(case, seed=13)
    rng = np.random.default_rng(14)
    xb = np.concatenate([xb0] * 8)
    yb = np.concatenate([yb0[rng.permutation(B)] for _ in range(8)])
    mlens = rng.integers(0, M + 1, size=128).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=128).astype(np.int32)
    lut = scores.dense_matrix("blosum62")
    subs = sw_pallas.subs_tensor(jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(lut), _n_syms(xb, yb))
    want = np.asarray(sw_pallas.sw_scores_global(subs, jnp.asarray(mlens), jnp.asarray(nlens), -11, -1, block_b=128))
    args = [torch.from_numpy(a) for a in (xb, yb, mlens, nlens)]
    got = sw.scores_global_lut_plain(sw.subs_tensor_plain(args[0], args[1], torch.from_numpy(lut)), args[2], args[3], -11, -1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(sw.scores_global_lut(*args, -11, -1, torch.from_numpy(lut)), got)
    assert torch.equal(sw.scan_global_lut(*args, -11, -1, torch.from_numpy(lut))[0], got)


def test_clip_scans_fed_by_lut_equal_matchparams_scans():
    """K7 and K9 fed by the MatchParams table equal K7 and K9."""
    xb, yb, mlens, nlens, _, _ = _stage_batch()
    args = [torch.from_numpy(a) for a in (xb, yb, mlens, nlens)]
    lut = torch.from_numpy(Scoring.from_scores(-5, -1, 2, -3).dense_lut())
    pairs = [
        (sw.scan_local_lut(*args, -5, -1, lut), sw.scan_local(*args, -5, -1, 2, -3)),
        (sw.scan_custom_lut(*args, -5, -1, lut, -7, -1, 0, -7), sw.scan_custom(*args, -5, -1, 2, -3, -7, -1, 0, -7)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---- end to end: BatchAligner against the JAX package and the oracle ----


def _fields(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, [str(o) for o in a.operations])


def _protein_pairs(seed, n, m_max=20, n_max=24, m1=False):
    """Ragged protein pairs: y random, x a mutated stretch of y (homologs)
    or, with ``m1``, one residue. Pair 0 has the longest x and y, so every
    batch pads to (m_max, n_max) and JAX compiles once per batch width."""
    rng = np.random.default_rng(seed)
    aa = np.frombuffer(AA, np.uint8)
    xs, ys = [], []
    for k in range(n):
        ny = n_max if k == 0 else int(rng.integers(1, n_max + 1))
        y = aa[rng.integers(0, 20, size=ny)]
        mx = 1 if m1 else (m_max if k == 0 else int(rng.integers(1, m_max + 1)))
        s = int(rng.integers(0, max(1, ny - mx) + 1))
        x = np.resize(y[s : s + mx], mx).copy()
        mut = rng.random(mx) < 0.3
        x[mut] = aa[rng.integers(0, 20, size=int(mut.sum()))]
        xs.append(x.tobytes())
        ys.append(y.tobytes())
    return xs, ys


MODES = ("global", "semiglobal", "local", "custom")


def _check_modes(port_sc, jax_sc, xs, ys):
    port = BatchAligner(port_sc, device="cpu")
    ref = JaxBatchAligner(jax_sc)
    scalar = JaxScalarAligner.with_scoring(jax_sc)
    for mode in MODES:
        fn = "global_" if mode == "global" else mode
        got = getattr(port, fn)(xs, ys)
        want = getattr(ref, fn)(xs, ys)
        assert [_fields(a) for a in got] == [_fields(a) for a in want], mode
        assert [_fields(a) for a in got] == [_fields(getattr(scalar, fn)(x, y)) for x, y in zip(xs, ys)], mode
        got_s = port.scores(xs, ys, mode)
        np.testing.assert_array_equal(got_s, ref.scores(xs, ys, mode))
        np.testing.assert_array_equal(got_s, [a.score for a in got])


@pytest.mark.parametrize("n", [1, 3, 9])
def test_blosum62_aligner_matches_jax_and_oracle(n):
    """rust-bio's doctest scoring, ``Scoring.new(-11, -1, blosum62)``."""
    xs, ys = _protein_pairs(100 + n, n)
    _check_modes(*_scorings("blosum62"), xs, ys)


@pytest.mark.parametrize("kind", ["pam250", "callable", "ndarray"])
def test_other_lut_scorings_match_jax_and_oracle(kind):
    xs, ys = _protein_pairs(200, 9)
    _check_modes(*_scorings(kind, -5, -2), xs, ys)


def test_m1_pairs_match_jax():
    """x of one residue: the port runs its kernels, the JAX package its XLA
    engine (M < 2)."""
    xs, ys = _protein_pairs(300, 3, m1=True)
    _check_modes(*_scorings("blosum62"), xs, ys)


def test_out_of_alphabet_bytes_match_jax():
    """Byte 0, lowercase and other bytes score through LOOKUP index 0 ('A');
    the Match/Subst bit still compares raw bytes."""
    rng = np.random.default_rng(400)
    pool = np.frombuffer(AA + AA.lower() + b"\x00*XBZ#", np.uint8)
    xs = [pool[rng.integers(0, len(pool), size=20 if k == 0 else int(rng.integers(1, 21)))].tobytes() for k in range(9)]
    ys = [pool[rng.integers(0, len(pool), size=24 if k == 0 else int(rng.integers(1, 25)))].tobytes() for k in range(9)]
    _check_modes(*_scorings("blosum62"), xs, ys)


def test_custom_with_x_clips_off_matches_jax():
    """Custom mode with y-clips -5 and the x-clips off: the port's K9 fed by
    the LUT against the JAX package's semiglobal subs kernel with live
    y-clips."""
    xs, ys = _protein_pairs(500, 9)
    port_sc, jax_sc = _scorings("blosum62")
    port_sc, jax_sc = port_sc.yclip(-5), jax_sc.yclip(-5)
    port = BatchAligner(port_sc, device="cpu")
    ref = JaxBatchAligner(jax_sc)
    scalar = JaxScalarAligner.with_scoring(jax_sc)
    got = port.custom(xs, ys)
    assert [_fields(a) for a in got] == [_fields(a) for a in ref.custom(xs, ys)]
    assert [_fields(a) for a in got] == [_fields(scalar.custom(x, y)) for x, y in zip(xs, ys)]
    np.testing.assert_array_equal(port.scores(xs, ys, "custom"), ref.scores(xs, ys, "custom"))


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
def test_packed_results_match_jax(mode):
    xs, ys = _protein_pairs(600, 9)
    port_sc, jax_sc = _scorings("blosum62")
    got = getattr(BatchAligner(port_sc, device="cpu"), f"{mode}_packed")(xs, ys)
    want = getattr(JaxBatchAligner(jax_sc), f"{mode}_packed")(xs, ys)
    assert got.cigars() == want.cigars()
    np.testing.assert_array_equal(got.score, want.score)
    for k in range(len(xs)):
        assert _fields(got.alignment(k)) == _fields(want.alignment(k)), k
