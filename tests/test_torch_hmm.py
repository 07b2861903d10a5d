"""The port's HMM (``rust_bio_tpu_torch.stats.hmm``: the host oracle, the
batched classes and ``baum_welch_batch``, kernels K-HMM-vit, K-HMM-fwd and
K-HMM-bwd through their plain PyTorch versions on the CPU) against the JAX
package.

Tolerances:
- discrete Viterbi against JAX's ``_viterbi``: paths and log-probabilities
  bit for bit (adds and maxima only, in the same order);
- forward and backward rows and totals against JAX's ``_forward`` /
  ``_backward``: rtol 1e-5, atol 1e-5 at T <= 48 (the sums' order and the
  exp/log of XLA and of PyTorch differ by float rounding);
- the Gaussian class against JAX: paths equal, rtol 1e-5, atol 1e-5;
- ``baum_welch_batch`` against JAX's: A, Bm, pi and the log-likelihoods
  within 1e-5;
- the host oracle against the JAX oracle: equal (the same float64
  statements);
- the batched classes against the host oracle: rel 1e-4, abs 1e-4, as
  ``tests/test_hmm.py`` holds the JAX classes.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.stats import hmm as jax_hmm
from rust_bio_tpu.stats.hmm import device as jax_device
from rust_bio_tpu_torch import carry
from rust_bio_tpu_torch.ops import hmm as ops
from rust_bio_tpu_torch.stats import hmm
from rust_bio_tpu_torch.stats.hmm import device

CASINO_A = [[0.95, 0.05], [0.1, 0.9]]
CASINO_B = [[1 / 6.0] * 6, [0.1, 0.1, 0.1, 0.1, 0.1, 0.5]]
CASINO_PI = [0.5, 0.5]


def _model(S: int, seed: int):
    """(A, Bm, pi) as probabilities: the casino at S = 2, Dirichlet rows
    otherwise; the 3-state model has ln-0 entries (a forbidden transition,
    a state that cannot start, a symbol one state never emits)."""
    if S == 2:
        return np.array(CASINO_A), np.array(CASINO_B), np.array(CASINO_PI)
    rng = np.random.default_rng(seed)
    V = 4 if S == 3 else 20
    A = rng.dirichlet(np.ones(S), size=S)
    Bm = rng.dirichlet(np.ones(V), size=S)
    pi = rng.dirichlet(np.ones(S))
    if S == 3:
        A[0, 2] = 0.0
        A[0] /= A[0].sum()
        pi[1] = 0.0
        pi /= pi.sum()
        Bm[2, 3] = 0.0
        Bm[2] /= Bm[2].sum()
    return A, Bm, pi


def _seqs(rng, V: int, B: int = 12, T: int = 48):
    lens = rng.integers(1, T + 1, size=B)
    lens[:3] = [T, 1, 2]
    return [rng.integers(0, V, size=int(n)).tolist() for n in lens]


def _log(a):
    with np.errstate(divide="ignore"):
        return np.log(np.asarray(a, np.float64))


@pytest.mark.parametrize("S", [2, 3, 40])
def test_plain_scans_match_jax(S):
    """Viterbi bit for bit, forward and backward rows and totals within
    rtol/atol 1e-5, on ragged lengths 1 to 48."""
    A, Bm, pi = _model(S, 11 + S)
    seqs = _seqs(np.random.default_rng(S), Bm.shape[1])
    jm = jax_device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi))
    pm = device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi), device="cpu")
    obs, lens = jm._pad(seqs)
    j_paths, j_prob = (np.asarray(a) for a in jm._viterbi(obs, lens))
    p_paths, p_prob = pm.viterbi_batch(seqs)
    np.testing.assert_array_equal(p_paths, j_paths)
    np.testing.assert_array_equal(p_prob.astype(np.float32), j_prob)
    for name in ("_forward", "_backward"):
        j_vals, j_tot = (np.asarray(a, np.float64) for a in getattr(jm, name)(obs, lens))
        p_vals, p_tot = getattr(pm, name[1:] + "_batch")(seqs)
        np.testing.assert_allclose(p_vals, j_vals, rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(p_tot, j_tot, rtol=1e-5, atol=1e-5, err_msg=name)


def test_gaussian_matches_jax_and_oracle():
    """The Gaussian class against JAX (Viterbi and forward) and, for the
    backward scan that JAX lacks, against the host oracle."""
    rng = np.random.default_rng(47)
    S = 3
    A = rng.dirichlet(np.ones(S), size=S)
    pi = rng.dirichlet(np.ones(S))
    params = [(0.0, 1.0), (5.0, 2.0), (-3.0, 0.5)]
    seqs = [list(rng.normal(0, 4, size=int(n))) for n in [40, 1, 2] + list(rng.integers(1, 41, size=5))]
    jm = jax_device.BatchGaussianHMM(_log(A), params, _log(pi))
    pm = device.BatchGaussianHMM(_log(A), params, _log(pi), device="cpu")
    j_paths, j_prob = jm.viterbi_batch(seqs)
    p_paths, p_prob = pm.viterbi_batch(seqs)
    np.testing.assert_array_equal(p_paths, j_paths)
    np.testing.assert_allclose(p_prob, j_prob, rtol=1e-5, atol=1e-5)
    j_vals, j_tot = jm.forward_batch(seqs)
    p_vals, p_tot = pm.forward_batch(seqs)
    np.testing.assert_allclose(p_vals, j_vals, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p_tot, j_tot, rtol=1e-5, atol=1e-5)
    oracle = hmm.GaussianModel.with_float(A, params, pi)
    b_vals, b_tot = pm.backward_batch(seqs)
    T = b_vals.shape[1]
    for b, s in enumerate(seqs):
        s32 = [float(np.float32(v)) for v in s]  # padded as float32
        w_vals, w_tot = hmm.backward(oracle, s32)
        np.testing.assert_allclose(b_vals[b, T - len(s) :], w_vals, rtol=1e-4, atol=1e-4)
        assert b_tot[b] == pytest.approx(float(w_tot), rel=1e-4, abs=1e-4)
        assert p_tot[b] == pytest.approx(float(hmm.forward(oracle, s32)[1]), rel=1e-4, abs=1e-4)


def test_batch_classes_match_oracle():
    """Viterbi (no near-ties here: the paths equal), the forward and
    backward tables with an end vector, against the port's host oracle
    (whose Viterbi takes no end)."""
    rng = np.random.default_rng(41)
    S, V = 3, 4
    A = rng.dirichlet(np.ones(S), size=S)
    Bm = rng.dirichlet(np.ones(V), size=S)
    pi = rng.dirichlet(np.ones(S))
    end = rng.dirichlet(np.ones(S))
    plain = hmm.DiscreteEmissionModel.with_float(A, Bm, pi)
    oracle = hmm.DiscreteEmissionOptEndModel.with_float(A, Bm, pi, end)
    pm0 = device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi), device="cpu")
    pm = device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi), _log(end), device="cpu")
    seqs = [list(rng.integers(0, V, size=int(rng.integers(1, 12)))) for _ in range(9)]
    paths, vprob = pm0.viterbi_batch(seqs)
    fvals, ftot = pm.forward_batch(seqs)
    bvals, btot = pm.backward_batch(seqs)
    T = paths.shape[1]
    for b, s in enumerate(seqs):
        L = len(s)
        w_path, w_prob = hmm.viterbi(plain, s)
        assert paths[b, :L].tolist() == w_path and (paths[b, L:] == w_path[-1]).all()
        assert vprob[b] == pytest.approx(float(w_prob), rel=1e-5, abs=1e-5)
        w_fvals, w_ftot = hmm.forward(oracle, s)
        np.testing.assert_allclose(fvals[b, :L], w_fvals, rtol=1e-4, atol=1e-4)
        assert ftot[b] == pytest.approx(float(w_ftot), rel=1e-4, abs=1e-4)
        w_bvals, w_btot = hmm.backward(oracle, s)
        np.testing.assert_allclose(bvals[b, T - L :], w_bvals, rtol=1e-4, atol=1e-4)
        assert btot[b] == pytest.approx(float(w_btot), rel=1e-4, abs=1e-4)


def test_baum_welch_batch_matches_jax():
    rng = np.random.default_rng(61)
    S, V = 3, 4
    A = rng.dirichlet(np.ones(S), size=S)
    Bm = rng.dirichlet(np.ones(V), size=S)
    pi = rng.dirichlet(np.ones(S))
    seqs = [list(rng.integers(0, V, size=int(n))) for n in [30, 1, 2] + list(rng.integers(4, 31, size=9))]
    jm, j_lls = jax_device.baum_welch_batch(jax_device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi)), seqs, n_iter=3, vocab=V)
    pm, p_lls = device.baum_welch_batch(device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi), device="cpu"), seqs, n_iter=3, vocab=V)
    assert pm.device.type == "cpu"
    np.testing.assert_allclose(p_lls, j_lls, rtol=1e-5, atol=1e-5)
    assert all(b >= a - 1e-3 for a, b in zip(p_lls, p_lls[1:]))
    for name in ("A", "Bm", "pi"):
        np.testing.assert_allclose(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)), rtol=1e-5, atol=1e-5, err_msg=name)



def test_baum_welch_rows_as_jax():
    """At T = 1000 the float32 E-step leaves the rows of the trained A off
    a log-sum of 0 by about 2e-5 (the backward rows' rounding at |b| near
    1000), in the JAX class as in the port: the port's row log-sums equal
    JAX's within 1e-6; the emission rows sum to 1 within 1e-6."""
    rng = np.random.default_rng(5)
    seqs = list(rng.integers(0, 6, size=(128, 1000)).astype(np.int32))
    logs = (_log(CASINO_A), _log(CASINO_B), _log(CASINO_PI))
    jm, _ = jax_device.baum_welch_batch(jax_device.BatchDiscreteHMM(*logs), seqs, n_iter=2)
    pm, _ = device.baum_welch_batch(device.BatchDiscreteHMM(*logs, device="cpu"), seqs, n_iter=2)
    lse = lambda a: np.log(np.exp(np.asarray(a, np.float64)).sum(axis=-1))  # noqa: E731
    np.testing.assert_allclose(lse(pm.A.numpy()), lse(jm.A), atol=1e-6)
    assert np.abs(lse(pm.Bm.numpy())).max() <= 1e-6

ORACLE_CASES = [
    ("toy", [[0.5, 0.5], [0.4, 0.6]], [[0.2, 0.3, 0.3, 0.2], [0.3, 0.2, 0.2, 0.3]], [0.5, 0.5], None,
     [2, 2, 1, 0, 1, 3, 2, 0, 0]),
    ("ices", [[0.8, 0.1], [0.1, 0.8]], [[0.7, 0.2, 0.1], [0.1, 0.2, 0.7]], [0.3, 0.7], [0.1, 0.1],
     [1, 2, 2, 1, 2, 1, 2, 1, 1, 2, 0, 2, 2, 0, 0, 0, 1, 0, 0, 0, 2, 0, 1, 0, 0, 0, 1, 2, 2, 1, 2, 1, 1]),
    ("uniform", [[0.5, 0.5], [0.5, 0.5]], [[0.5, 0.5], [0.5, 0.5]], [0.5, 0.5], None, [0, 1, 0, 1]),
    ("zeros", [[1.0, 0.0], [0.3, 0.7]], [[0.6, 0.4, 0.0], [0.2, 0.3, 0.5]], [1.0, 0.0], [0.5, 0.5], [0, 1, 1, 0, 2, 2, 1]),
]


@pytest.mark.parametrize("case", ORACLE_CASES, ids=[c[0] for c in ORACLE_CASES])
def test_oracle_matches_jax_oracle(case):
    """The port's copy of the host oracle equals the JAX package's:
    Viterbi (its last-maximum ties), forward, backward, one Baum-Welch
    step and iterative training."""
    _, A, Bm, pi, end, seq = case
    models = [
        mod.DiscreteEmissionOptEndModel.with_float(A, Bm, pi, end) if end is not None
        else mod.DiscreteEmissionModel.with_float(A, Bm, pi)
        for mod in (hmm, jax_hmm)
    ]
    p, j = models
    assert hmm.viterbi(p, seq) == jax_hmm.viterbi(j, seq)
    for fn in ("forward", "backward"):
        pv, pt = getattr(hmm, fn)(p, seq)
        jv, jt = getattr(jax_hmm, fn)(j, seq)
        np.testing.assert_array_equal(pv, jv)
        assert float(pt) == float(jt)
    if end is not None:
        for got, want in zip(hmm.baum_welch(p, seq), jax_hmm.baum_welch(j, seq)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(p.train_baum_welch([seq], n_iter=4), j.train_baum_welch([seq], n_iter=4)):
            np.testing.assert_array_equal(got, want)
    g = [mod.GaussianModel.with_float(A, [(0.0, 1.0), (2.0, 0.5)], pi) for mod in (hmm, jax_hmm)]
    xs = [0.1, 1.5, 1.8, 2.2, 0.5, -0.3]
    assert hmm.viterbi(g[0], xs) == jax_hmm.viterbi(g[1], xs)
    assert float(hmm.forward(g[0], xs)[1]) == float(jax_hmm.forward(g[1], xs)[1])
    assert float(hmm.backward(g[0], xs)[1]) == float(jax_hmm.backward(g[1], xs)[1])


def test_oracle_rejects_bad_dimensions():
    with pytest.raises(hmm.Error):
        hmm.DiscreteEmissionModel(np.zeros((2, 2)), np.zeros((3, 2)), np.zeros(2))
    with pytest.raises(hmm.Error):
        hmm.GaussianModel(np.zeros((2, 2)), [(0.0, 1.0)], np.zeros(2))


@pytest.mark.parametrize("kind", ["discrete", "gaussian"])
def test_hmm_from_jax(kind, monkeypatch):
    """A JAX model carried over computes what the JAX model computes (with
    an end vector: Viterbi and forward, which both packages take it into)."""
    rng = np.random.default_rng(5)
    S = 4
    A = rng.dirichlet(np.ones(S), size=S)
    pi = rng.dirichlet(np.ones(S))
    end = rng.dirichlet(np.ones(S))
    if kind == "discrete":
        jm = jax_device.BatchDiscreteHMM(_log(A), _log(rng.dirichlet(np.ones(5), size=S)), _log(pi), _log(end))
        seqs = _seqs(rng, 5, B=6, T=20)
    else:
        params = [(float(m), float(s)) for m, s in zip(rng.normal(0, 2, S), rng.uniform(0.3, 2, S))]
        jm = jax_device.BatchGaussianHMM(_log(A), params, _log(pi), _log(end))
        seqs = [list(rng.normal(0, 2, size=int(n))) for n in (20, 1, 7, 13)]
    pm = carry.hmm_from_jax(jm, device="cpu")
    assert type(pm).__name__ == type(jm).__name__
    for name in ("A", "pi", "end") + (("Bm",) if kind == "discrete" else ("mu", "log_norm", "inv2var")):
        np.testing.assert_array_equal(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)))
    jp, jprob = jm.viterbi_batch(seqs)
    pp, pprob = pm.viterbi_batch(seqs)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_allclose(pprob, jprob, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm.forward_batch(seqs)[1], jm.forward_batch(seqs)[1], rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        carry.hmm_from_jax(jm)


# ---- the departures from the JAX package (ROADMAP Queue 3) ----


def test_ties_first_maximum_against_oracle_last_maximum():
    """The uniform 2-state model on [0, 1, 0, 1]: the batch classes (port
    and JAX) take the lowest tied state, the host oracle the highest; both
    paths score ln(1/2^8)."""
    A = Bm = [[0.5, 0.5], [0.5, 0.5]]
    pi = [0.5, 0.5]
    seq = [0, 1, 0, 1]
    port = device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi), device="cpu").viterbi_batch([seq])
    jax_ = jax_device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi)).viterbi_batch([seq])
    oracle = hmm.viterbi(hmm.DiscreteEmissionModel.with_float(A, Bm, pi), seq)
    assert port[0].tolist() == jax_[0].tolist() == [[0, 0, 0, 0]]
    assert oracle[0] == [1, 1, 1, 0]
    assert port[1][0] == pytest.approx(float(oracle[1]), abs=1e-6) == pytest.approx(8 * np.log(0.5))


def test_backward_starts_from_end():
    """default_rng(3)'s 3-state model with end = [0.2, 0.5, 0.3] on [0, 1, 3,
    2, 1]: the port's backward total is the oracle's (-10.19716, the forward
    total); JAX's, which starts from zeros, is -9.04465."""
    rng = np.random.default_rng(3)
    S, V = 3, 4
    A = rng.dirichlet(np.ones(S), size=S)
    Bm = rng.dirichlet(np.ones(V), size=S)
    pi = rng.dirichlet(np.ones(S))
    end = np.array([0.2, 0.5, 0.3])
    seq = [0, 1, 3, 2, 1]
    oracle = hmm.DiscreteEmissionOptEndModel.with_float(A, Bm, pi, end)
    o_b = float(hmm.backward(oracle, seq)[1])
    o_f = float(hmm.forward(oracle, seq)[1])
    port = device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi), _log(end), device="cpu")
    jax_ = jax_device.BatchDiscreteHMM(_log(A), _log(Bm), _log(pi), _log(end))
    p_b = port.backward_batch([seq])[1][0]
    j_b = jax_.backward_batch([seq])[1][0]
    assert o_b == pytest.approx(-10.19716, abs=1e-5) and o_f == pytest.approx(o_b, abs=1e-5)
    assert p_b == pytest.approx(o_b, abs=1e-5)
    assert port.forward_batch([seq])[1][0] == pytest.approx(o_f, abs=1e-5)
    assert j_b == pytest.approx(-9.04465, abs=1e-5)
    # the rows: the port's row 0 is the end vector, JAX's zeros
    np.testing.assert_allclose(port.backward_batch([seq])[0][0], hmm.backward(oracle, seq)[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seqs", [[[0, 7, 1]], [[-1, 2], [1]], [[0, 1], []]], ids=["past-V", "negative", "empty"])
def test_bad_observations_raise(seqs):
    """Observations outside [0, V) and empty sequences raise ValueError in
    the port; JAX returns numbers for them (an emission of ln 1, or the
    padding's symbol)."""
    rng = np.random.default_rng(3)
    A = _log(rng.dirichlet(np.ones(3), size=3))
    Bm = _log(rng.dirichlet(np.ones(4), size=3))
    pi = _log(np.full(3, 1 / 3))
    port = device.BatchDiscreteHMM(A, Bm, pi, device="cpu")
    for fn in ("viterbi_batch", "forward_batch", "backward_batch"):
        with pytest.raises(ValueError):
            getattr(port, fn)(seqs)
    assert np.isfinite(jax_device.BatchDiscreteHMM(A, Bm, pi).forward_batch(seqs)[1]).all()
    with pytest.raises(ValueError):
        device.BatchGaussianHMM(A, [(0, 1)] * 3, pi, device="cpu").forward_batch([[0.5], []])


def test_gaussian_backward_follows_oracle():
    """JAX's BatchGaussianHMM.backward_batch raises TypeError; the port's
    equals the host oracle's backward."""
    A = [[0.9, 0.1], [0.2, 0.8]]
    params = [(0.0, 1.0), (2.0, 1.0)]
    xs = [0.1, 1.5, 1.8, 2.2, 0.5]
    jm = jax_device.BatchGaussianHMM(_log(A), params, _log([0.5, 0.5]))
    with pytest.raises(TypeError):
        jm.backward_batch([xs])
    pm = device.BatchGaussianHMM(_log(A), params, _log([0.5, 0.5]), device="cpu")
    vals, tot = pm.backward_batch([xs])
    w_vals, w_tot = hmm.backward(hmm.GaussianModel.with_float(A, params, [0.5, 0.5]), [float(np.float32(x)) for x in xs])
    np.testing.assert_allclose(vals[0], w_vals, rtol=1e-5, atol=1e-5)
    assert tot[0] == pytest.approx(float(w_tot), rel=1e-5)


# ---- the wrappers ----


def test_wrapper_checks():
    A = torch.zeros((2, 2))
    emit = torch.zeros((2, 3))
    pi = end = torch.zeros(2)
    obs = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.tensor([4, 1], dtype=torch.int32)
    for fn in (ops.viterbi, ops.forward, ops.backward):
        fn(A, emit, pi, end, obs, lens)
        with pytest.raises(ValueError, match="lens"):
            fn(A, emit, pi, end, obs, torch.tensor([5, 1], dtype=torch.int32))
        with pytest.raises(ValueError, match="lens"):
            fn(A, emit, pi, end, obs, torch.tensor([0, 1], dtype=torch.int32))
        with pytest.raises(ValueError, match="obs"):
            fn(A, emit, pi, end, obs + 3, lens)
        with pytest.raises(TypeError):
            fn(A, emit, pi, end, obs.long(), lens)
        with pytest.raises(ValueError):
            fn(A, torch.zeros((2, 3)), pi, end, obs.float(), lens)  # Gaussian rows are (3, S)
        with pytest.raises(ValueError, match="states"):
            fn(torch.zeros((257, 257)), torch.zeros((257, 3)), torch.zeros(257), torch.zeros(257), obs, lens)
    with pytest.raises(ValueError, match="states"):
        device.BatchDiscreteHMM(np.zeros((257, 257)), np.zeros((257, 2)), np.zeros(257), device="cpu")


def test_geometry_mirrors_source():
    src = (Path(ops.__file__).parent / "csrc" / "hmm.cu").read_text()
    const = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    assert const["WARPS"] == ops.HMM_WARPS
    assert const["WARP_MAX_S"] == ops.WARP_MAX_S
    assert const["MAX_S"] == ops.MAX_S
    assert const["SHARED_M_MAX"] == ops.SHARED_M_MAX
    assert ops.geometry(2) == {"layout": "warp", "slots": 2, "threads": 128, "shared_bytes": 0}
    assert ops.geometry(5)["slots"] == 8 and ops.geometry(32)["slots"] == 32
    g = ops.geometry(128)
    assert g["layout"] == "block" and g["threads"] == 128 and g["shared_m"] and g["shared_bytes"] == 4 * (256 + 128 * 128)
    assert not ops.geometry(200)["shared_m"] and ops.geometry(33)["threads"] == 64
    assert ops.geometry(156)["shared_m"] and not ops.geometry(157)["shared_m"]
