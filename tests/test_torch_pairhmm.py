"""The port's PairHMM family (``rust_bio_tpu_torch.stats.pairhmm``, kernels
K17, K17-log, K17-exact and K17-homopoly through their plain PyTorch
versions on the CPU) against the JAX package and the host oracles.

Tolerances (measured maxima in the comments):
- the -3e38 lanes of K17 and K17-log: the same set everywhere;
- K17 and K17-log in f32 against the interpret-mode Pallas K17 / the JAX
  ``BatchPairHMM._forward``: |d| <= 1e-5 * max(1, |p|);
- f64 log space and homopoly against the JAX twins: 1e-12 relative;
- K17-exact against the JAX class and the host oracle: 1e-12 relative (the
  plain version is bit-identical to both on these inputs), its skip mask
  bit for bit;
- the f32 classes against the host oracles: rel 2e-3, abs 2e-3, as
  ``tests/test_pairhmm.py`` and ``tests/test_homopolypairhmm.py`` hold the
  JAX classes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.ops.pairhmm_pallas import pairhmm_fwd_scaled as jax_fwd_scaled
from rust_bio_tpu.stats import pairhmm as jax_pairhmm
from rust_bio_tpu.stats.pairhmm import device as jax_device
from rust_bio_tpu.stats.pairhmm import exact as jax_exact
from rust_bio_tpu.stats.pairhmm import homopoly_device as jax_homopoly
from rust_bio_tpu.stats.pairhmm import homopolypairhmm as jax_homopoly_oracle
from rust_bio_tpu.utils.fastexp import fastexp as jax_pkg_fastexp
from rust_bio_tpu_torch import carry
from rust_bio_tpu_torch.ops import pairhmm as ops
from rust_bio_tpu_torch.stats import probs
from rust_bio_tpu_torch.stats.pairhmm import (
    BatchHomopolyPairHMM,
    BatchPairHMM,
    BatchPairHMMExact,
    BatchPairHMMLinear,
    EmissionParameters,
    GapParameters,
    Global,
    PairHMM,
    Semiglobal,
    XYEmission,
    homopolypairhmm,
)
from rust_bio_tpu_torch.utils.fastexp import fastexp, fastexp_torch

PROB_INS, PROB_DEL, PROB_SUBST = 2.8e-6, 5.1e-6, 0.0021
EMIT = np.array([math.log(1.0 - PROB_SUBST), math.log(PROB_SUBST / 3.0), math.log(1.0 - PROB_SUBST)])
NEG_INF = float("-inf")
# gap sets: the bench's (no extension) and one with both extensions on
GAPS = {
    "bench": (math.log(PROB_INS), math.log(PROB_DEL), NEG_INF, NEG_INF),
    "extend": (math.log(PROB_INS), math.log(PROB_DEL), math.log(0.3), math.log(0.2)),
}
F32_TOL = 1e-5


def _gap_kwargs(name):
    gx, gy, gxe, gye = GAPS[name]
    return dict(prob_gap_x=gx, prob_gap_y=gy, prob_gap_x_extend=gxe, prob_gap_y_extend=gye)


def _bench_batch(seed, B=12, M=36, N=14, ragged=True):
    """x a haplotype, y a substring of it with 2 errors (bench.py:225-248's
    geometry, small); ragged lengths with xlen 0 and ylen 0 lanes."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    xs = acgt[rng.integers(0, 4, size=(B, M))]
    ys = np.zeros((B, N), np.uint8)
    for i in range(B):
        s = int(rng.integers(0, M - N))
        ys[i] = xs[i, s : s + N]
        for _ in range(2):
            ys[i, int(rng.integers(0, N))] = acgt[int(rng.integers(0, 4))]
    xl = np.full(B, M, np.int32)
    yl = np.full(B, N, np.int32)
    if ragged:
        xl = rng.integers(N // 2, M + 1, size=B).astype(np.int32)
        yl = rng.integers(1, N + 1, size=B).astype(np.int32)
        xl[:4] = [M, 0, M, 1]
        yl[:4] = [N, N, 0, 1]
    for i in range(B):  # padding bytes past the lengths are zero
        xs[i, xl[i] :] = 0
        ys[i, yl[i] :] = 0
    return xs, ys, xl, yl


def _per_lane_emit(seed, B):
    """(B, 3) emissions from a per-read mean base quality (phred 15-40)."""
    q = np.random.default_rng(seed).uniform(15, 40, size=B)
    e = 10.0 ** (-q / 10.0)
    return np.stack([np.log1p(-e), np.log(e / 3.0), np.log1p(-e)], 1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


class _Emit(EmissionParameters):
    def __init__(self, x, y, ep):
        self.x, self.y, self.ep = x, y, ep

    def prob_emit_xy(self, i, j):
        if self.x[i] == self.y[j]:
            return XYEmission.match_(self.ep[0])
        return XYEmission.mismatch(self.ep[1])

    def prob_emit_x(self, i):
        return self.ep[2]

    def prob_emit_y(self, j):
        return self.ep[2]

    def len_x(self):
        return len(self.x)

    def len_y(self):
        return len(self.y)


class _Gaps(GapParameters):
    def __init__(self, name):
        self.v = GAPS[name]

    def prob_gap_x(self):
        return self.v[0]

    def prob_gap_y(self):
        return self.v[1]

    def prob_gap_x_extend(self):
        return self.v[2]

    def prob_gap_y_extend(self):
        return self.v[3]


def _oracle(gaps, xs, ys, xl, yl, ep, semiglobal, med=None, traces=None):
    hmm = PairHMM(_Gaps(gaps))
    out = []
    for b in range(len(xs)):
        e = ep if ep.ndim == 1 else ep[b]
        tr = [] if traces is not None else None
        x, y = bytes(xs[b, : xl[b]]), bytes(ys[b, : yl[b]])
        out.append(float(hmm.prob_related(_Emit(x, y, e), Semiglobal() if semiglobal else Global(), med, tr)))
        if traces is not None:
            traces.append(tr)
    return np.array(out)


_JAX_OBJECTS = {}


def _jax(cls, dtype=None, **kw):
    """One JAX object per class, dtype and scalar parameters: its forwards
    are jitted with the object static, so they compile once a module."""
    key = (cls, dtype, tuple(sorted(kw.items())))
    if key not in _JAX_OBJECTS:
        _JAX_OBJECTS[key] = cls(**kw) if dtype is None else cls(**kw, dtype=dtype)
    return _JAX_OBJECTS[key]


def _close_f32(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fell_g, fell_w = got <= ops.NEG_F32 / 2, want <= ops.NEG_F32 / 2
    np.testing.assert_array_equal(fell_g, fell_w)
    ok = ~fell_w
    err = np.abs(got[ok] - want[ok])
    assert (err <= F32_TOL * np.maximum(1.0, np.abs(want[ok]))).all(), err.max()


def _close_rel(got, want, rel=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    assert (np.abs(got[fin] - want[fin]) <= rel * np.maximum(1.0, np.abs(want[fin]))).all()


def _close_oracle(got, want):
    """The JAX suites' rule: an oracle -inf (or < -80) lane is < -75, the
    rest within rel 2e-3, abs 2e-3."""
    for g, w in zip(got, want):
        if w == NEG_INF or w < -80:
            assert g < -75, (g, w)
        else:
            assert g == pytest.approx(w, rel=2e-3, abs=2e-3)


# ---------------------------------------------------------------------------
# host copies: fastexp, LogProb, derived parameters
# ---------------------------------------------------------------------------


def test_fastexp_bit_identical():
    rng = np.random.default_rng(0)
    v = np.concatenate([
        [NEG_INF, -500.0, np.nextafter(-500.0, 0), np.nextafter(-500.0, -1), -499.999999, -500.000001,
         -1e300, 0.0, -0.0, -1e-300, -10.0, -0.6931471805599453, -708.0],
        -rng.exponential(20.0, size=2000), -rng.uniform(0, 1, size=500), rng.uniform(-520, -480, size=500),
    ])
    want = jax_pkg_fastexp(v)
    np.testing.assert_array_equal(fastexp(v).view(np.uint64), want.view(np.uint64))
    got_t = fastexp_torch(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got_t.view(np.uint64), want.view(np.uint64))


def test_logprob_copy_matches():
    from rust_bio_tpu.stats.probs import LogProb as JaxLogProb

    rng = np.random.default_rng(1)
    for _ in range(200):
        v = list(-rng.exponential(5.0, size=int(rng.integers(1, 6))))
        if rng.random() < 0.2:
            v[0] = NEG_INF
        assert float(probs.LogProb.ln_sum_exp(v)) == float(JaxLogProb.ln_sum_exp(v))
        a, b = float(v[0]), float(-rng.exponential(3.0))
        assert float(probs.LogProb(a).ln_add_exp(b)) == float(JaxLogProb(a).ln_add_exp(b))
        assert float(probs.LogProb(b).ln_one_minus_exp()) == float(JaxLogProb(b).ln_one_minus_exp())


@pytest.mark.parametrize("gaps", list(GAPS))
def test_derived_parameters_bit_identical(gaps):
    kw = _gap_kwargs(gaps)
    assert BatchPairHMM(**kw, device="cpu").g == jax_device.BatchPairHMM(**kw).g
    assert BatchPairHMMLinear(**kw, device="cpu").g == jax_device.BatchPairHMMLinear(**kw).g
    assert vars(BatchPairHMMExact(**kw, device="cpu").g) == vars(jax_exact.BatchPairHMMExact(**kw).g)
    assert vars(PairHMM(_Gaps(gaps)).gap_params) == vars(jax_pairhmm.PairHMM(_Gaps(gaps)).gap_params)


HOMOPOLY_SETS = {
    # tests/test_homopolypairhmm.py:332-340's parameter sets and the bench's
    "single-gaps": ("SingleGapParams", "NoHopParams", "SINGLE_GAPS_NO_HOPS"),
    "hops": ("NoGapParams", "WithHopParams", "NO_GAPS_WITH_HOPS"),
    "extend-gaps": ("ExtendGapParams", "NoHopParams", "EXTEND_GAPS_NO_HOPS"),
}


def _homopoly_kwargs(name):
    import test_homopolypairhmm as th

    gp, hp = getattr(th, HOMOPOLY_SETS[name][0])(), getattr(th, HOMOPOLY_SETS[name][1])()
    return dict(
        prob_gap_x=gp.prob_gap_x(), prob_gap_y=gp.prob_gap_y(),
        prob_gap_x_extend=gp.prob_gap_x_extend(), prob_gap_y_extend=gp.prob_gap_y_extend(),
        prob_hop_x=hp.prob_hop_x(), prob_hop_y=hp.prob_hop_y(),
        prob_hop_x_extend=hp.prob_hop_x_extend(), prob_hop_y_extend=hp.prob_hop_y_extend(),
    )


BENCH_HOPS = dict(
    prob_gap_x=math.log(PROB_INS), prob_gap_y=math.log(PROB_DEL), prob_gap_x_extend=NEG_INF,
    prob_gap_y_extend=NEG_INF, prob_hop_x=math.log(1e-4), prob_hop_y=math.log(1e-4),
    prob_hop_x_extend=math.log(0.5), prob_hop_y_extend=math.log(0.5),
)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", list(HOMOPOLY_SETS) + ["bench", "base-specific"])
def test_homopoly_derived_parameters_bit_identical(name, dtype):
    if name == "bench":
        kw = dict(BENCH_HOPS)
    elif name == "base-specific":
        kw = dict(BENCH_HOPS, prob_hop_x=np.log([1e-4, 2e-4, 3e-4, 4e-4]), prob_hop_y_extend=np.log([0.5, 0.4, 0.3, 0.2]))
    else:
        kw = _homopoly_kwargs(name)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.float64, jnp.float64)
    mine = BatchHomopolyPairHMM(**kw, dtype=tdt, device="cpu").p
    theirs = jax_homopoly.BatchHomopolyPairHMM(**kw, dtype=jdt).p
    assert mine.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(np.asarray(mine[k]).view(np.uint64), np.asarray(theirs[k]).view(np.uint64), err_msg=k)


def test_homopoly_oracle_copy_matches():
    import test_homopolypairhmm as th

    rng = np.random.default_rng(2)
    for name in HOMOPOLY_SETS:
        gp_name, hp_name, _ = HOMOPOLY_SETS[name]
        gp, hp = getattr(th, gp_name)(), getattr(th, hp_name)()
        mine = homopolypairhmm.HomopolyPairHMM(gp, hp)
        theirs = jax_homopoly_oracle.HomopolyPairHMM(gp, hp)
        assert mine.transition_probs == theirs.transition_probs
        for semi in (False, True):
            for _ in range(3):
                x = bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(1, 9))))
                y = bytes(rng.choice(list(b"ACGT"), size=int(rng.integers(1, 9))))
                mode = th.Semiglobal() if semi else th.Global()
                assert float(mine.prob_related(th.EmParams(x, y), mode, 2)) == float(
                    theirs.prob_related(th.EmParams(x, y), mode, 2)
                )


# ---------------------------------------------------------------------------
# K17: plain version against the interpret-mode Pallas kernel
# ---------------------------------------------------------------------------


def _pallas_k17(xs, ys, xl, yl, params, semiglobal):
    """The JAX package's Pallas K17 in interpret mode (B padded to 256 with
    length-1 lanes here only, as device.py:383-387 pads)."""
    B = xs.shape[0]
    padb = -B % 256
    out = jax_fwd_scaled(
        jnp.asarray(np.pad(xs, ((0, padb), (0, 0)))), jnp.asarray(np.pad(ys, ((0, padb), (0, 0)))),
        jnp.asarray(np.pad(xl, (0, padb), constant_values=1)), jnp.asarray(np.pad(yl, (0, padb), constant_values=1)),
        params, bool(semiglobal),
    )
    return np.asarray(out)[:B]


@pytest.mark.parametrize("semiglobal", [False, True])
@pytest.mark.parametrize("gaps", list(GAPS))
def test_k17_plain_matches_pallas_interpret(gaps, semiglobal):
    xs, ys, xl, yl = _bench_batch(3)
    hmm = BatchPairHMMLinear(**_gap_kwargs(gaps), device="cpu")
    lin = np.concatenate([hmm._lin_params.numpy(), np.exp(EMIT).astype(np.float32)])
    want = _pallas_k17(xs, ys, xl, yl, lin, semiglobal)
    got = ops.pairhmm_fwd_scaled(*_t(xs, ys, xl, yl), hmm._lin_params, torch.from_numpy(lin[7:]), semiglobal)
    _close_f32(got.numpy(), want)  # measured: max 4e-6 on the finite lanes


def test_k17_per_lane_emissions_are_the_shared_kernel_per_lane():
    """The lane stride of the emissions: (B, 3) rows all equal give the
    shared result bit for bit; distinct rows give each lane its own."""
    xs, ys, xl, yl = _bench_batch(4)
    B = xs.shape[0]
    hmm = BatchPairHMMLinear(**_gap_kwargs("bench"), device="cpu")
    shared = torch.from_numpy(np.exp(EMIT).astype(np.float32))
    args = _t(xs, ys, xl, yl)
    for semi in (False, True):
        want = ops.pairhmm_fwd_scaled(*args, hmm._lin_params, shared, semi)
        got = ops.pairhmm_fwd_scaled(*args, hmm._lin_params, shared.expand(B, 3).contiguous(), semi)
        assert torch.equal(got, want)
        ep = torch.from_numpy(np.exp(_per_lane_emit(5, B)).astype(np.float32))
        per = ops.pairhmm_fwd_scaled(*args, hmm._lin_params, ep, semi)
        for b in (0, 5, 9):
            one = ops.pairhmm_fwd_scaled(*(a[b : b + 1] for a in args), hmm._lin_params, ep[b].contiguous(), semi)
            assert torch.equal(per[b : b + 1], one)


# ---------------------------------------------------------------------------
# K17-log: plain version against BatchPairHMM._forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("emission", ["shared", "per-lane"])
@pytest.mark.parametrize("semiglobal", [False, True])
@pytest.mark.parametrize("gaps", list(GAPS))
def test_k17_log_plain_matches_jax_f32(gaps, semiglobal, emission):
    xs, ys, xl, yl = _bench_batch(5)
    ep = EMIT if emission == "shared" else _per_lane_emit(6, xs.shape[0])
    jhmm = _jax(jax_device.BatchPairHMM, **_gap_kwargs(gaps))
    want = np.asarray(jhmm._forward(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xl), jnp.asarray(yl),
                                    jnp.asarray(ep, jnp.float32), None, semiglobal))
    hmm = BatchPairHMM(**_gap_kwargs(gaps), device="cpu")
    got = ops.pairhmm_fwd_log(*_t(xs, ys, xl, yl), hmm._log_params, torch.from_numpy(ep).float(), semiglobal)
    _close_f32(got.numpy(), want)  # measured: max 4e-6


@pytest.mark.parametrize("semiglobal", [False, True])
@pytest.mark.parametrize("gaps", list(GAPS))
def test_k17_log_plain_matches_jax_f64(gaps, semiglobal):
    xs, ys, xl, yl = _bench_batch(7)
    ep = _per_lane_emit(8, xs.shape[0])
    with jax.enable_x64(True):
        jhmm = _jax(jax_device.BatchPairHMM, jnp.float64, **_gap_kwargs(gaps))
        want = np.asarray(jhmm._forward(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xl), jnp.asarray(yl),
                                        jnp.asarray(ep, jnp.float64), None, semiglobal))
    hmm = BatchPairHMM(**_gap_kwargs(gaps), dtype=torch.float64, device="cpu")
    got = ops.pairhmm_fwd_log(*_t(xs, ys, xl, yl), hmm._log_params, torch.from_numpy(ep), semiglobal).numpy()
    _close_rel(got, want)


# ---------------------------------------------------------------------------
# K17-exact: plain version against the JAX class and the host oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("med", [None, 2, 4])
@pytest.mark.parametrize("semiglobal", [False, True])
@pytest.mark.parametrize("gaps", list(GAPS))
def test_k17_exact_plain_matches_jax_and_oracle(gaps, semiglobal, med):
    xs, ys, xl, yl = _bench_batch(9, B=8, M=24, N=10)
    ep = EMIT if gaps == "bench" else _per_lane_emit(10, xs.shape[0])
    hmm = BatchPairHMMExact(**_gap_kwargs(gaps), device="cpu")
    got, skip = hmm._forward(*_t(xs, ys, xl, yl, ep), semiglobal, med, True)
    if med in (None, 2):  # the JAX class compiles once a band: two of the three
        with jax.enable_x64(True):
            want = _jax(jax_exact.BatchPairHMMExact, **_gap_kwargs(gaps)).prob_related_batch(
                xs, ys, ep, semiglobal, med, xl, yl
            )
        _close_rel(got.numpy(), want)  # measured: bit-identical
    traces = []
    oracle = _oracle(gaps, xs, ys, xl, yl, ep, semiglobal, med, traces)
    _close_rel(got.numpy(), oracle)  # measured: bit-identical
    for b, tr in enumerate(traces):
        mask = np.zeros(skip.shape[1:], bool)
        for i, j in tr:
            mask[i, j] = True
        np.testing.assert_array_equal(skip[b].numpy(), mask)


def test_k17_exact_reference_bench_pair():
    """benches/pairhmm.rs:9-13's pair, semiglobal, banded at 4 and not."""
    from test_pairhmm_exact import BENCH_PATTERN, BENCH_TEXT

    xs = np.frombuffer(BENCH_TEXT, np.uint8)[None, :]
    ys = np.frombuffer(BENCH_PATTERN, np.uint8)[None, :]
    hmm = BatchPairHMMExact(**_gap_kwargs("bench"), device="cpu")
    for med in (4, None):
        want = _oracle("bench", xs, ys, [xs.shape[1]], [ys.shape[1]], EMIT, True, med)
        got = hmm.prob_related_batch(xs, ys, EMIT, True, med)
        _close_rel(got, want)


def test_k17_exact_negative_band_skips_everything():
    xs, ys, xl, yl = _bench_batch(11, B=4, M=12, N=6, ragged=False)
    hmm = BatchPairHMMExact(**_gap_kwargs("bench"), device="cpu")
    got, skip = hmm._forward(*_t(xs, ys, xl, yl, EMIT), True, -1, True)
    assert skip.all() and (got.numpy() == NEG_INF).all()
    _close_rel(got.numpy(), _oracle("bench", xs, ys, xl, yl, EMIT, True, -1))


# ---------------------------------------------------------------------------
# K17-homopoly: plain version against the JAX class and the host oracle
# ---------------------------------------------------------------------------


def _homopoly_batch(seed):
    """tests/test_homopolypairhmm.py's device batch, with an xlen 0 and a
    ylen 0 lane."""
    rng = np.random.default_rng(seed)
    B = 8
    xs_list, ys_list = [], []
    for _ in range(B):
        m = int(rng.integers(2, 14))
        n = int(rng.integers(2, 18))
        x = rng.choice(list(b"ACGT"), size=m).astype("uint8")
        if rng.random() < 0.6 and n >= m:
            y = np.concatenate([x, rng.choice(list(b"ACGT"), size=n - m).astype("uint8")])
        else:
            y = rng.choice(list(b"ACGT"), size=n).astype("uint8")
        if rng.random() < 0.5:
            x[1:3] = x[0]
        xs_list.append(x)
        ys_list.append(y)
    xs_list[0] = xs_list[0][:0]
    ys_list[1] = ys_list[1][:0]
    M = max(len(x) for x in xs_list)
    N = max(len(y) for y in ys_list)
    xs = np.zeros((B, M), np.uint8)
    ys = np.zeros((B, N), np.uint8)
    xl = np.array([len(x) for x in xs_list], np.int32)
    yl = np.array([len(y) for y in ys_list], np.int32)
    for i in range(B):
        xs[i, : xl[i]] = xs_list[i]
        ys[i, : yl[i]] = ys_list[i]
    return xs, ys, xl, yl


def _homopoly_emit():
    import test_homopolypairhmm as th

    return np.array(th._emit_vec())


@pytest.mark.parametrize("semiglobal", [False, True])
@pytest.mark.parametrize("name", list(HOMOPOLY_SETS))
def test_k17_homopoly_plain_matches_jax_and_oracle(name, semiglobal):
    import test_homopolypairhmm as th

    kw = _homopoly_kwargs(name)
    xs, ys, xl, yl = _homopoly_batch(17)
    ep = _homopoly_emit()
    hmm32 = BatchHomopolyPairHMM(**kw, device="cpu")
    got32 = ops.pairhmm_fwd_homopoly(*_t(xs, ys, xl, yl), hmm32._params, torch.from_numpy(ep).float(), semiglobal)
    hmm64 = BatchHomopolyPairHMM(**kw, dtype=torch.float64, device="cpu")
    got64 = ops.pairhmm_fwd_homopoly(*_t(xs, ys, xl, yl), hmm64._params, torch.from_numpy(ep), semiglobal)
    # each JAX forward compiles for 4 s on one core: the f64 twin in
    # semiglobal mode, the f32 one in global mode on the extend-gap set
    if not semiglobal and name == "extend-gaps":
        want32 = jax_homopoly.BatchHomopolyPairHMM(**kw).prob_related_batch(xs, ys, ep, semiglobal, xl, yl)
        _close_f32(got32.numpy(), want32)  # measured: max 4e-6
    elif semiglobal:
        with jax.enable_x64(True):
            want64 = jax_homopoly.BatchHomopolyPairHMM(**kw, dtype=jnp.float64).prob_related_batch(
                xs, ys, ep, semiglobal, xl, yl
            )
        _close_rel(got64.numpy(), want64)
    _close_f32(got32.numpy(), got64.numpy())
    oracle = getattr(th, HOMOPOLY_SETS[name][2])
    mode = th.Semiglobal() if semiglobal else th.Global()
    want_o = [
        float(oracle.prob_related(th.EmParams(bytes(xs[b, : xl[b]]), bytes(ys[b, : yl[b]])), mode, None))
        for b in range(len(xs))
    ]
    _close_oracle(got32.numpy(), want_o)


def test_k17_homopoly_base_specific_hops_match_jax():
    xs, ys, xl, yl = _homopoly_batch(18)
    ep = np.tile(_homopoly_emit(), (len(xs), 1))
    ep[:, 1] -= np.linspace(0.0, 1.0, len(xs))  # per-lane mismatch emissions
    kw = dict(BENCH_HOPS, prob_hop_x=np.log([1e-3, 2e-3, 3e-3, 4e-3]), prob_hop_x_extend=np.log([0.5, 0.4, 0.3, 0.2]))
    with jax.enable_x64(True):
        want = jax_homopoly.BatchHomopolyPairHMM(**kw, dtype=jnp.float64).prob_related_batch(xs, ys, ep, True, xl, yl)
    got = BatchHomopolyPairHMM(**kw, dtype=torch.float64, device="cpu").prob_related_batch(xs, ys, ep, True, xl, yl)
    _close_rel(got, want)


def test_homopoly_match_transition_departs_from_the_oracle():
    """The JAX package's class (and so the port's) takes the mean hop
    probability as ln_sum_exp(hops) - ln 4, where the host oracle subtracts
    4.0 (homopolypairhmm.py:124-136): at bench.py's hop 1e-4 the classes'
    match-to-match transition is -2.08e-4 against the oracle's -2.26e-5, a
    constant 1.85e-4 a match step (ROADMAP Queue 3). With the class's value
    in the oracle's table the two agree."""
    import test_homopolypairhmm as th

    kw = dict(BENCH_HOPS)
    mine = BatchHomopolyPairHMM(**kw, device="cpu")
    assert float(mine.p["match_any"]) == float(jax_homopoly.BatchHomopolyPairHMM(**kw).p["match_any"])

    class Gaps(GapParameters):
        def prob_gap_x(self):
            return kw["prob_gap_x"]

        def prob_gap_y(self):
            return kw["prob_gap_y"]

        def prob_gap_x_extend(self):
            return NEG_INF

        def prob_gap_y_extend(self):
            return NEG_INF

    class Hops(homopolypairhmm.HopParameters):
        def prob_hop_x(self):
            return kw["prob_hop_x"]

        def prob_hop_y(self):
            return kw["prob_hop_y"]

        def prob_hop_x_extend(self):
            return kw["prob_hop_x_extend"]

        def prob_hop_y_extend(self):
            return kw["prob_hop_y_extend"]

    oracle = homopolypairhmm.HomopolyPairHMM(Gaps(), Hops())
    assert oracle.transition_probs[(0, 0)] == pytest.approx(-2.2553e-5, rel=1e-4)
    assert float(mine.p["match_any"]) == pytest.approx(-2.0792e-4, rel=1e-4)
    x = np.random.default_rng(28).choice(list(b"ACGT"), size=40).astype(np.uint8)
    xs, ys = x[None, :], x[None, 5:35].copy()  # a 30 bp read, no error
    got = mine.prob_related_batch(xs, ys, _homopoly_emit(), True)
    x, y = bytes(xs[0]), bytes(ys[0])
    want = float(oracle.prob_related(th.EmParams(x, y), Semiglobal(), None))
    # about one offset a match step of the 30
    steps = (got[0] - want) / (float(mine.p["match_any"]) - oracle.transition_probs[(0, 0)])
    assert 28 <= steps <= 31, steps
    for m1 in homopolypairhmm.MATCH_STATES:
        for m2 in homopolypairhmm.MATCH_STATES:
            oracle.transition_probs[(m1, m2)] = float(mine.p["match_any"])
    assert got[0] == pytest.approx(float(oracle.prob_related(th.EmParams(x, y), Semiglobal(), None)), abs=2e-5)


# ---------------------------------------------------------------------------
# the classes end to end on the CPU path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("emission", ["shared", "per-lane"])
@pytest.mark.parametrize("semiglobal", [False, True])
@pytest.mark.parametrize("cls", ["BatchPairHMM", "BatchPairHMMLinear"])
def test_log_and_linear_classes_against_jax_and_oracle(cls, semiglobal, emission):
    xs, ys, xl, yl = _bench_batch(19)
    ep = EMIT if emission == "shared" else _per_lane_emit(20, xs.shape[0])
    got = globals()[cls](**_gap_kwargs("bench"), device="cpu").prob_related_batch(xs, ys, ep, semiglobal, xl, yl)
    if emission == "shared" or cls == "BatchPairHMM":
        want = _jax(getattr(jax_device, cls), **_gap_kwargs("bench")).prob_related_batch(xs, ys, ep, semiglobal, xl, yl)
        _close_f32(got, want)
    _close_oracle(got, _oracle("bench", xs, ys, xl, yl, ep, semiglobal))


@pytest.mark.parametrize("semiglobal", [False, True])
def test_exact_class_against_oracle_with_extensions(semiglobal):
    xs, ys, xl, yl = _bench_batch(21, B=6, M=20, N=9)
    ep = _per_lane_emit(22, xs.shape[0])
    got = BatchPairHMMExact(**_gap_kwargs("extend"), device="cpu").prob_related_batch(xs, ys, ep, semiglobal, 3, xl, yl)
    _close_rel(got, _oracle("extend", xs, ys, xl, yl, ep, semiglobal, 3))


@pytest.mark.parametrize("semiglobal", [False, True])
def test_homopoly_class_on_bench_pairs_against_oracle(semiglobal):
    """bench.py:423-460's hop parameters on small bench pairs, per-lane
    emissions of equal rows."""
    kw = BENCH_HOPS
    xs, ys, xl, yl = _bench_batch(23, B=4, M=16, N=7)
    ep = np.tile(_homopoly_emit(), (4, 1))
    got = BatchHomopolyPairHMM(**kw, device="cpu").prob_related_batch(xs, ys, ep, semiglobal, xl, yl)

    class Gaps(GapParameters):
        def prob_gap_x(self):
            return kw["prob_gap_x"]

        def prob_gap_y(self):
            return kw["prob_gap_y"]

        def prob_gap_x_extend(self):
            return NEG_INF

        def prob_gap_y_extend(self):
            return NEG_INF

    class Hops(homopolypairhmm.HopParameters):
        def prob_hop_x(self):
            return kw["prob_hop_x"]

        def prob_hop_y(self):
            return kw["prob_hop_y"]

        def prob_hop_x_extend(self):
            return kw["prob_hop_x_extend"]

        def prob_hop_y_extend(self):
            return kw["prob_hop_y_extend"]

    import test_homopolypairhmm as th

    # with the class's match-to-match transition in the oracle's table (the
    # two derive it differently: the test above)
    oracle = homopolypairhmm.HomopolyPairHMM(Gaps(), Hops())
    for m1 in homopolypairhmm.MATCH_STATES:
        for m2 in homopolypairhmm.MATCH_STATES:
            oracle.transition_probs[(m1, m2)] = float(BatchHomopolyPairHMM(**kw, device="cpu").p["match_any"])
    mode = Semiglobal() if semiglobal else Global()
    want = [float(oracle.prob_related(th.EmParams(bytes(xs[b, : xl[b]]), bytes(ys[b, : yl[b]])), mode, None)) for b in range(4)]
    _close_oracle(got, want)


def test_classes_validate_inputs():
    hmm = BatchPairHMM(**_gap_kwargs("bench"), device="cpu")
    xs, ys, xl, yl = _bench_batch(24, B=3, M=8, N=4, ragged=False)
    with pytest.raises(ValueError, match="xlens"):
        hmm.prob_related_batch(xs, ys, EMIT, False, xl + 1, yl)
    with pytest.raises(ValueError, match="emit_probs"):
        hmm.prob_related_batch(xs, ys, np.zeros((2, 3)), False, xl, yl)
    with pytest.raises(TypeError, match="params"):
        ops.pairhmm_fwd_log(*_t(xs, ys, xl, yl), torch.zeros(7, dtype=torch.float16), torch.zeros(3), False)


# ---------------------------------------------------------------------------
# the JAX package's per-lane fallback fault (ROADMAP Queue 3)
# ---------------------------------------------------------------------------


def _fault_batch():
    """B = 4, x = y[10:64] (54 bp) for all four lanes, ylens [64, 64, 207,
    207]: the lanes of length 207 underflow K17 and fall back."""
    rng = np.random.default_rng(25)
    y = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=207)]
    xs = np.tile(y[10:64], (4, 1))
    ys = np.tile(y, (4, 1))
    xl = np.full(4, 54, np.int32)
    yl = np.array([64, 64, 207, 207], np.int32)
    kw = dict(prob_gap_x=math.log(2.8e-6), prob_gap_y=math.log(5.1e-6), prob_gap_x_extend=math.log(0.5), prob_gap_y_extend=math.log(0.5))
    return xs, ys, xl, yl, kw


def test_per_lane_fallback_fault_repaired():
    xs, ys, xl, yl, kw = _fault_batch()
    per_lane = np.tile(EMIT, (4, 1))
    # the JAX package: the fallback re-run broadcasts (4, 3) emissions onto
    # its 2-lane sub-batch
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        _jax(jax_device.BatchPairHMMLinear, **kw).prob_related_batch(xs, ys, per_lane, True, xl, yl)
    hmm = BatchPairHMMLinear(**kw, device="cpu")
    shared = hmm.prob_related_batch(xs, ys, EMIT, True, xl, yl)
    np.testing.assert_array_equal(hmm.prob_related_batch(xs, ys, per_lane, True, xl, yl), shared)
    fell = ops.pairhmm_fwd_scaled(*_t(xs, ys, xl, yl), hmm._lin_params, torch.from_numpy(np.exp(EMIT).astype(np.float32)), True)
    assert (fell.numpy() <= ops.NEG_F32 / 2).tolist() == [False, False, True, True]
    np.testing.assert_allclose(shared, _jax(jax_device.BatchPairHMMLinear, **kw).prob_related_batch(xs, ys, EMIT, True, xl, yl), rtol=1e-6)
    # lanes 0-1 and 2-3 are the same pairs: the oracle on lanes 1 and 2
    _close_oracle(shared[1:3], _oracle_gaps(kw, xs[1:3], ys[1:3], xl[1:3], yl[1:3], EMIT, True))
    # distinct rows: every lane, fallen or not, with its own emissions, as a
    # one-lane call with that row shared gives it, and as the f64
    # log-space forward does
    ep = _per_lane_emit(26, 4)
    got = hmm.prob_related_batch(xs, ys, ep, True, xl, yl)
    for b in (1, 2):  # one lane that K17 keeps, one it hands to K17-log
        one = hmm.prob_related_batch(xs[b : b + 1], ys[b : b + 1], ep[b], True, xl[b : b + 1], yl[b : b + 1])
        assert got[b] == one[0]
    f64 = BatchPairHMM(**kw, dtype=torch.float64, device="cpu").prob_related_batch(xs, ys, ep, True, xl, yl)
    _close_f32(got, f64)


def _oracle_gaps(kw, xs, ys, xl, yl, ep, semiglobal):
    GAPS["_fault"] = (kw["prob_gap_x"], kw["prob_gap_y"], kw["prob_gap_x_extend"], kw["prob_gap_y_extend"])
    try:
        return _oracle("_fault", xs, ys, xl, yl, ep, semiglobal)
    finally:
        del GAPS["_fault"]


# ---------------------------------------------------------------------------
# carry: the port's classes from a JAX object's derived parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["BatchPairHMM", "BatchPairHMMLinear", "BatchPairHMMExact", "BatchHomopolyPairHMM"])
def test_pairhmm_from_params(kind):
    xs, ys, xl, yl = _bench_batch(27, B=6, M=20, N=8)
    if kind == "BatchHomopolyPairHMM":
        jobj = jax_homopoly.BatchHomopolyPairHMM(**BENCH_HOPS)
        params, ep = jobj.p, np.append(EMIT, EMIT[2])
        mine = carry.pairhmm_from_params(kind, params, device="cpu")
        assert mine.p.keys() == jobj.p.keys()
    elif kind == "BatchPairHMMExact":
        jobj = _jax(jax_exact.BatchPairHMMExact, **_gap_kwargs("extend"))
        params, ep = vars(jobj.g), EMIT
        mine = carry.pairhmm_from_params(kind, params, device="cpu")
        assert vars(mine.g) == vars(jobj.g)
    else:
        jobj = _jax(getattr(jax_device, kind), **_gap_kwargs("extend"))
        params, ep = jobj.g, EMIT
        mine = carry.pairhmm_from_params(kind, params, device="cpu")
        assert mine.g == jobj.g
    ref = {
        "BatchPairHMM": lambda: BatchPairHMM(**_gap_kwargs("extend"), device="cpu"),
        "BatchPairHMMLinear": lambda: BatchPairHMMLinear(**_gap_kwargs("extend"), device="cpu"),
        "BatchPairHMMExact": lambda: BatchPairHMMExact(**_gap_kwargs("extend"), device="cpu"),
        "BatchHomopolyPairHMM": lambda: BatchHomopolyPairHMM(**BENCH_HOPS, device="cpu"),
    }[kind]()
    for semi in (False, True):
        got = mine.prob_related_batch(xs, ys, ep, semi, xlens=xl, ylens=yl)
        np.testing.assert_array_equal(got, ref.prob_related_batch(xs, ys, ep, semi, xlens=xl, ylens=yl))
    # and the JAX object on the same call (semiglobal: one compile)
    if kind == "BatchPairHMMExact":
        with jax.enable_x64(True):
            want = jobj.prob_related_batch(xs, ys, ep, True, xlens=xl, ylens=yl)
        _close_rel(got, want)
    else:
        _close_f32(got, jobj.prob_related_batch(xs, ys, ep, True, xlens=xl, ylens=yl))
    with pytest.raises(ValueError, match="kind"):
        carry.pairhmm_from_params("Nope", params, device="cpu")
