"""Hidden Markov Models: Viterbi, forward, backward, Baum-Welch.

Reference parity: src/stats/hmm/mod.rs — ``Model`` trait (:240-280),
``viterbi`` with last-max tie-breaking (:283-356,375), ``forward`` (:398),
``backward`` (reverse-ordered matrix, :439), one-step ``baum_welch``
(:520-682) and the iterative ``Trainable::train_baum_welch`` (:1016-1110);
concrete models: ``DiscreteEmissionModel`` (discrete_emission::Model,
:714-833), ``DiscreteEmissionOptEndModel`` (:836+), ``GaussianModel``
(univariate_continuous_emission, :1116+).

Matrices are numpy float64 arrays holding natural-log probabilities; the
batched path on the card lives in ``device.py``. The port's copy of the
JAX package's host oracle, with its last-maximum tie-break.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rust_bio_tpu_torch.stats.probs import LogProb

State = int
NEG_INF = float("-inf")


class Error(ValueError):
    pass


class Model:
    """HMM interface (hmm/mod.rs:240)."""

    def num_states(self) -> int:
        raise NotImplementedError

    def states(self):
        return range(self.num_states())

    def transitions(self):
        n = self.num_states()
        return ((a, b) for a in range(n) for b in range(n))

    def transition_prob(self, from_: State, to: State) -> float:
        raise NotImplementedError

    def transition_prob_idx(self, from_: State, to: State, _to_idx: int) -> float:
        return self.transition_prob(from_, to)

    def initial_prob(self, state: State) -> float:
        raise NotImplementedError

    def observation_prob(self, state: State, observation) -> float:
        raise NotImplementedError

    def end_prob(self, state: State) -> float:
        return 0.0  # ln_one

    def has_end_state(self) -> bool:
        return False


def _viterbi_matrices(hmm: Model, observations) -> Tuple[np.ndarray, np.ndarray]:
    n_obs = len(observations)
    N = hmm.num_states()
    vals = np.full((n_obs, N), NEG_INF)
    frm = np.zeros((n_obs, N), dtype=np.int64)
    for i, o in enumerate(observations):
        if i == 0:
            for s in hmm.states():
                vals[0, s] = hmm.initial_prob(s) + hmm.observation_prob(s, o)
                frm[0, s] = s
        else:
            for j in hmm.states():
                # last-max tie-break, zeros (ln 0) ordered smallest —
                # mirrors the reference's max_by semantics (:303-322)
                best_a, best_val = 0, None
                for a in hmm.states():
                    v = vals[i - 1, a]
                    key = (
                        NEG_INF
                        if v == NEG_INF
                        else v + hmm.transition_prob_idx(a, j, i)
                    )
                    if best_val is None or key >= best_val:
                        best_a, best_val = a, key
                vals[i, j] = (
                    vals[i - 1, best_a]
                    + hmm.transition_prob_idx(best_a, j, i)
                    + hmm.observation_prob(j, o)
                )
                frm[i, j] = best_a
    return vals, frm


def viterbi(hmm: Model, observations) -> Tuple[List[State], LogProb]:
    """Most probable state path and its probability (hmm/mod.rs:375)."""
    vals, frm = _viterbi_matrices(hmm, observations)
    n = vals.shape[0]
    result: List[State] = []
    curr = 0
    res_prob = NEG_INF
    for i in range(n):
        if i == 0:
            curr = int(np.argmax(vals[n - 1]))
            res_prob = float(vals[n - 1, curr])
        else:
            curr = int(frm[n - i, curr])
        result.append(curr)
    result.reverse()
    return result, LogProb(res_prob)


def forward(hmm: Model, observations) -> Tuple[np.ndarray, LogProb]:
    """Forward probability table + total probability (hmm/mod.rs:398)."""
    n_obs = len(observations)
    N = hmm.num_states()
    vals = np.full((n_obs, N), NEG_INF)
    for i, o in enumerate(observations):
        if i == 0:
            for s in hmm.states():
                vals[0, s] = hmm.initial_prob(s) + hmm.observation_prob(s, o)
        else:
            for j in hmm.states():
                xs = [
                    vals[i - 1, k]
                    + hmm.transition_prob_idx(k, j, i)
                    + hmm.observation_prob(j, o)
                    for k in hmm.states()
                ]
                vals[i, j] = float(LogProb.ln_sum_exp(xs))
    final = [
        vals[n_obs - 1, k] + hmm.end_prob(k) for k in hmm.states()
    ]
    return vals, LogProb(LogProb.ln_sum_exp(final))


def backward(hmm: Model, observations) -> Tuple[np.ndarray, LogProb]:
    """Backward table (rows in reverse time order, like the reference)."""
    n_obs = len(observations)
    N = hmm.num_states()
    vals = np.full((n_obs, N), NEG_INF)
    prob_vec_final: List[float] = []
    n = n_obs
    rev = list(observations)[::-1]
    for i, o in enumerate(rev):
        if i == 0:
            for j in hmm.states():
                vals[0, j] = hmm.end_prob(j)
            for j in hmm.states():
                xs = [
                    vals[i, k]
                    + hmm.transition_prob_idx(j, k, n - i)
                    + hmm.observation_prob(k, o)
                    for k in hmm.states()
                ]
                if n_obs > 1:
                    vals[i + 1, j] = float(LogProb.ln_sum_exp(xs))
                else:
                    prob_vec_final = [
                        vals[i, k]
                        + hmm.initial_prob(k)
                        + hmm.observation_prob(k, o)
                        for k in hmm.states()
                    ]
        elif i == n_obs - 1:
            prob_vec_final = [
                vals[i, k] + hmm.initial_prob(k) + hmm.observation_prob(k, o)
                for k in hmm.states()
            ]
        else:
            for j in hmm.states():
                xs = [
                    vals[i, k]
                    + hmm.transition_prob_idx(j, k, n - i)
                    + hmm.observation_prob(k, o)
                    for k in hmm.states()
                ]
                vals[i + 1, j] = float(LogProb.ln_sum_exp(xs))
    return vals, LogProb(LogProb.ln_sum_exp(prob_vec_final))


def baum_welch(
    hmm: Model, observations: Sequence
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One Baum-Welch step: (pi*, A*, B*, E*) estimates (hmm/mod.rs:520)."""
    N = hmm.num_states()
    n_obs = len(observations)
    f_tab, _ = forward(hmm, observations)
    b_cor, _ = backward(hmm, observations)

    b_tab = np.full_like(b_cor, NEG_INF)
    for j in range(n_obs):
        b_tab[n_obs - 1 - j] = b_cor[j]

    alpha_betas = f_tab + b_tab
    probx = float(LogProb.ln_sum_exp(list(alpha_betas[n_obs - 1])))

    # per-state expected emission counts keyed by sorted distinct observation
    distinct = sorted(set(observations))
    obs_index = {o: idx for idx, o in enumerate(distinct)}
    probs_obs = np.full((N, len(distinct)), NEG_INF)
    for h in hmm.states():
        for t, o in enumerate(observations):
            k = obs_index[o]
            probs_obs[h, k] = float(
                LogProb(probs_obs[h, k]).ln_add_exp(alpha_betas[t, h] - probx)
            )

    vals_xi = np.full((n_obs, N * N), NEG_INF)
    for t, o in enumerate(observations):
        if t == 0:
            continue
        for jdx, j in enumerate(hmm.states()):
            vals_xi[t, jdx * N : (jdx + 1) * N] = [
                f_tab[t - 1, j]
                + hmm.transition_prob_idx(j, i, t)
                + b_tab[t, i]
                + hmm.observation_prob(i, o)
                - probx
                for i in hmm.states()
            ]

    transitions_hat = np.full((N, N), NEG_INF)
    observations_hat = np.full((N, len(distinct)), NEG_INF)
    for idx, i in enumerate(hmm.states()):
        gamma_i = float(
            LogProb.ln_sum_exp([x - probx for x in alpha_betas[:, i]])
        )
        end_i = (
            NEG_INF
            if hmm.has_end_state()
            else alpha_betas[n_obs - 1, i] - probx
        )
        q = vals_xi[:, idx * N : (idx + 1) * N]
        denom = float(LogProb(gamma_i).ln_sub_exp(end_i))
        for k in hmm.states():
            sa = float(LogProb.ln_sum_exp(list(q[:, k])))
            transitions_hat[i, k] = sa - denom
        observations_hat[i] = probs_obs[i] - gamma_i

    pi_hat = alpha_betas[0] - probx

    if hmm.has_end_state():
        sum_p_states = np.array(
            [
                float(LogProb.ln_sum_exp([x - probx for x in alpha_betas[:, k]]))
                for k in hmm.states()
            ]
        )
        end_hat = (alpha_betas[n_obs - 1] - probx) - sum_p_states
    else:
        end_hat = np.zeros(N)  # ln(1)

    return pi_hat, transitions_hat, observations_hat, end_hat


class DiscreteEmissionModel(Model):
    """HMM with discrete emissions (discrete_emission::Model).

    Matrices are log-probabilities: transition (N, N), observation (N, M),
    initial (N,).
    """

    def __init__(self, transition, observation, initial) -> None:
        transition = np.asarray(transition, dtype=np.float64)
        observation = np.asarray(observation, dtype=np.float64)
        initial = np.asarray(initial, dtype=np.float64)
        an0, an1 = transition.shape
        bn, bm = observation.shape
        (pin,) = initial.shape
        if an0 != an1 or an0 != bn or an0 != pin:
            raise Error(
                f"invalid dimensions: A {an0}x{an1}, B {bn}x{bm}, pi {pin}"
            )
        self.transition = transition
        self.observation = observation
        self.initial = initial

    @classmethod
    def with_float(cls, transition, observation, initial) -> "DiscreteEmissionModel":
        with np.errstate(divide="ignore"):
            return cls(
                np.log(np.asarray(transition, dtype=np.float64)),
                np.log(np.asarray(observation, dtype=np.float64)),
                np.log(np.asarray(initial, dtype=np.float64)),
            )

    with_prob = with_float

    def num_states(self) -> int:
        return self.transition.shape[0]

    def transition_prob(self, from_, to) -> float:
        return float(self.transition[from_, to])

    def initial_prob(self, state) -> float:
        return float(self.initial[state])

    def observation_prob(self, state, observation) -> float:
        return float(self.observation[state, observation])


class DiscreteEmissionOptEndModel(DiscreteEmissionModel):
    """Discrete-emission HMM with an optional explicit end state and
    Baum-Welch training (discrete_emission_opt_end::Model)."""

    def __init__(self, transition, observation, initial, end=None) -> None:
        super().__init__(transition, observation, initial)
        self._has_end = end is not None
        self.end = (
            np.asarray(end, dtype=np.float64)
            if end is not None
            else np.zeros(self.num_states())
        )

    @classmethod
    def with_float(
        cls, transition, observation, initial, end=None
    ) -> "DiscreteEmissionOptEndModel":
        with np.errstate(divide="ignore"):
            return cls(
                np.log(np.asarray(transition, dtype=np.float64)),
                np.log(np.asarray(observation, dtype=np.float64)),
                np.log(np.asarray(initial, dtype=np.float64)),
                None if end is None else np.log(np.asarray(end, dtype=np.float64)),
            )

    def end_prob(self, state) -> float:
        return float(self.end[state])

    def has_end_state(self) -> bool:
        return self._has_end

    def update_matrices(self, transitions_hat, observations_hat, pi_hat, end_hat):
        self.transition = np.asarray(transitions_hat)
        self.observation = np.asarray(observations_hat)
        self.initial = np.asarray(pi_hat)
        self.end = np.asarray(end_hat)

    def train_baum_welch(
        self,
        observations: Sequence[Sequence[int]],
        n_iter: Optional[int] = None,
        tol: Optional[float] = None,
    ):
        """Iterative Baum-Welch training (hmm/mod.rs:1016-1110)."""
        tol = 1e-6 if tol is None else tol
        n_iter = 500 if n_iter is None else n_iter

        result = baum_welch(self, observations[0])
        _, prob_fwd_new = forward(self, observations[0])
        obs_n = float(len(observations[0]))
        nllh_o = math.exp(float(prob_fwd_new) / obs_n)

        llh = 0.0
        for _ in range(n_iter - 1):
            for obs in observations:
                result = baum_welch(self, obs)
                self.update_matrices(result[1], result[2], result[0], result[3])
                _, llh = forward(self, obs)
                llh = float(llh)
                obs_n = float(len(obs))
            nllh = math.exp(llh / obs_n)
            if nllh_o >= nllh:
                nllh_o = math.exp(llh / obs_n)
                continue
            if nllh - nllh_o < tol:
                break
            nllh_o = math.exp(llh / obs_n)
        return result


class GaussianModel(Model):
    """HMM with univariate Gaussian emissions (GaussianModel, :1116+).

    ``observation`` is a list of (mean, std) per state.
    """

    def __init__(self, transition, observation: List[Tuple[float, float]], initial):
        self.transition = np.asarray(transition, dtype=np.float64)
        self.params = list(observation)
        self.initial = np.asarray(initial, dtype=np.float64)
        n = self.transition.shape[0]
        if self.transition.shape != (n, n) or len(self.params) != n or len(self.initial) != n:
            raise Error("invalid dimensions")

    @classmethod
    def with_float(cls, transition, observation, initial) -> "GaussianModel":
        with np.errstate(divide="ignore"):
            return cls(
                np.log(np.asarray(transition, dtype=np.float64)),
                observation,
                np.log(np.asarray(initial, dtype=np.float64)),
            )

    def num_states(self) -> int:
        return self.transition.shape[0]

    def transition_prob(self, from_, to) -> float:
        return float(self.transition[from_, to])

    def initial_prob(self, state) -> float:
        return float(self.initial[state])

    def observation_prob(self, state, observation) -> float:
        mean, std = self.params[state]
        x = float(observation)
        return float(
            -0.5 * math.log(2 * math.pi) - math.log(std)
            - 0.5 * ((x - mean) / std) ** 2
        )
