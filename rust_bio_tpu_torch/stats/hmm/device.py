"""Batched HMM inference on the card (discrete and Gaussian emissions).

Port of ``rust_bio_tpu.stats.hmm.device``: B observation sequences of one
model advance through its time scans, now the hand kernels K-HMM-vit,
K-HMM-fwd and K-HMM-bwd (:mod:`rust_bio_tpu_torch.ops.hmm`). Variable
lengths freeze their lanes; the Viterbi path breaks argmax ties toward the
lowest state, as JAX's ``jnp.argmax`` does (the host oracle in
:mod:`rust_bio_tpu_torch.stats.hmm` breaks them toward the highest). Models
hold ln probabilities as float32 tensors on their device, ln 0 as the
finite surrogate NEG = -3.0e38; the ``*_batch`` methods return numpy
float64 (paths int32).

Where the port departs from the JAX package (each pinned by a test):

- the backward scan starts from ``end``, as the host oracle does (JAX
  starts from zeros and ignores ``end``);
- observations outside [0, V) and empty sequences raise ``ValueError``
  (JAX reads them as an emission of ln 1 and returns numbers);
- ``BatchGaussianHMM.backward_batch`` runs the Gaussian emissions (JAX's
  raises ``TypeError``).

At most ``ops.hmm.MAX_S`` (256) states: the kernels keep Viterbi's
back-pointers as uint8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.ops import hmm as hmm_ops

NEG = hmm_ops.NEG


def _fin(a, device) -> torch.Tensor:
    a = np.asarray(a, np.float64)
    return torch.from_numpy(np.where(np.isneginf(a), NEG, a).astype(np.float32)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


class BatchDiscreteHMM:
    """Batched inference for one discrete-emission HMM over B sequences.

    ``transition`` (S, S), ``observation`` (S, V), ``initial`` (S,) and
    ``end`` (S,) or None: ln probabilities (ln 0 may be -inf; converted to
    the finite surrogate). ``device=None`` means the CUDA device.
    """

    def __init__(self, transition, observation, initial, end=None, device=None) -> None:
        self.device = resolve_device(device)
        self.A = _fin(transition, self.device)  # (S, S) ln P(from -> to)
        self.Bm = _fin(observation, self.device)  # (S, V)
        self.pi = _fin(initial, self.device)  # (S,)
        S = self.A.shape[0]
        if self.A.shape != (S, S) or self.Bm.shape[0] != S or self.pi.shape != (S,):
            raise ValueError(f"invalid dimensions: A {tuple(self.A.shape)}, B {tuple(self.Bm.shape)}, pi {tuple(self.pi.shape)}")
        if S > hmm_ops.MAX_S:
            raise ValueError(f"S = {S}: the batched HMM takes at most {hmm_ops.MAX_S} states")
        self.end = _fin(end, self.device) if end is not None else torch.zeros(S, dtype=torch.float32, device=self.device)

    def _emit_table(self) -> torch.Tensor:
        return self.Bm

    def _viterbi(self, obs, lens):
        return hmm_ops.viterbi(self.A, self._emit_table(), self.pi, self.end, obs, lens)

    def _forward(self, obs, lens):
        return hmm_ops.forward(self.A, self._emit_table(), self.pi, self.end, obs, lens)

    def _backward(self, obs, lens):
        return hmm_ops.backward(self.A, self._emit_table(), self.pi, self.end, obs, lens)

    def _pad_numpy(self, seqs, dtype):
        if len(seqs) == 0:
            raise ValueError("no sequences")
        B = len(seqs)
        T = max(len(s) for s in seqs)
        if min(len(s) for s in seqs) == 0:
            raise ValueError("empty sequence: every sequence needs at least one observation")
        obs = np.zeros((B, T), dtype)
        lens = np.zeros(B, np.int32)
        for i, s in enumerate(seqs):
            obs[i, : len(s)] = np.asarray(s, dtype)
            lens[i] = len(s)
        return obs, lens

    def _pad(self, seqs):
        obs, lens = self._pad_numpy(seqs, np.int32)
        V = self.Bm.shape[1]
        if obs.min() < 0 or obs.max() >= V:
            raise ValueError(f"observations must lie in [0, {V})")
        return torch.from_numpy(obs).to(self.device), torch.from_numpy(lens).to(self.device)

    def viterbi_batch(self, seqs) -> Tuple[np.ndarray, np.ndarray]:
        """(paths (B, T) int32 [padded tail repeats the last state],
        log-probs (B,))."""
        paths, prob = self._viterbi(*self._pad(seqs))
        return paths.cpu().numpy(), _numpy(prob)

    def forward_batch(self, seqs) -> Tuple[np.ndarray, np.ndarray]:
        vals, tot = self._forward(*self._pad(seqs))
        return _numpy(vals), _numpy(tot)

    def backward_batch(self, seqs) -> Tuple[np.ndarray, np.ndarray]:
        """(rows (B, T, S) in reverse padded time, totals (B,))."""
        vals, tot = self._backward(*self._pad(seqs))
        return _numpy(vals), _numpy(tot)


class BatchGaussianHMM(BatchDiscreteHMM):
    """Batched inference for univariate-Gaussian emissions.

    ``params``: list of (mean, std) per state; observations are float
    sequences (padded as float32). Emission log-densities are computed in
    the kernels from mu, log_norm and inv2var.
    """

    def __init__(self, transition, params, initial, end=None, device=None) -> None:
        S = len(params)
        super().__init__(transition, np.zeros((S, 1)), initial, end, device=device)
        mu = np.array([m for m, _ in params], np.float64)
        sd = np.array([s for _, s in params], np.float64)
        self._set_density(mu, -0.5 * np.log(2 * np.pi) - np.log(sd), 0.5 / (sd * sd))

    def _set_density(self, mu, log_norm, inv2var) -> None:
        rows = [np.asarray(a, np.float64).astype(np.float32) for a in (mu, log_norm, inv2var)]
        self.mu, self.log_norm, self.inv2var = (torch.from_numpy(r).to(self.device) for r in rows)
        self._emit_rows = torch.stack([self.mu, self.log_norm, self.inv2var]).contiguous()

    @classmethod
    def from_arrays(cls, A, pi, end, mu, log_norm, inv2var, device=None) -> "BatchGaussianHMM":
        """A model from finite float32 arrays as the JAX class holds them."""
        S = len(np.asarray(mu))
        obj = cls.__new__(cls)
        BatchDiscreteHMM.__init__(obj, A, np.zeros((S, 1)), pi, end, device=device)
        obj._set_density(mu, log_norm, inv2var)
        return obj

    def _emit_table(self) -> torch.Tensor:
        return self._emit_rows

    def _pad(self, seqs):
        obs, lens = self._pad_numpy(seqs, np.float32)
        return torch.from_numpy(obs).to(self.device), torch.from_numpy(lens).to(self.device)


def baum_welch_batch(
    model: BatchDiscreteHMM, seqs, n_iter: int = 1, vocab: Optional[int] = None
):
    """Multi-sequence Baum-Welch (standard extension of hmm/mod.rs:520).

    E-steps run on the batched forward/backward kernels; expected counts
    aggregate across sequences in f64 on the host (the reference's
    single-sequence update is the B == 1 specialization). Returns
    (trained BatchDiscreteHMM on the model's device, per-iteration total
    log-likelihoods).
    """
    A = _numpy(model.A)
    Bm = _numpy(model.Bm)
    pi = _numpy(model.pi)
    S, V = Bm.shape
    if vocab is not None:
        V = vocab
        Bm = Bm[:, :V]
    lens = np.array([len(s) for s in seqs])
    T = int(lens.max())
    Bsz = len(seqs)
    obs = np.zeros((Bsz, T), np.int64)
    for i, s in enumerate(seqs):
        obs[i, : len(s)] = np.asarray(s)
    lls = []

    def lse(a, axis=None):
        with np.errstate(divide="ignore"):
            hi = np.max(a, axis=axis, keepdims=True)
            out = hi + np.log(np.sum(np.exp(a - hi), axis=axis, keepdims=True))
            out = np.where(np.isfinite(hi), out, hi)
        return np.squeeze(out, axis=axis) if axis is not None else float(out)

    m = model
    for _ in range(n_iter):
        f, ftot = m.forward_batch(seqs)  # (B, T, S), (B,)
        bv, _ = m.backward_batch(seqs)
        # backward rows come in reverse time order with short lanes at the
        # END of the padded axis (row T-1-t = time t), so one flip aligns
        # every lane; rows t >= len are garbage and masked below
        btab = bv[:, ::-1]
        tmask = np.arange(T)[None, :] < lens[:, None]  # (B, T)
        ab = f + btab  # (B, T, S)
        probx = ftot  # (B,) total ln P(x)
        lls.append(float(np.sum(probx)))
        gamma = ab - probx[:, None, None]
        gamma = np.where(tmask[:, :, None], gamma, -np.inf)

        # expected transition counts: xi[b,t,j,i], t >= 1
        with np.errstate(invalid="ignore"):
            emis = Bm.T[obs[:, 1:]]  # (B, T-1, S): ln B[i, o_t]
            xi = (
                f[:, :-1, :, None]
                + A[None, None, :, :]
                + (btab[:, 1:, :] + emis)[:, :, None, :]
                - probx[:, None, None, None]
            )
        xi = np.where(tmask[:, 1:, None, None], xi, -np.inf)

        # aggregate in probability domain across sequences and time
        trans_num = lse(xi.reshape(-1, S, S), axis=0)  # (S, S) logs
        gamma_sum = lse(gamma.reshape(-1, S), axis=0)  # (S,)
        last = gamma[np.arange(Bsz), lens - 1]  # (B, S) end mass
        end_mass = lse(last, axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = np.log(
                np.maximum(np.exp(gamma_sum) - np.exp(end_mass), 1e-300)
            )
        A_new = trans_num - denom[:, None]

        obs_hat = np.full((S, V), -np.inf)
        for v in range(V):
            sel = np.where((obs == v)[:, :, None] & tmask[:, :, None], gamma, -np.inf)
            obs_hat[:, v] = lse(sel.reshape(-1, S), axis=0)
        B_new = obs_hat - gamma_sum[:, None]
        pi_new = lse(gamma[:, 0, :], axis=0) - np.log(Bsz)

        A, Bm, pi = A_new, B_new, pi_new
        m = BatchDiscreteHMM(A, Bm, pi, device=model.device)
    return m, lls
