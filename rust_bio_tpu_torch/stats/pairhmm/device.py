"""Batched PairHMM forwards on the card: ``BatchPairHMM`` (log space, kernel
K17-log) and ``BatchPairHMMLinear`` (scaled linear space, kernel K17, with
the log-space kernel as its exact fallback).

The JAX package's ``stats/pairhmm/device.py`` holds the same two classes
with the same constructors, derived parameters (``g``, bit for bit) and
``prob_related_batch``; there the forwards are XLA scans and, for shared
emissions, the Pallas kernel. Here every forward is one kernel launch
(``ops/pairhmm.py``): B (x, y) pairs, one thread a pair.

Numerics: f32 log space with exact ``logaddexp`` (the reference uses f64 +
a fastexp approximation + a 10-nat max-dominance shortcut; agreement is
~1e-3 relative, held against the host oracle by the tests), or f64 with
``dtype=torch.float64``. Boundary quirks of the reference are kept: the
``ln(2)`` j = 0 boundary on the first row in semiglobal mode, the
never-written ``fx/fy`` column 0, and the per-row free-end-gap column
accumulation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.ops import pairhmm as ops

NEG_INF = ops.NEG_F32  # f32-safe -inf surrogate (finite to avoid nan in adds)
NEG_INF64 = ops.NEG_F64
# the derived parameters, in the order of the kernels' (7,) vectors
G_KEYS = ("no_gap", "no_gap_x_extend", "no_gap_y_extend", "gap_x", "gap_y", "gap_x_extend", "gap_y_extend")


def linear(logs: np.ndarray) -> np.ndarray:
    """f32 probabilities of f64 log values, clipped at -700 first (the JAX
    package's conversion for its Pallas kernel, stats/pairhmm/device.py
    :389-398)."""
    return np.ascontiguousarray(np.exp(np.asarray(logs, np.float64).clip(min=-700)).astype(np.float32))


def _batch(xs, ys, xlens, ylens):
    """(xs, ys, xlens, ylens) as contiguous numpy arrays; raises on lengths
    outside [0, M] / [0, N] or a shape that does not match the batch."""
    xs = np.ascontiguousarray(xs, dtype=np.uint8)
    ys = np.ascontiguousarray(ys, dtype=np.uint8)
    if xs.ndim != 2 or ys.ndim != 2 or xs.shape[0] != ys.shape[0]:
        raise ValueError(f"xs {xs.shape} and ys {ys.shape}: expected (B, M) and (B, N)")
    B, M = xs.shape
    N = ys.shape[1]
    xlens = np.full(B, M, np.int32) if xlens is None else np.ascontiguousarray(xlens, dtype=np.int32)
    ylens = np.full(B, N, np.int32) if ylens is None else np.ascontiguousarray(ylens, dtype=np.int32)
    for name, lens, limit in (("xlens", xlens, M), ("ylens", ylens, N)):
        if lens.shape != (B,):
            raise ValueError(f"{name}: expected shape ({B},), got {lens.shape}")
        if lens.size and (lens.min() < 0 or lens.max() > limit):
            raise ValueError(f"{name}: entries must lie in [0, {limit}]")
    return xs, ys, xlens, ylens


def _emit_array(emit_probs, B: int, k: int) -> np.ndarray:
    """The emissions as float64, (k,) shared or (B, k) per lane."""
    ep = np.asarray(emit_probs, np.float64)
    if ep.shape not in ((k,), (B, k)):
        raise ValueError(f"emit_probs: expected shape ({k},) or ({B}, {k}), got {ep.shape}")
    return np.ascontiguousarray(ep)


def _upload(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


class BatchPairHMM:
    """Batched forward probability for B sequence pairs (kernel K17-log).

    Gap parameters are shared scalars (log space); emissions use the
    standard sequencing model: match/mismatch/gap emission log-probs,
    shared or per lane. ``device=None`` means the CUDA device and raises
    without one; ``device="cpu"`` runs the plain PyTorch version.
    """

    def __init__(
        self,
        prob_gap_x: float,
        prob_gap_y: float,
        prob_gap_x_extend: float,
        prob_gap_y_extend: float,
        dtype=torch.float32,
        device=None,
    ) -> None:
        # f32 is the throughput mode (~1e-3 agreement with the f64 oracle);
        # pass torch.float64 for score-exact runs
        def ln1m(p):
            return float(np.log1p(-np.exp(p))) if p != float("-inf") else 0.0

        gx, gy = float(prob_gap_x), float(prob_gap_y)
        g = dict(
            no_gap=float(np.log1p(-(np.exp(gx) + np.exp(gy)))),
            no_gap_x_extend=ln1m(float(prob_gap_x_extend)),
            no_gap_y_extend=ln1m(float(prob_gap_y_extend)),
            gap_x=gx,
            gap_y=gy,
            gap_x_extend=float(prob_gap_x_extend)
            if prob_gap_x_extend != float("-inf")
            else NEG_INF,
            gap_y_extend=float(prob_gap_y_extend)
            if prob_gap_y_extend != float("-inf")
            else NEG_INF,
        )
        self._setup(g, dtype, device)

    @classmethod
    def from_g(cls, g: dict, dtype=torch.float32, device=None):
        """The class from derived parameters ``g`` (the seven floats of
        ``BatchPairHMM.g``), as ``carry.pairhmm_from_params`` takes them."""
        self = cls.__new__(cls)
        self._setup({k: float(g[k]) for k in G_KEYS}, dtype, device)
        return self

    def _setup(self, g: dict, dtype, device) -> None:
        self.device = resolve_device(device)
        self.dtype = dtype
        self.g = g
        logs = torch.tensor([g[k] for k in G_KEYS], dtype=torch.float64)
        self._log_params = logs.to(dtype).to(self.device)  # K17-log's (7,) vector

    def _forward(self, xs, ys, xlens, ylens, emit, semiglobal: bool) -> torch.Tensor:
        """xs (B, M) / ys (B, N) uint8, xlens / ylens (B,) int32 and emit
        (3,) / (B, 3) [ln p_match, ln p_mismatch, ln p_gap_emit] in
        ``dtype``, all tensors on the device -> (B,) log-likelihoods there."""
        return ops.pairhmm_fwd_log(xs, ys, xlens, ylens, self._log_params, emit, semiglobal)

    def prob_related_batch(
        self,
        xs,
        ys,
        emit_probs,
        semiglobal: bool = False,
        xlens: Optional[np.ndarray] = None,
        ylens: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Log-likelihoods for a padded pair batch, (B,) float64.

        ``emit_probs``: [ln p_match, ln p_mismatch, ln p_gap_emit], shared or
        per-lane (B, 3).
        """
        xs, ys, xlens, ylens = _batch(xs, ys, xlens, ylens)
        ep = _emit_array(emit_probs, xs.shape[0], 3)
        args = _upload(self.device, xs, ys, xlens, ylens)
        emit = torch.from_numpy(ep).to(self.dtype).to(self.device)
        out = self._forward(*args, emit, bool(semiglobal))
        return out.cpu().numpy().astype(np.float64)


class BatchPairHMMLinear(BatchPairHMM):
    """Scaled linear-space forward (GATK-style), kernel K17: transitions and
    emissions as f32 probabilities, per-row rescaling against under- and
    overflow (one log a row), the Y state's in-row recurrence in sequence.
    Agreement with the f64 host oracle is the same ~1e-3 relative as the
    f32 log-space class. Same constructor and ``prob_related_batch`` API;
    lanes whose probability underflows f32 relative to the per-row maximum
    are recomputed by the log-space kernel (K17-log).
    """

    def _setup(self, g: dict, dtype, device) -> None:
        """Also K17's (7,) f32 probabilities: the f64 log values clipped at
        -700 and exponentiated, as ``pairhmm_pallas.py`` takes them."""
        super()._setup(g, dtype, device)
        self._lin_params = torch.from_numpy(linear(np.array([g[k] for k in G_KEYS]))).to(self.device)

    def _forward(self, xs, ys, xlens, ylens, emit, semiglobal: bool) -> torch.Tensor:
        """As ``BatchPairHMM._forward``, but ``emit`` holds f32
        probabilities (``linear`` of the log values) and the result is
        K17's: ``NEG_INF`` on underflowed lanes."""
        return ops.pairhmm_fwd_scaled(xs, ys, xlens, ylens, self._lin_params, emit, semiglobal)

    def prob_related_batch(
        self,
        xs,
        ys,
        emit_probs,
        semiglobal: bool = False,
        xlens=None,
        ylens=None,
    ) -> np.ndarray:
        """Hybrid: the scaled linear pass covers the dominant-path regime
        (read vs candidate haplotype); lanes whose probability underflows
        f32 relative to the per-row maximum (≳1e-38 dynamic range, i.e.
        heavily divergent pairs) are recomputed with the log-space kernel,
        each with its own emission row, so results are always correct."""
        xs, ys, xlens, ylens = _batch(xs, ys, xlens, ylens)
        B = xs.shape[0]
        ep = _emit_array(emit_probs, B, 3)
        args = _upload(self.device, xs, ys, xlens, ylens)
        emit = torch.from_numpy(linear(ep)).to(self.device)
        out = self._forward(*args, emit, bool(semiglobal)).cpu().numpy().astype(np.float64)
        fell = out <= NEG_INF / 2
        if fell.any():
            sub = np.nonzero(fell)[0]
            # the JAX package passes the whole (B, 3) emission array with the
            # sub-batch here (a broadcasting error); the port takes the
            # fallen lanes' own rows
            ep_sub = ep if ep.ndim == 1 else np.ascontiguousarray(ep[sub])
            sub_args = _upload(self.device, xs[sub], ys[sub], xlens[sub], ylens[sub])
            emit_sub = torch.from_numpy(ep_sub).to(self.dtype).to(self.device)
            exact = BatchPairHMM._forward(self, *sub_args, emit_sub, bool(semiglobal))
            out[sub] = exact.cpu().numpy().astype(np.float64)
        return out
