"""Score-exact batched PairHMM forward on the card: ``BatchPairHMMExact``,
kernel K17-exact.

It replicates the host oracle (``stats/pairhmm/__init__.py``
``PairHMM.prob_related``, itself a statement-level twin of the reference
``pairhmm.rs:104-280``) operation for operation in f64, one thread a pair:
the reference's fastexp approximation (bit-exact), the
``ln_sum3_exp_approx`` 10-nat max-dominance shortcut with its partial-sort
tie semantics, the ``max_edit_dist`` banding with the oracle's stale-buffer
behavior (only ``fm`` is cleared between rows; a skipped cell's
``fx/fy/med`` keep the value from two rows earlier), and the free-end-gap
column accumulation in the oracle's summation order. The only difference
left is ``log1p``: the card's and the host libm's may differ by an ulp.

The JAX package's ``stats/pairhmm/exact.py`` holds the same class (same
constructor, ``g`` and ``prob_related_batch``) on an XLA engine; there f64
was emulated on the TPU.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Optional

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.ops import pairhmm as ops
from rust_bio_tpu_torch.stats.pairhmm import GapParameters, PairHMM, _GapParamCache
from rust_bio_tpu_torch.stats.pairhmm.device import _batch, _emit_array, _upload

NEG_INF = float("-inf")


class BatchPairHMMExact:
    """Batched oracle-order f64 PairHMM forward (global + semiglobal,
    optional ``max_edit_dist`` banding).

    Constructor matches ``BatchPairHMM``: shared scalar gap log-probs. The
    derived no-gap cache ``g`` is computed on the host with the oracle's own
    ``LogProb`` arithmetic, so the scalars entering the kernel are
    bit-identical to the oracle's ``_GapParamCache``. ``device=None`` means
    the CUDA device and raises without one; ``device="cpu"`` runs the plain
    PyTorch version.
    """

    def __init__(
        self,
        prob_gap_x: float,
        prob_gap_y: float,
        prob_gap_x_extend: float,
        prob_gap_y_extend: float,
        device=None,
    ) -> None:
        class _G(GapParameters):
            def prob_gap_x(self):
                return prob_gap_x

            def prob_gap_y(self):
                return prob_gap_y

            def prob_gap_x_extend(self):
                return prob_gap_x_extend

            def prob_gap_y_extend(self):
                return prob_gap_y_extend

        self._setup(PairHMM(_G()).gap_params, device)  # oracle-computed cache

    @classmethod
    def from_fields(cls, g: dict, device=None):
        """The class from the fields of a ``_GapParamCache`` as a dict (the
        JAX class's ``g``), as ``carry.pairhmm_from_params`` takes them."""
        self = cls.__new__(cls)
        self._setup(_GapParamCache(**{f.name: g[f.name] for f in fields(_GapParamCache)}), device)
        return self

    def _setup(self, g: _GapParamCache, device) -> None:
        self.device = resolve_device(device)
        self.g = g
        vals = [
            g.prob_no_gap, g.prob_no_gap_x_extend, g.prob_no_gap_y_extend, g.prob_gap_x, g.prob_gap_y,
            g.prob_gap_x_extend if g.do_gap_x_extend else NEG_INF,
            g.prob_gap_y_extend if g.do_gap_y_extend else NEG_INF,
        ]
        self._params = torch.tensor(vals, dtype=torch.float64).to(self.device)

    def _forward(
        self, xs, ys, xlens, ylens, emit, semiglobal: bool,
        max_edit_dist: Optional[int] = None, debug_skip: bool = False,
    ):
        """Tensors on the device (xs (B, M) / ys (B, N) uint8, lengths int32,
        emit (3,) / (B, 3) float64) -> (B,) float64 there; with
        ``debug_skip`` also the (B, M, N) bool mask of the cells the band
        skipped."""
        return ops.pairhmm_fwd_exact(
            xs, ys, xlens, ylens, self._params, emit, semiglobal, max_edit_dist, debug_skip
        )

    def prob_related_batch(
        self,
        xs,
        ys,
        emit_probs,
        semiglobal: bool = False,
        max_edit_dist: Optional[int] = None,
        xlens: Optional[np.ndarray] = None,
        ylens: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Oracle-order log-likelihoods for a padded (B, M)/(B, N) batch,
        (B,) float64.

        ``emit_probs``: [ln p_match, ln p_mismatch, ln p_gap_emit], shared
        or (B, 3).
        """
        xs, ys, xlens, ylens = _batch(xs, ys, xlens, ylens)
        ep = _emit_array(emit_probs, xs.shape[0], 3)
        args = _upload(self.device, xs, ys, xlens, ylens, ep)
        out = self._forward(*args, bool(semiglobal), max_edit_dist)
        return out.cpu().numpy()
