"""Batched 14-state HomopolyPairHMM forward on the card:
``BatchHomopolyPairHMM``, kernel K17-homopoly.

The JAX package's ``stats/pairhmm/homopoly_device.py`` holds the same class
(same constructor, derived parameters ``p`` bit for bit, and
``prob_related_batch``) on an XLA engine, a redesign of the reference's
row-sequential forward pass (homopolypairhmm.rs:246-420) for the standard
sequencing emission model. Its quirks are kept:
- quarter initial mass over the 4 match states, mismatch emissions halved
  (separate match states), the GapX/GapY parameter crossing in the
  transition table (homopolypairhmm.rs:519-534);
- free-end-gap mode's per-cell ``prob_cols`` accumulation
  (homopolypairhmm.rs:383-396) in closed form: each row contributes
  ``(len_y - 1)`` copies of the two-rows-ago column plus one fresh copy.

Numerics: f32 log space with exact logaddexp (the scalar oracle uses f64 +
fastexp; ~1e-3 relative agreement, held by the tests), or f64 with
``dtype=torch.float64``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.ops import pairhmm as ops
from rust_bio_tpu_torch.stats.pairhmm.device import NEG_INF, NEG_INF64, _batch, _emit_array, _upload
from rust_bio_tpu_torch.stats.probs import LogProb

# the derived parameters, in the order of the kernel's vector
P_KEYS = (
    "match_any", "pgx", "pgy", "pgxe", "pgye", "from_gx", "from_gy",
    "hx", "hy", "hxe", "hye", "from_hx", "from_hy",
)


def _ln1m(p: float) -> float:
    return float(LogProb(p).ln_one_minus_exp()) if p != float("-inf") else 0.0


class BatchHomopolyPairHMM:
    """Batched forward probability for B pairs under the 14-state model.

    ``hop_*`` parameters may be scalars (uniform) or length-4 arrays
    (base-specific, A/C/G/T order), all in log space. ``device=None`` means
    the CUDA device and raises without one; ``device="cpu"`` runs the plain
    PyTorch version.
    """

    def __init__(
        self,
        prob_gap_x: float,
        prob_gap_y: float,
        prob_gap_x_extend: float,
        prob_gap_y_extend: float,
        prob_hop_x,
        prob_hop_y,
        prob_hop_x_extend,
        prob_hop_y_extend,
        dtype=torch.float32,
        device=None,
    ) -> None:
        def vec4(v):
            a = np.asarray(v, np.float64).reshape(-1)
            return np.broadcast_to(a, (4,)).copy() if a.size == 1 else a

        hx, hy = vec4(prob_hop_x), vec4(prob_hop_y)
        hxe, hye = vec4(prob_hop_x_extend), vec4(prob_hop_y_extend)
        pgx, pgy = float(prob_gap_x), float(prob_gap_y)
        pgxe, pgye = float(prob_gap_x_extend), float(prob_gap_y_extend)

        # reference aggregates: mean hop prob over bases, then the match
        # self-transition soaks up the remainder (homopolypairhmm.rs:495+)
        ph_x = float(LogProb.ln_sum_exp(list(hx))) - np.log(4.0)
        ph_y = float(LogProb.ln_sum_exp(list(hy))) - np.log(4.0)
        match_any = _ln1m(float(LogProb.ln_sum_exp([pgy, pgx, ph_x, ph_y])))

        def fin(v):
            a = np.asarray(v, np.float64)
            neg = NEG_INF if dtype == torch.float32 else NEG_INF64
            return np.where(np.isneginf(a), neg, a)

        p = {
            "match_any": fin(match_any),
            "pgx": fin(pgx),  # Match -> GapY   (reference crossing)
            "pgy": fin(pgy),  # Match -> GapX
            "pgxe": fin(pgxe),  # GapY self
            "pgye": fin(pgye),  # GapX self
            "from_gx": fin(_ln1m(pgye)),  # GapX -> Match
            "from_gy": fin(_ln1m(pgxe)),  # GapY -> Match
            "hx": fin(hx),
            "hy": fin(hy),
            "hxe": fin(hxe),
            "hye": fin(hye),
            "from_hx": fin([_ln1m(v) for v in hx]),
            "from_hy": fin([_ln1m(v) for v in hy]),
        }
        self._setup(p, dtype, device)

    @classmethod
    def from_p(cls, p: dict, dtype=torch.float32, device=None):
        """The class from derived parameters ``p`` (the JAX class's ``p``:
        floats and length-4 arrays), as ``carry.pairhmm_from_params`` takes
        them."""
        self = cls.__new__(cls)
        self._setup({k: np.asarray(p[k], np.float64) for k in P_KEYS}, dtype, device)
        return self

    def _setup(self, p: dict, dtype, device) -> None:
        self.device = resolve_device(device)
        self.dtype = dtype
        self.p = p
        vals = np.concatenate(
            [np.asarray(p[k], np.float64).reshape(-1) for k in P_KEYS]
            + [np.array([np.log(2.0), np.log(0.25), -np.log(4.0)])]
        )
        assert vals.shape == (ops.HOMOPOLY_NPAR,)
        self._params = torch.from_numpy(vals).to(dtype).to(self.device)

    def _forward(self, xs, ys, xlens, ylens, emit, semiglobal: bool) -> torch.Tensor:
        """Tensors on the device (xs (B, M) / ys (B, N) uint8, lengths int32,
        emit (4,) / (B, 4) [p_match, p_mismatch, p_emit_x, p_emit_y] log
        probs in ``dtype``) -> (B,) log-likelihoods there."""
        return ops.pairhmm_fwd_homopoly(xs, ys, xlens, ylens, self._params, emit, semiglobal)

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

        ``emit_probs``: [ln p_match, ln p_mismatch, ln p_emit_x,
        ln p_emit_y], shared (4,) or per lane (B, 4).
        """
        xs, ys, xlens, ylens = _batch(xs, ys, xlens, ylens)
        ep = _emit_array(emit_probs, xs.shape[0], 4)
        args = _upload(self.device, xs, ys, xlens, ylens)
        emit = torch.from_numpy(ep).to(self.dtype).to(self.device)
        out = self._forward(*args, emit, bool(semiglobal))
        return out.cpu().numpy().astype(np.float64)
