"""Pair Hidden Markov Models (forward probability of two sequences).

Reference parity: src/stats/pairhmm/mod.rs traits (EmissionParameters :113,
Emission :131, GapParameters :141, StartEndGapParameters :160, XYEmission
:182) and src/stats/pairhmm/pairhmm.rs (PairHMM :46, GapParamCache :55,
ln_sum3_exp_approx 10-nat shortcut :26-40, prob_related :104-280 incl.
min-edit-dist banding and free-end-gap column accumulation).

The scalar ``PairHMM`` here is the exact oracle (f64, fastexp-based
arithmetic identical to the reference), a copy of the JAX package's. The
batched forwards on the card are exported from here too:
``BatchPairHMM`` and ``BatchPairHMMLinear`` (``device.py``),
``BatchPairHMMExact`` (``exact.py``) and ``BatchHomopolyPairHMM``
(``homopoly_device.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

from rust_bio_tpu_torch.stats.probs import LogProb

__all__ = [
    "XYEmission",
    "EmissionParameters",
    "GapParameters",
    "StartEndGapParameters",
    "PairHMM",
    "Semiglobal",
    "Global",
    "BatchPairHMM",
    "BatchPairHMMLinear",
    "BatchPairHMMExact",
    "BatchHomopolyPairHMM",
]

_NEG_INF = float("-inf")


@dataclass(frozen=True)
class XYEmission:
    """Match/Mismatch emission (pairhmm/mod.rs:182-201)."""

    prob: float
    is_match: bool

    @classmethod
    def match_(cls, p: float) -> "XYEmission":
        return cls(float(p), True)

    @classmethod
    def mismatch(cls, p: float) -> "XYEmission":
        return cls(float(p), False)


class EmissionParameters:
    """Emission interface (pairhmm/mod.rs:113-128)."""

    def prob_emit_xy(self, i: int, j: int) -> XYEmission:
        raise NotImplementedError

    def prob_emit_x(self, i: int) -> float:
        raise NotImplementedError

    def prob_emit_y(self, j: int) -> float:
        raise NotImplementedError

    def len_x(self) -> int:
        raise NotImplementedError

    def len_y(self) -> int:
        raise NotImplementedError


class GapParameters:
    """Gap interface (pairhmm/mod.rs:141-155)."""

    def prob_gap_x(self) -> float:
        raise NotImplementedError

    def prob_gap_y(self) -> float:
        raise NotImplementedError

    def prob_gap_x_extend(self) -> float:
        raise NotImplementedError

    def prob_gap_y_extend(self) -> float:
        raise NotImplementedError


class StartEndGapParameters:
    """Start/end gap interface (pairhmm/mod.rs:160-179)."""

    def prob_start_gap_x(self, i: int) -> float:
        return 0.0 if self.free_start_gap_x() else _NEG_INF

    def free_start_gap_x(self) -> bool:
        raise NotImplementedError

    def free_end_gap_x(self) -> bool:
        raise NotImplementedError


class Semiglobal(StartEndGapParameters):
    def free_start_gap_x(self) -> bool:
        return True

    def free_end_gap_x(self) -> bool:
        return True


class Global(StartEndGapParameters):
    def free_start_gap_x(self) -> bool:
        return False

    def free_end_gap_x(self) -> bool:
        return False


def ln_sum3_exp_approx(p0: float, p1: float, p2: float) -> float:
    """Max-dominance shortcut over three log-probs (pairhmm.rs:26-40)."""
    if p1 < p2:
        p1, p2 = p2, p1
    if p1 > p0:
        p1, p0 = p0, p1
    if p0 - p1 > 10.0:
        return p0
    return float(LogProb.ln_sum_exp([p0, p1, p2]))


@dataclass
class _GapParamCache:
    prob_no_gap: float
    prob_no_gap_x_extend: float
    prob_no_gap_y_extend: float
    prob_gap_x: float
    prob_gap_y: float
    prob_gap_x_extend: float
    prob_gap_y_extend: float
    do_gap_x_extend: bool
    do_gap_y_extend: bool


_USIZE_MAX = (1 << 64) - 1


def _sat_add(a: int, b: int) -> int:
    s = a + b
    return s if s <= _USIZE_MAX else _USIZE_MAX


class PairHMM:
    """Forward-probability pair HMM (Durbin et al. 1998 ch. 4)."""

    def __init__(self, gap_params: GapParameters) -> None:
        gx = float(gap_params.prob_gap_x())
        gy = float(gap_params.prob_gap_y())
        gxe = float(gap_params.prob_gap_x_extend())
        gye = float(gap_params.prob_gap_y_extend())
        self.gap_params = _GapParamCache(
            prob_no_gap=float(
                LogProb(gx).ln_add_exp(gy).ln_one_minus_exp()
            ),
            prob_no_gap_x_extend=float(LogProb(gxe).ln_one_minus_exp())
            if gxe != _NEG_INF
            else 0.0,
            prob_no_gap_y_extend=float(LogProb(gye).ln_one_minus_exp())
            if gye != _NEG_INF
            else 0.0,
            prob_gap_x=gx,
            prob_gap_y=gy,
            prob_gap_x_extend=gxe,
            prob_gap_y_extend=gye,
            do_gap_x_extend=gxe != _NEG_INF,
            do_gap_y_extend=gye != _NEG_INF,
        )

    def prob_related(
        self,
        emission_params: EmissionParameters,
        alignment_mode: StartEndGapParameters,
        max_edit_dist: Optional[int] = None,
        skip_trace: Optional[list] = None,
    ) -> LogProb:
        """``skip_trace`` (debug): when a list is passed, every banded
        ``continue`` appends ``(i, j)`` — lets tests assert the device
        path's integer banding bookkeeping bit-for-bit."""
        g = self.gap_params
        len_x = emission_params.len_x()
        len_y = emission_params.len_y()

        fm = [[_NEG_INF] * (len_y + 1) for _ in range(2)]
        fx = [[_NEG_INF] * (len_y + 1) for _ in range(2)]
        fy = [[_NEG_INF] * (len_y + 1) for _ in range(2)]
        med = [[_USIZE_MAX] * (len_y + 1) for _ in range(2)]
        prob_cols: List[float] = []

        prev, curr = 0, 1
        fm[prev][0] = 0.0  # ln_one

        for i in range(len_x):
            fm[prev][0] = float(
                LogProb(fm[prev][0]).ln_add_exp(
                    alignment_mode.prob_start_gap_x(i)
                )
            )
            if alignment_mode.free_start_gap_x():
                med[prev][0] = 0

            prob_emit_x = float(emission_params.prob_emit_x(i))

            for j in range(len_y):
                j_ = j + 1
                jm1 = j_ - 1

                med_topleft = med[prev][jm1]
                med_top = med[curr][jm1]
                med_left = med[prev][j_]

                if max_edit_dist is not None and (
                    min(med_topleft, med_top, med_left) > max_edit_dist
                ):
                    if skip_trace is not None:
                        skip_trace.append((i, j))
                    continue

                emit_xy = emission_params.prob_emit_xy(i, j)
                prob_match_mismatch = emit_xy.prob + ln_sum3_exp_approx(
                    g.prob_no_gap + fm[prev][jm1],
                    g.prob_no_gap_x_extend + fx[prev][jm1],
                    g.prob_no_gap_y_extend + fy[prev][jm1],
                )

                prob_gap_y = prob_emit_x + (g.prob_gap_y + fm[prev][j_])
                if g.do_gap_y_extend:
                    prob_gap_y = float(
                        LogProb(prob_gap_y).ln_add_exp(
                            g.prob_gap_y_extend + fx[prev][j_]
                        )
                    )

                prob_gap_x = float(emission_params.prob_emit_y(j)) + (
                    g.prob_gap_x + fm[curr][jm1]
                )
                if g.do_gap_x_extend:
                    prob_gap_x = float(
                        LogProb(prob_gap_x).ln_add_exp(
                            g.prob_gap_x_extend + fy[curr][jm1]
                        )
                    )

                if max_edit_dist is not None:
                    m = med_topleft if emit_xy.is_match else _sat_add(med_topleft, 1)
                    new_med = min(m, _sat_add(med_left, 1), _sat_add(med_top, 1))
                else:
                    new_med = 0

                fm[curr][j_] = prob_match_mismatch
                fx[curr][j_] = prob_gap_y
                fy[curr][j_] = prob_gap_x
                if max_edit_dist is not None:
                    med[curr][j_] = new_med

            if alignment_mode.free_end_gap_x():
                prob_cols.append(fm[curr][len_y])
                prob_cols.append(fx[curr][len_y])
                prob_cols.append(fy[curr][len_y])

            curr, prev = prev, curr
            for j_ in range(len_y + 1):
                fm[curr][j_] = _NEG_INF

        if alignment_mode.free_end_gap_x():
            p = LogProb.ln_sum_exp(prob_cols)
        else:
            p = LogProb.ln_sum_exp(
                [fm[prev][len_y], fx[prev][len_y], fy[prev][len_y]]
            )
        assert not math.isnan(p)
        if p > 0.0:
            return LogProb.ln_one()
        return LogProb(p)


from rust_bio_tpu_torch.stats.pairhmm.device import BatchPairHMM, BatchPairHMMLinear  # noqa: E402
from rust_bio_tpu_torch.stats.pairhmm.exact import BatchPairHMMExact  # noqa: E402
from rust_bio_tpu_torch.stats.pairhmm.homopoly_device import BatchHomopolyPairHMM  # noqa: E402
