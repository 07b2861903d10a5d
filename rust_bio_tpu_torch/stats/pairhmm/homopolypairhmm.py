"""14-state pair HMM modeling homopolymer (hop) errors (ONT sequencing).

Reference parity: src/stats/pairhmm/homopolypairhmm.rs — ``State`` enum of
4 match states + GapX/GapY + 8 hop states (:90-106), transition table built
from gap + (base-specific) hop parameters (:495-596; the reference indexes
it by bit-interleaved state pairs, here a plain dict keyed by state pairs),
``prob_related`` forward pass with min-edit-dist banding, the quarter
initial mass over match states, halved mismatch emissions and the
free-end-gap column accumulation quirk (:246-420). A copy of the JAX
package's host oracle.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from rust_bio_tpu_torch.stats.pairhmm import (
    EmissionParameters,
    GapParameters,
    StartEndGapParameters,
)
from rust_bio_tpu_torch.stats.probs import LogProb

_NEG_INF = float("-inf")

# states (homopolypairhmm.rs:90-106)
MATCH_A, MATCH_C, MATCH_G, MATCH_T = 0, 1, 2, 3
GAP_X, GAP_Y = 4, 5
HOP_AX, HOP_AY, HOP_CX, HOP_CY = 6, 7, 8, 9
HOP_GX, HOP_GY, HOP_TX, HOP_TY = 10, 11, 12, 13

STATES = list(range(14))
MATCH_STATES = [MATCH_A, MATCH_C, MATCH_G, MATCH_T]
HOP_X_STATES = [HOP_AX, HOP_CX, HOP_GX, HOP_TX]
HOP_Y_STATES = [HOP_AY, HOP_CY, HOP_GY, HOP_TY]
MATCH_HOP_X = list(zip(MATCH_STATES, HOP_X_STATES))
MATCH_HOP_Y = list(zip(MATCH_STATES, HOP_Y_STATES))

_BASE_OF = {
    MATCH_A: ord("A"), HOP_AX: ord("A"), HOP_AY: ord("A"),
    MATCH_C: ord("C"), HOP_CX: ord("C"), HOP_CY: ord("C"),
    MATCH_G: ord("G"), HOP_GX: ord("G"), HOP_GY: ord("G"),
    MATCH_T: ord("T"), HOP_TX: ord("T"), HOP_TY: ord("T"),
}

_SUPPORT = {
    MATCH_A: ord("A"),
    MATCH_C: ord("C"),
    MATCH_G: ord("G"),
    MATCH_T: ord("T"),
}


class HopParameters:
    """Uniform hop parameters (homopolypairhmm.rs:168)."""

    def prob_hop_x(self) -> float:
        raise NotImplementedError

    def prob_hop_y(self) -> float:
        raise NotImplementedError

    def prob_hop_x_extend(self) -> float:
        raise NotImplementedError

    def prob_hop_y_extend(self) -> float:
        raise NotImplementedError

    # base-specific view (BaseSpecificHopParameters blanket impl)
    def prob_hop_x_with_base(self, base: int) -> float:
        return self.prob_hop_x()

    def prob_hop_y_with_base(self, base: int) -> float:
        return self.prob_hop_y()

    def prob_hop_x_extend_with_base(self, base: int) -> float:
        return self.prob_hop_x_extend()

    def prob_hop_y_extend_with_base(self, base: int) -> float:
        return self.prob_hop_y_extend()


BaseSpecificHopParameters = HopParameters


class Emission:
    """Base-aware emission interface (pairhmm/mod.rs:131)."""

    def emission_x(self, i: int) -> int:
        raise NotImplementedError

    def emission_y(self, j: int) -> int:
        raise NotImplementedError


def _ln1m(p: float) -> float:
    return float(LogProb(p).ln_one_minus_exp())


def _build_transition_table(gap_params, hop_params) -> Dict[Tuple[int, int], float]:
    t: Dict[Tuple[int, int], float] = {}
    pgx = float(gap_params.prob_gap_x())
    pgy = float(gap_params.prob_gap_y())
    pgxe = float(gap_params.prob_gap_x_extend())
    pgye = float(gap_params.prob_gap_y_extend())

    for m, h in MATCH_HOP_X:
        t[(m, h)] = float(hop_params.prob_hop_x_with_base(_BASE_OF[h]))
    for m, h in MATCH_HOP_Y:
        t[(m, h)] = float(hop_params.prob_hop_y_with_base(_BASE_OF[h]))
    for h in HOP_X_STATES:
        t[(h, h)] = float(hop_params.prob_hop_x_extend_with_base(_BASE_OF[h]))
    for h in HOP_Y_STATES:
        t[(h, h)] = float(hop_params.prob_hop_y_extend_with_base(_BASE_OF[h]))
    for h in HOP_X_STATES:
        p = _ln1m(float(hop_params.prob_hop_x_with_base(_BASE_OF[h])))
        for m in MATCH_STATES:
            t[(h, m)] = p
    for h in HOP_Y_STATES:
        p = _ln1m(float(hop_params.prob_hop_y_with_base(_BASE_OF[h])))
        for m in MATCH_STATES:
            t[(h, m)] = p

    prob_hop_x = float(
        LogProb.ln_sum_exp(
            [float(hop_params.prob_hop_x_with_base(b)) for b in b"ACGT"]
        )
    ) - 4.0
    prob_hop_y = float(
        LogProb.ln_sum_exp(
            [float(hop_params.prob_hop_y_with_base(b)) for b in b"ACGT"]
        )
    ) - 4.0
    match_any = _ln1m(
        float(LogProb.ln_sum_exp([pgy, pgx, prob_hop_x, prob_hop_y]))
    )
    for a in MATCH_STATES:
        for b in MATCH_STATES:
            t[(a, b)] = match_any

    for a in MATCH_STATES:
        t[(a, GAP_X)] = pgy
        t[(a, GAP_Y)] = pgx
    for b in MATCH_STATES:
        t[(GAP_X, b)] = _ln1m(pgye)
        t[(GAP_Y, b)] = _ln1m(pgxe)
    t[(GAP_X, GAP_X)] = pgye
    t[(GAP_Y, GAP_Y)] = pgxe
    return t


_USIZE_MAX = (1 << 64) - 1


def _sat_add(a: int, b: int) -> int:
    s = a + b
    return s if s <= _USIZE_MAX else _USIZE_MAX


class HomopolyPairHMM:
    def __init__(self, gap_params: GapParameters, hop_params) -> None:
        self.transition_probs = _build_transition_table(gap_params, hop_params)

    def prob_related(
        self,
        emission_params,
        alignment_mode: StartEndGapParameters,
        max_edit_dist: Optional[int] = None,
    ) -> LogProb:
        t = self.transition_probs
        len_y = emission_params.len_y()
        len_x = emission_params.len_x()
        free_end = alignment_mode.free_end_gap_x()
        free_start = alignment_mode.free_start_gap_x()

        v = [
            {s: [_NEG_INF] * (len_y + 1) for s in STATES},
            {s: [_NEG_INF] * (len_y + 1) for s in STATES},
        ]
        prev, curr = 0, 1
        med = [[_USIZE_MAX] * (len_y + 1) for _ in range(2)]
        prob_cols = []

        quarter = math.log(0.25)
        for m in MATCH_STATES:
            v[prev][m][0] = quarter

        for i in range(len_x):
            if free_start:
                psg = float(alignment_mode.prob_start_gap_x(i)) - math.log(4.0)
                for m in MATCH_STATES:
                    v[prev][m][0] = float(
                        LogProb(v[prev][m][0]).ln_add_exp(psg)
                    )
                med[prev][0] = 0

            prob_emit_x_and_gap = float(emission_params.prob_emit_x(i))
            ex = emission_params.emission_x(i)

            for j in range(len_y):
                j_ = j + 1
                jm1 = j_ - 1

                med_tl = med[prev][jm1]
                med_top = med[curr][jm1]
                med_left = med[prev][j_]
                if max_edit_dist is not None and (
                    min(med_tl, med_top, med_left) > max_edit_dist
                ):
                    continue

                ey = emission_params.emission_y(j)
                any_match = False
                for m in MATCH_STATES:
                    if ex == _SUPPORT[m] or ey == _SUPPORT[m]:
                        emission = emission_params.prob_emit_xy(i, j)
                        if emission.is_match:
                            ep = emission.prob
                        else:
                            # separate match states halve mismatch probs
                            ep = emission.prob - math.log(2.0)
                        any_match |= emission.is_match
                        v[curr][m][j_] = ep + float(
                            LogProb.ln_sum_exp(
                                [
                                    t.get((s, m), _NEG_INF) + v[prev][s][jm1]
                                    for s in STATES
                                ]
                            )
                        )
                    else:
                        v[curr][m][j_] = _NEG_INF

                v[curr][GAP_Y][j_] = prob_emit_x_and_gap + float(
                    LogProb.ln_sum_exp(
                        [t[(s, GAP_Y)] + v[prev][s][j_] for s in MATCH_STATES]
                        + [t[(GAP_Y, GAP_Y)] + v[prev][GAP_Y][j_]]
                    )
                )
                for m, h in MATCH_HOP_Y:
                    v[curr][h][j_] = float(
                        LogProb(t[(m, h)] + v[prev][m][j_]).ln_add_exp(
                            t[(h, h)] + v[prev][h][j_]
                        )
                    )
                v[curr][GAP_X][j_] = float(emission_params.prob_emit_y(j)) + float(
                    LogProb.ln_sum_exp(
                        [t[(s, GAP_X)] + v[curr][s][jm1] for s in MATCH_STATES]
                        + [t[(GAP_X, GAP_X)] + v[curr][GAP_X][jm1]]
                    )
                )
                for m, h in MATCH_HOP_X:
                    v[curr][h][j_] = float(
                        LogProb(t[(m, h)] + v[curr][m][jm1]).ln_add_exp(
                            t[(h, h)] + v[curr][h][jm1]
                        )
                    )

                if max_edit_dist is not None:
                    med[curr][j_] = min(
                        med_tl if any_match else _sat_add(med_tl, 1),
                        _sat_add(med_left, 1),
                        _sat_add(med_top, 1),
                    )

                if free_end:
                    # per-cell column accumulation (reference quirk,
                    # homopolypairhmm.rs:383-396)
                    prob_cols.extend(v[curr][s][len_y] for s in MATCH_STATES)
                    prob_cols.extend(v[curr][s][len_y] for s in HOP_Y_STATES)
                    prob_cols.extend(v[curr][s][len_y] for s in HOP_X_STATES)
                    prob_cols.append(v[curr][GAP_Y][len_y])
                    prob_cols.append(v[curr][GAP_X][len_y])

            prev, curr = curr, prev
            for s in MATCH_STATES:
                for j_ in range(len_y + 1):
                    v[curr][s][j_] = _NEG_INF

        if free_end:
            p = LogProb.ln_sum_exp(prob_cols)
        else:
            p = LogProb.ln_sum_exp([v[prev][s][len_y] for s in STATES])
        assert not math.isnan(p)
        if p > 0.0:
            return LogProb.ln_one()
        return LogProb(p)
