"""Scoring model for the affine-gap aligner (own copy of
``rust_bio_tpu.alignment.pairwise.scoring``; reference parity:
src/alignment/pairwise/mod.rs:171-470).

The kernels take constant match/mismatch scores (``MatchParams``) as two
integers and every other match function as the dense (256, 256) int32 LUT
of ``Scoring.dense_lut``: a BLOSUM/PAM scorer by its matrix, a callable
tabulated over all byte pairs, an ndarray as it is.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple, Union

import numpy as np

# 'Negative infinity' score sentinel (~0.4 * i32::MIN), safe against
# underflow when two of them are added (reference: pairwise/mod.rs:174).
MIN_SCORE: int = -858_993_459

MatchFn = Callable[[int, int], int]


@dataclass(frozen=True)
class MatchParams:
    """Constant match/mismatch scores (reference: mod.rs:186)."""

    match_score: int
    mismatch_score: int

    def __post_init__(self) -> None:
        assert self.match_score >= 0, "match_score can't be negative"
        assert self.mismatch_score <= 0, "mismatch_score can't be positive"

    def score(self, a: int, b: int) -> int:
        return self.match_score if a == b else self.mismatch_score


def _lut_from_fn(fn: MatchFn) -> np.ndarray:
    """``fn`` over all 256 x 256 byte pairs (65,536 Python calls)."""
    lut = np.zeros((256, 256), dtype=np.int32)
    for a in range(256):
        for b in range(256):
            lut[a, b] = fn(a, b)
    return lut


@dataclass(frozen=True)
class Scoring:
    """Affine-gap scoring with clip penalties (reference: mod.rs:238-470).

    ``match_fn`` may be a ``MatchParams``, a callable ``(a, b) -> int`` over
    u8 symbols, or a precomputed (256, 256) int32 LUT.
    """

    gap_open: int
    gap_extend: int
    match_fn: Union[MatchParams, MatchFn, np.ndarray]
    match_scores: Optional[Tuple[int, int]] = None
    xclip_prefix: int = MIN_SCORE
    xclip_suffix: int = MIN_SCORE
    yclip_prefix: int = MIN_SCORE
    yclip_suffix: int = MIN_SCORE

    def __post_init__(self) -> None:
        assert self.gap_open <= 0, "gap_open can't be positive"
        assert self.gap_extend <= 0, "gap_extend can't be positive"

    @classmethod
    def new(cls, gap_open: int, gap_extend: int, match_fn) -> "Scoring":
        return cls(gap_open=gap_open, gap_extend=gap_extend, match_fn=match_fn)

    @classmethod
    def from_scores(
        cls,
        gap_open: int,
        gap_extend: int,
        match_score: int,
        mismatch_score: int,
    ) -> "Scoring":
        return cls(
            gap_open=gap_open,
            gap_extend=gap_extend,
            match_fn=MatchParams(match_score, mismatch_score),
            match_scores=(match_score, mismatch_score),
        )

    # ---- clip penalties (rust_bio_tpu/alignment/pairwise/scoring.py:91-127) ----

    def xclip(self, penalty: int) -> "Scoring":
        assert penalty <= 0, "Clipping penalty can't be positive"
        return replace(self, xclip_prefix=penalty, xclip_suffix=penalty)

    def xclip_prefix_(self, penalty: int) -> "Scoring":
        assert penalty <= 0, "Clipping penalty can't be positive"
        return replace(self, xclip_prefix=penalty)

    def xclip_suffix_(self, penalty: int) -> "Scoring":
        assert penalty <= 0, "Clipping penalty can't be positive"
        return replace(self, xclip_suffix=penalty)

    def yclip(self, penalty: int) -> "Scoring":
        assert penalty <= 0, "Clipping penalty can't be positive"
        return replace(self, yclip_prefix=penalty, yclip_suffix=penalty)

    def yclip_prefix_(self, penalty: int) -> "Scoring":
        assert penalty <= 0, "Clipping penalty can't be positive"
        return replace(self, yclip_prefix=penalty)

    def yclip_suffix_(self, penalty: int) -> "Scoring":
        assert penalty <= 0, "Clipping penalty can't be positive"
        return replace(self, yclip_suffix=penalty)

    def with_clips(self, xp: int, xs: int, yp: int, ys: int) -> "Scoring":
        return replace(self, xclip_prefix=xp, xclip_suffix=xs, yclip_prefix=yp, yclip_suffix=ys)

    def score(self, a: int, b: int) -> int:
        fn = self.match_fn
        if isinstance(fn, MatchParams):
            return fn.score(a, b)
        if isinstance(fn, np.ndarray):
            return int(fn[a, b])
        return int(fn(a, b))

    def dense_lut(self) -> np.ndarray:
        """(256, 256) int32 substitution LUT (scoring.py ``dense_lut``)."""
        fn = self.match_fn
        if isinstance(fn, np.ndarray):
            return np.ascontiguousarray(fn, dtype=np.int32)
        if isinstance(fn, MatchParams):
            lut = np.full((256, 256), fn.mismatch_score, dtype=np.int32)
            np.fill_diagonal(lut, fn.match_score)
            return lut
        if hasattr(fn, "matrix_name"):
            from rust_bio_tpu_torch.scores import dense_matrix

            return dense_matrix(fn.matrix_name)
        return _lut_from_fn(fn)
