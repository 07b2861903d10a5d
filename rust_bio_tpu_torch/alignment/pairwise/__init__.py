"""Pairwise alignment (port of ``rust_bio_tpu.alignment.pairwise``: global,
semiglobal, local and custom modes, with ``MatchParams`` scoring or a
substitution matrix; the banded aligner ``BatchBandedAligner``).

Gap model (reference: pairwise/mod.rs:9-15, v4.0 semantics):
``GapScore(k) = gap_open + gap_extend * (k - 1)``.
"""

from rust_bio_tpu_torch.alignment.pairwise.batched import BatchAligner
from rust_bio_tpu_torch.alignment.pairwise.banded_device import BatchBandedAligner
from rust_bio_tpu_torch.alignment.pairwise.scoring import (
    MIN_SCORE,
    MatchParams,
    Scoring,
)

__all__ = ["MIN_SCORE", "MatchParams", "Scoring", "BatchAligner", "BatchBandedAligner"]
