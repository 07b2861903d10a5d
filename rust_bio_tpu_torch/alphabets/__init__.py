"""Alphabets and rank transforms (own copy; reference parity: src/alphabets/)."""

from rust_bio_tpu_torch.alphabets.core import Alphabet, RankTransform
from rust_bio_tpu_torch.alphabets import dna, protein

__all__ = ["Alphabet", "RankTransform", "dna", "protein"]
