"""DNA alphabets with complement/revcomp LUTs (own copy of
``rust_bio_tpu.alphabets.dna``; reference: src/alphabets/dna.rs)."""

from __future__ import annotations

import numpy as np

from rust_bio_tpu_torch.alphabets.core import Alphabet
from rust_bio_tpu_torch.utils.text import TextLike, to_array


def n_alphabet() -> Alphabet:
    """The DNA alphabet including N. dna.rs:28"""
    return Alphabet(b"ACGTNacgtn")


def _build_complement() -> np.ndarray:
    comp = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"AGCTYRWSKMDVHBN", b"TCGARYWSMKHBDVN"):
        comp[a] = b
        comp[a + 32] = b + 32
    return comp


# (256,) uint8 LUT: IUPAC complement, case preserved, other bytes unchanged
COMPLEMENT: np.ndarray = _build_complement()


def complement(a):
    """Complement of a DNA symbol (IUPAC supported; case preserved). dna.rs:67"""
    if np.isscalar(a) or isinstance(a, int):
        return int(COMPLEMENT[a])
    return COMPLEMENT[to_array(a)]


def revcomp(text: TextLike) -> bytes:
    """Reverse complement of a DNA text. dna.rs:83"""
    return COMPLEMENT[to_array(text)][::-1].tobytes()


def revcomp_array(text: TextLike) -> np.ndarray:
    """Reverse complement as a uint8 array."""
    return COMPLEMENT[to_array(text)][::-1].copy()
