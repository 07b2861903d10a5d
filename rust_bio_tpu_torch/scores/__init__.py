"""Amino-acid substitution matrices (own copy of ``rust_bio_tpu.scores``;
reference parity: src/scores/).

The standard BLOSUM30/45/62 and PAM40/120/200/250 tables (public
scientific data, the reference's 27x27 tables), loaded from this package's
``matrices.npz``: each is a 27x27 int32 ndarray, indexed through the
(256,) uint8 ASCII->index ``LOOKUP``. :func:`dense_matrix` expands one to
the (256, 256) int32 LUT the alignment kernels read.

Index mapping (reference: scores/mod.rs:22-35): 'A'..'W' -> 0..22,
'Y' -> 23, 'Z' -> 24, 'X' -> 25, '*' -> 26; every other byte -> 0 (the
reference panics there; callers validate with ``Alphabet.is_word``).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

_DATA = np.load(os.path.join(os.path.dirname(__file__), "matrices.npz"))


def _build_lookup() -> np.ndarray:
    lut = np.zeros(256, dtype=np.uint8)
    lut[ord("A") : ord("X") + 1] = np.arange(ord("X") - ord("A") + 1)
    lut[ord("Y")] = 23
    lut[ord("Z")] = 24
    lut[ord("X")] = 25
    lut[ord("*")] = 26
    return lut


LOOKUP: np.ndarray = _build_lookup()


def matrix(name: str) -> np.ndarray:
    """The raw 27x27 int32 substitution matrix."""
    return _DATA[name]


@lru_cache(maxsize=None)
def dense_matrix(name: str) -> np.ndarray:
    """(256, 256) int32 LUT: score = dense[a, b] for raw bytes a, b."""
    mat = _DATA[name]
    return np.ascontiguousarray(mat[np.ix_(LOOKUP, LOOKUP)], dtype=np.int32)


def _scorer(name: str):
    mat = _DATA[name]

    def score(a: int, b: int) -> int:
        return int(mat[LOOKUP[a], LOOKUP[b]])

    score.__name__ = name
    score.matrix_name = name
    return score


blosum30 = _scorer("blosum30")
blosum45 = _scorer("blosum45")
blosum62 = _scorer("blosum62")
pam40 = _scorer("pam40")
pam120 = _scorer("pam120")
pam200 = _scorer("pam200")
pam250 = _scorer("pam250")

__all__ = [
    "blosum30",
    "blosum45",
    "blosum62",
    "pam40",
    "pam120",
    "pam200",
    "pam250",
    "matrix",
    "dense_matrix",
    "LOOKUP",
]
