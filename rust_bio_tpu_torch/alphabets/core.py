"""Alphabet and RankTransform (own copy of ``rust_bio_tpu.alphabets.core``;
reference parity: src/alphabets/mod.rs). Symbols and ranks are (256,) numpy
LUTs."""

from __future__ import annotations

from typing import List

import numpy as np

from rust_bio_tpu_torch.utils.text import TextLike, to_bytes


class Alphabet:
    """A set of u8 symbols (reference: alphabets::Alphabet, mod.rs:30)."""

    def __init__(self, symbols: TextLike = b"") -> None:
        self._mask = np.zeros(256, dtype=bool)
        arr = np.frombuffer(to_bytes(symbols), np.uint8)
        self._mask |= np.bincount(arr, minlength=256) > 0

    def insert(self, a: int) -> None:
        self._mask[a] = True

    def is_word(self, text: TextLike) -> bool:
        """Whether every symbol of ``text`` is in the alphabet."""
        return bool(self._mask[np.frombuffer(to_bytes(text), np.uint8)].all())

    def __len__(self) -> int:
        return int(self._mask.sum())

    def __contains__(self, a: int) -> bool:
        return bool(self._mask[a])

    def max_symbol(self):
        """The largest member symbol, or None for an empty alphabet."""
        nz = np.nonzero(self._mask)[0]
        return int(nz[-1]) if len(nz) else None

    def symbols(self) -> List[int]:
        """Sorted list of member symbols."""
        return [int(s) for s in np.nonzero(self._mask)[0]]


class RankTransform:
    """Dense rank recoding of an alphabet (reference: mod.rs:220): symbols get
    ranks 0..len-1 in ascending order; ``lut`` is (256,) uint8, 255 = not in
    the alphabet."""

    INVALID = 255

    def __init__(self, alphabet: Alphabet) -> None:
        self.lut = np.full(256, self.INVALID, dtype=np.uint8)
        syms = alphabet.symbols()
        self.lut[syms] = np.arange(len(syms), dtype=np.uint8)
