"""Fenwick (binary indexed) trees for prefix max / prefix sum (own copy of
``rust_bio_tpu.data_structures.bit_tree``).

Reference parity: src/data_structures/bit_tree.rs — ``PrefixOp`` trait,
``FenwickTree`` get/set over idx+1 internal indexing (:34-104);
``MaxBitTree`` is the engine under LCSk++/sdpkpp chaining.
"""

from __future__ import annotations

from typing import Callable, Generic, List, TypeVar

T = TypeVar("T")


class FenwickTree(Generic[T]):
    """Prefix-op Fenwick tree; ``op`` must be commutative/associative and
    monotone (max, sum)."""

    def __init__(self, len: int, op: Callable[[T, T], T], default: T) -> None:
        self.tree: List[T] = [default] * (len + 1)
        self.op = op
        self.default = default

    def get(self, idx: int) -> T:
        """Prefix value over elements [0..idx] (inclusive)."""
        idx += 1
        sum_ = self.default
        while idx > 0:
            sum_ = self.op(sum_, self.tree[idx])
            idx -= idx & (-idx)
        return sum_

    def set(self, idx: int, val: T) -> None:
        """Incorporate ``val`` at position idx (monotone update)."""
        idx += 1
        while idx < len(self.tree):
            self.tree[idx] = self.op(self.tree[idx], val)
            idx += idx & (-idx)

    def __len__(self) -> int:
        return len(self.tree) - 1


class MaxBitTree(FenwickTree):
    """Prefix-max Fenwick tree (values must be >= default, e.g. tuples)."""

    def __init__(self, len: int, default=None) -> None:
        if default is None:
            default = (0, 0)
        super().__init__(len, max, default)


class SumBitTree(FenwickTree):
    def __init__(self, len: int) -> None:
        super().__init__(len, lambda a, b: a + b, 0)
