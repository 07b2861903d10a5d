"""FM-index and FMD-index on the host (own copy of
``rust_bio_tpu.data_structures.fmindex``; reference: fmindex.rs).

``Interval`` (:69), ``BackwardSearchResult`` (:92), ``FMIndex`` with the
occ_r == 0 guard of its backward search (:144-248), ``BiInterval`` (:254)
and ``FMDIndex`` with ``smems`` / ``all_smems`` and the bidirectional
extensions (:284-570). This module is the exact scalar oracle of the
batched SMEM search (``fmd_device.DeviceFMDIndex``, kernel K-SMEM) and the
read mapper's fallback for the lanes that overflow the device's caps.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Tuple

import numpy as np

from rust_bio_tpu_torch.alphabets import dna
from rust_bio_tpu_torch.utils.text import to_array


@dataclass(frozen=True)
class Interval:
    """A suffix-array interval [lower, upper) (fmindex.rs:69)."""

    lower: int
    upper: int

    def occ(self, sa) -> List[int]:
        get = sa.get if hasattr(sa, "get") else lambda i: int(sa[i])
        return [get(pos) for pos in range(self.lower, self.upper)]


class BackwardSearchKind(Enum):
    Complete = "complete"
    Partial = "partial"
    Absent = "absent"


@dataclass(frozen=True)
class BackwardSearchResult:
    """Complete(interval) | Partial(interval, matched_len) | Absent."""

    kind: BackwardSearchKind
    interval: Interval | None = None
    matched_len: int = 0

    @classmethod
    def complete(cls, interval: Interval) -> "BackwardSearchResult":
        return cls(BackwardSearchKind.Complete, interval, 0)

    @classmethod
    def partial(cls, interval: Interval, l: int) -> "BackwardSearchResult":
        return cls(BackwardSearchKind.Partial, interval, l)

    @classmethod
    def absent(cls) -> "BackwardSearchResult":
        return cls(BackwardSearchKind.Absent)


class FMIndex:
    """FM-index over (bwt, less, occ) (fmindex.rs:216-248)."""

    def __init__(self, bwt, less, occ) -> None:
        self._bwt = to_array(bwt)
        self._less = np.asarray(less)
        self._occ = occ

    def occ(self, r: int, a: int) -> int:
        return self._occ.get(self._bwt, r, a)

    def less(self, a: int) -> int:
        return int(self._less[a])

    def bwt(self) -> np.ndarray:
        return self._bwt

    def backward_search(self, pattern) -> BackwardSearchResult:
        """O(m) backward search (fmindex.rs:144-208).

        >>> # see tests/test_fmindex.py for the reference doctest values
        """
        pat = to_array(pattern)
        l, r = 0, len(self._bwt) - 1
        pl, pr = l, r
        matched_len = 0
        complete_match = True

        for a in pat[::-1]:
            a = int(a)
            less_a = self.less(a)
            pl, pr = l, r
            occ_r = self.occ(r, a)
            # Empty interval; the assignment to r below would underflow when
            # less == 0 (reference issue #606 guard, fmindex.rs:164-170).
            if occ_r == 0:
                complete_match = False
                break
            l = less_a + (self.occ(l - 1, a) if l > 0 else 0)
            r = less_a + occ_r - 1
            if l > r:
                complete_match = False
                break
            matched_len += 1

        if matched_len > 0:
            if complete_match:
                return BackwardSearchResult.complete(Interval(l, r + 1))
            return BackwardSearchResult.partial(Interval(pl, pr + 1), matched_len)
        return BackwardSearchResult.absent()


@dataclass(frozen=True)
class BiInterval:
    """Bi-interval over forward and revcomp strand (fmindex.rs:254)."""

    lower: int
    lower_rev: int
    size: int
    match_size: int

    def forward(self) -> Interval:
        return Interval(self.lower, self.lower + self.size)

    def revcomp(self) -> Interval:
        return Interval(self.lower_rev, self.lower_rev + self.size)

    def swapped(self) -> "BiInterval":
        return BiInterval(self.lower_rev, self.lower, self.size, self.match_size)


# backward_ext iteration order over symbols (fmindex.rs:520-540):
# lexicographically smallest first, with complements mapping accordingly.
_EXT_ORDER = b"$TGCNAtgcna"


class FMDIndex:
    """FMD-index over a T$revcomp(T)$ text (Li 2012; fmindex.rs:284-570)."""

    def __init__(self, fmindex: FMIndex, check_alphabet: bool = True) -> None:
        if check_alphabet:
            alpha = dna.n_alphabet()
            alpha.insert(ord("$"))
            assert alpha.is_word(fmindex.bwt().tobytes()), (
                "Expecting BWT over the DNA alphabet (including N) "
                "with the sentinel $."
            )
        self.fmindex = fmindex

    # FMIndexable passthrough
    def occ(self, r: int, a: int) -> int:
        return self.fmindex.occ(r, a)

    def less(self, a: int) -> int:
        return self.fmindex.less(a)

    def bwt(self) -> np.ndarray:
        return self.fmindex.bwt()

    def backward_search(self, pattern) -> BackwardSearchResult:
        return self.fmindex.backward_search(pattern)

    def init_interval_with(self, a: int) -> BiInterval:
        comp_a = dna.complement(a)
        lower = self.less(a)
        return BiInterval(
            lower=lower,
            lower_rev=self.less(comp_a),
            size=self.less(a + 1) - lower,
            match_size=1,
        )

    def init_interval(self) -> BiInterval:
        return BiInterval(0, 0, len(self.bwt()), 0)

    def backward_ext(self, interval: BiInterval, a: int) -> BiInterval:
        s = 0
        o = 0
        l = interval.lower_rev
        for b in _EXT_ORDER:
            l += s
            o = 0 if interval.lower == 0 else self.occ(interval.lower - 1, b)
            s = self.occ(interval.lower + interval.size - 1, b) - o
            if b == a:
                break
        k = self.less(a) + o
        return BiInterval(
            lower=k, lower_rev=l, size=s, match_size=interval.match_size + 1
        )

    def forward_ext(self, interval: BiInterval, a: int) -> BiInterval:
        comp_a = dna.complement(a)
        return self.backward_ext(interval.swapped(), comp_a).swapped()

    def smems(
        self, pattern, i: int, l: int
    ) -> List[Tuple[BiInterval, int, int]]:
        """SMEMs (length >= l) overlapping position i (fmindex.rs:367-434)."""
        pat = to_array(pattern)
        curr: List[Tuple[BiInterval, int]] = []
        prev: List[Tuple[BiInterval, int]] = []
        matches: List[Tuple[BiInterval, int, int]] = []

        match_len = 0
        interval = self.init_interval_with(int(pat[i]))
        if interval.size != 0:
            match_len += 1

        for a in pat[i + 1 :]:
            forward_interval = self.forward_ext(interval, int(a))
            if interval.size != forward_interval.size:
                curr.append((interval, match_len))
            if forward_interval.size == 0:
                break
            interval = forward_interval
            match_len += 1
        curr.append((interval, match_len))
        curr.reverse()

        prev, curr = curr, prev
        j = len(pat)

        for k in range(i - 1, -2, -1):
            a = ord("$") if k == -1 else int(pat[k])
            curr = []
            last_size = -1
            for interval, match_len in prev:
                forward_interval = self.backward_ext(interval, a)
                if (
                    (forward_interval.size == 0 or k == -1)
                    and not curr
                    and k < j
                    and match_len >= l
                ):
                    j = k
                    matches.append((interval, k + 1, match_len))
                if (
                    forward_interval.size != 0
                    and forward_interval.size != last_size
                ):
                    last_size = forward_interval.size
                    curr.append((forward_interval, match_len + 1))
            if not curr:
                break
            prev, curr = curr, prev

        return matches

    def all_smems(self, pattern, l: int) -> List[Tuple[BiInterval, int, int]]:
        """All SMEMs of length >= l (fmindex.rs:477-495)."""
        pat = to_array(pattern)
        smems: List[Tuple[BiInterval, int, int]] = []
        i0 = 0
        while i0 < len(pat):
            curr = self.smems(pat, i0, l)
            next_i0 = i0 + 1
            for _, p, ln in curr:
                if p + ln > next_i0:
                    next_i0 = p + ln
            i0 = next_i0
            smems.extend(curr)
        return smems
