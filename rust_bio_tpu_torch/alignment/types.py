"""Alignment result types (reference parity: bio_types::alignment).

Own copy of ``rust_bio_tpu.alignment.types``. ``AlignmentOperation`` is a
``NamedTuple``, so operations compare equal to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from itertools import groupby
from typing import List, NamedTuple, Tuple


class AlignmentMode(Enum):
    Local = "local"
    Semiglobal = "semiglobal"
    Global = "global"
    Custom = "custom"


class AlignmentOperation(NamedTuple):
    kind: str  # Match | Subst | Del | Ins | Xclip | Yclip
    len: int = 0

    def __repr__(self) -> str:
        if self.kind in ("Xclip", "Yclip"):
            return f"{self.kind}({self.len})"
        return self.kind


Match = AlignmentOperation("Match")
Subst = AlignmentOperation("Subst")
Del = AlignmentOperation("Del")
Ins = AlignmentOperation("Ins")


def Xclip(n: int) -> AlignmentOperation:
    return AlignmentOperation("Xclip", n)


def Yclip(n: int) -> AlignmentOperation:
    return AlignmentOperation("Yclip", n)


_CIGAR_CHAR = {"Match": "=", "Subst": "X", "Del": "D", "Ins": "I"}


@dataclass
class Alignment:
    """Pairwise alignment of x (query) against y (reference).

    - score: alignment score
    - xstart/xend, ystart/yend: 0-based half-open aligned spans
    - xlen/ylen: full sequence lengths
    - operations: op list (including clips in Custom mode)
    - mode: which boundary condition produced this alignment
    """

    score: int
    xstart: int = 0
    xend: int = 0
    ystart: int = 0
    yend: int = 0
    xlen: int = 0
    ylen: int = 0
    operations: List[AlignmentOperation] = field(default_factory=list)
    mode: AlignmentMode = AlignmentMode.Custom

    def filter_clip_operations(self) -> None:
        """Drop Xclip/Yclip ops (reference: Alignment::filter_clip_operations)."""
        self.operations = [op for op in self.operations if op.kind in _CIGAR_CHAR]

    def cigar(self, hard_clip: bool = False) -> str:
        """CIGAR string, x as the query (reference: Alignment::cigar): clipped
        query prefix/suffix as S (or H with ``hard_clip``), Match '=',
        Subst 'X', Ins 'I', Del 'D'; runs merge across removed clip ops."""
        if self.mode in (AlignmentMode.Global, AlignmentMode.Local):
            raise ValueError(
                f"Cigar fn not supported for {self.mode.name} Alignment mode"
            )
        clip_str = "H" if hard_clip else "S"
        out: List[str] = []
        if self.xstart > 0:
            out.append(f"{self.xstart}{clip_str}")
        ops = [op for op in self.operations if op.kind in _CIGAR_CHAR]
        for op, grp in groupby(ops):
            out.append(f"{sum(1 for _ in grp)}{_CIGAR_CHAR[op.kind]}")
        if self.xlen > self.xend:
            out.append(f"{self.xlen - self.xend}{clip_str}")
        return "".join(out)

    def path(self) -> List[Tuple[int, int, AlignmentOperation]]:
        """Matrix-path coordinates per op (reference: Alignment::path)."""
        path: List[Tuple[int, int, AlignmentOperation]] = []
        x_i, y_i = self.xstart, self.ystart
        for op in self.operations:
            if op.kind in ("Match", "Subst"):
                x_i += 1
                y_i += 1
            elif op.kind == "Ins":
                x_i += 1
            elif op.kind == "Del":
                y_i += 1
            else:
                continue
            path.append((x_i, y_i, op))
        return path

    def y_aln_len(self) -> int:
        return self.yend - self.ystart

    def x_aln_len(self) -> int:
        return self.xend - self.xstart
