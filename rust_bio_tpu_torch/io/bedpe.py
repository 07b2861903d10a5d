"""BEDPE (paired-interval BED) reading and writing.

Reference parity: src/io/bedpe.rs:60-200 — Record with two intervals plus
aux columns (name/score/strand1/strand2 accessors).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional


@dataclass
class Record:
    """A BEDPE record (bedpe.rs:60)."""

    chrom1: str = ""
    start1: int = 0
    end1: int = 0
    chrom2: str = ""
    start2: int = 0
    end2: int = 0
    aux: List[str] = field(default_factory=list)

    def aux_get(self, i: int) -> Optional[str]:
        """Aux field by absolute column index (columns 7+; bedpe.rs:107)."""
        idx = i - 7
        return self.aux[idx] if 0 <= idx < len(self.aux) else None

    def name(self) -> Optional[str]:
        return self.aux[0] if len(self.aux) > 0 else None

    def score(self) -> Optional[str]:
        return self.aux[1] if len(self.aux) > 1 else None

    def strand1(self) -> Optional[str]:
        if len(self.aux) > 2 and self.aux[2] in ("+", "-"):
            return self.aux[2]
        return None

    def strand2(self) -> Optional[str]:
        if len(self.aux) > 3 and self.aux[3] in ("+", "-"):
            return self.aux[3]
        return None

    def set_name(self, v: str) -> None:
        self._ensure(1)
        self.aux[0] = v

    def set_score(self, v: str) -> None:
        self._ensure(2)
        self.aux[1] = v

    def set_strand1(self, v: str) -> None:
        self._ensure(3)
        self.aux[2] = v

    def set_strand2(self, v: str) -> None:
        self._ensure(4)
        self.aux[3] = v

    def push_aux(self, v: str) -> None:
        self.aux.append(v)

    def _ensure(self, n: int) -> None:
        while len(self.aux) < n:
            self.aux.append("")

    def to_line(self) -> str:
        return "\t".join(
            [
                self.chrom1,
                str(self.start1),
                str(self.end1),
                self.chrom2,
                str(self.start2),
                str(self.end2),
                *self.aux,
            ]
        )


class Reader:
    def __init__(self, handle) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "r")
        self._h = handle

    @classmethod
    def from_file(cls, path) -> "Reader":
        return cls(path)

    def records(self) -> Iterator[Record]:
        for line in self._h:
            line = line.rstrip("\r\n")
            if not line or line.startswith("#"):
                continue
            f = line.split("\t")
            if len(f) < 6:
                raise ValueError(f"BEDPE record with less than 6 fields: {line!r}")
            yield Record(
                chrom1=f[0],
                start1=int(f[1]),
                end1=int(f[2]),
                chrom2=f[3],
                start2=int(f[4]),
                end2=int(f[5]),
                aux=f[6:],
            )

    def __iter__(self) -> Iterator[Record]:
        return self.records()


class Writer:
    def __init__(self, handle) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "w")
        self._h = handle

    @classmethod
    def to_file(cls, path) -> "Writer":
        return cls(path)

    def write(self, record: Record) -> None:
        self._h.write(record.to_line() + "\n")

    def flush(self) -> None:
        self._h.flush()
