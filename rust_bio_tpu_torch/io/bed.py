"""BED format reading and writing.

Reference parity: src/io/bed/bed.rs — ``Record`` = chrom/start/end plus aux
columns with typed name/score/strand accessors (:45-90), TSV Reader/Writer
(bed/common.rs:84-160).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional


@dataclass
class Record:
    """A BED record (bed.rs:45)."""

    chrom: str = ""
    start: int = 0
    end: int = 0
    aux: List[str] = field(default_factory=list)

    # typed accessors over the aux columns (bed.rs:55-88)
    def name(self) -> Optional[str]:
        return self.aux[0] if len(self.aux) > 0 else None

    def score(self) -> Optional[str]:
        return self.aux[1] if len(self.aux) > 1 else None

    def strand(self) -> Optional[str]:
        if len(self.aux) > 2 and self.aux[2] in ("+", "-"):
            return self.aux[2]
        return None

    def set_name(self, name: str) -> None:
        self._ensure_aux(1)
        self.aux[0] = name

    def set_score(self, score: str) -> None:
        self._ensure_aux(2)
        self.aux[1] = score

    def set_strand(self, strand: str) -> None:
        self._ensure_aux(3)
        self.aux[2] = strand

    def _ensure_aux(self, n: int) -> None:
        while len(self.aux) < n:
            self.aux.append("")

    def to_line(self) -> str:
        fields = [self.chrom, str(self.start), str(self.end), *self.aux]
        return "\t".join(fields)


class Reader:
    """TSV BED reader (bed/common.rs:84)."""

    def __init__(self, handle) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "r")
        self._h = handle

    @classmethod
    def from_file(cls, path) -> "Reader":
        return cls(path)

    @classmethod
    def new(cls, handle) -> "Reader":
        return cls(handle)

    def records(self) -> Iterator[Record]:
        for line in self._h:
            line = line.rstrip("\r\n")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            fields = line.split("\t")
            if len(fields) < 3:
                raise ValueError(f"BED record with less than 3 fields: {line!r}")
            yield Record(
                chrom=fields[0],
                start=int(fields[1]),
                end=int(fields[2]),
                aux=fields[3:],
            )

    def __iter__(self) -> Iterator[Record]:
        return self.records()


class Writer:
    """TSV BED writer."""

    def __init__(self, handle) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "w")
        self._h = handle

    @classmethod
    def to_file(cls, path) -> "Writer":
        return cls(path)

    @classmethod
    def new(cls, handle) -> "Writer":
        return cls(handle)

    def write(self, record: Record) -> None:
        self._h.write(record.to_line() + "\n")

    def flush(self) -> None:
        self._h.flush()
