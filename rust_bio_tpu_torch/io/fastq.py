"""FASTQ reading and writing.

Reference parity: src/io/fastq.rs — ``Reader`` (:153-300), ``Record``
{id, desc, seq, qual} + ``check`` validating qualities (:309-431),
``Writer`` (:530-596).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional

from rust_bio_tpu_torch.utils.text import to_bytes


@dataclass
class Record:
    """A FASTQ record (fastq.rs:309)."""

    id: str = ""
    desc: Optional[str] = None
    seq: bytes = b""
    qual: bytes = b""

    @classmethod
    def with_attrs(cls, id: str, desc: Optional[str], seq, qual) -> "Record":
        return cls(id=id, desc=desc, seq=to_bytes(seq), qual=to_bytes(qual))

    def is_empty(self) -> bool:
        return not self.id and self.desc is None and not self.seq and not self.qual

    def check(self) -> Optional[str]:
        """None if valid, else an error string (fastq.rs:388-410)."""
        if not self.id:
            return "record has empty id"
        try:
            self.seq.decode("ascii")
        except UnicodeDecodeError:
            return "sequence contains non-ascii character"
        for b in self.seq:
            c = chr(b)
            if not (c.isascii() and c.isalpha()) and c not in "-.*":
                return "sequence contains invalid character"
        try:
            self.qual.decode("ascii")
        except UnicodeDecodeError:
            return "qualities contain non-ascii character"
        if len(self.seq) != len(self.qual):
            return "unequal length of sequence and qualities"
        return None

    def __str__(self) -> str:
        header = self.id if self.desc is None else f"{self.id} {self.desc}"
        return f"@{header}\n{self.seq.decode()}\n+\n{self.qual.decode()}\n"


class Reader:
    """Streaming FASTQ reader."""

    def __init__(self, handle) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "rb")
        self._h = handle

    @classmethod
    def from_file(cls, path) -> "Reader":
        return cls(path)

    @classmethod
    def new(cls, handle) -> "Reader":
        return cls(handle)

    def records(self) -> Iterator[Record]:
        it = iter(self._h)
        while True:
            header = next(it, None)
            if header is None:
                return
            header = header.rstrip(b"\r\n")
            if not header:
                continue
            if not header.startswith(b"@"):
                raise ValueError("Expected @ at record start.")
            seq = next(it, b"").rstrip(b"\r\n")
            sep = next(it, b"").rstrip(b"\r\n")
            if not sep.startswith(b"+"):
                raise ValueError("Expected + separator.")
            qual = next(it, b"").rstrip(b"\r\n")
            parts = header[1:].decode().split(None, 1)
            yield Record(
                id=parts[0] if parts else "",
                desc=parts[1] if len(parts) > 1 else None,
                seq=seq,
                qual=qual,
            )

    def __iter__(self) -> Iterator[Record]:
        return self.records()


class Writer:
    """FASTQ writer (fastq.rs:530-596)."""

    def __init__(self, handle) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "wb")
        self._h = handle

    @classmethod
    def to_file(cls, path) -> "Writer":
        return cls(path)

    def write_record(self, record: Record) -> None:
        self.write(record.id, record.desc, record.seq, record.qual)

    def write(self, id: str, desc: Optional[str], seq, qual) -> None:
        seq, qual = to_bytes(seq), to_bytes(qual)
        header = id if desc is None else f"{id} {desc}"
        self._h.write(b"@" + header.encode() + b"\n")
        self._h.write(seq + b"\n+\n" + qual + b"\n")

    def flush(self) -> None:
        self._h.flush()


def read_all(path) -> List[Record]:
    with open(path, "rb") as h:
        return list(Reader(h).records())
