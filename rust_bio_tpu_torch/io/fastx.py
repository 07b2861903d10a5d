"""Format-agnostic FASTX layer (auto-detecting FASTA/FASTQ).

Reference parity: src/io/fastx.rs — ``EitherRecord`` (:260-340),
``EitherRecords`` auto-detecting reader (:342+), ``Kind`` sniffing via the
first non-empty byte '>' vs '@' (:478-588).
"""

from __future__ import annotations

import io as _io
import os
from enum import Enum
from typing import Iterator, Optional, Union

from rust_bio_tpu_torch.io import fasta, fastq


class Kind(Enum):
    FASTA = "fasta"
    FASTQ = "fastq"


class EitherRecord:
    """A record from either format with a unified accessor surface."""

    def __init__(self, inner: Union[fasta.Record, fastq.Record]) -> None:
        self.inner = inner

    @property
    def kind(self) -> Kind:
        return Kind.FASTQ if isinstance(self.inner, fastq.Record) else Kind.FASTA

    @property
    def id(self) -> str:
        return self.inner.id

    @property
    def desc(self) -> Optional[str]:
        return self.inner.desc

    @property
    def seq(self) -> bytes:
        return self.inner.seq

    @property
    def qual(self) -> Optional[bytes]:
        return self.inner.qual if isinstance(self.inner, fastq.Record) else None

    def check(self) -> Optional[str]:
        return self.inner.check()

    def to_fasta(self) -> fasta.Record:
        return fasta.Record(id=self.id, desc=self.desc, seq=self.seq)

    def to_fastq(self, default_qual: int = ord("I")) -> fastq.Record:
        if isinstance(self.inner, fastq.Record):
            return self.inner
        return fastq.Record(
            id=self.id,
            desc=self.desc,
            seq=self.seq,
            qual=bytes([default_qual]) * len(self.seq),
        )


def get_kind(handle_or_bytes) -> Kind:
    """Sniff the format from the first non-whitespace byte (fastx.rs:478)."""
    if isinstance(handle_or_bytes, (bytes, bytearray)):
        data = bytes(handle_or_bytes)
    else:
        pos = handle_or_bytes.tell()
        data = handle_or_bytes.read(64)
        handle_or_bytes.seek(pos)
    for b in data:
        if b in b" \t\r\n":
            continue
        if b == ord(">"):
            return Kind.FASTA
        if b == ord("@"):
            return Kind.FASTQ
        break
    raise ValueError("Could not determine FASTX kind (expected '>' or '@').")


def get_kind_file(path) -> Kind:
    with open(path, "rb") as h:
        return get_kind(h)


class EitherRecords:
    """Auto-detecting FASTX reader (fastx.rs:342)."""

    def __init__(self, handle) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "rb")
        if not handle.seekable():
            handle = _io.BytesIO(handle.read())
        self.kind = get_kind(handle)
        if self.kind == Kind.FASTA:
            self._it = iter(fasta.Reader(handle).records())
        else:
            self._it = iter(fastq.Reader(handle).records())

    @classmethod
    def from_file(cls, path) -> "EitherRecords":
        return cls(path)

    def __iter__(self) -> Iterator[EitherRecord]:
        for rec in self._it:
            yield EitherRecord(rec)
