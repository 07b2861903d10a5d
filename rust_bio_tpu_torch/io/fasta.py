"""FASTA reading and writing, with .fai-indexed random access.

Reference parity: src/io/fasta.rs — ``Reader`` (:174-300), ``Record``
{id, desc, seq} + ``check`` (:943-1017), ``Writer`` with optional line
wrapping (:793-940), ``.fai`` ``Index`` (:364-417) and ``IndexedReader``
``fetch``/``fetch_by_rid``/``fetch_all``/``read`` (:421-571).
"""

from __future__ import annotations

import io as _io
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Union

from rust_bio_tpu_torch.utils.text import to_bytes


@dataclass
class Record:
    """A FASTA record (fasta.rs:943)."""

    id: str = ""
    desc: Optional[str] = None
    seq: bytes = b""

    @classmethod
    def with_attrs(cls, id: str, desc: Optional[str], seq) -> "Record":
        return cls(id=id, desc=desc, seq=to_bytes(seq))

    def is_empty(self) -> bool:
        return not self.id and self.desc is None and not self.seq

    def check(self) -> Optional[str]:
        """None if valid, else an error string (fasta.rs:993-1009)."""
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
        return None

    def __str__(self) -> str:
        header = self.id if self.desc is None else f"{self.id} {self.desc}"
        return f">{header}\n{self.seq.decode()}\n"


class Reader:
    """Streaming FASTA reader over a file path or binary stream."""

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
        rec: Optional[Record] = None
        seq_parts: List[bytes] = []
        for raw in self._h:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if rec is not None:
                    rec.seq = b"".join(seq_parts)
                    yield rec
                header = line[1:].decode()
                parts = header.split(None, 1)
                rec = Record(
                    id=parts[0] if parts else "",
                    desc=parts[1] if len(parts) > 1 else None,
                )
                seq_parts = []
            elif rec is not None:
                seq_parts.append(line)
            elif line:
                raise ValueError("Expected > at record start.")
        if rec is not None:
            rec.seq = b"".join(seq_parts)
            yield rec

    def __iter__(self) -> Iterator[Record]:
        return self.records()


class Writer:
    """FASTA writer with optional fixed line width (fasta.rs:793-940)."""

    def __init__(self, handle, line_width: Optional[int] = None) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "wb")
        self._h = handle
        self.line_width = line_width

    @classmethod
    def to_file(cls, path, line_width: Optional[int] = None) -> "Writer":
        return cls(path, line_width)

    def write_record(self, record: Record) -> None:
        self.write(record.id, record.desc, record.seq)

    def write(self, id: str, desc: Optional[str], seq) -> None:
        seq = to_bytes(seq)
        header = id if desc is None else f"{id} {desc}"
        self._h.write(b">" + header.encode() + b"\n")
        if self.line_width:
            w = self.line_width
            for i in range(0, len(seq), w):
                self._h.write(seq[i : i + w] + b"\n")
            if len(seq) == 0:
                self._h.write(b"\n")
        else:
            self._h.write(seq + b"\n")

    def flush(self) -> None:
        self._h.flush()


@dataclass(frozen=True)
class Sequence:
    """One .fai index entry's public view (fasta.rs:400-417)."""

    name: str
    len: int


@dataclass(frozen=True)
class _IndexRecord:
    name: str
    len: int
    offset: int
    line_bases: int
    line_bytes: int


class Index:
    """Parsed .fai index (fasta.rs:364-417)."""

    def __init__(self, records: List[_IndexRecord]) -> None:
        self.inner = records
        self.name_to_rid = {r.name: i for i, r in enumerate(records)}

    @classmethod
    def new(cls, fai_handle) -> "Index":
        if isinstance(fai_handle, (str, os.PathLike)):
            fai_handle = open(fai_handle, "rb")
        records = []
        for raw in fai_handle:
            line = raw.decode().rstrip("\n")
            if not line:
                continue
            name, ln, offset, lb, lw = line.split("\t")[:5]
            records.append(
                _IndexRecord(name, int(ln), int(offset), int(lb), int(lw))
            )
        return cls(records)

    @classmethod
    def from_file(cls, path) -> "Index":
        return cls.new(path)

    @classmethod
    def build(cls, fasta_path) -> "Index":
        """Build an index from a FASTA file (equivalent of samtools faidx)."""
        records = []
        with open(fasta_path, "rb") as h:
            name = None
            seq_len = 0
            offset = 0
            line_bases = 0
            line_bytes = 0
            pos = 0
            first_line = True
            for raw in h:
                start = pos
                pos += len(raw)
                line = raw.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        records.append(
                            _IndexRecord(name, seq_len, offset, line_bases, line_bytes)
                        )
                    name = line[1:].split()[0].decode() if len(line) > 1 else ""
                    seq_len = 0
                    offset = pos
                    line_bases = 0
                    line_bytes = 0
                    first_line = True
                elif name is not None and line:
                    if first_line:
                        line_bases = len(line)
                        line_bytes = len(raw)
                        first_line = False
                    seq_len += len(line)
            if name is not None:
                records.append(
                    _IndexRecord(name, seq_len, offset, line_bases, line_bytes)
                )
        return cls(records)

    def write(self, path) -> None:
        with open(path, "w") as h:
            for r in self.inner:
                h.write(
                    f"{r.name}\t{r.len}\t{r.offset}\t{r.line_bases}\t{r.line_bytes}\n"
                )

    def sequences(self) -> List[Sequence]:
        return [Sequence(r.name, r.len) for r in self.inner]


class IndexedReader:
    """Random access into an indexed FASTA (fasta.rs:421-571)."""

    def __init__(self, fasta_handle, index: Index) -> None:
        if isinstance(fasta_handle, (str, os.PathLike)):
            fasta_handle = open(fasta_handle, "rb")
        self._h = fasta_handle
        self.index = index
        self._fetched: Optional[tuple] = None  # (rid, start, stop)

    @classmethod
    def from_file(cls, path) -> "IndexedReader":
        fai = str(path) + ".fai"
        if os.path.exists(fai):
            index = Index.new(fai)
        else:
            index = Index.build(path)
        return cls(path, index)

    @classmethod
    def new(cls, fasta_handle, fai_handle) -> "IndexedReader":
        return cls(fasta_handle, Index.new(fai_handle))

    def fetch(self, seq_name: str, start: int, stop: int) -> None:
        rid = self.index.name_to_rid.get(seq_name)
        if rid is None:
            raise KeyError(f"sequence {seq_name!r} not in index")
        self.fetch_by_rid(rid, start, stop)

    def fetch_by_rid(self, rid: int, start: int, stop: int) -> None:
        if rid >= len(self.index.inner):
            raise IndexError("rid out of range")
        self._fetched = (rid, start, stop)

    def fetch_all(self, seq_name: str) -> None:
        rid = self.index.name_to_rid.get(seq_name)
        if rid is None:
            raise KeyError(f"sequence {seq_name!r} not in index")
        self.fetch_all_by_rid(rid)

    def fetch_all_by_rid(self, rid: int) -> None:
        self.fetch_by_rid(rid, 0, self.index.inner[rid].len)

    def read(self) -> bytes:
        """Read the fetched region (fasta.rs `read` into a Text)."""
        if self._fetched is None:
            raise RuntimeError("no region fetched")
        rid, start, stop = self._fetched
        rec = self.index.inner[rid]
        if stop > rec.len:
            raise ValueError("region out of bounds")
        if start > stop:
            raise ValueError("invalid region: start > stop")
        out = bytearray()
        line = start // rec.line_bases if rec.line_bases else 0
        line_off = start % rec.line_bases if rec.line_bases else 0
        offset = rec.offset + line * rec.line_bytes + line_off
        self._h.seek(offset)
        remaining = stop - start
        while remaining > 0:
            in_line = rec.line_bases - line_off
            take = min(remaining, in_line)
            chunk = self._h.read(take)
            out.extend(chunk)
            remaining -= take
            line_off = 0
            if remaining > 0:
                self._h.read(rec.line_bytes - rec.line_bases)  # skip newline
        return bytes(out)

    def read_iter(self) -> Iterator[int]:
        return iter(self.read())


def read_all(path) -> List[Record]:
    """Convenience: parse a whole FASTA file into records."""
    with open(path, "rb") as h:
        return list(Reader(h).records())
