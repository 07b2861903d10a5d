"""GFF3 / GFF2 / GTF2 reading and writing.

Reference parity: src/io/gff.rs — ``GffType`` (:45), 9-column TSV records
with multimap attributes, GFF3 percent-encoding of the column-9 reserved
characters (:95-110, 416-478), ``Phase`` newtype (:273), typed accessors
(:563-655).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterator, List, Optional


class GffType(Enum):
    GFF3 = "gff3"
    GFF2 = "gff2"
    GTF2 = "gtf2"

    @property
    def separators(self):
        """(attribute separator, key-value separator) per format."""
        if self is GffType.GFF3:
            return ";", "="
        return ";", " "


# GFF3 column-9 reserved characters (gff.rs:95-110)
_GFF3_RESERVED = {"\t": "%09", "\n": "%0A", "\r": "%0D", "%": "%25",
                  ";": "%3B", "=": "%3D", "&": "%26", ",": "%2C"}


def gff3_encode(s: str) -> str:
    return "".join(_GFF3_RESERVED.get(c, c) for c in s)


def gff3_decode(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "%" and i + 2 < len(s) + 1 and len(s) >= i + 3:
            hex2 = s[i + 1 : i + 3]
            try:
                out.append(chr(int(hex2, 16)))
                i += 3
                continue
            except ValueError:
                pass  # invalid escape passed through verbatim (gff.rs:946)
        out.append(c)
        i += 1
    return "".join(out)


class Phase:
    """CDS phase: '.', 0, 1 or 2 (gff.rs:273)."""

    def __init__(self, value: Optional[int] = None) -> None:
        assert value is None or value in (0, 1, 2)
        self.value = value

    @classmethod
    def parse(cls, s: str) -> "Phase":
        if s in (".", ""):
            return cls(None)
        return cls(int(s))

    def __str__(self) -> str:
        return "." if self.value is None else str(self.value)

    def __eq__(self, other) -> bool:
        return isinstance(other, Phase) and self.value == other.value


@dataclass
class Record:
    """A GFF record (gff.rs:548)."""

    seqname: str = ""
    source: str = ""
    feature_type: str = ""
    start: int = 0
    end: int = 0
    score: Optional[int] = None
    strand: Optional[str] = None  # '+', '-', or None
    phase: Phase = field(default_factory=Phase)
    attributes: Dict[str, List[str]] = field(default_factory=dict)

    def attribute(self, key: str) -> Optional[str]:
        vals = self.attributes.get(key)
        return vals[0] if vals else None

    def push_attribute(self, key: str, value: str) -> None:
        self.attributes.setdefault(key, []).append(value)


def _parse_attributes(s: str, fmt: GffType) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    if not s or s == ".":
        return out
    for part in s.split(";"):
        part = part.strip()
        if not part:
            continue
        if fmt is GffType.GFF3:
            if "=" in part:
                k, v = part.split("=", 1)
                for vv in v.split(","):
                    out.setdefault(gff3_decode(k), []).append(gff3_decode(vv))
            else:
                out.setdefault(gff3_decode(part), []).append("")
        else:
            # GFF2/GTF2: key "value" (quotes optional for numerics)
            if " " in part:
                k, v = part.split(" ", 1)
                v = v.strip()
                if v.startswith('"') and v.endswith('"') and len(v) >= 2:
                    v = v[1:-1]
                out.setdefault(k, []).append(v)
            else:
                out.setdefault(part, []).append("")
    return out


def _format_attributes(attrs: Dict[str, List[str]], fmt: GffType) -> str:
    parts = []
    for k, vals in attrs.items():
        if fmt is GffType.GFF3:
            # multiple values of one key are comma-joined (GFF3 spec)
            joined = ",".join(gff3_encode(v) for v in vals)
            parts.append(f"{gff3_encode(k)}={joined}")
        else:
            for v in vals:
                parts.append(f'{k} "{v}"')
    return ";".join(parts)


class Reader:
    """GFF reader (gff.rs:215-300)."""

    def __init__(self, handle, fileformat: GffType = GffType.GFF3) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "r")
        self._h = handle
        self.fileformat = fileformat

    @classmethod
    def from_file(cls, path, fileformat: GffType = GffType.GFF3) -> "Reader":
        return cls(path, fileformat)

    @classmethod
    def new(cls, handle, fileformat: GffType = GffType.GFF3) -> "Reader":
        return cls(handle, fileformat)

    def records(self) -> Iterator[Record]:
        for line in self._h:
            line = line.rstrip("\r\n")
            if not line or line.startswith("#"):
                continue
            f = line.split("\t")
            if len(f) < 9:
                raise ValueError(f"GFF record with less than 9 fields: {line!r}")
            yield Record(
                seqname=f[0],
                source=f[1],
                feature_type=f[2],
                start=int(f[3]),
                end=int(f[4]),
                score=None if f[5] == "." else int(float(f[5])),
                strand=f[6] if f[6] in ("+", "-") else None,
                phase=Phase.parse(f[7]),
                attributes=_parse_attributes(f[8], self.fileformat),
            )

    def __iter__(self) -> Iterator[Record]:
        return self.records()


class Writer:
    """GFF writer (gff.rs:479-546)."""

    def __init__(self, handle, fileformat: GffType = GffType.GFF3) -> None:
        if isinstance(handle, (str, os.PathLike)):
            handle = open(handle, "w")
        self._h = handle
        self.fileformat = fileformat

    @classmethod
    def to_file(cls, path, fileformat: GffType = GffType.GFF3) -> "Writer":
        return cls(path, fileformat)

    @classmethod
    def new(cls, handle, fileformat: GffType = GffType.GFF3) -> "Writer":
        return cls(handle, fileformat)

    def write(self, record: Record) -> None:
        fields = [
            record.seqname,
            record.source,
            record.feature_type,
            str(record.start),
            str(record.end),
            "." if record.score is None else str(record.score),
            record.strand or ".",
            str(record.phase),
            _format_attributes(record.attributes, self.fileformat),
        ]
        self._h.write("\t".join(fields) + "\n")

    def flush(self) -> None:
        self._h.flush()
