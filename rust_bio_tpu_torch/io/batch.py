"""Padded/bucketed read batching for the device pipeline.

This is the layer the reference does not have: sequencing records are
grouped into length buckets, padded to the bucket's max length and packed
into (B, L) uint8 arrays plus length vectors — the shape the port's
kernels take. Bucketing by length keeps padding waste low and the number
of distinct batch shapes bounded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rust_bio_tpu_torch.utils.text import to_bytes


@dataclass
class SeqBatch:
    """A device-ready padded batch of sequences."""

    seqs: np.ndarray  # (B, L) uint8, zero-padded
    lens: np.ndarray  # (B,) int32
    ids: List[str]
    quals: Optional[np.ndarray] = None  # (B, L) uint8 if FASTQ

    def __len__(self) -> int:
        return self.seqs.shape[0]


def pad_batch(
    seqs: Sequence,
    ids: Optional[Sequence[str]] = None,
    quals: Optional[Sequence] = None,
    pad_to_multiple: int = 1,
) -> SeqBatch:
    """Pack sequences into one padded (B, L) array."""
    bs = [to_bytes(s) for s in seqs]
    B = len(bs)
    L = max((len(s) for s in bs), default=1) or 1
    if pad_to_multiple > 1:
        L = -(-L // pad_to_multiple) * pad_to_multiple
    arr = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(bs):
        arr[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lens[i] = len(s)
    qarr = None
    if quals is not None:
        qarr = np.zeros((B, L), dtype=np.uint8)
        for i, q in enumerate(quals):
            qb = to_bytes(q)
            qarr[i, : len(qb)] = np.frombuffer(qb, dtype=np.uint8)
    return SeqBatch(
        seqs=arr,
        lens=lens,
        ids=list(ids) if ids is not None else [str(i) for i in range(B)],
        quals=qarr,
    )


def bucketed_batches(
    records: Iterable,
    batch_size: int = 1024,
    bucket_bounds: Sequence[int] = (64, 128, 256, 512, 1024),
    pad_to_multiple: int = 8,
) -> Iterator[SeqBatch]:
    """Group records into length buckets; yield full padded batches.

    ``records`` yields objects with .id/.seq (and optionally .qual) — the
    fasta/fastq/fastx Record types — or raw byte strings.
    """
    buckets: List[List] = [[] for _ in range(len(bucket_bounds) + 1)]

    def bucket_of(n: int) -> int:
        for k, b in enumerate(bucket_bounds):
            if n <= b:
                return k
        return len(bucket_bounds)

    def flush(bucket: List) -> SeqBatch:
        seqs = [getattr(r, "seq", r) for r in bucket]
        ids = [getattr(r, "id", str(i)) for i, r in enumerate(bucket)]
        quals = None
        if bucket and getattr(bucket[0], "qual", None) is not None:
            quals = [r.qual for r in bucket]
        return pad_batch(seqs, ids, quals, pad_to_multiple)

    for rec in records:
        seq = getattr(rec, "seq", rec)
        k = bucket_of(len(seq))
        buckets[k].append(rec)
        if len(buckets[k]) >= batch_size:
            yield flush(buckets[k])
            buckets[k] = []
    for bucket in buckets:
        if bucket:
            yield flush(bucket)
