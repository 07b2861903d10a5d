"""Checkpointed streaming read mapping (failure recovery).

The reference is a library with no runtime; production serving needs a
restartable stream. Design:

- the FASTQ stream is consumed in fixed-size batches; each batch maps on
  device and writes ONE output shard file (``<out>.shard-NNNNNN.tsv``),
  written to a temp path then atomically renamed — a shard either fully
  exists or not at all (idempotent merge);
- a JSON checkpoint records the batch cursor + an input fingerprint; on
  restart, completed batches are skipped by re-reading (cheap host-side
  parsing) without touching the device;
- per-batch structured stats (reads/s, mapped fraction, device time) go to
  a host-side log callback.

``finalize()`` concatenates shards in order into ``<out>`` and removes
them. A crashed run resumes with ``StreamingMapper.run`` on the same
paths; a lost host re-running its bucket overwrites nothing.

The port's copy of ``rust_bio_tpu.pipelines.stream``: for the same reads
and mapper outputs its shards, checkpoint and final file are byte for byte
the JAX package's.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Iterator, List, Optional

from rust_bio_tpu_torch.io import fastq
from rust_bio_tpu_torch.pipelines.read_mapper import MappedRead, ReadMapper


def _fingerprint(path: str, n_bytes: int = 1 << 16) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read(n_bytes))
    h.update(str(os.path.getsize(path)).encode())
    return h.hexdigest()[:16]


def _batches(records: Iterator, size: int) -> Iterator[List]:
    batch = []
    for rec in records:
        batch.append(rec)
        if len(batch) == size:
            yield batch
            batch = []
    if batch:
        yield batch


class StreamingMapper:
    """Restartable batched mapping of a FASTQ stream to TSV shards."""

    def __init__(
        self,
        mapper: ReadMapper,
        batch_size: int = 4096,
        on_stats: Optional[Callable[[dict], None]] = None,
    ) -> None:
        self.mapper = mapper
        self.batch_size = batch_size
        self.on_stats = on_stats

    def _shard_path(self, out_path: str, idx: int) -> str:
        return f"{out_path}.shard-{idx:06d}.tsv"

    def run(self, fastq_path: str, out_path: str, checkpoint_path: str) -> int:
        """Map the stream; resume from the checkpoint if present.

        Returns the number of batches processed in THIS invocation.
        """
        fp = _fingerprint(fastq_path)
        done = -1
        if os.path.exists(checkpoint_path):
            with open(checkpoint_path) as f:
                ck = json.load(f)
            if ck.get("fingerprint") == fp:
                done = ck.get("last_batch", -1)
            # fingerprint mismatch -> different input, start over

        processed = 0
        with open(fastq_path, "rb") as fh:
            reader = fastq.Reader(fh)
            for idx, batch in enumerate(_batches(reader.records(), self.batch_size)):
                shard = self._shard_path(out_path, idx)
                if idx <= done and os.path.exists(shard):
                    continue  # completed before the crash/restart
                t0 = time.perf_counter()
                results = self.mapper.map_batch(
                    [r.seq.encode() if isinstance(r.seq, str) else r.seq
                     for r in batch],
                    ids=[r.id for r in batch],
                )
                dt = time.perf_counter() - t0
                tmp = shard + ".tmp"
                with open(tmp, "w") as out:
                    for m in results:
                        out.write(
                            f"{m.read_id}\t{m.pos}\t{m.strand}\t{m.score}\t"
                            f"{m.cigar}\n"
                        )
                os.replace(tmp, shard)  # atomic: shard exists iff complete
                with open(checkpoint_path + ".tmp", "w") as f:
                    json.dump(
                        {"fingerprint": fp, "last_batch": idx}, f
                    )
                os.replace(checkpoint_path + ".tmp", checkpoint_path)
                processed += 1
                if self.on_stats is not None:
                    mapped = sum(1 for m in results if m.pos >= 0)
                    self.on_stats(
                        {
                            "batch": idx,
                            "reads": len(batch),
                            "mapped": mapped,
                            "reads_per_s": len(batch) / max(dt, 1e-9),
                            "seconds": dt,
                        }
                    )
        return processed

    def finalize(self, out_path: str) -> str:
        """Concatenate shards in order into ``out_path`` and remove them."""
        idx = 0
        with open(out_path, "w") as out:
            while True:
                shard = self._shard_path(out_path, idx)
                if not os.path.exists(shard):
                    break
                with open(shard) as f:
                    out.write(f.read())
                os.remove(shard)
                idx += 1
        return out_path
