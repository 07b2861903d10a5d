"""Seed-and-extend read mapping: FM-index seeds, then batched semiglobal
extension (port of ``rust_bio_tpu.pipelines.read_mapper.ReadMapper``).

1. Index build, once per genome: suffix array, BWT and the bit-plane
   FM-index of ``genome + "$"``, all on the device (``DeviceFMIndex``).
2. Per read batch: exact seed lookup on both strands (``seed_tries``
   windows of ``seed_len`` spread over each oriented read, backward search
   on kernel K4), then the locate LF-walk of the first complete seed
   (kernel K4-locate).
3. Extension: the oriented read against the reference window around its
   seed hit (``flank`` bases either side), through the packed semiglobal
   path (kernels K5 and K6), giving scores and reference-exact CIGARs; a
   batch padded to M + 1 >= ``batched.T_COLUMNS`` (reads of 4,095 bases or
   more) goes through ``BatchAligner.semiglobal`` (K15 and K15-walk)
   instead, as the JAX mapper's fallback does.

Reads without an exact seed on either strand are reported with
``pos == -1``. Results equal the JAX mapper's read for read.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.alignment.pairwise import batched
from rust_bio_tpu_torch.alignment.pairwise.batched import BatchAligner
from rust_bio_tpu_torch.alignment.pairwise.scoring import Scoring
from rust_bio_tpu_torch.alignment.types import Alignment
from rust_bio_tpu_torch.alphabets import dna
from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
from rust_bio_tpu_torch.ops.fm import COMPLETE
from rust_bio_tpu_torch.utils.text import to_bytes


@dataclass
class MappedRead:
    read_id: str
    pos: int  # 0-based reference position of the aligned window start (-1 = unmapped)
    strand: str  # '+' or '-'
    score: int
    cigar: str
    # Alignment object, or a zero-arg callable that decodes it on first access
    _aln: Optional[object] = None

    @property
    def alignment(self) -> Optional[Alignment]:
        if callable(self._aln):
            self._aln = self._aln()
        return self._aln


def _long_reads(M: int) -> bool:
    """Whether an extension batch padded to M takes ``semiglobal`` (read at
    call time: tests move ``batched.T_COLUMNS``)."""
    return M + 1 >= batched.T_COLUMNS


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _read_seqs(reads) -> List[bytes]:
    return [bytes(r.seq) if hasattr(r, "seq") else to_bytes(r) for r in reads]


def _read_ids(reads) -> List[str]:
    return [getattr(r, "id", str(i)) for i, r in enumerate(reads)]


class ReadMapper:
    """FM-seeded read mapper. ``device=None`` means the CUDA device
    (``RuntimeError`` without one); ``device="cpu"`` runs the kernels'
    plain PyTorch versions."""

    # batches of at least twice this size are mapped in chunks of it
    # through ``map_stream``; results are order-identical
    _PIPE_CHUNK = 8192

    def __init__(
        self,
        genome,
        scoring: Optional[Scoring] = None,
        seed_len: int = 20,
        seed_tries: int = 3,
        flank: int = 8,
        sa_sampling_rate: int = 32,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.genome = to_bytes(genome)
        self._genome_np = np.frombuffer(self.genome, np.uint8)
        self.index = DeviceFMIndex.from_text(
            self.genome + b"$", dna.n_alphabet(), sa_sampling_rate, self.device
        )
        self.scoring = scoring or Scoring.from_scores(-5, -1, 2, -2)
        self.aligner = BatchAligner(self.scoring, device=self.device)
        self.seed_len = seed_len
        self.seed_tries = seed_tries
        self.flank = flank

    def _seed_search_dispatch(self, pats: np.ndarray, plens: np.ndarray):
        """Start the seed search of a (n, L) seed batch on the device;
        returns the (status, lower) tensors without waiting for them."""
        status, lower, _upper, _mlen = self.index.search_arrays(
            torch.from_numpy(np.ascontiguousarray(pats, np.uint8)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(plens, np.int32)).to(self.device),
        )
        return status, lower

    def _seed_search(self, pats: np.ndarray, plens: np.ndarray):
        """(status, lower) numpy arrays for a (n, L) seed batch."""
        status, lower = self._seed_search_dispatch(pats, plens)
        return status.cpu().numpy(), lower.cpu().numpy()

    def map_batch(self, reads: Sequence, ids: Optional[Sequence[str]] = None) -> List[MappedRead]:
        seqs = _read_seqs(reads)
        ids = list(ids) if ids is not None else _read_ids(reads)
        B = len(seqs)
        C = self._PIPE_CHUNK
        if B >= 2 * C:
            offs = range(0, B, C)
            out: List[MappedRead] = []
            for part in self.map_stream([seqs[o : o + C] for o in offs], [ids[o : o + C] for o in offs]):
                out.extend(part)
            return out
        rcs, pats, plens, starts, K, L, rb = self._prepare_seeds(seqs)
        status, lower = self._seed_search(pats.reshape(2 * B * K, L), plens.reshape(-1))
        return self._finish_batch(seqs, rcs, ids, status, lower, starts, B, K, rb)

    def _prepare_seeds(self, seqs):
        """Both-strand seed batch: K windows spread over each oriented read
        (forward lanes, then reverse-complement lanes), gathered by one
        fancy index. Returns (rcs, pats (2B, K, L), plens (2B, K) int32,
        starts (2B, K), K, L, (ob, olens)); ``ob``/``olens`` are the padded
        oriented reads, from which the extension builds its input."""
        B = len(seqs)
        L = self.seed_len
        K = self.seed_tries
        rcs = [dna.revcomp(s) for s in seqs]
        Lr = max(max((len(s) for s in seqs), default=1), L)
        ob = np.zeros((2 * B, Lr), np.uint8)
        olens = np.ones(2 * B, np.int64)
        for i, (s, rc) in enumerate(zip(seqs, rcs)):
            ob[i, : len(s)] = np.frombuffer(s, np.uint8)
            ob[B + i, : len(rc)] = np.frombuffer(rc, np.uint8)
            olens[i] = olens[B + i] = max(len(s), 1)
        span = np.maximum(olens - L, 0)
        starts = (span[:, None] * np.arange(K)[None, :]) // max(K - 1, 1)  # (2B, K)
        win_idx = np.minimum(starts[:, :, None] + np.arange(L)[None, None, :], Lr - 1)
        pats = ob[np.arange(2 * B)[:, None, None], win_idx]  # (2B, K, L)
        plens = np.minimum(np.broadcast_to(olens[:, None], (2 * B, K)), L).astype(np.int32)
        return rcs, pats, plens, starts, K, L, (ob, olens)

    def _finish_batch(self, seqs, rcs, ids, status, lower, starts, B, K, rb=None):
        """Pick each read's first complete seed (forward strand before
        reverse, earlier windows first), locate it, and extend around it."""
        status, lower = _host(status), _host(lower)
        comp = (status == COMPLETE).reshape(2, B, K)
        comp2 = np.moveaxis(comp, 1, 0).reshape(B, 2 * K)  # (B, [fwd K, rev K])
        has = comp2.any(axis=1)
        first = np.argmax(comp2, axis=1)
        sidx = (first >= K).astype(np.int64)  # strand index
        kidx = first % K
        bsel = np.arange(B)
        sel_lower = lower.reshape(2, B, K)[sidx, bsel, kidx]
        sel_off = starts.reshape(2, B, K)[sidx, bsel, kidx]
        hit = np.nonzero(has)[0]
        positions = self.index.locate_batch(sel_lower[hit])
        picks = {}
        for i, seed_pos in zip(hit.tolist(), positions.tolist()):
            off = int(sel_off[i])
            n = len(seqs[i])  # the oriented read has the read's length
            win_start = max(seed_pos - off - self.flank, 0)
            win_end = min(seed_pos - off + n + self.flank, len(self.genome))
            picks[i] = ("-" if sidx[i] else "+", win_start, win_end)
        return self._extend(seqs, rcs, ids, picks, rb)

    def map_stream(self, read_batches, ids_batches=None):
        """Map a stream of read batches: batch i+1's seed search is started
        on the device before batch i's locate, extension and assembly run.
        Yields one result list per batch, equal to ``map_batch``'s."""
        pending = None
        for bi, reads in enumerate(read_batches):
            seqs = _read_seqs(reads)
            ids = list(ids_batches[bi]) if ids_batches is not None else _read_ids(reads)
            B = len(seqs)
            rcs, pats, plens, starts, K, L, rb = self._prepare_seeds(seqs)
            status, lower = self._seed_search_dispatch(pats.reshape(2 * B * K, L), plens.reshape(-1))
            if pending is not None:
                yield self._finish_batch(*pending)
            pending = (seqs, rcs, ids, status, lower, starts, B, K, rb)
        if pending is not None:
            yield self._finish_batch(*pending)

    def _extend_dispatch(self, seqs, rcs, picks):
        """Start the extension of ``picks`` (read index -> (strand, window
        start, window end)) from the reads as byte strings. Returns
        ``(metas, handle, pairs)`` for ``_extend_finish``: the packed
        handle, or for a long batch the (xs, ys) that ``semiglobal``
        aligns there."""
        xs, ys, metas = [], [], []
        for i, (strand, win_start, win_end) in sorted(picks.items()):
            xs.append(seqs[i] if strand == "+" else rcs[i])
            ys.append(self.genome[win_start:win_end])
            metas.append((i, strand, win_start))
        if not xs:
            return metas, None, None
        if _long_reads(max(map(len, xs))):
            return metas, None, (xs, ys)
        return metas, self.aligner.semiglobal_packed_async(xs, ys), None

    def _extend_dispatch_packed(self, pb, plens, rc_pb, picks):
        """``_extend_dispatch`` from the padded read batch ``pb`` (B, L) and
        its reverse complements ``rc_pb``: the extension input is built by
        fancy indexing over the reads and the genome array."""
        items = sorted(picks.items())
        if not items:
            return [], None, None
        rows = np.array([i for i, _ in items], np.int64)
        neg = np.array([p[0] == "-" for _, p in items])
        ws = np.array([p[1] for _, p in items], np.int64)
        we = np.array([p[2] for _, p in items], np.int64)
        metas = [(int(i), "-" if s else "+", int(w)) for i, s, w in zip(rows, neg, ws)]
        xb = np.where(neg[:, None], rc_pb[rows], pb[rows])
        mlens = plens[rows].astype(np.int32)
        nlens = (we - ws).astype(np.int32)
        W = max(int(nlens.max()), 1)
        g = self._genome_np
        win = g[np.minimum(ws[:, None] + np.arange(W)[None, :], len(g) - 1)]
        yb = np.where(np.arange(W)[None, :] < nlens[:, None], win, 0).astype(np.uint8)
        if _long_reads(xb.shape[1]):
            xs = [bytes(xb[r, : mlens[r]]) for r in range(len(rows))]
            ys = [bytes(yb[r, : nlens[r]]) for r in range(len(rows))]
            return metas, None, (xs, ys)
        return metas, self.aligner.semiglobal_packed_async_arrays(xb, yb, mlens, nlens), None

    def _extend_finish(self, out, ids, metas, handle, pairs) -> None:
        """Pull the packed extension, or align the long batch's ``pairs``
        with ``semiglobal``, and put the ``MappedRead``s into ``out`` at the
        read indices of ``metas``."""
        if pairs is not None:
            for (i, strand, win_start), aln in zip(metas, self.aligner.semiglobal(*pairs)):
                out[i] = MappedRead(
                    read_id=ids[i], pos=win_start + aln.ystart, strand=strand,
                    score=aln.score, cigar=aln.cigar(), _aln=aln,
                )
            return
        if handle is None:
            return
        packed = self.aligner.semiglobal_packed_finish(handle)
        cigars = packed.cigars()
        for r, (i, strand, win_start) in enumerate(metas):
            out[i] = MappedRead(
                read_id=ids[i],
                pos=win_start + int(packed.ystart[r]),
                strand=strand,
                score=int(packed.score[r]),
                cigar=cigars[r],
                _aln=(lambda p=packed, rr=r: p.alignment(rr)),
            )

    def _rc_pb(self, pb, plens):
        """Reverse complement of each row of a left-aligned padded read
        batch (B, L) with lengths ``plens``."""
        rev = dna.COMPLEMENT[pb][:, ::-1]
        rc = np.zeros_like(pb)
        L = pb.shape[1]
        for n in np.unique(plens):  # reads are near-uniform length
            if n <= 0:
                continue
            m = plens == n
            rc[m, :n] = rev[m][:, L - n :]
        return rc

    def _extend(self, seqs, rcs, ids, picks, rb=None) -> List[MappedRead]:
        """Batched semiglobal extension and result assembly. ``rb``: the
        ``(ob, olens)`` of ``_prepare_seeds``, whose rows B.. are the
        reverse complements."""
        B = len(seqs)
        out = [MappedRead(ids[i], -1, "+", 0, "", None) for i in range(B)]
        if rb is not None:
            ob, olens = rb
            ext = self._extend_dispatch_packed(ob[:B], olens[:B].astype(np.int32), ob[B:], picks)
        else:
            ext = self._extend_dispatch(seqs, rcs, picks)
        self._extend_finish(out, ids, *ext)
        return out

    def to(self, device) -> "ReadMapper":
        """A mapper of the same genome and settings whose index and aligner
        live on ``device`` (the index tables are copied, not rebuilt)."""
        twin = copy.copy(self)
        twin.device = resolve_device(device)
        twin.index = self.index.to(twin.device)
        twin.aligner = BatchAligner(self.scoring, device=twin.device)
        return twin
