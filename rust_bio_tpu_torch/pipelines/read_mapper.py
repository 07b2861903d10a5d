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

``SmemReadMapper`` seeds by super-maximal exact matches over the FMD index
of ``genome + "$" + revcomp(genome) + "$"`` instead (kernel K-SMEM with
its seed pick, then K4-locate) and extends as ``ReadMapper`` does.
"""

from __future__ import annotations

import copy
import hashlib
import os
import sys
import time
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
from rust_bio_tpu_torch.data_structures.bwt import Occ, less
from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
from rust_bio_tpu_torch.data_structures.fmd_device import DeviceFMDIndex, pad_batch
from rust_bio_tpu_torch.data_structures.fmindex import FMDIndex, FMIndex
from rust_bio_tpu_torch.data_structures.serialize import load_fm_index, read_meta, save_fm_index
from rust_bio_tpu_torch.data_structures.suffix_array import suffix_array_host
from rust_bio_tpu_torch.ops import fmd
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


class SmemReadMapper(ReadMapper):
    """Read mapper seeded by SMEMs over an FMD index (bwa-mem style; port of
    ``rust_bio_tpu.pipelines.read_mapper.SmemReadMapper``).

    The genome is indexed as ``T$revcomp(T)$``, a two-sentinel text, so one
    index covers both strands; super-maximal exact matches tolerate errors
    anywhere in the read, where ``ReadMapper``'s fixed windows fail once
    every window holds an error. Per batch, one device chain with one pull:
    K-SMEM at each read's middle in mapper mode with the pick of the
    longest match in its epilog (``ops.fmd.seed_pick``), then K4-locate of
    the picked row. Reads without a long enough match retry at 1/4 and 1/8
    of their length in one launch; reads that overflow the ``_E0`` slots
    retry at ``2 * _E0``, and those that overflow again take the host oracle
    (``fmindex.FMDIndex``). Extension is ``ReadMapper``'s (K5, K6, the
    native CIGAR emitter). Results equal the JAX mapper's read for read.

    ``index_cache``: an index file (``data_structures.serialize``) that is
    loaded where it exists (its header's genome hash must match; its own
    sampling rate is kept) and written after the build where it does not.
    ``seed_stats`` counts the seed launches and lanes of each path since it
    was last cleared."""

    def __init__(
        self,
        genome,
        scoring: Optional[Scoring] = None,
        min_seed_len: int = 19,
        flank: int = 8,
        sa_sampling_rate: int = 8,
        index_cache: Optional[str] = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.genome = to_bytes(genome)
        self._genome_np = np.frombuffer(self.genome, np.uint8)
        G = len(self.genome)
        genome_hash = hashlib.sha256(self.genome).hexdigest()[:16]
        self.build_s = {}
        if index_cache is not None and os.path.exists(index_cache):
            # the header's genome hash (caches without one: the length
            # alone) is checked before any array is read
            t0 = time.perf_counter()
            meta = read_meta(index_cache)
            if int(meta["n"]) != 2 * G + 2:
                raise ValueError(f"cached index of {meta['n']} symbols: this genome's FMD text has {2 * G + 2}")
            got = meta.get("genome_sha256")
            if got is not None and got != genome_hash:
                raise ValueError(
                    f"cached index was built from another genome (hash {got} != {genome_hash}): refusing to map against it"
                )
            self.index = load_fm_index(index_cache, self.device, verify=False)
            if self.index.s != sa_sampling_rate:
                print(
                    f"SmemReadMapper: cached index uses sa_sampling_rate={self.index.s} "
                    f"(requested {sa_sampling_rate}); using the cached value",
                    file=sys.stderr,
                )
            self._bwt = self.index.bwt_host()
            self.build_s["load_s"] = time.perf_counter() - t0
        else:
            text = np.frombuffer(self.genome + b"$" + dna.revcomp(self.genome) + b"$", np.uint8)
            alpha = dna.n_alphabet()
            alpha.insert(ord("$"))
            t0 = time.perf_counter()
            sa = suffix_array_host(text)  # the native SA-IS
            self._bwt = text[sa - 1]  # sa == 0 reads the last symbol
            t1 = time.perf_counter()
            self.index = DeviceFMIndex(self._bwt, alpha, sa=sa, sampling_rate=sa_sampling_rate, device=self.device)
            del sa
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.build_s.update(sais_s=t1 - t0, tables_s=time.perf_counter() - t1)
            if index_cache is not None:
                save_fm_index(index_cache, self.index, compress=False, extra_meta={"genome_sha256": genome_hash})
        self.fmd = DeviceFMDIndex(self.index)
        self._host_fmd = None  # the overflow lanes' oracle, built at first need
        self.G = G
        self.scoring = scoring or Scoring.from_scores(-5, -1, 2, -2)
        self.aligner = BatchAligner(self.scoring, device=self.device)
        self.min_seed_len = min_seed_len
        self.flank = flank
        # the seed chain's slot budget; overflow lanes retry at 2 * _E0
        # before the host oracle (tests shrink it to reach those paths)
        self._E0 = 16
        self.seed_stats = dict.fromkeys(
            ("main_launches", "quarter_launches", "wide_launches", "quarter_lanes", "wide_lanes", "oracle_lanes"), 0
        )

    def to(self, device) -> "SmemReadMapper":
        """A mapper of the same genome and settings on ``device`` (the index
        tables copied, not rebuilt)."""
        twin = copy.copy(self)
        twin.device = resolve_device(device)
        twin.index = self.index.to(twin.device)
        twin.fmd = DeviceFMDIndex(twin.index)
        twin.aligner = BatchAligner(self.scoring, device=twin.device)
        twin.seed_stats = dict.fromkeys(self.seed_stats, 0)
        return twin

    @property
    def host_fmd(self) -> FMDIndex:
        if self._host_fmd is None:
            alpha = dna.n_alphabet()
            self._host_fmd = FMDIndex(FMIndex(self._bwt, less(self._bwt, alpha), Occ(self._bwt, 128, alpha)))
        return self._host_fmd

    def map_stream(self, read_batches, ids_batches=None):
        """Map a stream of read batches: batch i+1's seed chain is launched
        before batch i's retries, locates, extension and assembly run. Yields
        one result list per batch, equal to ``map_batch``'s."""
        pending = None
        for bi, reads in enumerate(read_batches):
            seqs = _read_seqs(reads)
            ids = list(ids_batches[bi]) if ids_batches is not None else _read_ids(reads)
            handle = self._smem_dispatch(seqs)
            if pending is not None:
                yield self._smem_finish(*pending)
            pending = (seqs, ids, handle)
        if pending is not None:
            yield self._smem_finish(*pending)

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
        return self._smem_finish(seqs, ids, self._smem_dispatch(seqs))

    def _seed_kernel(self, pb, plens, iis, E: int = 16) -> torch.Tensor:
        """The seed chain on (B, L) uint8 reads, (B,) int32 lengths and
        positions on the device: K-SMEM with the pick, then K4-locate of the
        picked rows (row 0 for reads without a pick, as the JAX chain).
        Returns the (5, B) int32 tensor (position, start, length, found,
        ovf), whose transpose is the JAX chain's packed (B, 5)."""
        B = pb.shape[0]
        packed = torch.empty((5, B), dtype=torch.int32, device=pb.device)
        rows = fmd.seed_pick(self.fmd.tables, pb, plens, iis, self.min_seed_len, E, packed[1:])
        if B:
            self.index._locate(rows, out=packed[0])
        return packed

    def _seed_arrays(self, pb, plens, iis, E: int) -> torch.Tensor:
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        return self._seed_kernel(up(pb), up(plens.astype(np.int32)), up(iis.astype(np.int32)), E)

    def _smem_dispatch(self, seqs):
        """Launch the seed chain at the read middles without waiting for it.
        Returns ``(device packed, pb, plens)``: the padded reads ride along
        for the extension's input."""
        pb, plens, _ = pad_batch(seqs)
        iis = np.maximum(plens // 2 - 1, 0).astype(np.int32)
        self.seed_stats["main_launches"] += 1
        return self._seed_arrays(pb, plens, iis, self._E0), pb, plens

    def _pick_of_lane(self, lane):
        best = None
        for itv, q0, mlen in lane:
            if best is None or mlen > best[2]:
                best = (itv, q0, mlen)
        return best

    def _oracle_pick(self, seq: bytes, i: int):
        self.seed_stats["oracle_lanes"] += 1
        return self._pick_of_lane(self.host_fmd.smems(seq, i, self.min_seed_len))

    def _smem_finish(self, seqs, ids, handle) -> List[MappedRead]:
        """Pull the seed chain (one copy), run the retries, the host-oracle
        lanes and the locates they need, extend, and assemble."""
        B = len(seqs)
        seeds, pb, plens = handle
        pos_a, q0_a, ml_a, found_a, ovf_a = seeds.cpu().numpy()
        rc_pb = self._rc_pb(pb, plens)

        # reads without a long enough middle SMEM: both quarter positions
        # in one launch of a power-of-two bucket, pulled after the oracle
        # loop below (an earlier fraction's find wins)
        pending = [i for i in range(B) if seqs[i] and not found_a[i] and not ovf_a[i]]
        retry_handle = None
        fracs = (4, 8)
        if pending:
            nrow = len(pending) * len(fracs)
            cap = max(32, 1 << (nrow - 1).bit_length())
            Lr = max(max(len(seqs[i]) for i in pending), 1)
            rb = np.zeros((cap, Lr), np.uint8)
            rlens = np.ones(cap, np.int32)
            riis = np.zeros(cap, np.int32)
            for r, i in enumerate(pending):
                s = seqs[i]
                enc = np.frombuffer(s, np.uint8)
                for fi, frac in enumerate(fracs):
                    row = fi * len(pending) + r
                    rb[row, : len(s)] = enc
                    rlens[row] = len(s)
                    riis[row] = max(0, len(s) // frac - 1)
            retry_handle = self._seed_arrays(rb, rlens, riis, self._E0)
            self.seed_stats["quarter_launches"] += 1
            self.seed_stats["quarter_lanes"] += nrow

        # overflow lanes: the middle again at twice the slot budget, before
        # any host-oracle work
        ovf_lanes = [i for i in range(B) if seqs[i] and ovf_a[i]]
        ovf_handle = None
        if ovf_lanes:
            cap = max(32, 1 << (len(ovf_lanes) - 1).bit_length())
            Lo = max(len(seqs[i]) for i in ovf_lanes)
            ob = np.zeros((cap, Lo), np.uint8)
            olens = np.ones(cap, np.int32)
            oiis = np.zeros(cap, np.int32)
            for r, i in enumerate(ovf_lanes):
                s = seqs[i]
                ob[r, : len(s)] = np.frombuffer(s, np.uint8)
                olens[r] = len(s)
                oiis[r] = max(0, len(s) // 2 - 1)
            ovf_handle = self._seed_arrays(ob, olens, oiis, 2 * self._E0)
            self.seed_stats["wide_launches"] += 1
            self.seed_stats["wide_lanes"] += len(ovf_lanes)

        # the found reads' extension does not wait for the retries
        main_picks = {}
        for i in np.nonzero(found_a)[0].tolist():
            if seqs[i]:
                main_picks[i] = self._pick_window(len(seqs[i]), int(pos_a[i]), int(q0_a[i]), int(ml_a[i]))
        main_ext = self._extend_dispatch_packed(pb, plens, rc_pb, main_picks)

        # the wide retry; lanes that overflow it take the host oracle
        best_host = {}
        retry_packed = {}
        if ovf_handle is not None:
            sub = ovf_handle.cpu().numpy().T
            for r, i in enumerate(ovf_lanes):
                if sub[r, 4]:
                    best = self._oracle_pick(seqs[i], max(0, len(seqs[i]) // 2 - 1))
                    if best is not None:
                        best_host[i] = best
                elif sub[r, 3]:
                    retry_packed[i] = sub[r]

        # the host-oracle picks' locate, launched before the quarter retry's
        # pull; oracle lanes of that retry get a second, late locate
        early_host = sorted(best_host)
        loc_handle, loc_nb = (None, 0)
        if early_host:
            loc_handle, loc_nb = self.index.locate_batch_async(
                np.asarray([best_host[i][0].lower for i in early_host], np.int32)
            )

        if retry_handle is not None:
            sub = retry_handle.cpu().numpy().T
            for r, i in enumerate(pending):
                for fi in range(len(fracs)):
                    row = fi * len(pending) + r
                    if sub[row, 4]:
                        best = self._oracle_pick(seqs[i], int(riis[row]))
                        if best is not None:
                            best_host[i] = best
                        break
                    if sub[row, 3]:
                        retry_packed[i] = sub[row]
                        break

        if loc_handle is not None:
            poss = loc_handle.cpu().numpy()[:loc_nb]
            for i, p in zip(early_host, poss.tolist()):
                _, q0, mlen = best_host[i]
                retry_packed[i] = np.array([p, q0, mlen, 1, 0], np.int32)
        early = set(early_host)
        late_host = [i for i in sorted(best_host) if i not in early]
        if late_host:
            poss = self.index.locate_batch(np.asarray([best_host[i][0].lower for i in late_host], np.int32))
            for i, p in zip(late_host, poss.tolist()):
                _, q0, mlen = best_host[i]
                retry_packed[i] = np.array([p, q0, mlen, 1, 0], np.int32)

        retry_picks = {}
        for i, rp in retry_packed.items():
            if seqs[i] and not found_a[i]:
                p, q0, mlen = (int(x) for x in rp[:3])
                retry_picks[i] = self._pick_window(len(seqs[i]), p, q0, mlen)
        retry_ext = self._extend_dispatch_packed(pb, plens, rc_pb, retry_picks) if retry_picks else None

        out: List[MappedRead] = [MappedRead(ids[i], -1, "+", 0, "", None) for i in range(B)]
        self._extend_finish(out, ids, *main_ext)
        if retry_ext is not None:
            self._extend_finish(out, ids, *retry_ext)
        return out

    def _pick_window(self, n, p, q0, mlen):
        """(strand, window start, window end) of a located seed. A hit at
        text position p >= G + 1 lies in revcomp(T): the read maps to the
        '-' strand, its seed at offset n - q0 - mlen of the oriented read."""
        G = self.G
        if p < G:
            strand, off, gpos = "+", q0, p
        else:
            strand, off, gpos = "-", n - q0 - mlen, G - (p - (G + 1)) - mlen
        return strand, max(gpos - off - self.flank, 0), min(gpos - off + n + self.flank, G)
