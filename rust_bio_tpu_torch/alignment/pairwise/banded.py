"""Banded Smith-Waterman aligner seeded by sparse k-mer chaining.

Reference parity: src/alignment/pairwise/banded.rs — kmer matches → sdpkpp
backbone → per-column band ``Range`` of width w → banded DP with the exact
recurrences/tie-breaks of the full aligner; falls back to the full matrix
when no kmer matches; returns an empty MIN_SCORE alignment when the band
exceeds ``MAX_CELLS`` (:104, 406-420). Band rasterization replicates
``add_kmer``/``add_entry``/``add_gap``/``set_boundaries``
(:1071-1276) including the lazy diagonal extension, and the traceback
replicates the out-of-band ending fixups (:833-856).

Own copy of ``rust_bio_tpu.alignment.pairwise.banded``. The banded DP here
is the exact host oracle; batched device execution lives in
``banded_device.BatchBandedAligner`` (kernel K16, ``ops.sw.scan_banded``,
and its walk K16-walk, ``ops.walk.walk_banded``), held to this oracle by
tests/test_torch_banded.py. ``Band.create`` builds the band with the
port's native builder (``rust_bio_tpu_torch.native``); the Python builders
(``create_with_matches``, ``create_from_match_path``) are its oracle.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from rust_bio_tpu_torch.alignment import sparse
from rust_bio_tpu_torch.alignment.pairwise.tb import (
    TB_DEL,
    TB_INS,
    TB_MATCH,
    TB_START,
    TB_SUBST,
    TB_XCLIP_PREFIX,
    TB_XCLIP_SUFFIX,
    TB_YCLIP_PREFIX,
    TB_YCLIP_SUFFIX,
)
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE, Scoring
from rust_bio_tpu_torch.alignment.types import (
    Alignment,
    AlignmentMode,
    Del,
    Ins,
    Match,
    Subst,
    Xclip,
    Yclip,
)
from rust_bio_tpu_torch.utils.text import to_bytes

MAX_CELLS = 5_000_000
DEFAULT_MATCH_SCORE = 2


class Band:
    """Per-column row ranges [start, end) (banded.rs:1046)."""

    def __init__(self, m: int, n: int) -> None:
        self.rows = m + 1
        self.cols = n + 1
        self.starts = np.full(n + 1, m + 1, dtype=np.int64)
        self.ends = np.zeros(n + 1, dtype=np.int64)

    def full_matrix(self) -> None:
        self.starts[:] = 0
        self.ends[:] = self.rows

    def num_cells(self) -> int:
        return int(np.maximum(self.ends - self.starts, 0).sum())

    def add_kmer(self, start: Tuple[int, int], k: int, w: int) -> None:
        r, c = start
        if k == 0:
            return
        i = max(r - w, 0)
        for j in range(max(c - w, 0), min(c + w + 1, self.cols)):
            self.starts[j] = min(self.starts[j], i)
        i = max(r - w, 0)
        for j in range(min(c + w, self.cols), min(c + k + w, self.cols)):
            self.starts[j] = min(self.starts[j], i)
            i += 1
        i = r + w + k
        j = max(c + k - 1 - w, 0)
        while j > max(c - w, 0):
            j -= 1
            i -= 1
            self.ends[j] = max(self.ends[j], min(i, self.rows))
        i = min(r + w + k, self.rows)
        for j in range(max(c + k - 1 - w, 0), min(c + k + w, self.cols)):
            self.ends[j] = max(self.ends[j], i)

    def add_entry(self, pos: Tuple[int, int], w: int) -> None:
        r, c = pos
        istart = max(r - w, 0)
        iend = min(r + w + 1, self.rows)
        lo = max(c - w, 0)
        hi = min(c + w + 1, self.cols)
        np.minimum(self.starts[lo:hi], istart, out=self.starts[lo:hi])
        np.maximum(self.ends[lo:hi], iend, out=self.ends[lo:hi])

    def add_entries(self, rs: np.ndarray, cs: np.ndarray, w: int) -> None:
        """Batched ``add_entry`` over arrays of positions: per-column
        extreme then a sliding-window min/max of radius w (log-step
        doubling).  Pure min/max rasterization, so order-independent —
        byte-identical bands to the sequential calls."""
        if len(rs) == 0:
            return
        # entries with c outside [-w, cols-1+w] touch no column; the rest
        # go into a w-padded accumulator so out-of-range windows keep the
        # sequential semantics (clipping c would SHIFT its window)
        sel = (cs >= -w) & (cs <= self.cols - 1 + w)
        if not sel.all():
            rs, cs = rs[sel], cs[sel]
        if len(rs) == 0:
            return
        P = self.cols + 2 * w
        INF = np.iinfo(np.int64).max
        lo = np.full(P, INF, np.int64)
        hi = np.full(P, -INF - 1 + 1, np.int64)
        hi[:] = np.iinfo(np.int64).min
        np.minimum.at(lo, cs + w, np.maximum(rs - w, 0))
        np.maximum.at(hi, cs + w, np.minimum(rs + w + 1, self.rows))

        # sliding extreme over [j-w, j+w] via the two-block trick: combine
        # the (w+1)-wide block ending at j with the one ending at j+w
        W = w + 1

        def sliding(a, combine, fill):
            p = a.copy()
            k = 1
            while k < W:
                step = min(k, W - k)
                shifted = np.concatenate(
                    [np.full(step, fill, a.dtype), p[:-step]]
                )
                p = combine(p, shifted)
                k += step
            # p[j] = extreme of a[j-w .. j]
            endj = np.concatenate(
                [p[w:], np.full(min(w, len(a)), fill, a.dtype)]
            )[: len(a)]
            return combine(p, endj)

        slo = sliding(lo, np.minimum, np.iinfo(np.int64).max)[
            w : w + self.cols
        ]
        shi = sliding(hi, np.maximum, np.iinfo(np.int64).min)[
            w : w + self.cols
        ]
        np.minimum(self.starts, slo, out=self.starts)
        np.maximum(self.ends, shi, out=self.ends)

    def add_gap(self, start: Tuple[int, int], end: Tuple[int, int], w: int) -> None:
        nrows = end[0] - start[0]
        ncols = end[1] - start[1]
        if nrows > ncols:
            rs = np.arange(start[0], end[0], dtype=np.int64)
            cs = start[1] + (end[1] - start[1]) * (rs - start[0]) // (end[0] - start[0])
        else:
            cs = np.arange(start[1], end[1], dtype=np.int64)
            rs = start[0] + (end[0] - start[0]) * (cs - start[1]) // (end[1] - start[1])
        self.add_entries(rs, cs, w)

    def set_boundaries(
        self, start: Tuple[int, int], end: Tuple[int, int], k: int, w: int,
        scoring: Scoring,
    ) -> None:
        lazy_extend = 2 * k

        # -------------- START --------------
        r, c = start
        if not (r == 0 and c == 0):
            score_to_start = (scoring.xclip_prefix if r > 0 else 0) + (
                scoring.yclip_prefix if c > 0 else 0
            )
            if score_to_start == 0:
                d = min(lazy_extend, r, c)
                self.add_kmer((r - d, c - d), d, w)
                self.add_gap(
                    (max(r - lazy_extend, 0), max(c - lazy_extend, 0)),
                    (r - d, c - d),
                    w,
                )
            else:
                if r > c:
                    diagonal_score = scoring.xclip_prefix
                elif r < c:
                    diagonal_score = scoring.yclip_prefix
                else:
                    diagonal_score = 0
                if diagonal_score == 0:
                    d = min(r, c)
                    self.add_kmer((r - d, c - d), d, w)
                    s = (max(r - lazy_extend, 0), max(c - lazy_extend, 0))
                    e = (r - d, c - d)
                    if s[0] <= e[0] and s[1] <= e[1]:
                        self.add_gap(s, e, w)
                else:
                    self.add_gap((0, 0), start, w)

        # -------------- END --------------
        r, c = end[0] + k, end[1] + k
        if not (r == self.rows and c == self.cols):
            score_from_end = (0 if r == self.rows else scoring.xclip_suffix) + (
                0 if c == self.cols else scoring.yclip_suffix
            )
            if score_from_end == 0:
                d = min(lazy_extend, self.rows - r, self.cols - c)
                self.add_kmer((r, c), d, w)
                r1 = min(self.rows, r + d) - 1
                c1 = min(self.cols, c + d) - 1
                r2 = min(self.rows, r + lazy_extend)
                c2 = min(self.cols, c + lazy_extend)
                if r1 <= r2 and c1 <= c2:
                    self.add_gap((r1, c1), (r2, c2), w)
            else:
                dr = self.rows - r
                dc = self.cols - c
                if dr > dc:
                    diagonal_score = scoring.xclip_suffix
                elif dr < dc:
                    diagonal_score = scoring.yclip_suffix
                else:
                    diagonal_score = 0
                if diagonal_score == 0:
                    d = min(dr, dc)
                    self.add_kmer((r, c), d, w)
                    r1 = min(self.rows, r + d) - 1
                    c1 = min(self.cols, c + d) - 1
                    r2 = min(self.rows, r + lazy_extend)
                    c2 = min(self.cols, c + lazy_extend)
                    if r1 <= r2 and c1 <= c2:
                        self.add_gap((r1, c1), (r2, c2), w)
                else:
                    self.add_gap((r, c), (self.rows, self.cols), w)

    # ---- constructors (banded.rs:1278-1330) ----

    @classmethod
    def create(cls, x: bytes, y: bytes, k: int, w: int, scoring: Scoring) -> "Band":
        return cls.create_native(x, y, k, w, scoring)

    @classmethod
    def create_native(
        cls, x: bytes, y: bytes, k: int, w: int, scoring: Scoring
    ) -> "Band":
        """Native band build (kmer match -> sdpkpp -> raster, all in the
        port's ``csrc/band_build.cpp``; byte-identical bands to the Python
        path, its oracle). Raises when the library cannot be built."""
        from rust_bio_tpu_torch import native as _native

        x, y = to_bytes(x), to_bytes(y)
        mx = _native.kmer_matches(x, y, k)
        band = cls(len(x), len(y))
        if len(mx) == 0:
            band.full_matrix()
            return band
        match_score = (
            scoring.match_scores[0]
            if scoring.match_scores
            else DEFAULT_MATCH_SCORE
        )
        _dp_score, dp_prev, _best_score, best_idx = _native.sdpkpp_native(
            mx[:, 0], mx[:, 1], k, match_score,
            -scoring.gap_open, -scoring.gap_extend,
        )
        path: List[int] = []
        prev = best_idx
        while prev >= 0:
            path.append(prev)
            prev = int(dp_prev[prev])
        path.reverse()
        starts, ends = _native.band_raster(
            mx[np.asarray(path, np.int64)], len(x), len(y), k, w,
            (
                scoring.xclip_prefix, scoring.xclip_suffix,
                scoring.yclip_prefix, scoring.yclip_suffix,
            ),
        )
        band.starts = starts.astype(np.int64)
        band.ends = ends.astype(np.int64)
        return band

    @classmethod
    def create_with_prehash(
        cls, x: bytes, y: bytes, k: int, w: int, scoring: Scoring, y_kmer_hash
    ) -> "Band":
        matches = sparse.find_kmer_matches_seq2_hashed(x, y_kmer_hash, k)
        return cls.create_with_matches(x, y, k, w, scoring, matches)

    @classmethod
    def create_with_matches(
        cls, x: bytes, y: bytes, k: int, w: int, scoring: Scoring, matches
    ) -> "Band":
        if not matches:
            band = cls(len(x), len(y))
            band.full_matrix()
            return band
        match_score = (
            scoring.match_scores[0]
            if scoring.match_scores
            else DEFAULT_MATCH_SCORE
        )
        res = sparse.sdpkpp(
            matches, k, match_score, scoring.gap_open, scoring.gap_extend
        )
        return cls.create_from_match_path(x, y, k, w, scoring, res.path, matches)

    @classmethod
    def create_from_match_path(
        cls, x: bytes, y: bytes, k: int, w: int, scoring: Scoring,
        path: Sequence[int], matches,
    ) -> "Band":
        band = cls(len(x), len(y))
        if not matches:
            band.full_matrix()
            return band
        ps, pe = path[0], path[-1]
        band.set_boundaries(matches[ps], matches[pe], k, w, scoring)
        prev: Optional[Tuple[int, int]] = None
        diag_rs: List[int] = []
        diag_cs: List[int] = []
        for idx in path:
            curr = matches[idx]
            if prev is not None and curr == (prev[0] + 1, prev[1] + 1):
                diag_rs.append(prev[0] + k)
                diag_cs.append(prev[1] + k)
            else:
                if prev is not None:
                    band.add_gap((prev[0] + k - 1, prev[1] + k - 1), curr, w)
                band.add_kmer(curr, k, w)
            prev = curr
        band.add_entries(
            np.asarray(diag_rs, np.int64), np.asarray(diag_cs, np.int64), w
        )
        return band


DEFAULT_ALIGNER_CAPACITY = 200


class Aligner:
    """Banded aligner with the reference's full API surface. Where the
    reference's traceback never ends (an empty y whose column 0 ends in a
    clip, ROADMAP Queue 3) it raises ``ValueError``."""

    def __init__(self, scoring: Scoring, k: int, w: int) -> None:
        self.scoring = scoring
        self.k = k
        self.w = w
        self.band: Optional[Band] = None

    @classmethod
    def new(cls, gap_open: int, gap_extend: int, match_fn, k: int, w: int) -> "Aligner":
        return cls(Scoring.new(gap_open, gap_extend, match_fn), k, w)

    @classmethod
    def with_scoring(cls, scoring: Scoring, k: int, w: int) -> "Aligner":
        return cls(scoring, k, w)

    # ---- custom-mode entry points (banded.rs:282-404) ----

    def custom(self, x, y) -> Alignment:
        x, y = to_bytes(x), to_bytes(y)
        self.band = Band.create(x, y, self.k, self.w, self.scoring)
        return self.compute_alignment(x, y)

    def custom_with_prehash(self, x, y, y_kmer_hash) -> Alignment:
        x, y = to_bytes(x), to_bytes(y)
        self.band = Band.create_with_prehash(
            x, y, self.k, self.w, self.scoring, y_kmer_hash
        )
        return self.compute_alignment(x, y)

    def custom_with_matches(self, x, y, matches) -> Alignment:
        x, y = to_bytes(x), to_bytes(y)
        self.band = Band.create_with_matches(
            x, y, self.k, self.w, self.scoring, matches
        )
        return self.compute_alignment(x, y)

    def custom_with_expanded_matches(
        self, x, y, matches, allowed_mismatches: Optional[int],
        use_lcskpp_union: bool,
    ) -> Alignment:
        x, y = to_bytes(x), to_bytes(y)
        if allowed_mismatches is not None:
            matches = sparse.expand_kmer_matches(
                x, y, self.k, matches, allowed_mismatches
            )
        if use_lcskpp_union:
            match_score = (
                self.scoring.match_scores[0]
                if self.scoring.match_scores
                else DEFAULT_MATCH_SCORE
            )
            path = sparse.sdpkpp_union_lcskpp_path(
                matches, self.k, match_score,
                self.scoring.gap_open, self.scoring.gap_extend,
            )
            self.band = Band.create_from_match_path(
                x, y, self.k, self.w, self.scoring, path, matches
            )
        else:
            self.band = Band.create_with_matches(
                x, y, self.k, self.w, self.scoring, matches
            )
        return self.compute_alignment(x, y)

    def custom_with_match_path(self, x, y, matches, path) -> Alignment:
        x, y = to_bytes(x), to_bytes(y)
        self.band = Band.create_from_match_path(
            x, y, self.k, self.w, self.scoring, path, matches
        )
        return self.compute_alignment(x, y)

    # ---- mode wrappers (identical clip presets to the full aligner) ----

    def _with_clips(self, x, y, clips, mode, filter_clips, runner="custom", **kw):
        s = self.scoring
        saved = (s.xclip_prefix, s.xclip_suffix, s.yclip_prefix, s.yclip_suffix)
        self.scoring = s.with_clips(*clips)
        try:
            aln = getattr(self, runner)(x, y, **kw)
        finally:
            self.scoring = self.scoring.with_clips(*saved)
        aln.mode = mode
        if filter_clips:
            aln.filter_clip_operations()
        return aln

    def global_(self, x, y) -> Alignment:
        return self._with_clips(
            x, y, (MIN_SCORE,) * 4, AlignmentMode.Global, False
        )

    def semiglobal(self, x, y) -> Alignment:
        return self._with_clips(
            x, y, (MIN_SCORE, MIN_SCORE, 0, 0), AlignmentMode.Semiglobal, True
        )

    def semiglobal_with_prehash(self, x, y, y_kmer_hash) -> Alignment:
        return self._with_clips(
            x, y, (MIN_SCORE, MIN_SCORE, 0, 0), AlignmentMode.Semiglobal, True,
            runner="custom_with_prehash", y_kmer_hash=y_kmer_hash,
        )

    def local(self, x, y) -> Alignment:
        return self._with_clips(x, y, (0, 0, 0, 0), AlignmentMode.Local, True)

    # ---- the banded DP (banded.rs:406-870) ----

    def compute_alignment(self, x: bytes, y: bytes) -> Alignment:
        band = self.band
        assert band is not None
        if band.num_cells() > MAX_CELLS:
            return Alignment(
                score=MIN_SCORE, ystart=0, xstart=0, yend=0, xend=0,
                ylen=0, xlen=0, operations=[], mode=AlignmentMode.Custom,
            )

        sc = self.scoring
        m, n = len(x), len(y)
        go, ge = sc.gap_open, sc.gap_extend

        # packed traceback: i_bits | d_bits<<4 | s_bits<<8
        tb = np.zeros((m + 1, n + 1), dtype=np.int32)

        def tb_set(i, j, ib, db, sb):
            tb[i, j] = ib | (db << 4) | (sb << 8)

        def tb_set_s(i, j, sb):
            tb[i, j] = (tb[i, j] & 0x0FF) | (sb << 8)

        def tb_set_i(i, j, ib):
            tb[i, j] = (tb[i, j] & ~0xF) | ib

        def tb_s(i, j):
            return (tb[i, j] >> 8) & 0xF

        def tb_i(i, j):
            return tb[i, j] & 0xF

        def tb_d(i, j):
            return (tb[i, j] >> 4) & 0xF

        S = [np.full(m + 1, MIN_SCORE, dtype=np.int64) for _ in range(2)]
        I = [np.full(m + 1, MIN_SCORE, dtype=np.int64) for _ in range(2)]
        D = [np.full(m + 1, MIN_SCORE, dtype=np.int64) for _ in range(2)]
        Lx = np.zeros(n + 1, dtype=np.int64)
        Ly = np.zeros(m + 1, dtype=np.int64)
        Sn = np.full(m + 1, MIN_SCORE, dtype=np.int64)
        starts, ends = band.starts, band.ends

        # ---- j = 0 column ----
        curr = 0
        i_start, i_end = int(starts[0]), int(ends[0])
        if i_start == 0:
            S[curr][0] = 0
        for i in range(max(1, i_start), i_end):
            ib, db, sb = TB_START, TB_START, TB_START
            if i == 1:
                I[curr][i] = go
                ib = TB_START
            else:
                i_score = go + ge * (i - 1)
                c_score = sc.xclip_prefix + go
                if i_score > c_score:
                    I[curr][i] = i_score
                    ib = TB_INS
                else:
                    I[curr][i] = c_score
                    ib = TB_XCLIP_PREFIX
            if i == m:
                sb = TB_XCLIP_SUFFIX
            if I[curr][i] > S[curr][i]:
                S[curr][i] = I[curr][i]
                sb = TB_INS
            if sc.xclip_prefix > S[curr][i]:
                S[curr][i] = sc.xclip_prefix
                sb = TB_XCLIP_PREFIX
            if S[curr][i] + sc.xclip_suffix > S[curr][m]:
                S[curr][m] = S[curr][i] + sc.xclip_suffix
                Lx[0] = m - i
                tb_set_s(m, 0, TB_XCLIP_SUFFIX)
            tb_set(i, 0, ib, db, sb)
        for i in range(i_end, min(m + 1, int(ends[min(n, 1)]))):
            S[curr][i] = MIN_SCORE
            I[curr][i] = MIN_SCORE
        if i_end < m + 1:
            S[curr][m] = MIN_SCORE
        if sc.yclip_prefix > sc.yclip_suffix:
            Sn[0] = sc.yclip_prefix
            tb_set_s(0, n, TB_YCLIP_PREFIX)
        else:
            Sn[0] = sc.yclip_suffix
            Ly[0] = n
            tb_set_s(0, n, TB_YCLIP_SUFFIX)

        # ---- main loop over j ----
        for j in range(1, n + 1):
            curr = j % 2
            prev = 1 - curr
            i_start, i_end = int(starts[j]), int(ends[j])

            if i_start == 0:
                ib, db, sb = TB_START, TB_START, TB_START
                I[curr][0] = MIN_SCORE
                if j == 1:
                    D[curr][0] = go
                    db = TB_START
                else:
                    d_score = go + ge * (j - 1)
                    c_score = sc.yclip_prefix + go
                    if d_score > c_score:
                        D[curr][0] = d_score
                        db = TB_DEL
                    else:
                        D[curr][0] = c_score
                        db = TB_YCLIP_PREFIX
                if D[curr][0] > sc.yclip_prefix:
                    S[curr][0] = D[curr][0]
                    sb = TB_DEL
                else:
                    S[curr][0] = sc.yclip_prefix
                    sb = TB_YCLIP_PREFIX
                if S[curr][0] + sc.yclip_suffix > Sn[0]:
                    Sn[0] = S[curr][0] + sc.yclip_suffix
                    Ly[0] = n - j
                    tb_set_s(0, n, TB_YCLIP_SUFFIX)
                tb_set(0, j, ib, db, sb)

            for i in range(max(i_start - 1, 0), i_start):
                S[curr][i] = MIN_SCORE
                I[curr][i] = MIN_SCORE
                D[curr][i] = MIN_SCORE
            S[curr][m] = MIN_SCORE

            q = y[j - 1]
            xclip_score = sc.xclip_prefix + max(
                max(sc.yclip_prefix, int(Sn[0])) if j == n else sc.yclip_prefix,
                go + ge * (j - 1),
            )

            for i in range(max(1, i_start), i_end):
                p = x[i - 1]
                ib, db, sb = TB_START, TB_START, TB_START

                m_score = S[prev][i - 1] + sc.score(p, q)

                i_score = I[curr][i - 1] + ge
                s_score = S[curr][i - 1] + go
                if i_score > s_score:
                    best_i_score = i_score
                    ib = TB_INS
                else:
                    best_i_score = s_score
                    ib = tb_s(i - 1, j)
                if j == n:
                    clip_score = Sn[i - 1] + go
                    if clip_score > best_i_score:
                        best_i_score = clip_score
                        ib = TB_YCLIP_SUFFIX

                d_score = D[prev][i] + ge
                s_score = S[prev][i] + go
                if d_score > s_score:
                    best_d_score = d_score
                    db = TB_DEL
                else:
                    best_d_score = s_score
                    db = tb_s(i, j - 1)

                if i == m:
                    sb = TB_XCLIP_SUFFIX
                else:
                    S[curr][i] = MIN_SCORE
                best_s_score = S[curr][i]

                if m_score > best_s_score:
                    best_s_score = m_score
                    sb = TB_MATCH if p == q else TB_SUBST
                if best_i_score > best_s_score:
                    best_s_score = best_i_score
                    sb = TB_INS
                if best_d_score > best_s_score:
                    best_s_score = best_d_score
                    sb = TB_DEL
                if xclip_score > best_s_score:
                    best_s_score = xclip_score
                    sb = TB_XCLIP_PREFIX
                yclip_score = sc.yclip_prefix + go + ge * (i - 1)
                if yclip_score > best_s_score:
                    best_s_score = yclip_score
                    sb = TB_YCLIP_PREFIX

                S[curr][i] = best_s_score
                I[curr][i] = best_i_score
                D[curr][i] = best_d_score

                if S[curr][i] + sc.xclip_suffix > S[curr][m]:
                    S[curr][m] = S[curr][i] + sc.xclip_suffix
                    Lx[j] = m - i
                    tb_set_s(m, j, TB_XCLIP_SUFFIX)
                if S[curr][i] + sc.yclip_suffix > Sn[i]:
                    Sn[i] = S[curr][i] + sc.yclip_suffix
                    Ly[i] = n - j
                    tb_set_s(i, n, TB_YCLIP_SUFFIX)
                tb_set(i, j, ib, db, sb)

            if S[curr][m] + sc.yclip_suffix > Sn[m]:
                Sn[m] = S[curr][m] + sc.yclip_suffix
                Ly[m] = n - j
                tb_set_s(m, n, TB_YCLIP_SUFFIX)
            if i_end < m + 1:
                tb_set_s(m, j, TB_XCLIP_SUFFIX)
                S[curr][m] = MIN_SCORE

            for i in range(i_end, min(m + 1, int(ends[min(n, j + 1)]))):
                S[curr][i] = MIN_SCORE
                I[curr][i] = MIN_SCORE
                D[curr][i] = MIN_SCORE

            if getattr(self, "_snap", None) is not None:
                self._snap.append(
                    (S[curr].copy(), I[curr].copy(), D[curr].copy(),
                     Sn.copy())
                )

        # ---- suffix fixups at j = n (banded.rs:677-766) ----
        curr = n % 2
        for i in range(m + 1):
            if i != m and (i < starts[n] or i > ends[n]):
                S[curr][i] = MIN_SCORE
            if Sn[i] > S[curr][i]:
                S[curr][i] = Sn[i]
                tb_set_s(i, n, TB_YCLIP_SUFFIX)
            if S[curr][i] + sc.xclip_suffix > S[curr][m]:
                S[curr][m] = S[curr][i] + sc.xclip_suffix
                Lx[n] = m - i
                tb_set_s(m, n, TB_XCLIP_SUFFIX)

        for i in range(max(1, int(starts[n])), int(ends[n])):
            s_score = S[curr][i - 1] + go
            if s_score > I[curr][i]:
                I[curr][i] = s_score
                tb_set_i(i, n, tb_s(i - 1, n))
            if s_score > S[curr][i]:
                S[curr][i] = s_score
                tb_set_s(i, n, TB_INS)
                if S[curr][i] + sc.xclip_suffix > S[curr][m]:
                    S[curr][m] = S[curr][i] + sc.xclip_suffix
                    Lx[n] = m - i
                    tb_set_s(m, n, TB_XCLIP_SUFFIX)

        for j in range(1, n + 1):
            d_score = go + ge * (j - 1)
            if d_score > sc.yclip_prefix:
                tb_set_s(0, j, TB_DEL)
            else:
                tb_set_s(0, j, TB_YCLIP_PREFIX)
            if j == n:
                best_score = max(d_score, sc.yclip_prefix)
                if sc.yclip_suffix > best_score:
                    best_score = sc.yclip_suffix
                    tb_set_s(0, j, TB_YCLIP_SUFFIX)
                if sc.xclip_suffix + best_score > S[n % 2][m]:
                    S[n % 2][m] = sc.xclip_suffix + best_score
                    Lx[n] = m
                    tb_set_s(m, n, TB_XCLIP_SUFFIX)

        for i in range(1, m + 1):
            c_score = go + ge * (i - 1)
            if c_score > sc.xclip_prefix:
                tb_set_s(i, 0, TB_INS)
            else:
                tb_set_s(i, 0, TB_XCLIP_PREFIX)
            if i == m:
                best_score = max(c_score, sc.xclip_prefix)
                if sc.xclip_suffix > best_score:
                    best_score = sc.xclip_suffix
                    tb_set_s(i, 0, TB_XCLIP_SUFFIX)
                if sc.yclip_suffix + best_score > S[n % 2][m]:
                    S[n % 2][m] = sc.yclip_suffix + best_score
                    Ly[m] = n
                    tb_set_s(m, n, TB_YCLIP_SUFFIX)

        # ---- traceback walk (banded.rs:768-870) ----
        i, j = m, n
        operations: List = []
        xstart = ystart = 0
        xend, yend = m, n
        last_layer = tb_s(i, j)
        while True:
            if last_layer == TB_START:
                break
            at = (i, j)
            if last_layer == TB_INS:
                operations.append(Ins)
                next_layer = tb_i(i, j)
                i -= 1
            elif last_layer == TB_DEL:
                operations.append(Del)
                next_layer = tb_d(i, j)
                j -= 1
            elif last_layer == TB_MATCH:
                operations.append(Match)
                next_layer = tb_s(i - 1, j - 1)
                i -= 1
                j -= 1
            elif last_layer == TB_SUBST:
                operations.append(Subst)
                next_layer = tb_s(i - 1, j - 1)
                i -= 1
                j -= 1
            elif last_layer == TB_XCLIP_PREFIX:
                operations.append(Xclip(i))
                xstart = i
                i = 0
                next_layer = tb_s(0, j)
            elif last_layer == TB_XCLIP_SUFFIX:
                operations.append(Xclip(int(Lx[j])))
                i -= int(Lx[j])
                xend = i
                next_layer = tb_s(i, j)
            elif last_layer == TB_YCLIP_PREFIX:
                operations.append(Yclip(j))
                ystart = j
                j = 0
                next_layer = tb_s(i, 0)
            elif last_layer == TB_YCLIP_SUFFIX:
                operations.append(Yclip(int(Ly[i])))
                j -= int(Ly[i])
                yend = j
                next_layer = tb_s(i, j)
            else:
                raise AssertionError("Dint expect this!")
            if (i, j) == at and next_layer == last_layer:
                # a clip of length 0 that reads its own cell again: the
                # reference walk repeats this step forever (an empty y whose
                # column 0 ends in a clip; ROADMAP Queue 3)
                raise ValueError(f"the banded traceback does not end: a clip of length 0 at ({i}, {j}) repeats")
            last_layer = next_layer

        # endings outside the band (banded.rs:833-856)
        if i != 0:
            i_score = go + ge * (i - 1)
            if i_score > sc.xclip_prefix:
                operations.extend([Ins] * i)
                xstart = 0
            else:
                operations.append(Xclip(i))
                xstart = i
        if j != 0:
            d_score = go + ge * (j - 1)
            if d_score > sc.yclip_prefix:
                operations.extend([Del] * j)
                ystart = 0
            else:
                operations.append(Yclip(j))
                ystart = j

        operations.reverse()
        # the DP's buffers, for the stage-by-stage tests
        self._dbg = dict(
            tb=tb.copy(), S=[S[0].copy(), S[1].copy()],
            I=[I[0].copy(), I[1].copy()], D=[D[0].copy(), D[1].copy()],
            Sn=Sn.copy(), Lx=Lx.copy(), Ly=Ly.copy(),
        )
        return Alignment(
            score=int(S[n % 2][m]),
            ystart=ystart,
            xstart=xstart,
            yend=yend,
            xend=xend,
            ylen=n,
            xlen=m,
            operations=operations,
            mode=AlignmentMode.Custom,
        )
