"""Sparse alignment: LCSk++ / gap-penalized sparse DP over k-mer matches (own
copy of ``rust_bio_tpu.alignment.sparse``).

Reference parity: src/alignment/sparse.rs — ``SparseAlignmentResult``
(:40), ``lcskpp`` event sweep + Fenwick prefix-max (:67-150), ``sdpkpp``
with ``PrevPtr`` gap-penalized chaining (:188-295), ``sdpkpp_union_lcskpp_path``
(:297), ``find_kmer_matches``/``hash_kmers`` (:337-402) and
``expand_kmer_matches`` diagonal expansion with mismatch allowance (:404+).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from rust_bio_tpu_torch.data_structures.bit_tree import MaxBitTree
from rust_bio_tpu_torch.utils.text import to_bytes


@dataclass
class SparseAlignmentResult:
    path: List[int] = field(default_factory=list)
    score: int = 0
    dp_vector: List[Tuple[int, int]] = field(default_factory=list)


def _check_sorted(matches) -> None:
    for i in range(1, len(matches)):
        assert matches[i - 1] < matches[i], "incoming matches must be sorted."


def lcskpp(matches: List[Tuple[int, int]], k: int) -> SparseAlignmentResult:
    """LCSk++ (Pavetić et al. 2014) over sorted kmer match points."""
    if not matches:
        return SparseAlignmentResult()
    _check_sorted(matches)
    nm = len(matches)

    events: List[Tuple[int, int, int]] = []
    n = 0
    for idx, (x, y) in enumerate(matches):
        events.append((x, y, idx + nm))
        events.append((x + k, y + k, idx))
        n = max(n, x + k, y + k)
    events.sort()

    max_col_dp = MaxBitTree(n, default=(0, 0))
    dp: List[Tuple[int, int]] = [(0, 0)] * len(events)
    best_dp = (k, 0)

    for ex, ey, eidx in events:
        p = eidx % nm
        if eidx >= nm:  # start of kmer
            dp[p] = (k, -1)
            best_value, best_position = max_col_dp.get(ey)
            if best_value > 0:
                dp[p] = (k + best_value, best_position)
                best_dp = max(best_dp, (dp[p][0], p))
        else:  # end of kmer
            if ex > k and ey > k:
                ci = bisect.bisect_left(matches, (ex - k - 1, ey - k - 1))
                if ci < nm and matches[ci] == (ex - k - 1, ey - k - 1):
                    candidate = (dp[ci][0] + 1, ci)
                    dp[p] = max(dp[p], candidate)
                    best_dp = max(best_dp, (dp[p][0], p))
            max_col_dp.set(ey, (dp[p][0], p))

    path = []
    best_score, prev = best_dp
    while prev >= 0:
        path.append(prev)
        prev = dp[prev][1]
    path.reverse()
    return SparseAlignmentResult(path, best_score, dp)


def sdpkpp(
    matches: List[Tuple[int, int]],
    k: int,
    match_score: int,
    gap_open: int,
    gap_extend: int,
) -> SparseAlignmentResult:
    """Gap-penalized sparse DP chaining (sparse.rs:188).

    Hot path of the banded aligner's seeding; runs on the port's native
    C++ twin (``csrc/band_build.cpp`` ``sdpkpp_i64``), which raises when
    it cannot be built; ``_sdpkpp_py`` is the pure-Python oracle the tests
    hold it against."""
    if not matches:
        return SparseAlignmentResult()
    assert gap_open <= 0 and gap_extend <= 0, "gap parameters cannot be positive"
    _check_sorted(matches)

    from rust_bio_tpu_torch import native as _native

    nm = len(matches)
    xs = np.fromiter((m[0] for m in matches), dtype=np.int64, count=nm)
    ys = np.fromiter((m[1] for m in matches), dtype=np.int64, count=nm)
    dp_score, dp_prev, best_score, best_idx = _native.sdpkpp_native(
        xs, ys, k, match_score, -gap_open, -gap_extend
    )
    dp = [(int(s), int(p)) for s, p in zip(dp_score, dp_prev)] + [(0, 0)] * nm
    path: List[int] = []
    prev = best_idx
    while prev >= 0:
        path.append(prev)
        prev = dp[prev][1]
    path.reverse()
    return SparseAlignmentResult(path, int(best_score), dp)


def _sdpkpp_py(
    matches: List[Tuple[int, int]],
    k: int,
    match_score: int,
    gap_open: int,
    gap_extend: int,
) -> SparseAlignmentResult:
    """Pure-Python sdpkpp (the native kernel's oracle)."""
    go, ge = -gap_open, -gap_extend
    nm = len(matches)

    events: List[Tuple[int, int, int]] = []
    n = 0
    for idx, (x, y) in enumerate(matches):
        events.append((x, y, idx + nm))
        events.append((x + k, y + k, idx))
        n = max(n, x + k, y + k)
    events.sort()

    # PrevPtr ordering: (plane, score, d, id, x, y) lexicographic
    zero_ptr = (0, 0, 0, 0, 0, 0)
    max_col_dp = MaxBitTree(n, default=zero_ptr)
    dp: List[Tuple[int, int]] = [(0, 0)] * len(events)
    best_dp = (k, 0)

    for ex, ey, eidx in events:
        p = eidx % nm
        if eidx >= nm:  # chain start
            dp[p] = (k * match_score, -1)
            plane, score, d, pid, px, py = max_col_dp.get(ey)
            if score > 0:
                gap = max(ex - px, ey - py)
                gap_penalty = go + gap * ge if gap > 0 else 0
                reward = k * match_score
                new_score = max(score + reward - gap_penalty, 0)
                dp[p] = max(dp[p], (new_score, pid))
                best_dp = max(best_dp, (dp[p][0], p))
        else:
            if ex > k and ey > k:
                ci = bisect.bisect_left(matches, (ex - k - 1, ey - k - 1))
                if ci < nm and matches[ci] == (ex - k - 1, ey - k - 1):
                    candidate = (dp[ci][0] + match_score, ci)
                    dp[p] = max(dp[p], candidate)
                    best_dp = max(best_dp, (dp[p][0], p))
            d = ex + ey
            max_col_dp.set(ey, (dp[p][0] + d * ge, dp[p][0], d, p, ex, ey))

    path = []
    best_score, prev = best_dp
    while prev >= 0:
        path.append(prev)
        prev = dp[prev][1]
    path.reverse()
    return SparseAlignmentResult(path, best_score, dp)


def sdpkpp_union_lcskpp_path(
    matches, k, match_score, gap_open, gap_extend
) -> List[int]:
    """Union path of lcskpp and sdpkpp (sparse.rs:297)."""
    if not matches:
        return []
    lc = lcskpp(matches, k)
    sd = sdpkpp(matches, k, match_score, gap_open, gap_extend)
    i = bisect.bisect_left(lc.path, sd.path[0])
    pre = i if i < len(lc.path) and lc.path[i] == sd.path[0] else 0
    j = bisect.bisect_left(lc.path, sd.path[-1])
    if j < len(lc.path) and lc.path[j] == sd.path[-1]:
        post = j + 1
    else:
        post = len(lc.path)
    return lc.path[:pre] + sd.path + lc.path[post:]


def hash_kmers(seq, k: int) -> Dict[bytes, List[int]]:
    """All k-mer start positions keyed by k-mer (sparse.rs:350)."""
    s = to_bytes(seq)
    out: Dict[bytes, List[int]] = {}
    for i in range(max(len(s) + 1 - k, 0)):
        out.setdefault(s[i : i + k], []).append(i)
    return out


def find_kmer_matches_seq1_hashed(seq1_set, seq2, k: int) -> List[Tuple[int, int]]:
    s2 = to_bytes(seq2)
    matches = []
    for i in range(max(len(s2) + 1 - k, 0)):
        for pos1 in seq1_set.get(s2[i : i + k], ()):
            matches.append((pos1, i))
    matches.sort()
    return matches


def find_kmer_matches_seq2_hashed(seq1, seq2_set, k: int) -> List[Tuple[int, int]]:
    s1 = to_bytes(seq1)
    matches = []
    for i in range(max(len(s1) + 1 - k, 0)):
        for pos2 in seq2_set.get(s1[i : i + k], ()):
            matches.append((i, pos2))
    matches.sort()
    return matches


def find_kmer_matches(seq1, seq2, k: int) -> List[Tuple[int, int]]:
    """All k-length shared substring positions (sparse.rs:337)."""
    s1, s2 = to_bytes(seq1), to_bytes(seq2)
    if len(s1) < len(s2):
        return find_kmer_matches_seq1_hashed(hash_kmers(s1, k), s2, k)
    return find_kmer_matches_seq2_hashed(s1, hash_kmers(s2, k), k)


def expand_kmer_matches(
    seq1, seq2, k: int, sorted_matches, allowed_mismatches: int
) -> List[Tuple[int, int]]:
    """Diagonal expansion of matches with a mismatch budget (sparse.rs:404)."""
    s1, s2 = to_bytes(seq1), to_bytes(seq2)
    for i in range(1, len(sorted_matches)):
        assert sorted_matches[i - 1] < sorted_matches[i], (
            "incoming matches must be sorted"
        )

    last_match_along_diag: Dict[int, Tuple[int, int]] = {}
    left_expanded = list(sorted_matches)
    for mx, my in sorted_matches:
        diag = mx - my
        min_xy = min(mx, my)
        last = last_match_along_diag.get(
            diag, (mx - min_xy - 1, my - min_xy - 1)
        )
        n_mis = 0
        cx, cy = mx - 1, my - 1
        while last < (cx, cy):
            n_mis += 0 if s1[cx] == s2[cy] else 1
            if n_mis > allowed_mismatches:
                break
            left_expanded.append((cx, cy))
            cx, cy = cx - 1, cy - 1
        last_match_along_diag[diag] = (mx, my)

    left_expanded.sort()
    expanded = list(left_expanded)
    left_expanded.reverse()

    next_match_along_diag: Dict[int, Tuple[int, int]] = {}
    for mx, my in left_expanded:
        diag = mx - my
        max_inc = max(min(len(s1) - mx, len(s2) - my) - (k - 1), 0)
        nxt = next_match_along_diag.get(diag, (mx + max_inc, my + max_inc))
        n_mis = 0
        cx, cy = mx + 1, my + 1
        while (cx, cy) < nxt:
            n_mis += 0 if s1[cx + k - 1] == s2[cy + k - 1] else 1
            if n_mis > allowed_mismatches:
                break
            expanded.append((cx, cy))
            cx, cy = cx + 1, cy + 1
        next_match_along_diag[diag] = (mx, my)

    expanded.sort()
    return expanded
