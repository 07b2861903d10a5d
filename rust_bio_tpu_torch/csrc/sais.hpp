// SA-IS (Nong, Zhang & Chan 2009), integer alphabet, templated on the
// text symbol type Tp and the index type Idx: the port's own copy of
// rust_bio_tpu's native/sais.hpp, compiled into the port's host library
// (host_index.cpp's SAIS entry points).
//
// Genome-scale memory: the reference dispatches its SA index dtype by
// text length (suffix_array.rs:270-281) for exactly this reason.  A
// (u8 text, i32 SA) build costs ~7 bytes/symbol here (SA 4n + types 1n +
// text 1n + geometric recursion) versus ~40 bytes/symbol for the old
// all-int64 instantiation — a 3 Gbp chromosome-set text fits in ~21 GB.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace sais {

template <typename Tp, typename Idx>
inline void get_counts(const Tp* T, Idx* C, Idx n, Idx K) {
  std::memset(C, 0, sizeof(Idx) * K);
  for (Idx i = 0; i < n; ++i) C[T[i]]++;
}

template <typename Idx>
inline void get_buckets(const Idx* C, Idx* B, Idx K, bool end) {
  Idx sum = 0;
  for (Idx i = 0; i < K; ++i) {
    sum += C[i];
    B[i] = end ? sum : sum - C[i];
  }
}

// T: text (values in [0, K)); SA: output length n. Requires T[n-1] unique
// minimum (sentinel) for standard SAIS; callers guarantee distinct sentinel
// ranks, making the last symbol the unique minimum of its run.
template <typename Tp, typename Idx>
inline void sais_core(const Tp* T, Idx* SA, Idx n, Idx K) {
  if (n == 0) return;
  if (n == 1) { SA[0] = 0; return; }

  std::vector<uint8_t> t(n);  // 1 = S-type, 0 = L-type
  t[n - 1] = 1;
  for (Idx i = n - 2; i >= 0; --i)
    t[i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && t[i + 1])) ? 1 : 0;

  auto is_lms = [&](Idx i) { return i > 0 && t[i] && !t[i - 1]; };

  std::vector<Idx> C(K), B(K);

  // Stage 1: sort LMS substrings via induced sorting.
  get_counts(T, C.data(), n, K);
  get_buckets(C.data(), B.data(), K, true);
  for (Idx i = 0; i < n; ++i) SA[i] = -1;
  for (Idx i = n - 1; i > 0; --i)
    if (is_lms(i)) SA[--B[T[i]]] = i;

  auto induce = [&]() {
    // induce L-types left to right
    get_buckets(C.data(), B.data(), K, false);
    for (Idx i = 0; i < n; ++i) {
      Idx j = SA[i];
      if (j > 0 && !t[j - 1]) SA[B[T[j - 1]]++] = j - 1;
    }
    // induce S-types right to left
    get_buckets(C.data(), B.data(), K, true);
    for (Idx i = n - 1; i >= 0; --i) {
      Idx j = SA[i];
      if (j > 0 && t[j - 1]) SA[--B[T[j - 1]]] = j - 1;
    }
  };
  induce();

  // Compact sorted LMS positions to the front.
  Idx n1 = 0;
  for (Idx i = 0; i < n; ++i)
    if (SA[i] > 0 && is_lms(SA[i])) SA[n1++] = SA[i];

  // Name LMS substrings into SA[n1..] (indexed by pos/2).
  for (Idx i = n1; i < n; ++i) SA[i] = -1;
  Idx name = 0, prev = -1;
  for (Idx i = 0; i < n1; ++i) {
    Idx pos = SA[i];
    bool diff = false;
    // canonical LMS-substring comparison: equal types at equal chars imply
    // equal is_lms flags, so a break at an LMS boundary means "identical"
    for (Idx d = 0; d < n; ++d) {
      if (prev < 0 || pos + d >= n || prev + d >= n ||
          T[pos + d] != T[prev + d] || t[pos + d] != t[prev + d]) {
        diff = true;
        break;
      }
      if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
    }
    if (diff) { ++name; prev = pos; }
    SA[n1 + pos / 2] = name - 1;
  }
  // Compact names to the tail in text order: s1 = SA[n - n1 .. n).
  Idx* s1 = SA + n - n1;
  for (Idx i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // Stage 2: sort the reduced problem (reduced text is Idx-typed names).
  if (name < n1) {
    sais_core<Idx, Idx>(s1, SA, n1, name);
  } else {
    for (Idx i = 0; i < n1; ++i) SA[s1[i]] = i;
  }

  // Stage 3: map reduced order back to LMS text positions, then induce.
  for (Idx i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) s1[j++] = i;  // LMS positions in text order
  for (Idx i = 0; i < n1; ++i) SA[i] = s1[SA[i]];

  get_counts(T, C.data(), n, K);
  get_buckets(C.data(), B.data(), K, true);
  for (Idx i = n1; i < n; ++i) SA[i] = -1;
  for (Idx i = n1 - 1; i >= 0; --i) {
    Idx j = SA[i];
    SA[i] = -1;
    SA[--B[T[j]]] = j;
  }
  induce();
}

// ---------------------------------------------------------------------------
// Top-level SA-IS specialization for 2^31 <= n < 2^32 (the full human
// genome: 3.1 Gbp does not fit the i32 index path, and the all-i64
// instantiation costs ~2.5x the working set and blows multi-hour budgets
// on a 4-core host).  SA is stored as uint32 (EMPTY = 0xFFFFFFFF takes the
// role of the signed path's -1 marker; loop counters stay int64), which
// halves the top level's memory traffic vs i64.  The reduced problem has
// n1 <= n/2 < 2^31, so stage 2 recurses into the ordinary i32-indexed
// core over the same buffer (values are nonnegative and < 2^31, so the
// u32 <-> i32 reinterpretation is value-preserving).
// Mirrors the reference's index-dtype dispatch (suffix_array.rs:270-281).
// ---------------------------------------------------------------------------
inline void sais_top_u8_u32(const uint8_t* T, uint32_t* SA, int64_t n,
                            int64_t K) {
  const uint32_t EMPTY = ~0u;
  if (n == 0) return;
  if (n == 1) { SA[0] = 0; return; }

  std::vector<uint8_t> t(n);  // 1 = S-type, 0 = L-type
  t[n - 1] = 1;
  for (int64_t i = n - 2; i >= 0; --i)
    t[i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && t[i + 1])) ? 1 : 0;

  auto is_lms = [&](int64_t i) { return i > 0 && t[i] && !t[i - 1]; };

  std::vector<int64_t> C(K), B(K);
  auto get_counts64 = [&]() {
    std::fill(C.begin(), C.end(), 0);
    for (int64_t i = 0; i < n; ++i) C[T[i]]++;
  };
  auto get_buckets64 = [&](bool end) {
    int64_t sum = 0;
    for (int64_t i = 0; i < K; ++i) {
      sum += C[i];
      B[i] = end ? sum : sum - C[i];
    }
  };

  // Stage 1: sort LMS substrings via induced sorting.
  get_counts64();
  get_buckets64(true);
  for (int64_t i = 0; i < n; ++i) SA[i] = EMPTY;
  for (int64_t i = n - 1; i > 0; --i)
    if (is_lms(i)) SA[--B[T[i]]] = (uint32_t)i;

  auto induce = [&]() {
    get_buckets64(false);
    for (int64_t i = 0; i < n; ++i) {
      uint32_t j = SA[i];
      if (j != EMPTY && j > 0 && !t[j - 1]) SA[B[T[j - 1]]++] = j - 1;
    }
    get_buckets64(true);
    for (int64_t i = n - 1; i >= 0; --i) {
      uint32_t j = SA[i];
      if (j != EMPTY && j > 0 && t[j - 1]) SA[--B[T[j - 1]]] = j - 1;
    }
  };
  induce();

  // Compact sorted LMS positions to the front.
  int64_t n1 = 0;
  for (int64_t i = 0; i < n; ++i)
    if (SA[i] != EMPTY && SA[i] > 0 && is_lms((int64_t)SA[i]))
      SA[n1++] = SA[i];

  // Name LMS substrings into SA[n1..] (indexed by pos/2).
  for (int64_t i = n1; i < n; ++i) SA[i] = EMPTY;
  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < n1; ++i) {
    int64_t pos = SA[i];
    bool diff = false;
    for (int64_t d = 0; d < n; ++d) {
      if (prev < 0 || pos + d >= n || prev + d >= n ||
          T[pos + d] != T[prev + d] || t[pos + d] != t[prev + d]) {
        diff = true;
        break;
      }
      if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
    }
    if (diff) { ++name; prev = pos; }
    SA[n1 + pos / 2] = (uint32_t)(name - 1);
  }
  // Compact names to the tail in text order: s1 = SA[n - n1 .. n).
  uint32_t* s1 = SA + (n - n1);
  for (int64_t i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] != EMPTY) SA[j--] = SA[i];

  // Stage 2: the reduced problem (n1 < 2^31, names < 2^31) runs the
  // ordinary i32-indexed core over the same buffer.
  if (name < n1) {
    sais_core<uint32_t, int32_t>(s1, reinterpret_cast<int32_t*>(SA),
                                 (int32_t)n1, (int32_t)name);
  } else {
    for (int64_t i = 0; i < n1; ++i) SA[s1[i]] = (uint32_t)i;
  }

  // Stage 3: map reduced order back to LMS text positions, then induce.
  for (int64_t i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) s1[j++] = (uint32_t)i;  // LMS positions in text order
  for (int64_t i = 0; i < n1; ++i) SA[i] = s1[SA[i]];

  get_counts64();
  get_buckets64(true);
  for (int64_t i = n1; i < n; ++i) SA[i] = EMPTY;
  for (int64_t i = n1 - 1; i >= 0; --i) {
    uint32_t j = SA[i];
    SA[i] = EMPTY;
    SA[--B[T[j]]] = j;
  }
  induce();
}

}  // namespace sais
