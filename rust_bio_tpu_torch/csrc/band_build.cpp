// Host band builder of the banded aligner (the port's own copy of what
// rust_bio_tpu's native/biotpu.cpp band_build_batch needs): k-mer matches ->
// sdpkpp chain -> band raster per pair, threaded over pairs.
//
//   kmer_matches_i64  sorted (i, j) k-mer match pairs (sparse.rs:337 twin)
//   sdpkpp_i64        gap-penalized sparse chaining (sparse.rs:188 twin)
//   band_raster_i64   per-column [start, end) band from a match path
//   band_build_batch  all three per pair, cropped column windows out
//
// Built at first use by rust_bio_tpu_torch/native.py with
// c++ -O3 -std=c++17 -shared -fPIC -pthread; plain C entry points for ctypes.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Gap-penalized sparse DP chaining (sdpkpp), the banded aligner's backbone.
// Statement-level twin of alignment/sparse.py::sdpkpp (itself mirroring the
// reference sparse.rs:188): event sweep + prefix-max Fenwick tree over the
// column axis with the 6-field lexicographic PrevPtr ordering.
// ---------------------------------------------------------------------------

namespace sdp {

struct P6 {
  int64_t a, b, c, d, e, f;
};

static inline bool lt6(const P6& x, const P6& y) {
  if (x.a != y.a) return x.a < y.a;
  if (x.b != y.b) return x.b < y.b;
  if (x.c != y.c) return x.c < y.c;
  if (x.d != y.d) return x.d < y.d;
  if (x.e != y.e) return x.e < y.e;
  return x.f < y.f;
}

struct Fenwick {
  std::vector<P6> tree;  // 1-based, prefix-max
  explicit Fenwick(int64_t n) : tree(n + 1, P6{0, 0, 0, 0, 0, 0}) {}
  P6 get(int64_t idx) const {
    ++idx;
    P6 best{0, 0, 0, 0, 0, 0};
    while (idx > 0) {
      if (lt6(best, tree[idx])) best = tree[idx];
      idx -= idx & (-idx);
    }
    return best;
  }
  void set(int64_t idx, const P6& val) {
    ++idx;
    while (idx < (int64_t)tree.size()) {
      if (lt6(tree[idx], val)) tree[idx] = val;
      idx += idx & (-idx);
    }
  }
};

struct Ev {
  int64_t x, y, eidx;
};

}  // namespace sdp

}  // namespace

extern "C" {

// sdpkpp chaining over nm sorted (x, y) kmer matches.  go_neg/ge_neg are the
// POSITIVE gap penalties (-gap_open, -gap_extend).  Outputs: per-match
// dp_score/dp_prev and best_out = {best_score, best_end_index_or_-1}.
void sdpkpp_i64(const int64_t* xs, const int64_t* ys, int64_t nm, int64_t k,
                int64_t match_score, int64_t go_neg, int64_t ge_neg,
                int64_t* dp_score, int64_t* dp_prev, int64_t* best_out) {
  using sdp::Ev;
  using sdp::Fenwick;
  using sdp::P6;
  std::vector<Ev> events;
  events.reserve(2 * nm);
  int64_t n = 0;
  for (int64_t i = 0; i < nm; ++i) {
    events.push_back(Ev{xs[i], ys[i], i + nm});
    events.push_back(Ev{xs[i] + k, ys[i] + k, i});
    n = std::max(n, std::max(xs[i] + k, ys[i] + k));
  }
  std::sort(events.begin(), events.end(), [](const Ev& a, const Ev& b) {
    if (a.x != b.x) return a.x < b.x;
    if (a.y != b.y) return a.y < b.y;
    return a.eidx < b.eidx;
  });

  // Coordinate-compress the Fenwick axis: the tree is only ever SET at
  // the nm end-event columns (y + k), so prefix-max over ranks of those
  // values is identical to prefix-max over raw y — and the tree shrinks
  // from max-coordinate entries (a ~1 MB zero-init per 20 kb pair) to nm.
  std::vector<int64_t> ycoords(nm);
  for (int64_t i = 0; i < nm; ++i) ycoords[i] = ys[i] + k;
  std::sort(ycoords.begin(), ycoords.end());
  ycoords.erase(std::unique(ycoords.begin(), ycoords.end()),
                ycoords.end());
  // rank(v) = number of set-columns <= v, minus one (prefix query index)
  auto rank_of = [&](int64_t v) {
    return (int64_t)(std::upper_bound(ycoords.begin(), ycoords.end(), v) -
                     ycoords.begin()) -
           1;
  };
  n = (int64_t)ycoords.size();
  Fenwick max_col_dp(n);
#define BIOTPU_FW_IDX(v) rank_of(v)
  for (int64_t i = 0; i < nm; ++i) {
    dp_score[i] = 0;
    dp_prev[i] = 0;
  }
  int64_t best_score = k, best_idx = 0;

  auto dp_max = [&](int64_t p, int64_t s, int64_t prev) {
    if (s > dp_score[p] || (s == dp_score[p] && prev > dp_prev[p])) {
      dp_score[p] = s;
      dp_prev[p] = prev;
    }
  };
  auto best_max = [&](int64_t s, int64_t idx) {
    if (s > best_score || (s == best_score && idx > best_idx)) {
      best_score = s;
      best_idx = idx;
    }
  };

  for (const Ev& ev : events) {
    int64_t p = ev.eidx % nm;
    if (ev.eidx >= nm) {  // chain start
      dp_score[p] = k * match_score;
      dp_prev[p] = -1;
      P6 t = max_col_dp.get(BIOTPU_FW_IDX(ev.y));
      if (t.b > 0) {
        int64_t gap = std::max(ev.x - t.e, ev.y - t.f);
        int64_t gap_penalty = gap > 0 ? go_neg + gap * ge_neg : 0;
        int64_t reward = k * match_score;
        int64_t new_score = std::max(t.b + reward - gap_penalty, (int64_t)0);
        dp_max(p, new_score, t.d);
        best_max(dp_score[p], p);
      }
    } else {
      if (ev.x > k && ev.y > k) {
        // lower_bound for the diagonal predecessor match
        int64_t tx = ev.x - k - 1, ty = ev.y - k - 1;
        int64_t lo = 0, hi = nm;
        while (lo < hi) {
          int64_t mid = (lo + hi) / 2;
          if (xs[mid] < tx || (xs[mid] == tx && ys[mid] < ty)) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        if (lo < nm && xs[lo] == tx && ys[lo] == ty) {
          dp_max(p, dp_score[lo] + match_score, lo);
          best_max(dp_score[p], p);
        }
      }
      int64_t d = ev.x + ev.y;
      max_col_dp.set(BIOTPU_FW_IDX(ev.y),
                     P6{dp_score[p] + d * ge_neg, dp_score[p], d, p, ev.x, ev.y});
    }
  }
#undef BIOTPU_FW_IDX
  best_out[0] = best_score;
  best_out[1] = best_idx;
}

// All shared k-length substring positions of (x, y), sorted ascending by
// (x_pos, y_pos) — semantic twin of sparse.py find_kmer_matches (itself
// mirroring sparse.rs:337-401).  Writes up to cap (i, j) pairs into
// out_xy (interleaved), returns the TOTAL match count (callers realloc
// and retry when count > cap).
int64_t kmer_matches_i64(const uint8_t* x, int64_t xm, const uint8_t* y,
                         int64_t yn, int64_t k, int64_t* out_xy,
                         int64_t cap) {
  if (k <= 0 || xm < k || yn < k) return 0;
  const int64_t nx = xm + 1 - k;
  const int64_t ny = yn + 1 - k;
  // DNA fast path: for pure-ACGT inputs and k <= 31 the k-mer packs into
  // a rolling 2-bit key, replacing the per-position k-byte FNV hash +
  // memcmp with two shifts and an integer compare (~4x at 20 kb targets;
  // byte-identical output order).  Any other byte falls through to the
  // generic hashed path below.
  if (k <= 31) {
    static const auto CODE_T = [] {
      std::array<int8_t, 256> t{};
      t.fill(-1);
      t['A'] = 0; t['C'] = 1; t['G'] = 2; t['T'] = 3;
      return t;
    }();
    const int8_t* CODE = CODE_T.data();
    // one vectorizable byte->code pass per input (also the validity
    // check); scratch is thread_local — the threaded band builder calls
    // this per pair and per-call vector allocs cost ~60 us at 20 kb
    thread_local std::vector<int8_t> xc, yc;
    thread_local std::vector<uint64_t> ykeys_ws, hkey_ws;
    thread_local std::vector<int64_t> head_ws, nxt_ws, tail_ws;
    xc.resize(xm);
    yc.resize(yn);
    int ok = 1;
    for (int64_t i = 0; i < xm; ++i) {
      xc[i] = CODE[x[i]];
      ok &= xc[i] >= 0;
    }
    for (int64_t j = 0; j < yn; ++j) {
      yc[j] = CODE[y[j]];
      ok &= yc[j] >= 0;
    }
    if (ok) {
      const uint64_t kmask =
          k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1);
      // open-addressed table over x k-mer KEYS; chains via nxt[]
      int64_t tbits = 4;
      while ((int64_t(1) << tbits) < 2 * nx) ++tbits;
      const int64_t tsz = int64_t(1) << tbits;
      const uint64_t mask = tsz - 1;
      auto& head = head_ws;
      auto& nxt = nxt_ws;
      auto& tail = tail_ws;
      auto& hkey = hkey_ws;
      head.assign(tsz, -1);
      nxt.assign(nx, -1);
      tail.assign(tsz, -1);
      hkey.resize(tsz);
      uint64_t key = 0;
      for (int64_t i = 0; i < xm; ++i) {
        key = ((key << 2) | (uint64_t)xc[i]) & kmask;
        if (i < k - 1) continue;
        const int64_t pos = i - (k - 1);
        // multiplicative scramble spreads the packed key
        uint64_t s = (key * 0x9E3779B97F4A7C15ULL) & mask;
        while (true) {
          if (head[s] < 0) {
            head[s] = tail[s] = pos;
            hkey[s] = key;
            break;
          }
          if (hkey[s] == key) {
            nxt[tail[s]] = pos;
            tail[s] = pos;
            break;
          }
          s = (s + 1) & mask;
        }
      }
      // y keys built in k vectorizable shifted-add passes (the rolling
      // single-pass form is a serial dependency chain at ~10 ns/pos;
      // per-offset array passes auto-vectorize)
      auto& ykeys = ykeys_ws;
      ykeys.resize(ny);
      for (int64_t j = 0; j < ny; ++j) ykeys[j] = (uint64_t)yc[j + k - 1];
      for (int64_t d = 0; d < k - 1; ++d) {
        const uint64_t sh = 2 * (k - 1 - d);
        for (int64_t j = 0; j < ny; ++j)
          ykeys[j] |= (uint64_t)yc[j + d] << sh;
      }
      int64_t count = 0;
      for (int64_t pos = 0; pos < ny; ++pos) {
        const uint64_t ykey = ykeys[pos];
        uint64_t s = (ykey * 0x9E3779B97F4A7C15ULL) & mask;
        while (head[s] >= 0) {
          if (hkey[s] == ykey) {
            for (int64_t i = head[s]; i >= 0; i = nxt[i]) {
              if (count < cap) {
                out_xy[2 * count] = i;
                out_xy[2 * count + 1] = pos;
              }
              ++count;
            }
            break;
          }
          s = (s + 1) & mask;
        }
      }
      if (count <= cap && count > 1) {
        struct IJ {
          int64_t i, j;
        };
        IJ* p = reinterpret_cast<IJ*>(out_xy);
        std::sort(p, p + count, [](const IJ& a, const IJ& b) {
          return a.i != b.i ? a.i < b.i : a.j < b.j;
        });
      }
      return count;
    }
  }
  // FNV-1a over the k bytes; buckets verified byte-wise (collision-safe)
  auto fnv = [&](const uint8_t* p) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t d = 0; d < k; ++d) h = (h ^ p[d]) * 1099511628211ULL;
    return h;
  };
  // open-addressed table over x k-mers: slot -> first x position; chains
  // via next[] (x is the short side in the banded use; table is tiny)
  int64_t tbits = 4;
  while ((int64_t(1) << tbits) < 2 * nx) ++tbits;
  const int64_t tsz = int64_t(1) << tbits;
  const uint64_t mask = tsz - 1;
  std::vector<int64_t> head(tsz, -1), nxt(nx, -1), tail(tsz, -1);
  std::vector<uint64_t> hkey(tsz, 0);
  for (int64_t i = 0; i < nx; ++i) {
    uint64_t h = fnv(x + i);
    uint64_t s = h & mask;
    while (true) {
      if (head[s] < 0) {
        head[s] = tail[s] = i;
        hkey[s] = h;
        break;
      }
      if (hkey[s] == h &&
          std::memcmp(x + head[s], x + i, (size_t)k) == 0) {
        nxt[tail[s]] = i;  // append: ascending x positions per bucket
        tail[s] = i;
        break;
      }
      s = (s + 1) & mask;
    }
  }
  int64_t count = 0;
  for (int64_t j = 0; j < ny; ++j) {
    uint64_t h = fnv(y + j);
    uint64_t s = h & mask;
    while (head[s] >= 0) {
      if (hkey[s] == h &&
          std::memcmp(x + head[s], y + j, (size_t)k) == 0) {
        for (int64_t i = head[s]; i >= 0; i = nxt[i]) {
          if (count < cap) {
            out_xy[2 * count] = i;
            out_xy[2 * count + 1] = j;
          }
          ++count;
        }
        break;
      }
      s = (s + 1) & mask;
    }
  }
  // emitted in (ascending j, ascending i-within-bucket) order; the Python
  // twin sorts by (i, j) — do the same (pairs are unique)
  if (count <= cap && count > 1) {
    struct IJ { int64_t i, j; };
    IJ* p = reinterpret_cast<IJ*>(out_xy);
    std::sort(p, p + count, [](const IJ& a, const IJ& b) {
      return a.i != b.i ? a.i < b.i : a.j < b.j;
    });
  }
  return count;
}

// ---------------------------------------------------------------------------
// Band rasterization (banded.py Band::create_from_match_path, itself a
// statement twin of banded.rs:1046-1330): set_boundaries + per-path-segment
// add_kmer / add_gap / add_entry into per-column [start, end) row ranges.
// Byte-identical bands to the Python implementation (property-tested).
// ---------------------------------------------------------------------------

namespace bandr {

struct B {
  int64_t rows, cols;
  int32_t* starts;
  int32_t* ends;
};

inline void add_entry(B& b, int64_t r, int64_t c, int64_t w) {
  int64_t istart = std::max(r - w, (int64_t)0);
  int64_t iend = std::min(r + w + 1, b.rows);
  int64_t lo = std::max(c - w, (int64_t)0);
  int64_t hi = std::min(c + w + 1, b.cols);
  for (int64_t j = lo; j < hi; ++j) {
    if (istart < b.starts[j]) b.starts[j] = (int32_t)istart;
    if (iend > b.ends[j]) b.ends[j] = (int32_t)iend;
  }
}

inline void add_kmer(B& b, int64_t r, int64_t c, int64_t k, int64_t w) {
  if (k == 0) return;
  int64_t i = std::max(r - w, (int64_t)0);
  for (int64_t j = std::max(c - w, (int64_t)0);
       j < std::min(c + w + 1, b.cols); ++j)
    if (i < b.starts[j]) b.starts[j] = (int32_t)i;
  i = std::max(r - w, (int64_t)0);
  for (int64_t j = std::min(c + w, b.cols);
       j < std::min(c + k + w, b.cols); ++j) {
    if (i < b.starts[j]) b.starts[j] = (int32_t)i;
    ++i;
  }
  i = r + w + k;
  int64_t j = std::max(c + k - 1 - w, (int64_t)0);
  while (j > std::max(c - w, (int64_t)0)) {
    --j;
    --i;
    int64_t e = std::min(i, b.rows);
    if (e > b.ends[j]) b.ends[j] = (int32_t)e;
  }
  i = std::min(r + w + k, b.rows);
  for (int64_t jj = std::max(c + k - 1 - w, (int64_t)0);
       jj < std::min(c + k + w, b.cols); ++jj)
    if (i > b.ends[jj]) b.ends[jj] = (int32_t)i;
}

inline void add_gap(B& b, int64_t sr, int64_t sc, int64_t er, int64_t ec,
                    int64_t w) {
  int64_t nrows = er - sr, ncols = ec - sc;
  if (nrows > ncols) {
    for (int64_t r = sr; r < er; ++r)
      add_entry(b, r, sc + (ec - sc) * (r - sr) / (er - sr), w);
  } else {
    if (ec == sc) return;  // empty column span: no entries
    for (int64_t c = sc; c < ec; ++c)
      add_entry(b, sr + (er - sr) * (c - sc) / (ec - sc), c, w);
  }
}

inline void set_boundaries(B& b, int64_t sr, int64_t sc, int64_t er,
                           int64_t ec, int64_t k, int64_t w, int64_t xcp,
                           int64_t xcs, int64_t ycp, int64_t ycs) {
  const int64_t lazy = 2 * k;
  // -------------- START --------------
  {
    int64_t r = sr, c = sc;
    if (!(r == 0 && c == 0)) {
      int64_t score_to_start = (r > 0 ? xcp : 0) + (c > 0 ? ycp : 0);
      if (score_to_start == 0) {
        int64_t d = std::min(lazy, std::min(r, c));
        add_kmer(b, r - d, c - d, d, w);
        add_gap(b, std::max(r - lazy, (int64_t)0),
                std::max(c - lazy, (int64_t)0), r - d, c - d, w);
      } else {
        int64_t diag = r > c ? xcp : (r < c ? ycp : 0);
        if (diag == 0) {
          int64_t d = std::min(r, c);
          add_kmer(b, r - d, c - d, d, w);
          int64_t s0 = std::max(r - lazy, (int64_t)0);
          int64_t s1 = std::max(c - lazy, (int64_t)0);
          if (s0 <= r - d && s1 <= c - d)
            add_gap(b, s0, s1, r - d, c - d, w);
        } else {
          add_gap(b, 0, 0, r, c, w);
        }
      }
    }
  }
  // -------------- END --------------
  {
    int64_t r = er + k, c = ec + k;
    if (!(r == b.rows && c == b.cols)) {
      int64_t score_from_end =
          (r == b.rows ? 0 : xcs) + (c == b.cols ? 0 : ycs);
      if (score_from_end == 0) {
        int64_t d = std::min(lazy, std::min(b.rows - r, b.cols - c));
        add_kmer(b, r, c, d, w);
        int64_t r1 = std::min(b.rows, r + d) - 1;
        int64_t c1 = std::min(b.cols, c + d) - 1;
        int64_t r2 = std::min(b.rows, r + lazy);
        int64_t c2 = std::min(b.cols, c + lazy);
        if (r1 <= r2 && c1 <= c2) add_gap(b, r1, c1, r2, c2, w);
      } else {
        int64_t dr = b.rows - r, dc = b.cols - c;
        int64_t diag = dr > dc ? xcs : (dr < dc ? ycs : 0);
        if (diag == 0) {
          int64_t d = std::min(dr, dc);
          add_kmer(b, r, c, d, w);
          int64_t r1 = std::min(b.rows, r + d) - 1;
          int64_t c1 = std::min(b.cols, c + d) - 1;
          int64_t r2 = std::min(b.rows, r + lazy);
          int64_t c2 = std::min(b.cols, c + lazy);
          if (r1 <= r2 && c1 <= c2) add_gap(b, r1, c1, r2, c2, w);
        } else {
          add_gap(b, r, c, b.rows, b.cols, w);
        }
      }
    }
  }
}

}  // namespace bandr

// Band from a sdpkpp match path.  path_xy: (np, 2) interleaved (r, c) of
// the path's matches IN PATH ORDER.  starts/ends: caller-allocated int32
// arrays of length n + 1 (initialized here).
void band_raster_i64(const int64_t* path_xy, int64_t np_, int64_t m,
                     int64_t n, int64_t k, int64_t w, int64_t xcp,
                     int64_t xcs, int64_t ycp, int64_t ycs, int32_t* starts,
                     int32_t* ends) {
  bandr::B b{m + 1, n + 1, starts, ends};
  for (int64_t j = 0; j <= n; ++j) {
    starts[j] = (int32_t)(m + 1);
    ends[j] = 0;
  }
  if (np_ == 0) {  // no matches: full matrix (banded.py create_with_matches)
    for (int64_t j = 0; j <= n; ++j) {
      starts[j] = 0;
      ends[j] = (int32_t)(m + 1);
    }
    return;
  }
  bandr::set_boundaries(b, path_xy[0], path_xy[1], path_xy[2 * (np_ - 1)],
                        path_xy[2 * (np_ - 1) + 1], k, w, xcp, xcs, ycp,
                        ycs);
  int64_t pr = -1, pc = -1;
  bool have_prev = false;
  for (int64_t t = 0; t < np_; ++t) {
    int64_t r = path_xy[2 * t], c = path_xy[2 * t + 1];
    if (have_prev && r == pr + 1 && c == pc + 1) {
      bandr::add_entry(b, pr + k, pc + k, w);
    } else {
      if (have_prev) bandr::add_gap(b, pr + k - 1, pc + k - 1, r, c, w);
      bandr::add_kmer(b, r, c, k, w);
    }
    pr = r;
    pc = c;
    have_prev = true;
  }
}

// Batched band build for the device banded aligner: per pair, kmer
// matches -> sdpkpp chain -> path walk -> band raster (the exact same
// three routines the per-pair Python path calls), threaded over pairs.
// At mapper/bench batch sizes the per-pair ctypes round trips and Python
// path bookkeeping cost ~1 ms/pair; one batched call with a thread
// stripe costs ~30 us/pair.
//
// Batched band build with CROPPED outputs: xb (B, Mmax) row-major u8 +
// mlens (B,); yb (B, Nmax) + nlens (B,).  Full-width (B, Nmax + 1) band
// arrays would cost ~160 MB of allocation + writes per 1 K x 20 kb
// batch, so the band is rasterized into per-worker scratch and only the
// nonempty column window is emitted:
//   st_w/en_w: (B, wcap + 1) int32 — band rows for columns
//     [c0, c0 + nle], padded past the window with (m + 1, 0);
//   c0_out/nle_out: (B,) int64 — window origin and effective length
//     (the device column crop: c0 = max(j0 - 1, 0), nle = j1 - c0 + e
//     with e the final-column two-buffer parity fixup; crop = 0 emits
//     the whole [0, n] range); nle_out = -1 flags a window wider than
//     wcap (caller falls back for that pair);
//   cells: (B,) int64 band num_cells (MAX_CELLS host check);
//   jwin: (B, 2) int64 first/last nonempty band column (-1/-1 if none).
void band_build_batch(const uint8_t* xb, const int64_t* mlens,
                      int64_t Mmax, const uint8_t* yb,
                      const int64_t* nlens, int64_t Nmax, int64_t B,
                      int64_t k, int64_t w, int64_t xcp, int64_t xcs,
                      int64_t ycp, int64_t ycs, int64_t match_score,
                      int64_t go_neg, int64_t ge_neg, int64_t nthreads,
                      int64_t crop, int64_t wcap, int32_t* st_w,
                      int32_t* en_w, int64_t* c0_out, int64_t* nle_out,
                      int64_t* cells, int64_t* jwin) {
  if (nthreads <= 0) {
    nthreads = (int64_t)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
    if (nthreads > 32) nthreads = 32;
  }
  if (nthreads > B) nthreads = B > 0 ? B : 1;

  auto worker = [&](int64_t lo, int64_t hi) {
    std::vector<int64_t> mbuf(4096), xs, ys, dp_score, dp_prev, path_xy;
    std::vector<int32_t> stf(Nmax + 1), enf(Nmax + 1);
    for (int64_t b = lo; b < hi; ++b) {
      const uint8_t* x = xb + b * Mmax;
      const uint8_t* y = yb + b * Nmax;
      const int64_t m = mlens[b], n = nlens[b];
      int32_t* st = stf.data();
      int32_t* en = enf.data();
      std::fill(stf.begin(), stf.begin() + n + 1, (int32_t)(m + 1));
      std::fill(enf.begin(), enf.begin() + n + 1, 0);
      int64_t nm = kmer_matches_i64(x, m, y, n, k, mbuf.data(),
                                    (int64_t)mbuf.size() / 2);
      if (2 * nm > (int64_t)mbuf.size()) {
        mbuf.resize(2 * nm);
        nm = kmer_matches_i64(x, m, y, n, k, mbuf.data(), nm);
      }
      if (nm == 0) {  // full matrix (banded.rs:1309-1313)
        for (int64_t j = 0; j <= n; ++j) {
          st[j] = 0;
          en[j] = (int32_t)(m + 1);
        }
      } else {
        xs.resize(nm);
        ys.resize(nm);
        for (int64_t t = 0; t < nm; ++t) {
          xs[t] = mbuf[2 * t];
          ys[t] = mbuf[2 * t + 1];
        }
        dp_score.assign(nm, 0);
        dp_prev.assign(nm, 0);
        int64_t best[2];
        sdpkpp_i64(xs.data(), ys.data(), nm, k, match_score, go_neg,
                   ge_neg, dp_score.data(), dp_prev.data(), best);
        path_xy.clear();
        for (int64_t p = best[1]; p >= 0; p = dp_prev[p]) {
          path_xy.push_back(xs[p]);
          path_xy.push_back(ys[p]);
        }
        const int64_t np_ = (int64_t)path_xy.size() / 2;
        for (int64_t t = 0; t < np_ / 2; ++t) {
          std::swap(path_xy[2 * t], path_xy[2 * (np_ - 1 - t)]);
          std::swap(path_xy[2 * t + 1], path_xy[2 * (np_ - 1 - t) + 1]);
        }
        band_raster_i64(path_xy.data(), np_, m, n, k, w, xcp, xcs, ycp,
                        ycs, st, en);
      }
      int64_t c = 0, j0 = -1, j1 = -1;
      for (int64_t j = 0; j <= n; ++j) {
        if (en[j] > st[j]) {
          c += en[j] - st[j];
          if (j0 < 0) j0 = j;
          j1 = j;
        }
      }
      cells[b] = c;
      jwin[2 * b] = j0;
      jwin[2 * b + 1] = j1;
      // column-window crop + window emission
      int64_t c0 = 0, nle = n;
      if (crop && j0 >= 0) {
        c0 = j0 > 0 ? j0 - 1 : 0;
        int64_t tail = n - j1;
        int64_t e = tail == 0 ? 0 : (tail % 2 == 1 ? 1 : 2);
        nle = j1 - c0 + e;
      }
      c0_out[b] = c0;
      if (nle > wcap) {
        nle_out[b] = -1;  // window overflow: caller falls back
        continue;
      }
      nle_out[b] = nle;
      int32_t* sw = st_w + b * (wcap + 1);
      int32_t* ew = en_w + b * (wcap + 1);
      const int64_t win = std::min(nle, n - c0) + 1;
      for (int64_t j = 0; j < win; ++j) {
        sw[j] = st[c0 + j];
        ew[j] = en[c0 + j];
      }
      for (int64_t j = win; j <= wcap; ++j) {
        sw[j] = (int32_t)(m + 1);
        ew[j] = 0;
      }
    }
  };

  if (nthreads == 1) {
    worker(0, B);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  const int64_t step = (B + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * step, hi = std::min(B, lo + step);
    if (lo >= hi) break;
    pool.emplace_back(worker, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
