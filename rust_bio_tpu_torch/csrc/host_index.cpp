// Host index build and CIGAR emitter of the port (its own copy of what
// rust_bio_tpu's native/biotpu.cpp gives the FM index and the delivered
// CIGARs):
//
//   sais_u8_i32, sais_u8_i64, sais_u8_u32, sais_i64
//                  O(n) SA-IS suffix arrays (sais.hpp), dispatched on the
//                  text's symbol type and the SA's index type as the
//                  reference dispatches by length (suffix_array.rs:270-281)
//   cigars_colrle  the column-RLE walk streams of a batch -> CIGAR strings,
//                  threaded over lanes
//
// Built at first use by rust_bio_tpu_torch/native.py together with
// band_build.cpp (c++ -O3 -std=c++17 -shared -fPIC -pthread); plain C entry
// points for ctypes.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

#include "sais.hpp"

extern "C" {

// Suffix array of an int64 text over alphabet [0, K). SA must hold n entries.
void sais_i64(const int64_t* text, int64_t n, int64_t K, int64_t* sa) {
  sais::sais_core(text, sa, n, K);
}

// u8 text, i32 SA (n < 2^31): about 7 bytes a symbol in all.
void sais_u8_i32(const uint8_t* text, int32_t n, int32_t K, int32_t* sa) {
  sais::sais_core(text, sa, n, K);
}

void sais_u8_i64(const uint8_t* text, int64_t n, int64_t K, int64_t* sa) {
  sais::sais_core(text, sa, n, K);
}

// 2^31 <= n < 2^32 (a human genome): u32 SA storage at the top level, i32
// recursion (sais.hpp sais_top_u8_u32).
void sais_u8_u32(const uint8_t* text, int64_t n, int64_t K, uint32_t* sa) {
  sais::sais_top_u8_u32(text, sa, n, K);
}

// Column-RLE -> CIGAR strings for a whole batch (the delivered-CIGAR path
// of the semiglobal and global packs): per lane the walk emits one [exit
// op][Ins run] group per DP column, plus a leading Ins run and the fixed
// column's group.
//
// ex/cnt: (B, N) row-major uint16 per-column exit codes / Ins runs;
// out: (B, cap) char buffer, out_len: (B,) int32 string lengths (-1 where
// the row's string does not fit cap). Codes 1..4 map to I D X =; anything
// else (Start, clips) is dropped WITHOUT breaking a run, as the numpy
// merge (batched.py PackedSemiglobal.cigars) drops it. Soft clips: xstart
// > 0 prepends "{xstart}S", mlen > xend appends "{mlen - xend}S".
void cigars_colrle(const uint16_t* ex, const uint16_t* cnt, int64_t B,
                   int64_t N, const int32_t* nlens, const int32_t* mlens,
                   const int32_t* ins0, const int32_t* fix_exit,
                   const int32_t* fix_ins, const int32_t* xstart,
                   const int32_t* xend, int64_t cap, char* out,
                   int32_t* out_len, int64_t nthreads) {
  static const char OPCH[5] = {'?', 'I', 'D', 'X', '='};
  if (nthreads <= 0) {
    nthreads = (int64_t)std::thread::hardware_concurrency();
    if (nthreads <= 0) nthreads = 1;
    if (nthreads > 32) nthreads = 32;
  }
  if (nthreads > B) nthreads = B > 0 ? B : 1;

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      char* p = out + b * cap;
      char* end = p + cap;
      bool ovf = false;
      auto put_num = [&](int64_t v) {
        char tmp[20];
        int t = 0;
        do {
          tmp[t++] = '0' + (int)(v % 10);
          v /= 10;
        } while (v);
        if (p + t >= end) {
          ovf = true;
          return;
        }
        while (t) *p++ = tmp[--t];
      };
      int cur_kind = -1;
      int64_t cur_len = 0;
      auto flush = [&]() {
        if (cur_len > 0 && !ovf) {
          put_num(cur_len);
          if (p < end) *p++ = OPCH[cur_kind];
          else ovf = true;
        }
        cur_len = 0;
        cur_kind = -1;
      };
      auto push = [&](int kind, int64_t len) {
        if (kind < 1 || kind > 4 || len <= 0) return;  // drop, keep run
        if (kind == cur_kind) {
          cur_len += len;
        } else {
          flush();
          cur_kind = kind;
          cur_len = len;
        }
      };
      if (xstart[b] > 0) {
        put_num(xstart[b]);
        if (p < end) *p++ = 'S';
        else ovf = true;
      }
      push(1, ins0[b]);
      const uint16_t* exr = ex + b * N;
      const uint16_t* cnr = cnt + b * N;
      const int64_t nl = nlens[b];
      for (int64_t j = 0; j < nl; ++j) {
        push(exr[j], 1);
        push(1, cnr[j]);
      }
      push(fix_exit[b], 1);
      push(1, fix_ins[b]);
      flush();
      if (mlens[b] > xend[b]) {
        put_num(mlens[b] - xend[b]);
        if (p < end) *p++ = 'S';
        else ovf = true;
      }
      out_len[b] = ovf ? -1 : (int32_t)(p - (out + b * cap));
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
