// K6 sweep_walk_semiglobal: the traceback walk of the semiglobal family
// over the traceback tensor of K5 or K12 (sw_warp.cu, the (N, X, B) view of
// a pair-major tensor) or a contiguous (N, X, B) tensor, read through its
// element strides. Replaces
// rust_bio_tpu/ops/walk_pallas.py sweep_walk_semiglobal ->
// _kernel_sweep_walk_semi.
//
// The walk's steps inside the suffix-fixed final column (j = nlens) are
// resolved before the launch, in plain torch (ops/walk.py
// resolve_fixed_column); this kernel starts from the state that leaves
// behind (row i1, column j1, carried layer ca1, use-s flag us1, done dn1).
// Output is the column-RLE form of the rest of the path, walked
// end -> start: per DP column j and pair, ins_cnt[j-1] Ins ops then one
// exit op exit_op[j-1] (TB_MATCH / TB_SUBST / TB_DEL / TB_YCLIP_PREFIX, 0
// where the pair never is); ins0, the Ins run left in column 0; and
// ystart, the column of the Yclip-prefix exit (at least ystart0, the
// prolog's own).
//
// Design: K2's (walk_global.cu). One thread per pair keeps the Pallas
// kernel's state machine and steps j = N..1 in lockstep with its warp, so
// the ins_cnt / exit_op stores of a warp are 64 contiguous bytes. Inside a
// column it follows an Ins run cell by cell, which gives the length the
// Pallas kernel reads from the 15-capped nibble plus its re-gather chain.
// A Yclip-prefix exit jumps to column 0 and keeps reading s-bits there: the
// pair emits the column-0 Ins run of its row.
//
// Bound on this card: per pair it reads the cells of its path (about
// M + N; on K5's and K12's views a column's cells are contiguous, so an
// Ins run shares sectors, on a contiguous (N, X, B) tensor each cell is a
// 32-byte sector of its own) and writes
// 2 * N uint16; each step waits on a dependent load, so it is
// latency-bound, as K2 is.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB_START = 0;
constexpr int TB_INS = 1;
constexpr int TB_DEL = 2;
constexpr int TB_SUBST = 3;
constexpr int TB_MATCH = 4;
constexpr int TB_YCLIP_PREFIX = 7;
constexpr int THREADS = 64;  // 8192 pairs -> 128 blocks: one per SM

__global__ void __launch_bounds__(THREADS) sweep_walk_semiglobal_kernel(
    const uint16_t* __restrict__ tb,  // (N, X, B) through the strides
    const int* __restrict__ i1, const int* __restrict__ j1,
    const int* __restrict__ ca1, const int* __restrict__ us1,
    const int* __restrict__ dn1, const int* __restrict__ ystart0, int B,
    int X, int N, long long sj, long long si, long long sb,
    uint16_t* __restrict__ ins_cnt,   // (N, B)
    uint16_t* __restrict__ exit_op,   // (N, B)
    uint16_t* __restrict__ ins0,      // (B,)
    int* __restrict__ ystart) {       // (B,)
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  int icur = i1[b];
  int jcur = j1[b];
  int carried = ca1[b];
  bool use_s = us1[b] != 0;
  bool done = dn1[b] != 0;
  int ys = ystart0[b];

  for (int j = N; j >= 1; --j) {
    int cnt = 0;
    int code = 0;
    if (jcur == j && !done) {
      const uint16_t* col = tb + (j - 1) * sj + b * sb;
      // cell (i, j), or -1 outside the column (as the Pallas row gather)
      auto cell = [&](int i) -> int {
        return (i >= 0 && i < X) ? static_cast<int>(col[i * si]) : -1;
      };
      const int g1 = cell(icur);
      const int entry = use_s ? (g1 >> 8) & 0xF : carried;
      int layer2;
      int db2;
      int i2;
      if (entry == TB_INS) {
        int m = 0;  // Ins i-bits run ending at row icur
        while ((cell(icur - m) & 0xF) == TB_INS) ++m;
        cnt = m + 1;
        layer2 = cell(icur - m) & 0xF;
        db2 = (cell(icur - m - 1) >> 4) & 0xF;
        i2 = icur - m - 1;
      } else {
        layer2 = entry;
        db2 = (g1 >> 4) & 0xF;
        i2 = icur;
      }
      const bool is_mm = layer2 == TB_MATCH || layer2 == TB_SUBST;
      const bool is_del = layer2 == TB_DEL;
      const bool is_ycp = layer2 == TB_YCLIP_PREFIX;
      if (is_mm || is_del || is_ycp) {
        code = layer2;
        icur = is_mm ? i2 - 1 : i2;
        jcur = is_ycp ? 0 : j - 1;
      }
      if (is_del) carried = db2;
      if (is_ycp) ys = max(ys, j);
      use_s = is_mm || is_ycp;
      if (layer2 == TB_START) done = true;
    }
    ins_cnt[static_cast<size_t>(j - 1) * B + b] = static_cast<uint16_t>(cnt);
    exit_op[static_cast<size_t>(j - 1) * B + b] = static_cast<uint16_t>(code);
  }
  // column 0 is the analytic init column: a live pair emits icur Ins
  ins0[b] = static_cast<uint16_t>(done ? 0 : icur);
  ystart[b] = ys;
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tb's element strides (column, row, pair): X * B, B, 1 for K5's
// contiguous tensor, 1 for rows in K12's pair-major view.
int sweep_walk_semiglobal(const void* tb, const void* i1, const void* j1,
                          const void* ca1, const void* us1, const void* dn1,
                          const void* ystart0, int B, int X, int N, long long sj,
                          long long si, long long sb, void* ins_cnt,
                          void* exit_op, void* ins0, void* ystart, void* stream) {
  sweep_walk_semiglobal_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(i1),
      static_cast<const int*>(j1), static_cast<const int*>(ca1),
      static_cast<const int*>(us1), static_cast<const int*>(dn1),
      static_cast<const int*>(ystart0), B, X, N, sj, si, sb,
      static_cast<uint16_t*>(ins_cnt), static_cast<uint16_t*>(exit_op),
      static_cast<uint16_t*>(ins0), static_cast<int*>(ystart));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
