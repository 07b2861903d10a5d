// K14 sweep_walk_global_seg: the global-mode traceback walk over the
// traceback tensor of K13 (csrc/sw_global_rows.cu). Replaces
// rust_bio_tpu/ops/walk_pallas.py _sweep_walk_global_seg ->
// _make_seg_walk_kernel.
//
// Layouts: it reads the cell of DP cell (i, j) of pair b at
// tb[(j - 1) * sj + i * si + b * sb], element strides it is given: K13's
// pair-major (B, N, Xp) tensor (sj = Xp, si = 1, sb = N * Xp), or a
// contiguous (N, X, B) one (sj = X * B, si = B, sb = 1), as K1's and the
// plain versions' are; ops/walk.py takes those two and raises on others.
//
// Output is K2's (csrc/walk_global.cu): per DP column j and pair,
// ins_cnt[j-1] Ins ops then one exit op exit_op[j-1] (TB_MATCH / TB_SUBST /
// TB_DEL, 0 where the pair never is), walking end -> start, and ins0, the
// Ins run left in column 0.
//
// K13's cells carry no run nibble, and at the first row of each row block
// an i-layer pointer may read TB_REREAD: "the s-bits of the cell above".
// The TPU kernel resolves both over whole column segments (a cummax of the
// rows that break an Ins chain, two passes a column). Design here: K2's
// state machine, one thread a pair in lockstep over the columns j = N..1
// (a warp's ins_cnt / exit_op stores are 64 contiguous bytes); inside a
// column the thread walks its Ins run up cell by cell (contiguous addresses
// in the pair-major layout), resolving each
// i-layer from the cell itself or, where it reads TB_REREAD, from the cell
// above. The exit is read at the row that breaks the chain, with the
// d-bits of the cell above it, as in K2.
//
// Bound on this card: per pair it reads the cells of its path (about
// M + N of them, scattered: one 32-byte sector each) and writes 2 * N
// uint16; with one thread a pair and a dependent read a step it is
// latency-bound (a 4.8 kb insertion is 4,800 dependent loads).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB_START = 0;
constexpr int TB_INS = 1;
constexpr int TB_DEL = 2;
constexpr int TB_SUBST = 3;
constexpr int TB_MATCH = 4;
constexpr int TB_REREAD = 9;
constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS) sweep_walk_global_seg_kernel(
    const uint16_t* __restrict__ tb,  // (N, X, B) through the strides
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int X,
    int N, long long sj, long long si, long long sb,
    uint16_t* __restrict__ ins_cnt,   // (N, B)
    uint16_t* __restrict__ exit_op,   // (N, B)
    uint16_t* __restrict__ ins0) {    // (B,)
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  int icur = mlens[b];
  int jcur = nlens[b];
  int carried = TB_START;
  bool use_s = true;
  bool done = false;

  for (int j = N; j >= 1; --j) {
    int cnt = 0;
    int code = 0;
    if (jcur == j && !done) {
      const uint16_t* col = tb + (j - 1) * sj + b * sb;
      // cell (i, j), or -1 outside the column
      auto cell = [&](int i) -> int {
        return (i >= 0 && i < X) ? static_cast<int>(col[i * si]) : -1;
      };
      // the i-layer of cell i, TB_REREAD resolved to the s-bits above
      auto layer = [&](int i) -> int {
        const int ib = cell(i) & 0xF;
        return ib == TB_REREAD ? (cell(i - 1) >> 8) & 0xF : ib;
      };
      const int g1 = cell(icur);
      const int entry = use_s ? (g1 >> 8) & 0xF : carried;
      int layer2;
      int db2;
      int i2;
      if (entry == TB_INS) {
        int m = 0;  // Ins run ending at row icur
        while (layer(icur - m) == TB_INS) ++m;
        cnt = m + 1;
        layer2 = layer(icur - m);
        db2 = (cell(icur - m - 1) >> 4) & 0xF;
        i2 = icur - m - 1;
      } else {
        layer2 = entry;
        db2 = (g1 >> 4) & 0xF;
        i2 = icur;
      }
      const bool is_mm = layer2 == TB_MATCH || layer2 == TB_SUBST;
      const bool is_del = layer2 == TB_DEL;
      if (is_mm || is_del) {
        code = layer2;
        icur = is_mm ? i2 - 1 : i2;
        jcur = j - 1;
      }
      if (is_del) carried = db2;
      use_s = is_mm;
      if (layer2 == TB_START) done = true;
    }
    ins_cnt[static_cast<size_t>(j - 1) * B + b] = static_cast<uint16_t>(cnt);
    exit_op[static_cast<size_t>(j - 1) * B + b] = static_cast<uint16_t>(code);
  }
  // column 0 is the analytic init column: a live pair emits icur Ins
  ins0[b] = static_cast<uint16_t>(done ? 0 : icur);
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tb's element strides: sj between columns, si between rows, sb between pairs
int sweep_walk_global_seg(const void* tb, const void* mlens, const void* nlens,
                          int B, int X, int N, long long sj, long long si,
                          long long sb, void* ins_cnt, void* exit_op, void* ins0,
                          void* stream) {
  sweep_walk_global_seg_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(mlens),
      static_cast<const int*>(nlens), B, X, N, sj, si, sb, static_cast<uint16_t*>(ins_cnt),
      static_cast<uint16_t*>(exit_op), static_cast<uint16_t*>(ins0));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
