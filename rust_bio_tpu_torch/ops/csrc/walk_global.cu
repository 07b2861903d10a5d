// K2 sweep_walk_global: global-mode traceback walk over the traceback tensor
// of K1 or K11 (sw_warp.cu). Replaces
// rust_bio_tpu/ops/walk_pallas.py sweep_walk_global ->
// _kernel_sweep_walk_global.
//
// Layouts: it reads the cell of DP cell (i, j) of pair b at
// tb[(j - 1) * sj + i * si + b * sb], element strides it is given: a
// contiguous (N, X, B) tensor (sj = X * B, si = B, sb = 1), as the plain
// versions', or K1's and K11's pair-major (B, N, Xp) one (sj = Xp, si = 1,
// sb = N * Xp), read in place; ops/walk.py takes those two and raises on
// others.
//
// Output is the column-RLE form of the path, walked end -> start: per DP
// column j and pair, ins_cnt[j-1] Ins ops then one exit op
// exit_op[j-1] (TB_MATCH / TB_SUBST / TB_DEL, 0 where the pair never is),
// and ins0, the Ins run left in column 0.
//
// Design: one thread per pair keeps the Pallas kernel's state machine
// (icur, jcur, carried, use_s, done) and steps j = N..1 in lockstep with
// its warp, so the ins_cnt / exit_op stores of a warp are 64 contiguous
// bytes. Inside a column the thread reads its own cells (contiguous
// addresses in the pair-major layout): the TPU kernel
// reads the capped run nibble (bits 12-15) and re-gathers runs of 15 or
// more; a thread instead follows an Ins run cell by cell, which gives the
// same run length.
//
// Bound on this card: per pair it reads the cells of its path (about
// M + N of them, scattered: one 32-byte sector each) and writes 2 * N
// uint16; with one thread per pair and a dependent read per step it is
// latency-bound, not bandwidth-bound.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB_START = 0;
constexpr int TB_INS = 1;
constexpr int TB_DEL = 2;
constexpr int TB_SUBST = 3;
constexpr int TB_MATCH = 4;
constexpr int THREADS = 64;  // 8192 pairs -> 128 blocks: one per SM

__global__ void __launch_bounds__(THREADS) sweep_walk_global_kernel(
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

int sweep_walk_global(const void* tb, const void* mlens, const void* nlens,
                      int B, int X, int N, long long sj, long long si,
                      long long sb, void* ins_cnt, void* exit_op, void* ins0,
                      void* stream) {
  sweep_walk_global_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(mlens),
      static_cast<const int*>(nlens), B, X, N, sj, si, sb, static_cast<uint16_t*>(ins_cnt),
      static_cast<uint16_t*>(exit_op), static_cast<uint16_t*>(ins0));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
