// K13 sw_scan_global_rows: global affine-gap DP in blocks of rows, for long
// x. Replaces rust_bio_tpu/ops/sw_pallas.py scan_global_rows_pallas_mp ->
// _kernel_scan_global_rows_mp; sw_scan_global_rows_lut is the same kernel
// fed by a (256, 256) substitution LUT (the JAX package runs its XLA engine
// there).
//
// What it computes: K1's DP (csrc/sw_global.cu), the score and the
// traceback cells i_bits | d_bits << 4 | s_bits << 8, with no run nibble
// and, at the first row r * RB of every row block r >= 1, i-bits TB_INS
// where the extend candidate won, else TB_REREAD (9): "the s-bits of the
// cell above", which the segmented walk (csrc/walk_global_seg.cu) reads.
//
// Design: one thread a pair, 32 pairs a block, as K1. K1 keeps a whole
// column of S / D / s-bits in shared memory, 3 * (M+1) * 32 * 4 bytes, which
// leaves the 227 KB a block can have at M = 605; beyond it K1 moves the
// column into device memory and every cell's three loads and stores go
// through L1/L2. This kernel keeps RB rows of the column in shared memory
// instead and sweeps the row blocks in order, each over all columns
// j = 1..nlens. What block r hands block r + 1 per column sits in a
// (3, N, B) int32 device buffer, coalesced across a warp's 32 pairs: the
// boundary row's final S, its insertion score I and its S~ = max(m, D).
// The next block's first row reads them back as the TPU kernel's carried
// boundary: its diagonal is the boundary S of column j - 1, its insertion
// seed max(I + ge, S~ + go) (bndI), and its i-bits come from I + ge > S~ + go
// (bndE). Row 0 exists only in block 0; column 0 of a block is the init
// column restricted to its rows.
//
// RB: a wrapper argument (ops/sw.py, default 128). At 128 the three layers
// take 3 * 128 * 32 * 4 = 48 KB, exactly what a block gets without opting
// in, and 4 blocks fit an SM; the boundary costs 6 words a column per
// block, under 1/40 of a word a cell.
//
// Bound on this card: the tb stream, N * (M+1) * B uint16 (6.7 GB at
// 128 pairs of 5.1 kb: 2.0 ms at 3.35 TB/s), or the cells' integer
// operations; a warp stores 64 contiguous bytes per cell row. With one
// thread a pair the per-cell dependency chain bounds it instead: 128 pairs
// fill 4 warps of the card's 132 SMs. The redesign is a wavefront over the
// row blocks of one pair (block r + 1 trails block r by a column), which is
// what the TPU's carried boundary maps to; left for a later change.
//
// Exactness as K1 (sw_global.cu:40-46): int32 arithmetic wraps, D and the
// row-0 match value start at MIN_SCORE = -858993459, strict '>' with
// priority Match/Subst > Ins > Del, the I-open candidate uses S~, and the
// Match/Subst bit is byte equality under either substitution source.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB_START = 0;
constexpr int TB_INS = 1;
constexpr int TB_DEL = 2;
constexpr int TB_SUBST = 3;
constexpr int TB_REREAD = 9;
constexpr int MIN_I32 = -858993459;  // reference MIN_SCORE
constexpr int NEG = -(1 << 30);      // final-reduction sentinel
constexpr int PAIRS = 32;            // pairs (threads) per block

// int32 add / multiply that wrap like XLA's (signed overflow is UB in C++)
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// S of DP cell (i, 0): the init column
__device__ __forceinline__ int init_s(int i, int go, int ge) {
  return i == 0 ? 0 : add(go, mul(ge, i - 1));
}

// Substitution sources: the score of DP cell (x_i, y_j) from their bytes.
struct MatchParams {
  int ma, mi;
  __device__ __forceinline__ int score(int x, int y) const { return x == y ? ma : mi; }
};
struct Lut {
  const int* __restrict__ lut;  // (256, 256) int32, row x
  __device__ __forceinline__ int score(int x, int y) const { return __ldg(lut + (x << 8) + y); }
};

template <class Subst>
__global__ void __launch_bounds__(PAIRS) scan_global_rows_kernel(
    const uint8_t* __restrict__ xt,  // (M, B)
    const uint8_t* __restrict__ yt,  // (N, B)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M,
    int N, int rb, int go, int ge, Subst sub,
    int* __restrict__ score,     // (B,)
    uint16_t* __restrict__ tb,   // (N, M + 1, B)
    int* __restrict__ bnd) {     // (3, N, B): boundary S, I, S~ per column
  const int b = blockIdx.x * PAIRS + threadIdx.x;
  if (b >= B) return;
  extern __shared__ int smem[];
  // row t of the block's layer: S[t * PAIRS] (conflict-free across a warp)
  int* S = smem + threadIdx.x;
  int* D = S + rb * PAIRS;
  int* SB = D + rb * PAIRS;
  const int ml = mlens[b];
  const int nl = nlens[b];
  const size_t rows = static_cast<size_t>(M) + 1;
  const size_t layer = static_cast<size_t>(N) * B;
  int* bS = bnd + b;
  int* bI = bS + layer;
  int* bT = bI + layer;
  int result = NEG;

  for (int lo = 0; lo <= ml; lo += rb) {
    const int hi = min(lo + rb - 1, ml);
    const bool carry_out = lo + rb <= ml;  // a later block reads this one
    for (int i = lo; i <= hi; ++i) {
      const int t = (i - lo) * PAIRS;
      S[t] = init_s(i, go, ge);
      D[t] = MIN_I32;
      SB[t] = i == 0 ? TB_START : TB_INS;
    }
    // S of the boundary row lo - 1 at column j - 1 (the first row's diagonal)
    int s_diag = lo == 0 ? 0 : init_s(lo - 1, go, ge);

    for (int j = 1; j <= nl; ++j) {
      const int yj = yt[static_cast<size_t>(j - 1) * B + b];
      const size_t e = static_cast<size_t>(j - 1) * B;
      uint16_t* tbcol = tb + static_cast<size_t>(j - 1) * rows * B + b;
      // row i - 1 of this column: S at column j - 1, S~, I, s-bits
      int s_up_old, st_up, bi_up, sbits_up;
      int i = lo;
      if (lo == 0) {  // row 0: delete the first j symbols of y
        const int dj0 = add(go, mul(ge, j - 1));
        tbcol[0] = static_cast<uint16_t>(TB_START | ((j == 1 ? TB_START : TB_DEL) << 4) | (TB_DEL << 8));
        s_up_old = S[0];
        st_up = dj0;
        bi_up = MIN_I32;
        sbits_up = TB_DEL;
        S[0] = dj0;
        D[0] = dj0;
        SB[0] = TB_DEL;
        i = 1;
      } else {  // the boundary block r - 1 left at this column
        s_up_old = s_diag;
        s_diag = bS[e];
        bi_up = bI[e];
        st_up = bT[e];
        sbits_up = TB_REREAD;
      }
      for (; i <= hi; ++i) {
        const int t = (i - lo) * PAIRS;
        const int sp = S[t];
        const int dp = D[t];
        const int sbp = SB[t];
        const int xi = xt[static_cast<size_t>(i - 1) * B + b];
        const int m_val = add(s_up_old, sub.score(xi, yj));
        const int d_ext = add(dp, ge);
        const int d_open = add(sp, go);
        const bool d_wins = d_ext > d_open;
        const int best_d = d_wins ? d_ext : d_open;
        const int d_bits = d_wins ? TB_DEL : sbp;
        const int t_open = add(st_up, go);
        const int i_ext = add(bi_up, ge);
        const int best_i = max(i_ext, t_open);
        const int i_bits = i_ext > t_open ? TB_INS : sbits_up;
        int s_col = m_val;
        int s_bits = TB_SUBST + (xi == yj);  // TB_MATCH = TB_SUBST + 1
        if (best_i > s_col) {
          s_col = best_i;
          s_bits = TB_INS;
        }
        if (best_d > s_col) {
          s_col = best_d;
          s_bits = TB_DEL;
        }
        tbcol[static_cast<size_t>(i) * B] = static_cast<uint16_t>(i_bits | (d_bits << 4) | (s_bits << 8));
        s_up_old = sp;
        st_up = max(m_val, best_d);
        bi_up = best_i;
        sbits_up = s_bits;
        S[t] = s_col;
        D[t] = best_d;
        SB[t] = s_bits;
      }
      if (carry_out) {  // row hi = lo + rb - 1 is the next block's boundary
        bS[e] = S[(hi - lo) * PAIRS];
        bI[e] = bi_up;
        bT[e] = st_up;
      }
    }
    if (hi == ml) result = max(S[(ml - lo) * PAIRS], NEG);
  }
  score[b] = result;
}

template <class Kernel>
int set_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <class Subst>
int launch(const void* xt, const void* yt, const void* mlens, const void* nlens,
           int B, int M, int N, int rb, int go, int ge, Subst sub, void* score,
           void* tb, void* bnd, void* stream) {
  const size_t smem = static_cast<size_t>(3) * rb * PAIRS * sizeof(int);
  int rc = set_smem(scan_global_rows_kernel<Subst>, smem);
  if (rc) return rc;
  scan_global_rows_kernel<Subst><<<(B + PAIRS - 1) / PAIRS, PAIRS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xt), static_cast<const uint8_t*>(yt),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, N,
      rb, go, ge, sub, static_cast<int*>(score), static_cast<uint16_t*>(tb),
      static_cast<int*>(bnd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K13. bnd: a (3, max(N, 1), B) int32 scratch; rb rows a block, 1..605.
int sw_scan_global_rows(const void* xt, const void* yt, const void* mlens,
                        const void* nlens, int B, int M, int N, int rb, int go,
                        int ge, int ma, int mi, void* score, void* tb,
                        void* bnd, void* stream) {
  return launch(xt, yt, mlens, nlens, B, M, N, rb, go, ge, MatchParams{ma, mi},
                score, tb, bnd, stream);
}

// K13 fed by the LUT. lut: (256, 256) int32 on the device.
int sw_scan_global_rows_lut(const void* xt, const void* yt, const void* mlens,
                            const void* nlens, int B, int M, int N, int rb,
                            int go, int ge, const void* lut, void* score,
                            void* tb, void* bnd, void* stream) {
  return launch(xt, yt, mlens, nlens, B, M, N, rb, go, ge,
                Lut{static_cast<const int*>(lut)}, score, tb, bnd, stream);
}

}  // extern "C"
