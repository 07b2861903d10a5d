// K1 sw_scan_global, the global affine-gap DP with its traceback (K11, K1
// fed by a LUT, is csrc/sw_warp.cu's; K3, the score only, is
// csrc/sw_warp.cu's sw_scores_global_warp at short x and
// csrc/sw_global_rows.cu's sw_scores_global_rows at long x):
//
//   K1  sw_scan_global       replaces rust_bio_tpu/ops/sw_pallas.py
//                            scan_global_pallas_mp -> _kernel_scan_global_mp
//                            (runs="ins"): score, 12-bit traceback cells plus
//                            the vertical insertion-run nibble, and the cells
//                            frozen at j = nlens (tbk).
//
// Design: one thread per pair walks DP columns j = 1..nlens and rows
// i = 0..mlens in order, so the insertion score is a scalar carry: as the
// TPU kernels' (max,+) prefix scan computes it, I[i] = P[i] + i * ge with
// P[i] = max(P[i-1], T[i] - i * ge), T[i] = S~[i-1] + go, in wrapping int32
// (equal to the recurrence max(I[i-1] + ge, T[i]) until a sum wraps). The previous
// column's S / D / s-bits live in shared memory laid out [row][pair], 32
// pairs per block, so a warp's accesses are conflict-free; columns longer
// than the shared-memory budget use a (layers, M+1, B) scratch in device
// memory instead. Sequences arrive transposed ((M, B), (N, B)) so a warp
// reads one 32-byte line per row. The substitution score is ma or mi by
// byte equality (MatchParams), as the Match/Subst bit.
//
// Bound on this card: K1 writes N * (M+1) * B uint16 cells (371 MB at
// 8192 x 150 x 150): a warp stores 64 contiguous bytes per cell row, so the
// stream is coalesced; the per-cell dependency chain (about 25 integer ops
// per cell, one thread per pair) makes it latency-bound at 8192
// pairs (2 warps per SM), which the design accepts for a first version.
//
// Exactness (sw_pallas.py:597-721): int32 arithmetic wraps as in XLA; D
// and the row-0 match value start at MIN_SCORE = -858993459; every
// selection is a strict '>' with priority Match/Subst > Ins > Del; the
// I-open candidate uses S~ = max(m, D), not S; an I-cell whose extend does
// not strictly win points at the s-bits of the cell above in the same
// column.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB_START = 0;
constexpr int TB_INS = 1;
constexpr int TB_DEL = 2;
constexpr int TB_SUBST = 3;
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
__device__ __forceinline__ int minus(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Column state of this thread's pair: row i of layer k is at
// base[(k * rows + i) * stride].
struct Column {
  int* base;
  size_t stride;
  size_t layer;  // rows * stride
  __device__ int& at(int k, int i) const {
    return base[k * layer + static_cast<size_t>(i) * stride];
  }
};

// The score of DP cell (x_i, y_j) from their bytes.
struct MatchParams {
  int ma, mi;
  __device__ __forceinline__ int score(int x, int y) const { return x == y ? ma : mi; }
};

__device__ __forceinline__ Column column_state(int* scratch, int B, int rows,
                                               int b) {
  extern __shared__ int smem[];
  Column c;
  c.stride = scratch ? static_cast<size_t>(B) : static_cast<size_t>(PAIRS);
  c.base = scratch ? scratch + b : smem + threadIdx.x;
  c.layer = static_cast<size_t>(rows) * c.stride;
  return c;
}

__global__ void __launch_bounds__(PAIRS) scan_global_kernel(
    const uint8_t* __restrict__ xt,  // (M, B)
    const uint8_t* __restrict__ yt,  // (N, B)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M,
    int go, int ge, MatchParams sub,
    int* __restrict__ score,      // (B,)
    uint16_t* __restrict__ tb,    // (N, M + 1, B)
    int* __restrict__ tbk,        // (B, M + 1)
    int* __restrict__ scratch) {  // (3, M + 1, B) or null
  const int b = blockIdx.x * PAIRS + threadIdx.x;
  if (b >= B) return;
  const int rows = M + 1;
  const Column st = column_state(scratch, B, rows, b);
  const int ml = mlens[b];
  const int nl = nlens[b];
  int* tbk_b = tbk + static_cast<size_t>(b) * rows;

  // column 0: S[i] = go + ge*(i-1), s-bits Ins (i >= 1); i-bits Start at i <= 1
  for (int i = 0; i <= ml; ++i) {
    st.at(0, i) = i == 0 ? 0 : add(go, mul(ge, i - 1));
    st.at(1, i) = MIN_I32;
    st.at(2, i) = i == 0 ? TB_START : TB_INS;
    if (nl == 0)
      tbk_b[i] = (i <= 1 ? TB_START : TB_INS) | ((i == 0 ? TB_START : TB_INS) << 8);
  }

  for (int j = 1; j <= nl; ++j) {
    const bool last = j == nl;
    const int yj = yt[static_cast<size_t>(j - 1) * B + b];
    const int dj0 = add(go, mul(ge, j - 1));
    uint16_t* tbcol = tb + static_cast<size_t>(j - 1) * rows * B + b;

    // row 0: delete the first j symbols of y
    const int cell0 = TB_START | ((j == 1 ? TB_START : TB_DEL) << 4) | (TB_DEL << 8);
    tbcol[0] = static_cast<uint16_t>(cell0);
    int s_up_old = st.at(0, 0);  // previous column's S, row i - 1
    int st_up = dj0;             // this column's S~ = max(m, D), row i - 1
    int p_up = MIN_I32;          // this column's P, row i - 1
    int rge = 0;                 // i * ge
    int sbits_up = TB_DEL;       // this column's s-bits, row i - 1
    int run = 0;                 // Ins i-bits run ending at row i - 1
    st.at(0, 0) = dj0;
    st.at(1, 0) = dj0;
    st.at(2, 0) = TB_DEL;
    if (last) tbk_b[0] = cell0;

    for (int i = 1; i <= ml; ++i) {
      const int sp = st.at(0, i);
      const int dp = st.at(1, i);
      const int sbp = st.at(2, i);
      const int xi = xt[static_cast<size_t>(i - 1) * B + b];
      const int eq = xi == yj;
      const int m_val = add(s_up_old, sub.score(xi, yj));
      const int d_ext = add(dp, ge);
      const int d_open = add(sp, go);
      const bool d_wins = d_ext > d_open;
      const int best_d = d_wins ? d_ext : d_open;
      const int d_bits = d_wins ? TB_DEL : sbp;
      rge = add(rge, ge);
      const int t_open = add(st_up, go);
      const int i_ext = add(p_up, rge);  // I[i-1] + ge
      const int p = max(p_up, minus(t_open, rge));
      const int best_i = add(p, rge);
      const int i_bits = i_ext > t_open ? TB_INS : sbits_up;
      int s_col = m_val;
      int s_bits = TB_SUBST + eq;  // TB_MATCH = TB_SUBST + 1
      if (best_i > s_col) {
        s_col = best_i;
        s_bits = TB_INS;
      }
      if (best_d > s_col) {
        s_col = best_d;
        s_bits = TB_DEL;
      }
      run = i_bits == TB_INS ? run + 1 : 0;
      const int cell = i_bits | (d_bits << 4) | (s_bits << 8) | (min(run, 15) << 12);
      tbcol[static_cast<size_t>(i) * B] = static_cast<uint16_t>(cell);
      s_up_old = sp;
      st_up = max(m_val, best_d);
      p_up = p;
      sbits_up = s_bits;
      st.at(0, i) = s_col;
      st.at(1, i) = best_d;
      st.at(2, i) = s_bits;
      if (last) tbk_b[i] = cell;
    }
  }
  score[b] = max(st.at(0, ml), NEG);
}

template <class Kernel>
int set_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// scratch: null to keep the column state in shared memory
// (3 * (M+1) * 32 * 4 bytes per block), else a (3, M+1, B) int32 buffer.
int launch_scan(const void* xt, const void* yt, const void* mlens,
                const void* nlens, int B, int M, int go, int ge, MatchParams sub,
                void* score, void* tb, void* tbk, void* scratch, void* stream) {
  const size_t smem = scratch ? 0 : static_cast<size_t>(3) * (M + 1) * PAIRS * sizeof(int);
  int rc = set_smem(scan_global_kernel, smem);
  if (rc) return rc;
  scan_global_kernel<<<(B + PAIRS - 1) / PAIRS, PAIRS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xt), static_cast<const uint8_t*>(yt),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, go,
      ge, sub, static_cast<int*>(score), static_cast<uint16_t*>(tb),
      static_cast<int*>(tbk), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.
int sw_scan_global(const void* xt, const void* yt, const void* mlens,
                   const void* nlens, int B, int M, int go, int ge, int ma,
                   int mi, void* score, void* tb, void* tbk, void* scratch,
                   void* stream) {
  return launch_scan(xt, yt, mlens, nlens, B, M, go, ge, MatchParams{ma, mi},
                     score, tb, tbk, scratch, stream);
}

}  // extern "C"
