// K13 sw_scan_global_rows and K13-LUT sw_scan_global_rows_lut: the global
// affine-gap DP of long x, as a row-stripe wavefront over one pair a block;
// and K3's launch at long x, sw_scores_global_rows, the score only.
//
// Replaces rust_bio_tpu/ops/sw_pallas.py:2260 _kernel_scan_global_rows_mp
// (scan_global_rows_pallas_mp :2434) and, under a LUT, the XLA engine
// batched.py:948 _align_batch_device, which the JAX package runs there;
// K3's launch replaces :199 _kernel_mp (sw_scores_global_matchparams :258)
// where ops/sw.py scores_route picks it.
//
// What it computes: K1's DP (csrc/sw_warp.cu): S; D, the deletion score
// carried along a row; I, the insertion score carried down a column; S~ =
// max(m, D), the I-open candidate; the score, S at (mlens, nlens) clamped
// at NEG; and the traceback cells i_bits | d_bits << 4 | s_bits << 8 of
// columns j = 1..nlens and rows i = 0..mlens, with no run nibble. Row 0 (the
// delete row) and column 0 (the init column) are closed forms; column 0 has
// no cells in tb.
//
// Seams: the rows i = r * rb (r >= 1) are where the JAX kernel's row blocks
// meet. There the i-bits read TB_REREAD (9, "the s-bits of the cell above")
// where the open candidate wins (i_ext > t_open false), and TB_INS where the
// extend candidate wins; every other bit is what it is with no seam, since
// the JAX kernel's carried boundary holds the same S, I and S~. The
// segmented walk (csrc/walk_global_seg.cu) resolves them. rb: 1..605.
//
// Traceback layout: pair-major, the cell of DP cell (i, j) of pair b at
// tb[(b * N + j - 1) * Xp + i], for a row pitch Xp >= M + 1 that is a
// multiple of 8 (ops/sw.py returns the (N, M+1, B) view of it, which K14
// reads through its strides). A null tb skips the cells (score-only).
//
// Bound on this card: the tb's 2 bytes a cell (6.7 GB at 128 pairs of
// 5.1 kb: 2.0 ms at 3.35 TB/s) or the cells' 26 integer operations (2.6 ms
// there), the larger. The one-thread-a-pair kernel before this one walked
// a pair's 26 M cells in order, 4 warps on the card's 132 SMs, at
// 920-2,060x that bound (PERF.md).
//
// Design: one block per pair, in the shape of csrc/sw_columns.cu. Thread t
// of T owns the stripe of R rows [t * R, t * R + R) (row 0 in thread 0) and
// the block sweeps the columns as a skewed wavefront: at step s thread t
// computes column j = s - t, for 1 <= j <= nlens, so a pair takes nlens +
// ceil((mlens + 1) / R) - 1 steps, one __syncthreads() each; stripes past
// row mlens only meet the barrier. Down a column, thread t hands thread
// t + 1 four words of its last row through a double-buffered shared slot
// [2][4][T], written at step s into buffer s & 1 and read at step s + 1: S,
// which one step later is the next stripe's diagonal and is kept in a
// register; P (the insertion chain, below); S~; the s-bits. Along a row,
// S, D and the s-bits stay with the row's owner: three int32 layers
// [3][R][T], lane innermost (a warp's accesses are conflict-free), in
// shared memory up to ROWS_SHARED_MAX_M of ops/sw.py, else in the block's
// own slice of a (B, 3, R, T) device
// scratch. The stripe's x bytes are staged in shared memory once; y_j is
// read a step ahead. R is a multiple of 8: a thread computes its rows 8 at
// a time and stores their cells with one 16-byte store, so a stripe's cells
// of a column are 2R contiguous, aligned bytes, and thread t + 1 writes the
// next 2R a step later. The thread that holds row mlens stops after the
// group of 8 that holds it (its other rows are outside the defined region).
//
// Geometry (ops/sw.py rows_geometry, which the wrapper uses to size the
// scratch, computes the same): R = 8 * ceil((M + 1) / (8 * 256)),
// T = ceil((M + 1) / R) rounded up to a multiple of 32; at M = 5,588,
// R = 24 and T = 256, 88,064 bytes of shared memory. Why 256: the tb's
// cost falls as a thread's 2R-byte pieces grow, its compute rises as the
// threads get fewer; on an H100, 128 STR pairs of 5.6 kb took 13.6 ms at
// 256 stripes (R = 24), 15.5 at 512 (R = 16), 20.1 at 1,024 (R = 8), 12.5
// at 128 (R = 48), and 64 long proteins 12.2, 13.3, 10.4 and 19.3 ms
// (scripts/rows_trial.py, PERF.md). The substitution source is a template
// parameter: MatchParams, or a (256, 256) LUT read through the read-only
// path; the Match/Subst bit is byte equality under either.
//
// Exactness as K1 (sw_warp.cu): int32 arithmetic wraps, D starts at
// MIN_I32 = -858993459, strict '>' with priority Match/Subst > Ins > Del,
// the I-open candidate uses S~. The insertion chain is the JAX kernel's: in
// each seam-to-seam block of rows, a prefix maximum P of T[i] - k * ge over
// the block's rows (k counted from the block's first row), seeded by that
// row and floored at NEG (the fill of its scan), I = P + k * ge; the first
// row's I is NEG in the first block, else max(I[i-1] + ge, T[i], NEG), the
// boundary value the block above hands down. A stripe hands P down. Equal
// to K1's chain while no sum wraps int32.
//
// K3 at long x (scores_global_rows_kernel): this wavefront without tb or
// s-bits, two int32 layers a row (S, D; [2][R][T] in shared memory up to
// ops/sw.py SCORES_ROWS_SHARED_MAX_M, 24,575, else a (B, 2, R, T) scratch)
// and three carries (S, P, S~), with K3's chain and sentinels, not K13's:
// D and row 0 at NEG = -2^30, one prefix maximum P of T[i] - i * ge from
// row 0 down the whole column (no seams, no floor beyond row 0's NEG),
// I = P + i * ge, and the score max(S[mlens], NEG), as sw_pallas.py
// _kernel_mp and csrc/sw_warp.cu's K18. K13's chain parts from it where
// int32 wraps, so K13's score-only launch is not K3. Bound: about 14
// integer operations a cell (1.38 ms for phase 3d's 128 STR pairs, 31 M
// cells a pair); the one-thread kernel before it took 5.35 s there (4
// warps on 132 SMs).

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
constexpr int T_STRIPES = 256;       // most threads (stripes) a block
constexpr int GROUP = 8;             // rows a thread computes, then stores, at once
constexpr int CARRIES = 4;           // S, P, S~, s-bits
constexpr int LAYERS = 3;            // S, D, s-bits
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may opt into
constexpr int SCORE_CARRIES = 3;     // K3: S, P, S~
constexpr int SCORE_LAYERS = 2;      // K3: S, D

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

// ONCHIP: the row state in shared memory, else in the device scratch
template <bool TB, bool ONCHIP, class Subst>
__global__ void __launch_bounds__(T_STRIPES) scan_global_rows_kernel(
    const uint8_t* __restrict__ xb,  // (B, M)
    const uint8_t* __restrict__ yb,  // (B, N)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int M, int N,
    int Xp, int R, int rb, int go, int ge, Subst sub,
    int* __restrict__ score,      // (B,)
    uint16_t* __restrict__ tb,    // (B, N, Xp), or null
    int* __restrict__ scratch) {  // (B, 3, R, T), or null when ONCHIP
  extern __shared__ int smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int ml = mlens[b];
  const int nl = nlens[b];

  int* carry = smem;  // [2][CARRIES][T]
  int* state;         // [LAYERS][R][T]
  if constexpr (ONCHIP) {
    state = smem + 2 * CARRIES * T;
  } else {
    state = scratch + static_cast<size_t>(b) * LAYERS * R * T;
  }
  // row r of this stripe: S_[r * T], D_[r * T], SB_[r * T]
  int* S_ = state + t;
  int* D_ = S_ + R * T;
  int* SB_ = D_ + R * T;
  // x_i of this stripe's row i0 + r at xr[r] (0 at row 0 and past mlens)
  uint8_t* xr = reinterpret_cast<uint8_t*>(smem + 2 * CARRIES * T + (ONCHIP ? LAYERS * R * T : 0))
                + static_cast<size_t>(t) * R;

  const int i0 = t * R;          // this stripe's first row
  const int t_act = ml / R + 1;  // stripes that hold a row <= mlens
  const bool owner = t < t_act;
  const bool holds_m = t == t_act - 1;  // the stripe of row mlens
  // groups of 8 rows this thread computes: through the one holding mlens
  const int groups = owner ? min(R, ml - i0 + GROUP) / GROUP : 0;
  for (int r = 0; r < R && owner; ++r) {
    const int i = i0 + r;
    xr[r] = (i >= 1 && i <= ml) ? xb[static_cast<size_t>(b) * M + i - 1] : 0;
    S_[r * T] = init_s(i, go, ge);
    D_[r * T] = MIN_I32;
    SB_[r * T] = i == 0 ? TB_START : TB_INS;
  }
  const int seam0 = i0 <= rb ? rb : (i0 + rb - 1) / rb * rb;  // first seam row >= i0
  const int lge0 = t > 0 ? mul(ge, (i0 - 1) % rb) : 0;        // k * ge of row i0 - 1

  int s_up_prev = t > 0 ? init_s(i0 - 1, go, ge) : 0;  // previous column's S, row i0 - 1
  int y_next = nl > 0 ? yb[static_cast<size_t>(b) * N] : 0;  // y_j, read a step ahead
  const int steps = nl > 0 ? nl + t_act - 1 : 0;
  for (int s = 1; s <= steps; ++s) {
    const int j = s - t;
    if (owner && j >= 1 && j <= nl) {
      const int* in = carry + ((s + 1) & 1) * CARRIES * T + (t > 0 ? t - 1 : 0);  // t - 1, step s - 1
      int* out = carry + (s & 1) * CARRIES * T + t;
      const int yj = y_next;
      if (j < nl) y_next = yb[static_cast<size_t>(b) * N + j];
      // row 0: delete y_1..y_j
      const int dj0 = add(go, mul(ge, j - 1));
      const int cell0 = TB_START | ((j == 1 ? TB_START : TB_DEL) << 4) | (TB_DEL << 8);
      int s_up_old = 0;  // previous column's S, row i - 1
      int p_up = 0;      // this column's P, row i - 1
      int lge_up = lge0; // k * ge, row i - 1
      int st_up = 0;     // this column's S~, row i - 1
      int sbits_up = 0;  // this column's s-bits, row i - 1
      if (t > 0) {
        s_up_old = s_up_prev;
        s_up_prev = in[0];
        p_up = in[T];
        st_up = in[2 * T];
        sbits_up = in[3 * T];
      }
      uint16_t* tbcol = TB ? tb + (static_cast<size_t>(b) * N + (j - 1)) * Xp + i0 : nullptr;
      int seam = seam0;
      int s_last = 0;
      for (int g = 0; g < groups; ++g) {
        const uint2 xw = *reinterpret_cast<const uint2*>(xr + g * GROUP);
        uint32_t w[GROUP / 2];
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          const int r = g * GROUP + k;
          const int i = i0 + r;
          const int xi = ((k < 4 ? xw.x : xw.y) >> (8 * (k & 3))) & 0xFF;
          const int sp = S_[r * T];
          const int dp = D_[r * T];
          const int sbp = SB_[r * T];
          const int m_val = add(s_up_old, sub.score(xi, yj));
          const int d_ext = add(dp, ge);
          const int d_open = add(sp, go);
          const bool d_wins = d_ext > d_open;
          int best_d = d_wins ? d_ext : d_open;
          const int d_bits = d_wins ? TB_DEL : sbp;
          const int t_open = add(st_up, go);
          const bool at_seam = i == seam;
          if (at_seam) seam += rb;
          // the block's first row takes the carried I, the rows below the
          // block's prefix maximum
          int lge = at_seam ? 0 : add(lge_up, ge);
          const int i_ext = add(p_up, add(lge_up, ge));  // I[i-1] + ge
          int p = at_seam ? max(max(i_ext, t_open), NEG) : max(p_up, minus(t_open, lge));
          int best_i = add(p, lge);
          const int i_bits = i_ext > t_open ? TB_INS : (at_seam ? TB_REREAD : sbits_up);
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
          int cell = i_bits | (d_bits << 4) | (s_bits << 8);
          int st = max(m_val, best_d);
          if (k == 0 && i == 0) {  // row 0, in thread 0's first group
            cell = cell0;
            s_col = best_d = st = dj0;
            s_bits = TB_DEL;
            best_i = p = NEG;
            lge = 0;
          }
          if (k & 1) {
            w[k / 2] |= static_cast<uint32_t>(cell) << 16;
          } else {
            w[k / 2] = static_cast<uint32_t>(cell);
          }
          s_up_old = sp;
          p_up = p;
          lge_up = lge;
          st_up = st;
          sbits_up = s_bits;
          S_[r * T] = s_col;
          D_[r * T] = best_d;
          SB_[r * T] = s_bits;
          s_last = s_col;
        }
        if constexpr (TB) {
          *reinterpret_cast<uint4*>(tbcol + g * GROUP) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      // the stripe's last row, for the next stripe (the holder's goes unread)
      out[0] = s_last;
      out[T] = p_up;
      out[2 * T] = st_up;
      out[3 * T] = sbits_up;
    }
    __syncthreads();
  }
  if (holds_m) score[b] = max(S_[(ml - i0) * T], NEG);
}

// K3 at long x: the global score only, in K13's shape with K3's chain (the
// head note). Two int32 layers a row (S, D), three carries a stripe (S, P,
// S~). ONCHIP: the row state in shared memory, else in the device scratch
template <bool ONCHIP>
__global__ void __launch_bounds__(T_STRIPES) scores_global_rows_kernel(
    const uint8_t* __restrict__ xb,  // (B, M)
    const uint8_t* __restrict__ yb,  // (B, N)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int M, int N, int R,
    int go, int ge, MatchParams sub,
    int* __restrict__ score,      // (B,)
    int* __restrict__ scratch) {  // (B, 2, R, T), or null when ONCHIP
  extern __shared__ int smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int ml = mlens[b];
  const int nl = nlens[b];

  int* carry = smem;  // [2][SCORE_CARRIES][T]
  int* state;         // [SCORE_LAYERS][R][T]
  if constexpr (ONCHIP) {
    state = smem + 2 * SCORE_CARRIES * T;
  } else {
    state = scratch + static_cast<size_t>(b) * SCORE_LAYERS * R * T;
  }
  int* S_ = state + t;  // row r of this stripe: S_[r * T], D_[r * T]
  int* D_ = S_ + R * T;
  uint8_t* xr = reinterpret_cast<uint8_t*>(smem + 2 * SCORE_CARRIES * T + (ONCHIP ? SCORE_LAYERS * R * T : 0))
                + static_cast<size_t>(t) * R;

  const int i0 = t * R;
  const int t_act = ml / R + 1;
  const bool owner = t < t_act;
  const int groups = owner ? min(R, ml - i0 + GROUP) / GROUP : 0;
  for (int r = 0; r < R && owner; ++r) {
    const int i = i0 + r;
    xr[r] = (i >= 1 && i <= ml) ? xb[static_cast<size_t>(b) * M + i - 1] : 0;
    S_[r * T] = init_s(i, go, ge);
    D_[r * T] = NEG;
  }

  int s_up_prev = t > 0 ? init_s(i0 - 1, go, ge) : 0;  // previous column's S, row i0 - 1
  int y_next = nl > 0 ? yb[static_cast<size_t>(b) * N] : 0;  // y_j, read a step ahead
  const int steps = nl > 0 ? nl + t_act - 1 : 0;
  for (int s = 1; s <= steps; ++s) {
    const int j = s - t;
    if (owner && j >= 1 && j <= nl) {
      const int* in = carry + ((s + 1) & 1) * SCORE_CARRIES * T + (t > 0 ? t - 1 : 0);  // t - 1, step s - 1
      int* out = carry + (s & 1) * SCORE_CARRIES * T + t;
      const int yj = y_next;
      if (j < nl) y_next = yb[static_cast<size_t>(b) * N + j];
      const int s0j = add(go, mul(ge, j - 1));  // row 0: delete y_1..y_j
      int s_up_old = 0;  // previous column's S, row i - 1
      int mx_up = 0;     // this column's running max of T - k * ge, rows k <= i - 1
      int st_up = 0;     // this column's S~ = max(m, D), row i - 1
      if (t > 0) {
        s_up_old = s_up_prev;
        s_up_prev = in[0];
        mx_up = in[T];
        st_up = in[2 * T];
      }
      // a group's S and D of the previous column, loaded before its stores,
      // and the next group's ahead of them (as csrc/sw_warp.cu's K18)
      int sp_g[GROUP], dp_g[GROUP];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        sp_g[k] = S_[k * T];
        dp_g[k] = D_[k * T];
      }
      int s_last = 0;
      for (int g = 0; g < groups; ++g) {
        const uint2 xw = *reinterpret_cast<const uint2*>(xr + g * GROUP);
        int sp_n[GROUP] = {}, dp_n[GROUP] = {};
        if (g + 1 < groups) {
#pragma unroll
          for (int k = 0; k < GROUP; ++k) {
            sp_n[k] = S_[((g + 1) * GROUP + k) * T];
            dp_n[k] = D_[((g + 1) * GROUP + k) * T];
          }
        }
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          const int r = g * GROUP + k;
          const int i = i0 + r;
          const int xi = ((k < 4 ? xw.x : xw.y) >> (8 * (k & 3))) & 0xFF;
          const int m_val = add(s_up_old, sub.score(xi, yj));
          const int best_d = max(add(dp_g[k], ge), add(sp_g[k], go));
          // I = max_k (T_k + (i - k) * ge), T_k = S~[k-1] + go: the prefix
          // maximum of T_k - k * ge from row 0 down, plus i * ge
          const int rge = mul(i, ge);
          int mx = max(mx_up, minus(add(st_up, go), rge));
          int s_col = max(max(m_val, add(mx, rge)), best_d);
          int st = max(m_val, best_d);
          if (k == 0 && i == 0) {  // row 0, in thread 0's first group
            s_col = st = s0j;
            mx = NEG;
          }
          s_up_old = sp_g[k];
          mx_up = mx;
          st_up = st;
          S_[r * T] = s_col;
          D_[r * T] = best_d;
          s_last = s_col;
        }
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          sp_g[k] = sp_n[k];
          dp_g[k] = dp_n[k];
        }
      }
      // the stripe's last row, for the next stripe (the holder's goes unread)
      out[0] = s_last;
      out[T] = mx_up;
      out[2 * T] = st_up;
    }
    __syncthreads();
  }
  if (t == t_act - 1) score[b] = max(S_[(ml - i0) * T], NEG);
}

template <bool TB, bool ONCHIP, class Subst>
int launch_on(int B, int M, int N, int Xp, int R, int T, size_t smem, int rb,
              const void* xb, const void* yb, const void* mlens, const void* nlens,
              int go, int ge, Subst sub, void* score, void* tb, void* scratch,
              void* stream) {
  auto kernel = scan_global_rows_kernel<TB, ONCHIP, Subst>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<B, T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xb), static_cast<const uint8_t*>(yb),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), M, N, Xp, R,
      rb, go, ge, sub, static_cast<int*>(score), static_cast<uint16_t*>(tb),
      static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <class Subst>
int launch(const void* xb, const void* yb, const void* mlens, const void* nlens,
           int B, int M, int N, int Xp, int rb, int go, int ge, Subst sub,
           void* score, void* tb, void* scratch, void* stream) {
  if (B < 1 || M < 0 || M > 65534 || N < 0 || rb < 1 || (tb && (Xp < M + 1 || Xp % GROUP)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the geometry of ops/sw.py rows_geometry
  const int rows = M + 1;
  const int R = (rows + GROUP * T_STRIPES - 1) / (GROUP * T_STRIPES) * GROUP;
  const int T = ((rows + R - 1) / R + 31) / 32 * 32;
  const size_t onchip = static_cast<size_t>(LAYERS) * R * T * sizeof(int);
  const size_t smem = static_cast<size_t>(2 * CARRIES) * T * sizeof(int)
                      + static_cast<size_t>(R) * T + (scratch ? 0 : onchip);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (tb) {
    auto fn = scratch ? launch_on<true, false, Subst> : launch_on<true, true, Subst>;
    return fn(B, M, N, Xp, R, T, smem, rb, xb, yb, mlens, nlens, go, ge, sub, score,
              tb, scratch, stream);
  }
  auto fn = scratch ? launch_on<false, false, Subst> : launch_on<false, true, Subst>;
  return fn(B, M, N, Xp, R, T, smem, rb, xb, yb, mlens, nlens, go, ge, sub, score,
            tb, scratch, stream);
}

// K3's launch at long x, in the geometry of ops/sw.py rows_geometry(M, True)
int launch_scores(const void* xb, const void* yb, const void* mlens, const void* nlens, int B,
                  int M, int N, int go, int ge, MatchParams sub, void* score, void* scratch,
                  void* stream) {
  if (B < 1 || M < 0 || M > 65534 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = M + 1;
  const int R = (rows + GROUP * T_STRIPES - 1) / (GROUP * T_STRIPES) * GROUP;
  const int T = ((rows + R - 1) / R + 31) / 32 * 32;
  const size_t onchip = static_cast<size_t>(SCORE_LAYERS) * R * T * sizeof(int);
  const size_t smem = static_cast<size_t>(2 * SCORE_CARRIES) * T * sizeof(int)
                      + static_cast<size_t>(R) * T + (scratch ? 0 : onchip);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = scratch ? scores_global_rows_kernel<false> : scores_global_rows_kernel<true>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<B, T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xb), static_cast<const uint8_t*>(yb),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), M, N, R, go, ge, sub,
      static_cast<int*>(score), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Entry points: xb (B, M) and yb (B, N) uint8 row-major; tb null for a
// score-only call, else (B, N, Xp) uint16; scratch null to keep the row
// state in shared memory, else a (B, 3, R, T) int32 buffer in the geometry
// above; rb the seam period, 1..605; lut a (256, 256) int32 table on the
// device.

// K13: constant match/mismatch scores.
int sw_scan_global_rows(const void* xb, const void* yb, const void* mlens,
                        const void* nlens, int B, int M, int N, int Xp, int rb,
                        int go, int ge, int ma, int mi, void* score, void* tb,
                        void* scratch, void* stream) {
  return launch(xb, yb, mlens, nlens, B, M, N, Xp, rb, go, ge, MatchParams{ma, mi},
                score, tb, scratch, stream);
}

// K13-LUT: K13 fed by the LUT.
int sw_scan_global_rows_lut(const void* xb, const void* yb, const void* mlens,
                            const void* nlens, int B, int M, int N, int Xp, int rb,
                            int go, int ge, const void* lut, void* score, void* tb,
                            void* scratch, void* stream) {
  return launch(xb, yb, mlens, nlens, B, M, N, Xp, rb, go, ge,
                Lut{static_cast<const int*>(lut)}, score, tb, scratch, stream);
}

// K3 at long x: the global score, match / mismatch scores ma / mi; scratch
// null to keep the row state in shared memory, else a (B, 2, R, T) int32
// buffer in the geometry of rows_geometry(M, True).
int sw_scores_global_rows(const void* xb, const void* yb, const void* mlens,
                          const void* nlens, int B, int M, int N, int go, int ge,
                          int ma, int mi, void* score, void* scratch, void* stream) {
  return launch_scores(xb, yb, mlens, nlens, B, M, N, go, ge, MatchParams{ma, mi}, score, scratch,
                       stream);
}

}  // extern "C"
