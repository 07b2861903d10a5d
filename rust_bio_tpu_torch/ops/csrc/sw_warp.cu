// K11 sw_scan_global_lut, K18 sw_scores_global_lut, K7-LUT
// sw_scan_local_lut, K9-LUT sw_scan_custom_lut and K12
// sw_scan_semiglobal_lut: the global (with its traceback, and score only),
// the local, the custom-clip and the semiglobal affine-gap DP under a
// (256, 256) substitution LUT at protein lengths, one warp a pair over row
// stripes held by its lanes; and, under match / mismatch scores, K1
// sw_scan_global (K11's kernel), the global DP of the 150 bp pairs, K3 at
// short x, sw_scores_global_warp (K18's kernel), K7 sw_scan_local (K7-LUT's
// kernel), the local DP of the 150 bp reads, K9 sw_scan_custom
// (K9-LUT's kernel), their custom-clip DP, and K5 sw_scan_semiglobal
// (K12's kernel), the semiglobal DP of the read mapper's extension.
//
// Replace rust_bio_tpu/ops/sw_pallas.py:1129 _kernel_scan_global_subs
// (scan_global_pallas_subs :1275, runs="ins"; the JAX package streams
// lut[x, y] * 2 | (x == y) in, these kernels read the LUT themselves),
// :559 _kernel_scan_global_mp (scan_global_pallas_mp :780, runs="ins", K1),
// :79 _kernel (sw_scores_global :140, which reads a (B, M, N) substitution
// tensor), :199 _kernel_mp (sw_scores_global_matchparams :258, K3), :1328
// _kernel_scan_semiglobal_subs (scan_semiglobal_pallas_subs :1529,
// runs="ins"), :1966 _kernel_scan_local_mp (scan_local_pallas_mp :2177,
// runs="ins", K7), :1601 _kernel_scan_custom_mp (scan_custom_pallas_mp
// :1884, runs="ins", K9), :855 _kernel_scan_semiglobal_mp
// (scan_semiglobal_pallas_mp :1057, runs="ins", K5) and, in local and
// custom mode under a LUT, the XLA
// engine alignment/pairwise/batched.py:948 _align_batch_device, which the
// JAX package runs there.
//
// What they compute:
//  K1: the score, S at (mlens, nlens) clamped at NEG; the traceback cells
//   i_bits | d_bits << 4 | s_bits << 8 | min(ins_run, 15) << 12 of columns
//   j = 1..nlens and rows i = 0..mlens; tbk (B, M+1), the cells of column
//   nlens (column 0's when nlens = 0). K11 is K1 fed by the LUT, the same
//   kernel under the other substitution source (the template's, as K3's).
//  K9-LUT: K9 fed by the LUT, all four clips live (the JAX custom kernel's
//   recurrence, sw_pallas.py:1601-1881): the
//   cells of columns j = 0..nlens (column 0, the init column, at index 0)
//   with the run nibble; lx (N+1, B), the x-suffix clip length of each
//   column's row mlens; the finals S, I, Sn, Ly and tbk (B, M+1) at column
//   nlens. A lane with nlens = 0 takes column 0's I and cells as its
//   finals. Without a tb (score only) it skips the cells, lx and the run
//   nibble. K7-LUT: K7 fed by the LUT, the same kernel with the
//   clips zero at compile time (K9's cell at clips 0: the y-prefix and
//   x-prefix clip terms stay, which a wrapped gap sum makes live). K9 and
//   K7 are those two kernels under match / mismatch scores (the template's
//   substitution source, as K3's).
//  K5: the semiglobal-family DP (x-clips off, the y-clip penalties ycp and
//   ycs live, 0 / 0 in semiglobal mode): the cells of columns j = 1..nlens
//   and rows 0..mlens with the run nibble; the finals S, I, Sn, Ly and tbk
//   (B, M+1) at column nlens (column 0's I and cells when nlens = 0).
//   Without a tb it skips the cells' stores only: its finals are the full
//   call's. K12 is K5 fed by the LUT, the same kernel under the other
//   substitution source.
//  K18: K3 fed by the LUT, K11's DP without tb, tbk or s-bits: the
//   score, S at (mlens, nlens) clamped at NEG. Its D and row 0's I start
//   at NEG = -2^30, K3's and the JAX kernel's sentinel, not at K11's
//   MIN_I32: under large tables int32 wraparound tells the two apart. K3
//   is the same kernel with the score ma or mi by byte equality (the
//   template's substitution source); csrc/sw_global_rows.cu holds its
//   launch at long x.
//  All of them carry the insertion chain as the JAX kernels' prefix
//  maximum, P = max(P, T - i * ge) down the rows and I = P + i * ge, a
//  lane handing P down: equal to max(I + ge, T) a row until
//  a sum wraps int32, and then still equal to the plain versions and the
//  JAX kernels (K1's one thread a pair carried it as a scalar before).
//
// Design: the row-stripe wavefront of csrc/sw_global_rows.cu, shrunk to one
// warp a pair, WARPS warps a block (the pairs are independent). Lane t owns
// the rows [t * R, t * R + R), R = 8 * ceil((M + 1) / 256), and at step s
// computes column j = s - t; a pair takes nlens + ceil((mlens + 1) / R) - 1
// steps (K7-LUT and K9-LUT one more: column 0 is a step of the
// wavefront, since row mlens of column 0 reads a maximum over the rows
// above). Lanes past
// row mlens only take part in the shuffles. Down a column, lane t hands
// lane t + 1 the values of its stripe's last row with __shfl_up_sync, and
// lane t + 1 uses them one step later in the same column: S, which one
// step later still is the next stripe's diagonal; P; S~ = max(m, D)
// (K9-LUT: max(m, D, the row's y-prefix clip, the column's x-prefix clip));
// the s-bits and the Ins run, capped at 15, in one word; K9-LUT also the
// running maximum of S + xcs over rows 1..m-1 and its first row, which
// decide row m's x-suffix replacement and lx (the row's first is packed in
// the s-bits' word); K5 and K12 hand S~ = max(m, D, the row's y-prefix
// clip) down. No barrier in the column loop: a warp's
// lanes read and write only their own rows. Along a row, the state stays
// with the row's owner as [layer][R][32], lane innermost (conflict-free):
// S, D, s-bits for K1 and K11 (6 KB a warp at M = 450), S and D for K18 and K3 (4 KB),
// and Sn, Ly besides for K5, K7, K7-LUT, K9, K9-LUT and K12 (10 KB), in the warp's
// slice of shared memory, or, where the
// wrapper passes a scratch (ops/sw.py warp_geometry, above its per-warp
// budget), in the warp's slice of a (B, layers, R, 32) device scratch. The
// stripe's x bytes are staged in shared memory once; y_j is read a step
// ahead; the LUT through the read-only path (its live entries stay in L1).
// A lane computes its rows 8 at a time and stores their cells with one
// 16-byte store into the pair-major tb, (B, N, Xp) for K1, K11, K5 and K12 and
// (B, N+1, Xp) for K7, K7-LUT, K9 and K9-LUT, Xp = M + 1 rounded up to 8
// (ops/sw.py returns the (N, M+1, B) or (N+1, M+1, B) view, which K2, K6,
// K8 and K10 read through their strides);
// the lane that holds row mlens stops after the group of 8 that holds it.
//
// Bound on this card: the cells' integer operations (about 34 a cell for
// K11, 52 for K7-LUT and K9-LUT: 1.0 G cells of the homolog corpus take
// 1.0-1.6 ms at the int32 peak) or the tb's 2 bytes a cell (2.0 GB there:
// 0.6 ms), the larger (K12 and K5: about 42 a cell; K5 on the read
// mapper's 8192 extensions of 150 bp reads into 166 bp windows: 42 a cell
// over 8192 * 150 * nlens cells, its tb 2 bytes a cell; K7 on 8192 random
// 150 bp pairs: 45 a cell over 184 M cells, 0.29 ms, R = 8 rows a lane and
// 19 of 32 lanes live, 2.3 KB of x and 5 KB of state a warp; K9 on 8192
// clipped 150 bp reads against 166-bp windows: 52 a cell, 0.32 ms; K1 on
// 8192 random 150 bp pairs: 34 a cell, 0.19 ms, its 371 MB tb 0.11 ms, 3
// KB of state a warp). The one-thread-a-pair kernels before
// these kept a pair's column in shared memory and fit one warp an SM (K1:
// 32 pairs in 58 KB, 3.6-4.0 ms on those pairs, 20x that bound; K11:
// 32 pairs in 173 KB; K18: 32 pairs in 115 KB; K12: 32 pairs in 129 KB at
// M = 200; K5: 32 pairs in 96.6 KB at M = 150, 4.6-5.3 ms on the mapper's
// extensions, 18-20x that bound) or less (K7-LUT: 25 pairs), 50-100x off that bound (K9-LUT:
// 27.2 ms on the domain corpus, 47x; K7: 5.45 ms, 19x; K9: 5.79 ms,
// 18x); here a warp
// needs 4-11 KB. K18's and K3's bound: about 14 operations a cell (at
// M = 150 K3's lanes hold R = 8 rows, 19 of 32 lanes live, 2.3 KB a warp;
// the one-thread K3 before it ran 1.0-1.2 ms on 8192 pairs, 13x that
// bound).
//
// Exactness as the JAX kernels (sw_pallas.py:597-721 for K1, :855-1054 for
// K5, the custom kernel sw_pallas.py:1601-1881):
// int32 arithmetic wraps, LUT entries included; D starts at MIN_I32 =
// -858993459; the running maximum starts at -2^31 + 1 and counts only
// above MIN_I32; every choice is a strict '>' with priority Match/Subst >
// Ins > Del > Xclip-prefix > Yclip-prefix; the I-open candidate uses S~;
// the Match/Subst bit is byte equality.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB_START = 0;
constexpr int TB_INS = 1;
constexpr int TB_DEL = 2;
constexpr int TB_SUBST = 3;
constexpr int TB_XCLIP_PREFIX = 5;
constexpr int TB_XCLIP_SUFFIX = 6;
constexpr int TB_YCLIP_PREFIX = 7;
constexpr int TB_YCLIP_SUFFIX = 8;
constexpr int MIN_I32 = -858993459;  // reference MIN_SCORE
constexpr int NEG = -(1 << 30);      // final-reduction sentinel
constexpr int SENT = -2147483647;    // -2^31 + 1: the empty running maximum
constexpr int LANES = 32;            // stripes a pair
constexpr int WARPS = 4;             // pairs a block
constexpr int GROUP = 8;             // rows a lane computes, then stores, at once
constexpr int GLOBAL_LAYERS = 3;     // K1, K11: S, D, s-bits
constexpr int SCORE_LAYERS = 2;      // K18, K3: S, D
constexpr int LOCAL_LAYERS = 5;      // K7-LUT, K9-LUT, K12: S, D, s-bits, Sn, Ly
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may opt into

// int32 add / multiply that wrap like XLA's (signed overflow is UB in C++)
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// s, bits <- cand, cbits when cand is strictly greater
__device__ __forceinline__ void take(int& s, int& bits, int cand, int cbits) {
  if (cand > s) {
    s = cand;
    bits = cbits;
  }
}

// S of DP cell (i, 0) in global mode: the init column
__device__ __forceinline__ int init_s(int i, int go, int ge) {
  return i == 0 ? 0 : add(go, mul(ge, i - 1));
}

// byte k of the 8 x bytes of a group
__device__ __forceinline__ int byte_of(uint2 w, int k) {
  return ((k < 4 ? w.x : w.y) >> (8 * (k & 3))) & 0xFF;
}

// the ints of a warp's slice of shared memory: its row state when ONCHIP,
// then its lanes' x bytes
__host__ __device__ __forceinline__ size_t warp_ints(int layers, int R, bool onchip) {
  return (onchip ? static_cast<size_t>(layers) * R * LANES : 0) + static_cast<size_t>(R) * LANES / 4;
}

// This lane's rows: the state layers (row r of layer k at at(k, r)), its x
// bytes, and the stripe's place in the pair.
struct Stripe {
  int* base;     // layer 0, row 0 of this lane
  int R;
  uint8_t* x;    // x_i of row i0 + r at x[r] (0 at row 0 and past mlens)
  int i0;        // first row
  int t_act;     // lanes that hold a row <= mlens
  int groups;    // groups of 8 rows this lane computes: through row mlens
  __device__ int& at(int k, int r) const { return base[(k * R + r) * LANES]; }
};

template <int LAYERS, bool ONCHIP>
__device__ __forceinline__ Stripe stripe_of(int* scratch, const uint8_t* __restrict__ xb, int b,
                                            int M, int R, int ml) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x % LANES;
  const int w = threadIdx.x / LANES;
  const size_t state_ints = static_cast<size_t>(LAYERS) * R * LANES;
  int* wsm = smem + w * warp_ints(LAYERS, R, ONCHIP);
  Stripe st;
  st.base = (ONCHIP ? wsm : scratch + static_cast<size_t>(b) * state_ints) + lane;
  st.R = R;
  st.x = reinterpret_cast<uint8_t*>(wsm + (ONCHIP ? state_ints : 0)) + static_cast<size_t>(lane) * R;
  st.i0 = lane * R;
  st.t_act = ml / R + 1;
  st.groups = lane < st.t_act ? min(R, ml - st.i0 + GROUP) / GROUP : 0;
  for (int r = 0; r < R && lane < st.t_act; ++r) {
    const int i = st.i0 + r;
    st.x[r] = (i >= 1 && i <= ml) ? xb[static_cast<size_t>(b) * M + i - 1] : 0;
  }
  return st;
}

// Substitution sources of the templated kernels (K1 / K11, K3 / K18, K7 /
// K7-LUT, K9 / K9-LUT, K5 / K12), read a column at a time: the score of x against
// the column's y. Param is the kernel's argument.
struct MatchParams {  // ma where the bytes are equal, else mi
  using Param = int2;  // (ma, mi)
  struct Column {
    int y, ma, mi;
    __device__ __forceinline__ int score(int x) const { return x == y ? ma : mi; }
  };
  static __device__ __forceinline__ Column column(Param p, int y) { return Column{y, p.x, p.y}; }
};
struct Lut {  // a (256, 256) int32 table, row x, through the read-only path
  using Param = const int* __restrict__;
  struct Column {
    const int* p;
    __device__ __forceinline__ int score(int x) const { return __ldg(p + (x << 8)); }
  };
  static __device__ __forceinline__ Column column(Param lut, int y) { return Column{lut + y}; }
};

// K1 (Subst = MatchParams) and K11 (Lut). TB: store the cells (else score
// only; tbk is written either way)
template <bool TB, bool ONCHIP, class Subst>
__global__ void __launch_bounds__(WARPS * LANES) scan_global_warp_kernel(
    const uint8_t* __restrict__ xb,  // (B, M)
    const uint8_t* __restrict__ yb,  // (B, N)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M, int N,
    int Xp, int R, int go, int ge,
    typename Subst::Param subst,  // MatchParams: (ma, mi); Lut: the (256, 256) table, row x
    int* __restrict__ score,      // (B,)
    uint16_t* __restrict__ tb,    // (B, N, Xp), or null
    int* __restrict__ tbk,        // (B, M + 1)
    int* __restrict__ scratch) {  // (B, 3, R, 32), or null when ONCHIP
  const int lane = threadIdx.x % LANES;
  const int b = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (b >= B) return;  // the whole warp
  const int ml = mlens[b];
  const int nl = nlens[b];
  const Stripe st = stripe_of<GLOBAL_LAYERS, ONCHIP>(scratch, xb, b, M, R, ml);
  int* tbk_b = tbk + static_cast<size_t>(b) * (M + 1);

  // column 0: S[i] = go + ge*(i-1), s-bits Ins (i >= 1); i-bits Start at i <= 1
  for (int r = 0; r < R && lane < st.t_act; ++r) {
    const int i = st.i0 + r;
    st.at(0, r) = init_s(i, go, ge);
    st.at(1, r) = MIN_I32;
    st.at(2, r) = i == 0 ? TB_START : TB_INS;
    if (nl == 0 && i <= ml)
      tbk_b[i] = (i <= 1 ? TB_START : TB_INS) | ((i == 0 ? TB_START : TB_INS) << 8);
  }

  int s_up_prev = lane > 0 ? init_s(st.i0 - 1, go, ge) : 0;  // previous column's S, row i0 - 1
  int in_s = 0, in_i = 0, in_st = 0, in_pk = 0;  // lane - 1's last row, from the last shuffle
  int y_next = nl > 0 ? yb[static_cast<size_t>(b) * N] : 0;  // y_j, read a step ahead
  const int steps = nl > 0 ? nl + st.t_act - 1 : 0;
  for (int s = 1; s <= steps; ++s) {
    const int j = s - lane;
    int c_s = 0, c_i = 0, c_st = 0, c_pk = 0;  // this stripe's last row, for lane + 1
    if (st.groups > 0 && j >= 1 && j <= nl) {
      const int yj = y_next;
      if (j < nl) y_next = yb[static_cast<size_t>(b) * N + j];
      const auto col = Subst::column(subst, yj);
      const bool last = j == nl;
      // row 0: delete y_1..y_j
      const int dj0 = add(go, mul(ge, j - 1));
      const int cell0 = TB_START | ((j == 1 ? TB_START : TB_DEL) << 4) | (TB_DEL << 8);
      int s_up_old = 0;  // previous column's S, row i - 1
      int p_up = 0;      // this column's P, row i - 1
      int st_up = 0;     // this column's S~, row i - 1
      int sbits_up = 0;  // this column's s-bits, row i - 1
      int run = 0;       // Ins i-bits run ending at row i - 1, capped at 15
      if (lane > 0) {
        s_up_old = s_up_prev;
        s_up_prev = in_s;
        p_up = in_i;
        st_up = in_st;
        sbits_up = in_pk & 0xF;
        run = in_pk >> 4;
      }
      uint16_t* tbcol = TB ? tb + (static_cast<size_t>(b) * N + (j - 1)) * Xp + st.i0 : nullptr;
      for (int g = 0; g < st.groups; ++g) {
        const uint2 xw = *reinterpret_cast<const uint2*>(st.x + g * GROUP);
        uint32_t w[GROUP / 2];
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          const int r = g * GROUP + k;
          const int i = st.i0 + r;
          const int xi = byte_of(xw, k);
          const int sp = st.at(0, r);
          const int dp = st.at(1, r);
          const int sbp = st.at(2, r);
          const int m_val = add(s_up_old, col.score(xi));
          const int d_ext = add(dp, ge);
          const int d_open = add(sp, go);
          const bool d_wins = d_ext > d_open;
          int best_d = d_wins ? d_ext : d_open;
          const int d_bits = d_wins ? TB_DEL : sbp;
          const int rge = mul(i, ge);
          const int t_open = add(st_up, go);
          const int i_ext = add(p_up, rge);  // I[i-1] + ge
          int p = max(p_up, sub(t_open, rge));
          int best_i = add(p, rge);
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
          run = i_bits == TB_INS ? min(run + 1, 15) : 0;
          int cell = i_bits | (d_bits << 4) | (s_bits << 8) | (run << 12);
          int st_col = max(m_val, best_d);
          if (k == 0 && i == 0) {  // row 0, in lane 0's first group
            cell = cell0;
            s_col = best_d = st_col = dj0;
            s_bits = TB_DEL;
            best_i = p = MIN_I32;
            run = 0;
          }
          if (k & 1) {
            w[k / 2] |= static_cast<uint32_t>(cell) << 16;
          } else {
            w[k / 2] = static_cast<uint32_t>(cell);
          }
          s_up_old = sp;
          p_up = p;
          st_up = st_col;
          sbits_up = s_bits;
          st.at(0, r) = s_col;
          st.at(1, r) = best_d;
          st.at(2, r) = s_bits;
          if (last && i <= ml) tbk_b[i] = cell;
          c_s = s_col;
        }
        if constexpr (TB) {
          *reinterpret_cast<uint4*>(tbcol + g * GROUP) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      c_i = p_up;
      c_st = st_up;
      c_pk = sbits_up | (run << 4);
    }
    in_s = __shfl_up_sync(FULL, c_s, 1);
    in_i = __shfl_up_sync(FULL, c_i, 1);
    in_st = __shfl_up_sync(FULL, c_st, 1);
    in_pk = __shfl_up_sync(FULL, c_pk, 1);
  }
  if (lane == st.t_act - 1) score[b] = max(st.at(0, ml - st.i0), NEG);
}

// K3 (Subst = MatchParams) and K18 (Lut). D and row 0's running maximum
// start at NEG
template <bool ONCHIP, class Subst>
__global__ void __launch_bounds__(WARPS * LANES) scores_global_warp_kernel(
    const uint8_t* __restrict__ xb,  // (B, M)
    const uint8_t* __restrict__ yb,  // (B, N)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M, int N, int R,
    int go, int ge,
    typename Subst::Param subst,  // MatchParams: (ma, mi); Lut: the (256, 256) table, row x
    int* __restrict__ score,      // (B,)
    int* __restrict__ scratch) {  // (B, 2, R, 32), or null when ONCHIP
  const int lane = threadIdx.x % LANES;
  const int b = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (b >= B) return;  // the whole warp
  const int ml = mlens[b];
  const int nl = nlens[b];
  const Stripe st = stripe_of<SCORE_LAYERS, ONCHIP>(scratch, xb, b, M, R, ml);

  // column 0: S[i] = go + ge*(i-1)
  for (int r = 0; r < R && lane < st.t_act; ++r) {
    st.at(0, r) = init_s(st.i0 + r, go, ge);
    st.at(1, r) = NEG;
  }

  int s_up_prev = lane > 0 ? init_s(st.i0 - 1, go, ge) : 0;  // previous column's S, row i0 - 1
  int in_s = 0, in_i = 0, in_st = 0;  // lane - 1's last row, from the last shuffle
  int y_next = nl > 0 ? yb[static_cast<size_t>(b) * N] : 0;  // y_j, read a step ahead
  const int steps = nl > 0 ? nl + st.t_act - 1 : 0;
  for (int s = 1; s <= steps; ++s) {
    const int j = s - lane;
    int c_s = 0, c_i = 0, c_st = 0;  // this stripe's last row, for lane + 1
    if (st.groups > 0 && j >= 1 && j <= nl) {
      const int yj = y_next;
      if (j < nl) y_next = yb[static_cast<size_t>(b) * N + j];
      const auto col = Subst::column(subst, yj);
      const int s0j = add(go, mul(ge, j - 1));  // row 0: delete y_1..y_j
      int s_up_old = 0;  // previous column's S, row i - 1
      int mx_up = 0;     // this column's running max of T - k * ge, rows k <= i - 1
      int st_up = 0;     // this column's S~ = max(m, D), row i - 1
      if (lane > 0) {
        s_up_old = s_up_prev;
        s_up_prev = in_s;
        mx_up = in_i;
        st_up = in_st;
      }
      // a group's S and D of the previous column, loaded before its stores
      // and the next group's ahead of them (the compiler cannot tell the
      // rows apart, so it would load each row after the row above's stores)
      int sp_g[GROUP], dp_g[GROUP];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        sp_g[k] = st.at(0, k);
        dp_g[k] = st.at(1, k);
      }
      for (int g = 0; g < st.groups; ++g) {
        const uint2 xw = *reinterpret_cast<const uint2*>(st.x + g * GROUP);
        int sp_n[GROUP] = {}, dp_n[GROUP] = {};
        if (g + 1 < st.groups) {
#pragma unroll
          for (int k = 0; k < GROUP; ++k) {
            sp_n[k] = st.at(0, (g + 1) * GROUP + k);
            dp_n[k] = st.at(1, (g + 1) * GROUP + k);
          }
        }
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          const int r = g * GROUP + k;
          const int i = st.i0 + r;
          const int sp = sp_g[k];
          const int dp = dp_g[k];
          const int m_val = add(s_up_old, col.score(byte_of(xw, k)));
          const int best_d = max(add(dp, ge), add(sp, go));
          // I = max_k (T_k + (i - k) * ge), T_k = S~[k-1] + go, as the
          // prefix maximum of T_k - k * ge plus i * ge (the JAX kernel's
          // scan; equal to max(I[i-1] + ge, T_i) until int32 wraps)
          const int rge = mul(i, ge);
          int mx = max(mx_up, sub(add(st_up, go), rge));
          int s_col = max(max(m_val, add(mx, rge)), best_d);
          int st_col = max(m_val, best_d);
          if (k == 0 && i == 0) {  // row 0, in lane 0's first group
            s_col = st_col = s0j;
            mx = NEG;
          }
          s_up_old = sp;
          mx_up = mx;
          st_up = st_col;
          st.at(0, r) = s_col;
          st.at(1, r) = best_d;
          c_s = s_col;
        }
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          sp_g[k] = sp_n[k];
          dp_g[k] = dp_n[k];
        }
      }
      c_i = mx_up;
      c_st = st_up;
    }
    in_s = __shfl_up_sync(FULL, c_s, 1);
    in_i = __shfl_up_sync(FULL, c_i, 1);
    in_st = __shfl_up_sync(FULL, c_st, 1);
  }
  if (lane == st.t_act - 1) score[b] = max(st.at(0, ml - st.i0), NEG);
}

// K9 and K9-LUT, and K7 and K7-LUT at LOCAL (the clips zero at compile
// time). TB: store
// the cells with the run nibble, and lx (else score only)
template <bool TB, bool ONCHIP, bool LOCAL, class Subst>
__global__ void __launch_bounds__(WARPS * LANES) scan_clip_warp_kernel(
    const uint8_t* __restrict__ xb,  // (B, M)
    const uint8_t* __restrict__ yb,  // (B, N)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M, int N,
    int Xp, int R, int go, int ge,
    typename Subst::Param subst,  // MatchParams: (ma, mi); Lut: the (256, 256) table, row x
    int xcp, int xcs, int ycp, int ycs,
    uint16_t* __restrict__ tb,    // (B, N + 1, Xp), or null
    int* __restrict__ lx,         // (N + 1, B), or null
    int* __restrict__ s_f,        // (B, M + 1) each
    int* __restrict__ i_f,
    int* __restrict__ sn_f,
    int* __restrict__ ly_f,
    int* __restrict__ tbk,
    int* __restrict__ scratch) {  // (B, 5, R, 32), or null when ONCHIP
  if constexpr (LOCAL) {
    xcp = xcs = ycp = ycs = 0;
  }
  const int lane = threadIdx.x % LANES;
  const int b = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (b >= B) return;  // the whole warp
  const int ml = mlens[b];
  const int nl = nlens[b];
  const Stripe st = stripe_of<LOCAL_LAYERS, ONCHIP>(scratch, xb, b, M, R, ml);
  const size_t fb = static_cast<size_t>(b) * (M + 1);
  const bool holds_m = lane == st.t_act - 1;  // the lane of row mlens
  const int clip_i = add(xcp, go);            // column 0's x-prefix clip I
  const int d_clip = add(ycp, go);            // the y-prefix clip of row 1
  const int yclip0 = sub(d_clip, ge);         // ycp + go - ge: the y-prefix clip is yclip0 + i * ge

  int s_up_prev = 0;  // previous column's S, row i0 - 1 (from column 0 on)
  int in_s = 0, in_i = 0, in_st = 0, in_acc = 0, in_pk = 0;  // lane - 1's, from the last shuffle
  int y_next = nl > 0 ? yb[static_cast<size_t>(b) * N] : 0;  // y_j, read a step ahead
  const int steps = nl + st.t_act;  // columns 0..nlens
  for (int s = 0; s < steps; ++s) {
    const int j = s - lane;
    int c_s = 0, c_i = 0, c_st = 0, c_acc = 0, c_pk = 0;  // for lane + 1
    if (st.groups > 0 && j >= 0 && j <= nl) {
      int s_up_old = 0;    // previous column's S, row i - 1
      int p_up = 0;        // this column's P, row i - 1
      int st_up = 0;       // this column's S~, row i - 1
      int sbits_up = 0;    // this column's s-bits, row i - 1
      int run = 0;         // Ins i-bits run ending at row i - 1, capped at 15
      int acc = SENT;      // running max of S + xcs over rows 1..m-1
      int first = 0;       // its first row
      if (lane > 0) {
        s_up_old = s_up_prev;
        s_up_prev = in_s;
        p_up = in_i;
        st_up = in_st;
        acc = in_acc;
        sbits_up = in_pk & 0xF;
        run = (in_pk >> 4) & 0xF;
        first = in_pk >> 8;
      }
      uint16_t* tbcol = TB ? tb + (static_cast<size_t>(b) * (N + 1) + j) * Xp + st.i0 : nullptr;
      if (j == 0) {
        // column 0 (sw_pallas.py:1648-1711): I0 takes a gap or the x-prefix
        // clip, S the better of I0 and the clip, row m the x-suffix
        // replacement
        for (int g = 0; g < st.groups; ++g) {
          uint32_t w[GROUP / 2];
#pragma unroll
          for (int k = 0; k < GROUP; ++k) {
            const int r = g * GROUP + k;
            const int i = st.i0 + r;
            int s0 = 0;
            int sb = TB_START;
            int ib = TB_START;
            int i0v = MIN_I32;
            if (i >= 1) {
              const int gap_i = add(go, mul(ge, i - 1));
              const bool ins_wins = gap_i > clip_i;
              i0v = i == 1 ? go : (ins_wins ? gap_i : clip_i);
              if (i >= 2) ib = ins_wins ? TB_INS : TB_XCLIP_PREFIX;
              if (i < ml) {
                s0 = MIN_I32;
                take(s0, sb, i0v, TB_INS);
                take(s0, sb, xcp, TB_XCLIP_PREFIX);
                const int v = add(s0, xcs);
                if (v > acc) {
                  acc = v;
                  first = i;
                }
              } else {
                s0 = acc > MIN_I32 ? acc : MIN_I32;
                sb = TB_XCLIP_SUFFIX;
                take(s0, sb, i0v, TB_INS);
                take(s0, sb, xcp, TB_XCLIP_PREFIX);
              }
            }
            const int cell = ib | (TB_START << 4) | (sb << 8);
            run = ib == TB_INS ? min(run + 1, 15) : 0;
            const int word = TB ? cell | (run << 12) : cell;
            if (k & 1) {
              w[k / 2] |= static_cast<uint32_t>(word) << 16;
            } else {
              w[k / 2] = static_cast<uint32_t>(word);
            }
            st.at(0, r) = s0;
            st.at(1, r) = MIN_I32;
            st.at(2, r) = sb;
            const int sn = add(s0, ycs);
            const bool live = i == 0 || sn > MIN_I32;
            st.at(3, r) = i == 0 ? ycs : (live ? sn : MIN_I32);
            st.at(4, r) = live ? nl : 0;
            if (nl == 0 && i <= ml) {
              i_f[fb + i] = i0v;
              tbk[fb + i] = cell;
            }
            c_s = s0;
          }
          if constexpr (TB) {
            *reinterpret_cast<uint4*>(tbcol + g * GROUP) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      } else {
        const int yj = y_next;
        if (j < nl) y_next = yb[static_cast<size_t>(b) * N + j];
        const auto col = Subst::column(subst, yj);
        const bool last = j == nl;
        const int d_gap = add(go, mul(ge, j - 1));
        const int xclip = add(xcp, max(ycp, d_gap));  // the column's x-prefix clip
        for (int g = 0; g < st.groups; ++g) {
          const uint2 xw = *reinterpret_cast<const uint2*>(st.x + g * GROUP);
          uint32_t w[GROUP / 2];
#pragma unroll
          for (int k = 0; k < GROUP; ++k) {
            const int r = g * GROUP + k;
            const int i = st.i0 + r;
            int cell;
            int s_col;
            if (k == 0 && i == 0) {
              // row 0 (lane 0): Del against the y-prefix clip, then, in the
              // last column, the y-suffix takeover
              int dj0, db0;
              if (j == 1) {
                dj0 = go;
                db0 = TB_START;
              } else if (d_gap > d_clip) {
                dj0 = d_gap;
                db0 = TB_DEL;
              } else {
                dj0 = d_clip;
                db0 = TB_YCLIP_PREFIX;
              }
              s_col = dj0 > ycp ? dj0 : ycp;
              int sb0 = dj0 > ycp ? TB_DEL : TB_YCLIP_PREFIX;
              const int sn0 = st.at(3, 0);
              if (last && sn0 > s_col) {
                s_col = sn0;
                sb0 = TB_YCLIP_SUFFIX;
              } else if (add(s_col, ycs) > sn0) {
                st.at(3, 0) = add(s_col, ycs);
                st.at(4, 0) = nl - j;
              }
              cell = TB_START | (db0 << 4) | (sb0 << 8);
              s_up_old = st.at(0, 0);
              st_up = s_col;
              p_up = MIN_I32;
              sbits_up = sb0;
              run = 0;
              st.at(0, 0) = s_col;
              st.at(1, 0) = dj0;
              st.at(2, 0) = sb0;
              if (last) {
                i_f[fb] = MIN_I32;
                tbk[fb] = cell;
              }
            } else {
              const int xi = byte_of(xw, k);
              const int sp = st.at(0, r);
              const int dp = st.at(1, r);
              const int sbp = st.at(2, r);
              const int snp = st.at(3, r);
              const int m_val = add(s_up_old, col.score(xi));
              const int m_bits = TB_SUBST + (xi == yj);  // TB_MATCH = TB_SUBST + 1
              const int d_ext = add(dp, ge);
              const int d_open = add(sp, go);
              const bool d_wins = d_ext > d_open;
              const int best_d = d_wins ? d_ext : d_open;
              const int d_bits = d_wins ? TB_DEL : sbp;
              const int rge = mul(i, ge);
              const int t_open = add(st_up, go);
              const int i_ext = add(p_up, rge);  // I[i-1] + ge
              const int p = max(p_up, sub(t_open, rge));
              const int best_i = add(p, rge);
              const int i_bits = i_ext > t_open ? TB_INS : sbits_up;
              const int yclip = add(yclip0, rge);  // the y-prefix clip of row i
              s_col = m_val;
              int s_bits = m_bits;
              take(s_col, s_bits, best_i, TB_INS);
              take(s_col, s_bits, best_d, TB_DEL);
              take(s_col, s_bits, xclip, TB_XCLIP_PREFIX);
              take(s_col, s_bits, yclip, TB_YCLIP_PREFIX);
              if (i < ml) {
                const int v = add(s_col, xcs);
                if (v > acc) {
                  acc = v;
                  first = i;
                }
              } else {
                // row m: the x-suffix clip seeds the chain, the cell's own
                // candidates take it over only where strictly greater
                s_col = acc > MIN_I32 ? acc : MIN_I32;
                s_bits = TB_XCLIP_SUFFIX;
                take(s_col, s_bits, m_val, m_bits);
                take(s_col, s_bits, best_i, TB_INS);
                take(s_col, s_bits, best_d, TB_DEL);
                take(s_col, s_bits, xclip, TB_XCLIP_PREFIX);
                take(s_col, s_bits, yclip, TB_YCLIP_PREFIX);
              }
              cell = i_bits | (d_bits << 4) | (s_bits << 8);
              if constexpr (TB) {  // the run nibble, in tbk too (as K7 and K9)
                run = i_bits == TB_INS ? min(run + 1, 15) : 0;
                cell |= run << 12;
              }
              if (add(s_col, ycs) > snp) {
                st.at(3, r) = add(s_col, ycs);
                st.at(4, r) = nl - j;
              }
              s_up_old = sp;
              st_up = max(max(max(m_val, best_d), yclip), xclip);
              p_up = p;
              sbits_up = s_bits;
              st.at(0, r) = s_col;
              st.at(1, r) = best_d;
              st.at(2, r) = s_bits;
              if (last && i <= ml) {
                i_f[fb + i] = best_i;
                tbk[fb + i] = cell;
              }
            }
            if (k & 1) {
              w[k / 2] |= static_cast<uint32_t>(cell) << 16;
            } else {
              w[k / 2] = static_cast<uint32_t>(cell);
            }
            c_s = s_col;
          }
          if constexpr (TB) {
            *reinterpret_cast<uint4*>(tbcol + g * GROUP) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
      if (TB && holds_m) lx[static_cast<size_t>(j) * B + b] = acc > MIN_I32 ? ml - first : 0;
      c_i = p_up;
      c_st = st_up;
      c_acc = acc;
      c_pk = sbits_up | (run << 4) | (first << 8);
    }
    in_s = __shfl_up_sync(FULL, c_s, 1);
    in_i = __shfl_up_sync(FULL, c_i, 1);
    in_st = __shfl_up_sync(FULL, c_st, 1);
    in_acc = __shfl_up_sync(FULL, c_acc, 1);
    in_pk = __shfl_up_sync(FULL, c_pk, 1);
  }
  for (int r = 0; r < R && lane < st.t_act && st.i0 + r <= ml; ++r) {
    const size_t o = fb + st.i0 + r;
    s_f[o] = st.at(0, r);
    sn_f[o] = st.at(3, r);
    ly_f[o] = st.at(4, r);
  }
}

// K5 (Subst = MatchParams) and K12 (Lut). TB: store the cells (the run
// nibble is in tbk either way)
template <bool TB, bool ONCHIP, class Subst>
__global__ void __launch_bounds__(WARPS * LANES) scan_semiglobal_warp_kernel(
    const uint8_t* __restrict__ xb,  // (B, M)
    const uint8_t* __restrict__ yb,  // (B, N)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M, int N,
    int Xp, int R, int go, int ge,
    typename Subst::Param subst,  // MatchParams: (ma, mi); Lut: the (256, 256) table, row x
    int ycp, int ycs,
    uint16_t* __restrict__ tb,    // (B, N, Xp), or null
    int* __restrict__ s_f,        // (B, M + 1) each
    int* __restrict__ i_f,
    int* __restrict__ sn_f,
    int* __restrict__ ly_f,
    int* __restrict__ tbk,
    int* __restrict__ scratch) {  // (B, 5, R, 32), or null when ONCHIP
  const int lane = threadIdx.x % LANES;
  const int b = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (b >= B) return;  // the whole warp
  const int ml = mlens[b];
  const int nl = nlens[b];
  const Stripe st = stripe_of<LOCAL_LAYERS, ONCHIP>(scratch, xb, b, M, R, ml);
  const size_t fb = static_cast<size_t>(b) * (M + 1);

  // column 0: S[i] = go + ge*(i-1), s-bits Ins (i >= 1); i-bits Start at
  // i <= 1; Sn/Ly = (ycs, nl) at row 0 and (S + ycs, nl) below
  for (int r = 0; r < R && lane < st.t_act; ++r) {
    const int i = st.i0 + r;
    const int s0 = init_s(i, go, ge);
    st.at(0, r) = s0;
    st.at(1, r) = MIN_I32;
    st.at(2, r) = i == 0 ? TB_START : TB_INS;
    st.at(3, r) = i == 0 ? ycs : add(s0, ycs);
    st.at(4, r) = nl;
    if (nl == 0 && i <= ml) {
      i_f[fb + i] = MIN_I32;
      tbk[fb + i] = (i <= 1 ? TB_START : TB_INS) | ((i == 0 ? TB_START : TB_INS) << 8);
    }
  }

  const int d_clip = add(ycp, go);
  int s_up_prev = lane > 0 ? init_s(st.i0 - 1, go, ge) : 0;  // previous column's S, row i0 - 1
  int in_s = 0, in_i = 0, in_st = 0, in_pk = 0;  // lane - 1's last row, from the last shuffle
  int y_next = nl > 0 ? yb[static_cast<size_t>(b) * N] : 0;  // y_j, read a step ahead
  const int steps = nl > 0 ? nl + st.t_act - 1 : 0;
  for (int s = 1; s <= steps; ++s) {
    const int j = s - lane;
    int c_s = 0, c_i = 0, c_st = 0, c_pk = 0;  // this stripe's last row, for lane + 1
    if (st.groups > 0 && j >= 1 && j <= nl) {
      const int yj = y_next;
      if (j < nl) y_next = yb[static_cast<size_t>(b) * N + j];
      const auto col = Subst::column(subst, yj);
      const bool last = j == nl;
      int s_up_old = 0;  // previous column's S, row i - 1
      int p_up = 0;      // this column's P, row i - 1
      int st_up = 0;     // this column's S~, row i - 1
      int sbits_up = 0;  // this column's s-bits, row i - 1
      int run = 0;       // Ins i-bits run ending at row i - 1, capped at 15
      if (lane > 0) {
        s_up_old = s_up_prev;
        s_up_prev = in_s;
        p_up = in_i;
        st_up = in_st;
        sbits_up = in_pk & 0xF;
        run = in_pk >> 4;
      }
      uint16_t* tbcol = TB ? tb + (static_cast<size_t>(b) * N + (j - 1)) * Xp + st.i0 : nullptr;
      for (int g = 0; g < st.groups; ++g) {
        const uint2 xw = *reinterpret_cast<const uint2*>(st.x + g * GROUP);
        uint32_t w[GROUP / 2];
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          const int r = g * GROUP + k;
          const int i = st.i0 + r;
          int cell;
          int s_col;
          if (k == 0 && i == 0) {
            // row 0 (lane 0): Del against the y-prefix clip, then, in the
            // last column, the y-suffix takeover
            const int d_gap = add(go, mul(ge, j - 1));
            int dj0, db0;
            if (j == 1) {
              dj0 = go;
              db0 = TB_START;
            } else if (d_gap > d_clip) {
              dj0 = d_gap;
              db0 = TB_DEL;
            } else {
              dj0 = d_clip;
              db0 = TB_YCLIP_PREFIX;
            }
            s_col = dj0 > ycp ? dj0 : ycp;
            int sb0 = dj0 > ycp ? TB_DEL : TB_YCLIP_PREFIX;
            const int sn0 = st.at(3, 0);
            if (last && sn0 > s_col) {
              s_col = sn0;
              sb0 = TB_YCLIP_SUFFIX;
            } else if (add(s_col, ycs) > sn0) {
              st.at(3, 0) = add(s_col, ycs);
              st.at(4, 0) = nl - j;
            }
            cell = TB_START | (db0 << 4) | (sb0 << 8);
            s_up_old = st.at(0, 0);
            st_up = s_col;
            p_up = MIN_I32;
            sbits_up = sb0;
            run = 0;
            st.at(0, 0) = s_col;
            st.at(1, 0) = dj0;
            st.at(2, 0) = sb0;
            if (last) {
              i_f[fb] = MIN_I32;
              tbk[fb] = cell;
            }
          } else {
            const int xi = byte_of(xw, k);
            const int sp = st.at(0, r);
            const int dp = st.at(1, r);
            const int sbp = st.at(2, r);
            const int snp = st.at(3, r);
            const int m_val = add(s_up_old, col.score(xi));
            const int d_ext = add(dp, ge);
            const int d_open = add(sp, go);
            const bool d_wins = d_ext > d_open;
            const int best_d = d_wins ? d_ext : d_open;
            const int d_bits = d_wins ? TB_DEL : sbp;
            const int rge = mul(i, ge);
            const int t_open = add(st_up, go);
            const int i_ext = add(p_up, rge);  // I[i-1] + ge
            const int p = max(p_up, sub(t_open, rge));
            const int best_i = add(p, rge);
            const int i_bits = i_ext > t_open ? TB_INS : sbits_up;
            const int yclip = add(d_clip, mul(ge, i - 1));  // the y-prefix clip of row i
            s_col = m_val;
            int s_bits = TB_SUBST + (xi == yj);  // TB_MATCH = TB_SUBST + 1
            take(s_col, s_bits, best_i, TB_INS);
            take(s_col, s_bits, best_d, TB_DEL);
            take(s_col, s_bits, yclip, TB_YCLIP_PREFIX);
            run = i_bits == TB_INS ? min(run + 1, 15) : 0;
            cell = i_bits | (d_bits << 4) | (s_bits << 8) | (run << 12);
            if (add(s_col, ycs) > snp) {  // against the row's Sn before this column
              st.at(3, r) = add(s_col, ycs);
              st.at(4, r) = nl - j;
            }
            s_up_old = sp;
            st_up = max(max(m_val, best_d), yclip);
            p_up = p;
            sbits_up = s_bits;
            st.at(0, r) = s_col;
            st.at(1, r) = best_d;
            st.at(2, r) = s_bits;
            if (last && i <= ml) {
              i_f[fb + i] = best_i;
              tbk[fb + i] = cell;
            }
          }
          if (k & 1) {
            w[k / 2] |= static_cast<uint32_t>(cell) << 16;
          } else {
            w[k / 2] = static_cast<uint32_t>(cell);
          }
          c_s = s_col;
        }
        if constexpr (TB) {
          *reinterpret_cast<uint4*>(tbcol + g * GROUP) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      c_i = p_up;
      c_st = st_up;
      c_pk = sbits_up | (run << 4);
    }
    in_s = __shfl_up_sync(FULL, c_s, 1);
    in_i = __shfl_up_sync(FULL, c_i, 1);
    in_st = __shfl_up_sync(FULL, c_st, 1);
    in_pk = __shfl_up_sync(FULL, c_pk, 1);
  }
  for (int r = 0; r < R && lane < st.t_act && st.i0 + r <= ml; ++r) {
    const size_t o = fb + st.i0 + r;
    s_f[o] = st.at(0, r);
    sn_f[o] = st.at(3, r);
    ly_f[o] = st.at(4, r);
  }
}

// Stripe rows and dynamic shared bytes of a launch (ops/sw.py warp_geometry
// computes the same); 0 rows when it cannot launch.
int geometry(int M, int layers, bool onchip, size_t* smem) {
  const int R = (M + 1 + GROUP * LANES - 1) / (GROUP * LANES) * GROUP;
  *smem = WARPS * warp_ints(layers, R, onchip) * sizeof(int);
  return *smem <= SMEM_MAX ? R : 0;
}

template <class Kernel>
int opt_in(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

int blocks(int B) { return (B + WARPS - 1) / WARPS; }

template <class Subst>
int launch_global(const void* xb, const void* yb, const void* mlens, const void* nlens, int B, int M,
                  int N, int Xp, int go, int ge, typename Subst::Param subst, void* score, void* tb,
                  void* tbk, void* scratch, void* stream) {
  size_t smem = 0;
  const int R = geometry(M, GLOBAL_LAYERS, !scratch, &smem);
  if (B < 1 || M < 0 || N < 0 || R == 0 || (tb && (Xp < M + 1 || Xp % GROUP)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tb ? (scratch ? scan_global_warp_kernel<true, false, Subst> : scan_global_warp_kernel<true, true, Subst>)
                   : (scratch ? scan_global_warp_kernel<false, false, Subst>
                              : scan_global_warp_kernel<false, true, Subst>);
  const int rc = opt_in(kernel, smem);
  if (rc) return rc;
  kernel<<<blocks(B), WARPS * LANES, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xb), static_cast<const uint8_t*>(yb),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, N, Xp, R, go, ge, subst,
      static_cast<int*>(score), static_cast<uint16_t*>(tb), static_cast<int*>(tbk),
      static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <class Subst>
int launch_scores(const void* xb, const void* yb, const void* mlens, const void* nlens, int B, int M,
                  int N, int go, int ge, typename Subst::Param subst, void* score, void* scratch,
                  void* stream) {
  size_t smem = 0;
  const int R = geometry(M, SCORE_LAYERS, !scratch, &smem);
  if (B < 1 || M < 0 || N < 0 || R == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = scratch ? scores_global_warp_kernel<false, Subst> : scores_global_warp_kernel<true, Subst>;
  const int rc = opt_in(kernel, smem);
  if (rc) return rc;
  kernel<<<blocks(B), WARPS * LANES, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xb), static_cast<const uint8_t*>(yb),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, N, R, go, ge, subst,
      static_cast<int*>(score), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <bool LOCAL, class Subst>
int launch_clip(const void* xb, const void* yb, const void* mlens, const void* nlens, int B, int M,
                int N, int Xp, int go, int ge, typename Subst::Param subst, int xcp, int xcs, int ycp,
                int ycs, void* tb, void* lx, void* s_f, void* i_f, void* sn_f, void* ly_f, void* tbk,
                void* scratch, void* stream) {
  size_t smem = 0;
  const int R = geometry(M, LOCAL_LAYERS, !scratch, &smem);
  if (B < 1 || M < 0 || N < 0 || R == 0 || !tb != !lx || (tb && (Xp < M + 1 || Xp % GROUP)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tb ? (scratch ? scan_clip_warp_kernel<true, false, LOCAL, Subst>
                              : scan_clip_warp_kernel<true, true, LOCAL, Subst>)
                   : (scratch ? scan_clip_warp_kernel<false, false, LOCAL, Subst>
                              : scan_clip_warp_kernel<false, true, LOCAL, Subst>);
  const int rc = opt_in(kernel, smem);
  if (rc) return rc;
  kernel<<<blocks(B), WARPS * LANES, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xb), static_cast<const uint8_t*>(yb),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, N, Xp, R, go, ge, subst,
      xcp, xcs, ycp, ycs, static_cast<uint16_t*>(tb), static_cast<int*>(lx),
      static_cast<int*>(s_f), static_cast<int*>(i_f), static_cast<int*>(sn_f),
      static_cast<int*>(ly_f), static_cast<int*>(tbk), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <class Subst>
int launch_semiglobal(const void* xb, const void* yb, const void* mlens, const void* nlens, int B,
                      int M, int N, int Xp, int go, int ge, typename Subst::Param subst, int ycp,
                      int ycs, void* tb, void* s_f, void* i_f, void* sn_f, void* ly_f, void* tbk,
                      void* scratch, void* stream) {
  size_t smem = 0;
  const int R = geometry(M, LOCAL_LAYERS, !scratch, &smem);
  if (B < 1 || M < 0 || N < 0 || R == 0 || (tb && (Xp < M + 1 || Xp % GROUP)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tb ? (scratch ? scan_semiglobal_warp_kernel<true, false, Subst>
                              : scan_semiglobal_warp_kernel<true, true, Subst>)
                   : (scratch ? scan_semiglobal_warp_kernel<false, false, Subst>
                              : scan_semiglobal_warp_kernel<false, true, Subst>);
  const int rc = opt_in(kernel, smem);
  if (rc) return rc;
  kernel<<<blocks(B), WARPS * LANES, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xb), static_cast<const uint8_t*>(yb),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, N, Xp, R, go, ge, subst,
      ycp, ycs, static_cast<uint16_t*>(tb), static_cast<int*>(s_f), static_cast<int*>(i_f),
      static_cast<int*>(sn_f), static_cast<int*>(ly_f), static_cast<int*>(tbk),
      static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Entry points: xb (B, M) and yb (B, N) uint8 row-major; lut a (256, 256)
// int32 table on the device; tb null for a score-only call, else the
// pair-major (B, N, Xp) (K1, K11, K5, K12) or (B, N+1, Xp) (K7, K7-LUT, K9, K9-LUT)
// uint16 tensor with Xp >= M + 1 a multiple of 8; scratch null to keep the
// row state in shared memory, else a (B, layers, R, 32) int32 buffer in the geometry
// above (layers 3 for K1 and K11, 2 for K18 and K3, 5 for K7, K7-LUT, K9, K9-LUT,
// K5 and K12).

// K1: the global DP with its traceback, match / mismatch scores ma / mi.
int sw_scan_global(const void* xb, const void* yb, const void* mlens, const void* nlens, int B,
                   int M, int N, int Xp, int go, int ge, int ma, int mi, void* score, void* tb,
                   void* tbk, void* scratch, void* stream) {
  return launch_global<MatchParams>(xb, yb, mlens, nlens, B, M, N, Xp, go, ge, make_int2(ma, mi), score, tb,
                                    tbk, scratch, stream);
}

// K11: K1 fed by the LUT.
int sw_scan_global_lut(const void* xb, const void* yb, const void* mlens,
                       const void* nlens, int B, int M, int N, int Xp, int go,
                       int ge, const void* lut, void* score, void* tb, void* tbk,
                       void* scratch, void* stream) {
  return launch_global<Lut>(xb, yb, mlens, nlens, B, M, N, Xp, go, ge, static_cast<const int*>(lut), score, tb,
                            tbk, scratch, stream);
}

// K3 at short x: the global score, match / mismatch scores ma / mi.
int sw_scores_global_warp(const void* xb, const void* yb, const void* mlens,
                          const void* nlens, int B, int M, int N, int go, int ge,
                          int ma, int mi, void* score, void* scratch, void* stream) {
  return launch_scores<MatchParams>(xb, yb, mlens, nlens, B, M, N, go, ge, make_int2(ma, mi), score,
                                    scratch, stream);
}

// K18: K3 fed by the LUT, score only.
int sw_scores_global_lut(const void* xb, const void* yb, const void* mlens,
                         const void* nlens, int B, int M, int N, int go, int ge,
                         const void* lut, void* score, void* scratch, void* stream) {
  return launch_scores<Lut>(xb, yb, mlens, nlens, B, M, N, go, ge, static_cast<const int*>(lut), score,
                            scratch, stream);
}

// K7: the local DP under match / mismatch scores ma / mi; needs gap_open,
// gap_extend <= 0. lx null with tb.
int sw_scan_local(const void* xb, const void* yb, const void* mlens, const void* nlens, int B,
                  int M, int N, int Xp, int go, int ge, int ma, int mi, void* tb, void* lx,
                  void* s_f, void* i_f, void* sn_f, void* ly_f, void* tbk, void* scratch,
                  void* stream) {
  return launch_clip<true, MatchParams>(xb, yb, mlens, nlens, B, M, N, Xp, go, ge, make_int2(ma, mi),
                                        0, 0, 0, 0, tb, lx, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
}

// K7-LUT: K7 fed by the LUT; needs gap_open, gap_extend <= 0. lx null with tb.
int sw_scan_local_lut(const void* xb, const void* yb, const void* mlens,
                      const void* nlens, int B, int M, int N, int Xp, int go,
                      int ge, const void* lut, void* tb, void* lx, void* s_f,
                      void* i_f, void* sn_f, void* ly_f, void* tbk,
                      void* scratch, void* stream) {
  return launch_clip<true, Lut>(xb, yb, mlens, nlens, B, M, N, Xp, go, ge, static_cast<const int*>(lut),
                                0, 0, 0, 0, tb, lx, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
}

// K9: the custom-clip DP under match / mismatch scores ma / mi, the four
// clip penalties live; needs gap_open, gap_extend <= 0. lx null with tb.
int sw_scan_custom(const void* xb, const void* yb, const void* mlens, const void* nlens, int B,
                   int M, int N, int Xp, int go, int ge, int ma, int mi, int xcp, int xcs, int ycp,
                   int ycs, void* tb, void* lx, void* s_f, void* i_f, void* sn_f, void* ly_f,
                   void* tbk, void* scratch, void* stream) {
  return launch_clip<false, MatchParams>(xb, yb, mlens, nlens, B, M, N, Xp, go, ge, make_int2(ma, mi),
                                         xcp, xcs, ycp, ycs, tb, lx, s_f, i_f, sn_f, ly_f, tbk, scratch,
                                         stream);
}

// K9-LUT: K9 fed by the LUT, the four clip penalties live; needs gap_open,
// gap_extend <= 0. lx null with tb.
int sw_scan_custom_lut(const void* xb, const void* yb, const void* mlens,
                       const void* nlens, int B, int M, int N, int Xp, int go,
                       int ge, const void* lut, int xcp, int xcs, int ycp, int ycs,
                       void* tb, void* lx, void* s_f, void* i_f, void* sn_f,
                       void* ly_f, void* tbk, void* scratch, void* stream) {
  return launch_clip<false, Lut>(xb, yb, mlens, nlens, B, M, N, Xp, go, ge, static_cast<const int*>(lut),
                                 xcp, xcs, ycp, ycs, tb, lx, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
}

// K5: the semiglobal-family DP under match / mismatch scores ma / mi;
// ycp and ycs the y-clip penalties (0 / 0 in semiglobal mode).
int sw_scan_semiglobal(const void* xb, const void* yb, const void* mlens, const void* nlens,
                       int B, int M, int N, int Xp, int go, int ge, int ma, int mi, int ycp,
                       int ycs, void* tb, void* s_f, void* i_f, void* sn_f, void* ly_f,
                       void* tbk, void* scratch, void* stream) {
  return launch_semiglobal<MatchParams>(xb, yb, mlens, nlens, B, M, N, Xp, go, ge, make_int2(ma, mi),
                                        ycp, ycs, tb, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
}

// K12: K5 fed by the LUT; ycp and ycs the y-clip penalties (0 / 0 in
// semiglobal mode).
int sw_scan_semiglobal_lut(const void* xb, const void* yb, const void* mlens,
                           const void* nlens, int B, int M, int N, int Xp, int go,
                           int ge, const void* lut, int ycp, int ycs, void* tb,
                           void* s_f, void* i_f, void* sn_f, void* ly_f, void* tbk,
                           void* scratch, void* stream) {
  return launch_semiglobal<Lut>(xb, yb, mlens, nlens, B, M, N, Xp, go, ge, static_cast<const int*>(lut),
                                ycp, ycs, tb, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
}

}  // extern "C"
