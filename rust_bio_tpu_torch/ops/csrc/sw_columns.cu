// K15 sw_scan_columns and K15-LUT sw_scan_columns_lut: the clip-mode column
// scan of long x, as a row-stripe wavefront over one pair a block.
//
// Replaces rust_bio_tpu/ops/sw_pallas.py:313 _kernel_scan_full_mp
// (scan_columns_pallas_mp :449, which runs batched.py _column_body and packs
// each column's Lx into the high nibbles of tb rows 0-2, hence M < 4096)
// and, under a LUT, the XLA engine batched.py:948 _align_batch_device over
// _column_body :228 (_scan_columns_xla), which the JAX package runs at
// M >= 4096. _column_body is K9's recurrence (csrc/sw_warp.cu) for any
// four clips; K15 gives it with 12-bit cells i | d << 4 | s << 8 in tb and
// tbk, no run nibble, and each column's x-suffix clip length in full in lx,
// so M is limited only by the uint16 clip lengths of the walk (M <= 65534).
//
// Outputs: tb, pair-major (B, N+1, Xp) uint16 with a row pitch Xp >= M + 1
// that is a multiple of 8: the cell of DP cell (i, j) of pair b at
// tb[(b * (N + 1) + j) * Xp + i], for columns j = 0..nlens (column 0, the
// init column, at index 0) and rows i = 0..mlens (ops/sw.py returns the
// (N+1, M+1, B) view, which K15-walk, the suffix fixups and the tests read
// through its strides); lx (N+1, B) int32, the x-suffix clip length of each
// column's row mlens; the finals at j = nlens that the suffix fixups read:
// S, I, Sn, Ly and the cells tbk, each (B, M+1) int32. A null tb skips the
// tb and lx stores (score-only).
//
// Bound on this card: the larger of the tb bytes over HBM (2 bytes a cell)
// and about 45 integer operations a cell over the int32 rate. What held the
// one-thread-a-pair kernel before it back was neither: one thread walked a
// pair's 29 M cells in order, two live lanes an SM, so each cell's
// dependency chain and its shared-memory round trips set the pace (249-281
// ns a cell on an H100, PERF.md).
//
// Design: one block per pair. Thread t of T owns the stripe of R rows
// [t * R, t * R + R) (row 0 in thread 0) and the block sweeps the columns as
// a skewed wavefront: at step s thread t computes column j = s - t of its
// rows, for 0 <= j <= nlens, so a pair takes nlens + ceil((mlens + 1) / R)
// steps, one __syncthreads() each. Within a column the only sequential
// dependencies run down the rows: the insertion carry P, the S~ and s-bits
// of the row above, the previous column's S of the row above (the
// diagonal), and the x-suffix running maximum with its first row. Thread t
// hands those six words of its last row to thread t + 1 through a
// double-buffered shared slot, [2][6][T]: written at step s into buffer
// s & 1, read at step s + 1, when the writer is already on its next column.
// The diagonal of the first row is the S that the slot carried one step
// earlier, kept in a register. What flows along a row stays with the row's
// owner: S, D, s-bits, Sn and Ly, five int32 layers [5][R][T] (lane t
// innermost, so a warp's accesses are conflict-free) in shared memory, or,
// above COLUMNS_SHARED_MAX_M of ops/sw.py, in the block's own contiguous
// slice of a (B, 5, R, T) device scratch. x's R bytes of the stripe are
// staged in shared memory once; y_j is read one step ahead. The y-prefix
// clip of row i and the x-prefix clip of column j are closed forms.
//
// Geometry (ops/sw.py columns_geometry, which the wrapper uses to size the
// scratch, computes the same): R = 8 * ceil((M + 1) / (8 * 1024)),
// T = ceil((M + 1) / R) rounded up to a multiple of 32 (at most 1,024); at
// M = 5,588, R = 8 and T = 704, 149 KB of shared memory, one block an SM.
// The substitution source is a template parameter: MatchParams, or a
// (256, 256) LUT read through the read-only path; the Match/Subst bit is
// byte equality under either.
//
// The tb stores: a thread's cells of a column are its R rows, 2R
// contiguous bytes of the pair-major tb, and thread t + 1 writes the next
// 2R a step later. A thread shifts each row's cell into a 16-byte word
// (four funnel shifts) and stores the word when it completes an 8-row
// group, so R, a multiple of 8, makes every store an aligned 16-byte one;
// the thread that holds row mlens closes its last group early, the rows
// past mlens zero. The layout it replaces kept the pair innermost
// ((N+1, M+1, B)): each block stored 2 bytes in each 32-byte sector, over
// 90% of a launch at x of 5.6 kb on an H100 (268 ms against 21 score-only,
// PERF.md). On phase 3e's STR pairs (scripts/columns_trial.py, H100): 49 ms
// at 1,024 stripes with plain stores, 28.5 with streaming ones, 31 with the
// cells computed and no store at all; at 512 stripes (R = 16) 40.6, 34.4
// and 36.0; at 256 (R = 24) 48 with plain stores.
//
// Exactness, as csrc/sw_custom.cu (sw_pallas.py:1601-1881): int32
// arithmetic wraps as in XLA; D starts at MIN_I32 = -858993459; the running
// maximum starts at -2^31 + 1 and counts only when it exceeds MIN_I32; every
// selection is a strict '>' with priority Match/Subst > Ins > Del >
// Xclip-prefix > Yclip-prefix; the per-row y-prefix clip ycp + go + ge*(i-1)
// and the per-column x-prefix clip xcp + max(ycp, go + ge*(j-1)) enter
// S~ = max(m, D, yclip, xclip), hence the I-open candidate; I is the prefix
// maximum of the JAX scan (csrc/sw_warp.cu), a stripe hands its P down; S
// is chosen from MIN_I32 up (Xclip-suffix bits), as batched.py _column_body
// does, which parts from K9's choice only where every candidate wrapped
// below MIN_I32; row 0 takes Del
// or the y-prefix clip, and in the last column the y-suffix accumulator may
// take row 0 over; row mlens takes the x-suffix clip as the seed of its
// chain, its own candidates replacing it only where strictly greater, and
// the thread that holds row mlens writes lx once the carried maximum
// reaches it; the Sn/Ly update reads S after the row-m replacement. The
// final I of a lane with nlens = 0 is column 0's I0 (rows >= 1), as the
// reference's column 0 holds it.

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
constexpr int SENT = -2147483647;    // -2^31 + 1: the empty running maximum
constexpr int T_STRIPES = 1024;      // most threads (stripes) a block
constexpr int GROUP = 8;             // rows a thread stores at once
constexpr int CARRIES = 6;           // S, S~, P, s-bits, running max, its first row
constexpr int LAYERS = 5;            // S, D, s-bits, Sn, Ly
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may opt into

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

// s, bits <- cand, cbits when cand is strictly greater
__device__ __forceinline__ void take(int& s, int& bits, int cand, int cbits) {
  if (cand > s) {
    s = cand;
    bits = cbits;
  }
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

// A thread's cells of one 8-row group of a column, shifted in from the top:
// after the group's last row, w0..w3 hold its 8 cells in row order, one
// 16-byte streaming store (evict-first: the tb is written once, read by the
// walk later, and would otherwise push the row state out of L2).
struct Pack {
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  __device__ __forceinline__ void push(uint32_t cell) {
    w0 = __funnelshift_r(w0, w1, 16);
    w1 = __funnelshift_r(w1, w2, 16);
    w2 = __funnelshift_r(w2, w3, 16);
    w3 = __funnelshift_r(w3, cell, 16);
  }
  __device__ __forceinline__ void store(uint16_t* dst) const {
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w0, w1, w2, w3));
  }
  // after the row r - 1 of the stripe (rows 0..r-1 pushed): store the group
  // that a stop before its end left open, its rows past the stop zero
  __device__ __forceinline__ void close(uint16_t* col, int r) {
    if (r & (GROUP - 1)) {
      for (int k = r; k & (GROUP - 1); ++k) push(0);
      store(col + (r & ~(GROUP - 1)));
    }
  }
};

// ONCHIP: the row state in shared memory, else in the device scratch
template <bool TB, bool ONCHIP, class Subst>
__global__ void __launch_bounds__(T_STRIPES) scan_columns_kernel(
    const uint8_t* __restrict__ xt,  // (M, B)
    const uint8_t* __restrict__ yt,  // (N, B)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M,
    int N, int Xp, int R, int go, int ge, Subst sub, int xcp, int xcs, int ycp, int ycs,
    uint16_t* __restrict__ tb,    // (B, N + 1, Xp), or null
    int* __restrict__ lx,         // (N + 1, B), or null
    int* __restrict__ s_f,        // (B, M + 1) each
    int* __restrict__ i_f,
    int* __restrict__ sn_f,
    int* __restrict__ ly_f,
    int* __restrict__ tbk,
    int* __restrict__ scratch) {  // (B, 5, R, T), or null when ONCHIP
  extern __shared__ int smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int rows = M + 1;
  const int ml = mlens[b];
  const int nl = nlens[b];
  const size_t fb = static_cast<size_t>(b) * rows;

  int* carry = smem;  // [2][CARRIES][T]
  int* state;         // [LAYERS][R][T]
  if constexpr (ONCHIP) {
    state = smem + 2 * CARRIES * T;
  } else {
    state = scratch + static_cast<size_t>(b) * LAYERS * R * T;
  }
  uint8_t* xs = reinterpret_cast<uint8_t*>(smem + 2 * CARRIES * T + (ONCHIP ? LAYERS * R * T : 0));
  auto at = [&](int k, int r) -> int& { return state[(k * R + r) * T + t]; };

  const int i0 = t * R;                        // this stripe's first row
  // this stripe's cells of column 0 (column j at + j * Xp)
  uint16_t* const tb0 = TB ? tb + static_cast<size_t>(b) * (N + 1) * Xp + i0 : nullptr;
  const int t_act = ml / R + 1;                // stripes that hold a row <= mlens
  const bool owner = t < t_act;
  const bool holds_m = t == t_act - 1;         // the stripe of row mlens
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    xs[r * T + t] = (i >= 1 && i <= ml) ? xt[static_cast<size_t>(i - 1) * B + b] : 0;
  }

  const int clip_i = add(xcp, go);
  const int d_clip = add(ycp, go);
  int s_up_prev = MIN_I32;  // the previous column's S at row i0 - 1
  int y_next = 0;           // y_{j+1}, read a step ahead
  const int steps = nl + t_act;
  for (int s = 0; s < steps; ++s) {
    const int j = s - t;
    if (owner && j >= 0 && j <= nl) {
      const int* in = carry + ((s + 1) & 1) * CARRIES * T + (t > 0 ? t - 1 : 0);  // t - 1, step s - 1
      int* out = carry + (s & 1) * CARRIES * T + t;
      const bool last = j == nl;
      const int yj = y_next;
      if (j < nl) y_next = yt[static_cast<size_t>(j) * B + b];
      int acc = SENT;  // running max of S + xcs over rows 1..m-1
      int first = 0;
      int s_new = MIN_I32;  // this column's S at the stripe's last row
      uint16_t* const tbcol = TB ? tb0 + static_cast<size_t>(j) * Xp : nullptr;
      Pack pk;
      if (j == 0) {
        // column 0 (sw_pallas.py:1648-1711): I0 takes a gap or the
        // x-prefix clip, S the better of I0 and the clip, row m the
        // x-suffix replacement
        if (t > 0) {
          s_up_prev = in[0];
          acc = in[4 * T];
          first = in[5 * T];
        }
        int r = 0;
        for (; r < R; ++r) {
          const int i = i0 + r;
          if (i > ml) break;
          int s0 = 0;
          int sb = TB_START;
          int ib = TB_START;
          int iv = MIN_I32;
          if (i >= 1) {
            const int gap_i = add(go, mul(ge, i - 1));
            const bool ins_wins = gap_i > clip_i;
            iv = i == 1 ? go : (ins_wins ? gap_i : clip_i);
            if (i >= 2) ib = ins_wins ? TB_INS : TB_XCLIP_PREFIX;
            if (i < ml) {
              s0 = MIN_I32;
              take(s0, sb, iv, TB_INS);
              take(s0, sb, xcp, TB_XCLIP_PREFIX);
              const int v = add(s0, xcs);
              if (v > acc) {
                acc = v;
                first = i;
              }
            } else {
              s0 = acc > MIN_I32 ? acc : MIN_I32;
              sb = TB_XCLIP_SUFFIX;
              take(s0, sb, iv, TB_INS);
              take(s0, sb, xcp, TB_XCLIP_PREFIX);
            }
          }
          const int cell = ib | (TB_START << 4) | (sb << 8);
          if constexpr (TB) {
            pk.push(cell);
            if ((r & (GROUP - 1)) == GROUP - 1) pk.store(tbcol + r - (GROUP - 1));
          }
          at(0, r) = s0;
          at(1, r) = MIN_I32;
          at(2, r) = sb;
          const int sn = add(s0, ycs);
          const bool live = i == 0 || sn > MIN_I32;
          at(3, r) = i == 0 ? ycs : (live ? sn : MIN_I32);
          at(4, r) = live ? nl : 0;
          if (last) {
            i_f[fb + i] = iv;
            tbk[fb + i] = cell;
          }
          s_new = s0;
        }
        if constexpr (TB) pk.close(tbcol, r);
        out[0] = s_new;
        out[4 * T] = acc;
        out[5 * T] = first;
      } else {
        const int d_gap = add(go, mul(ge, j - 1));
        // the column's x-prefix clip score
        const int xclip = add(xcp, max(ycp, d_gap));
        int s_up_old;  // previous column's S, row i - 1
        int st_up;     // this column's S~, row i - 1
        int p_up;      // this column's P, row i - 1
        int sbits_up;  // this column's s-bits, row i - 1
        int r = 0;
        if (t == 0) {
          // row 0: Del against the y-prefix clip, then the y-suffix takeover
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
          int s0j = dj0 > ycp ? dj0 : ycp;
          int sb0 = dj0 > ycp ? TB_DEL : TB_YCLIP_PREFIX;
          const int sn0 = at(3, 0);
          if (last && sn0 > s0j) {
            s0j = sn0;
            sb0 = TB_YCLIP_SUFFIX;
          } else if (add(s0j, ycs) > sn0) {
            at(3, 0) = add(s0j, ycs);
            at(4, 0) = nl - j;
          }
          const int cell0 = TB_START | (db0 << 4) | (sb0 << 8);
          if constexpr (TB) pk.push(cell0);
          s_up_old = at(0, 0);
          st_up = s0j;
          p_up = MIN_I32;
          sbits_up = sb0;
          at(0, 0) = s0j;
          at(1, 0) = dj0;
          at(2, 0) = sb0;
          if (last) {
            i_f[fb] = MIN_I32;
            tbk[fb] = cell0;
          }
          s_new = s0j;
          r = 1;
        } else {
          s_up_old = s_up_prev;
          s_up_prev = in[0];
          st_up = in[T];
          p_up = in[2 * T];
          sbits_up = in[3 * T];
          acc = in[4 * T];
          first = in[5 * T];
        }
        // the substitution score one row ahead: its load (x from shared
        // memory, the LUT from L1) then overlaps a row's dependency chain
        int x_ahead = r < R ? xs[r * T + t] : 0;
        int sc_ahead = sub.score(x_ahead, yj);
        int eq_ahead = x_ahead == yj;
        int rge = mul(ge, i0 + r - 1);  // i * ge, row i - 1
        for (; r < R; ++r) {
          const int i = i0 + r;
          if (i > ml) break;
          const int sp = at(0, r);
          const int dp = at(1, r);
          const int sbp = at(2, r);
          const int snp = at(3, r);
          const int eq = eq_ahead;
          const int m_val = add(s_up_old, sc_ahead);
          if (r + 1 < R) {
            x_ahead = xs[(r + 1) * T + t];
            sc_ahead = sub.score(x_ahead, yj);
            eq_ahead = x_ahead == yj;
          }
          const int m_bits = TB_SUBST + eq;  // TB_MATCH = TB_SUBST + 1
          const int yclip = add(d_clip, mul(ge, i - 1));
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
          // S from MIN_I32 up, as the JAX column body chooses it
          int s_col = MIN_I32;
          int s_bits = TB_XCLIP_SUFFIX;
          take(s_col, s_bits, m_val, m_bits);
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
          const int cell = i_bits | (d_bits << 4) | (s_bits << 8);
          if constexpr (TB) {
            pk.push(cell);
            if ((r & (GROUP - 1)) == GROUP - 1) pk.store(tbcol + r - (GROUP - 1));
          }
          if (add(s_col, ycs) > snp) {
            at(3, r) = add(s_col, ycs);
            at(4, r) = nl - j;
          }
          s_up_old = sp;
          st_up = max(max(max(m_val, best_d), yclip), xclip);
          p_up = p;
          sbits_up = s_bits;
          at(0, r) = s_col;
          at(1, r) = best_d;
          at(2, r) = s_bits;
          if (last) {
            i_f[fb + i] = best_i;
            tbk[fb + i] = cell;
          }
          s_new = s_col;
        }
        if constexpr (TB) pk.close(tbcol, r);
        out[0] = s_new;
        out[T] = st_up;
        out[2 * T] = p_up;
        out[3 * T] = sbits_up;
        out[4 * T] = acc;
        out[5 * T] = first;
      }
      if (TB && holds_m) lx[static_cast<size_t>(j) * B + b] = acc > MIN_I32 ? ml - first : 0;
    }
    __syncthreads();
  }
  if (owner) {
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      if (i > ml) break;
      s_f[fb + i] = at(0, r);
      sn_f[fb + i] = at(3, r);
      ly_f[fb + i] = at(4, r);
    }
  }
}

template <bool TB, bool ONCHIP, class Subst>
int launch_on(int B, int M, int N, int Xp, int R, int T, size_t smem, const void* xt, const void* yt,
              const void* mlens, const void* nlens, int go, int ge, Subst sub,
              int xcp, int xcs, int ycp, int ycs, void* tb, void* lx, void* s_f,
              void* i_f, void* sn_f, void* ly_f, void* tbk, void* scratch,
              void* stream) {
  auto kernel = scan_columns_kernel<TB, ONCHIP, Subst>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<B, T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xt), static_cast<const uint8_t*>(yt),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, N, Xp, R, go,
      ge, sub, xcp, xcs, ycp, ycs, static_cast<uint16_t*>(tb),
      static_cast<int*>(lx), static_cast<int*>(s_f), static_cast<int*>(i_f),
      static_cast<int*>(sn_f), static_cast<int*>(ly_f), static_cast<int*>(tbk),
      static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <class Subst>
int launch(const void* xt, const void* yt, const void* mlens, const void* nlens,
           int B, int M, int N, int Xp, int go, int ge, Subst sub, int xcp, int xcs, int ycp,
           int ycs, void* tb, void* lx, void* s_f, void* i_f, void* sn_f,
           void* ly_f, void* tbk, void* scratch, void* stream) {
  if (B < 1 || M < 0 || M > 65534 || N < 0 || !tb != !lx || (tb && (Xp < M + 1 || Xp % GROUP)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the geometry of ops/sw.py columns_geometry
  const int rows = M + 1;
  const int R = (rows + GROUP * T_STRIPES - 1) / (GROUP * T_STRIPES) * GROUP;
  const int T = ((rows + R - 1) / R + 31) / 32 * 32;
  const size_t onchip = static_cast<size_t>(LAYERS) * R * T * sizeof(int);
  const size_t smem = static_cast<size_t>(2 * CARRIES) * T * sizeof(int)
                      + static_cast<size_t>(R) * T + (scratch ? 0 : onchip);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (tb) {
    auto fn = scratch ? launch_on<true, false, Subst> : launch_on<true, true, Subst>;
    return fn(B, M, N, Xp, R, T, smem, xt, yt, mlens, nlens, go, ge, sub, xcp, xcs, ycp,
              ycs, tb, lx, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
  }
  auto fn = scratch ? launch_on<false, false, Subst> : launch_on<false, true, Subst>;
  return fn(B, M, N, Xp, R, T, smem, xt, yt, mlens, nlens, go, ge, sub, xcp, xcs, ycp,
            ycs, tb, lx, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Entry points: xt (M, B) and yt (N, B) uint8; tb/lx null for a
// score-only call, else tb the pair-major (B, N + 1, Xp) uint16 tensor,
// Xp >= M + 1 a multiple of 8, and lx (N + 1, B) int32; scratch null to
// keep the row state in shared memory, else a (B, 5, R, T) int32 buffer in
// the geometry above; lut a (256, 256) int32 table on the device.

// K15: any clips, constant match/mismatch scores.
int sw_scan_columns(const void* xt, const void* yt, const void* mlens,
                    const void* nlens, int B, int M, int N, int Xp, int go, int ge,
                    int ma, int mi, int xcp, int xcs, int ycp, int ycs, void* tb,
                    void* lx, void* s_f, void* i_f, void* sn_f, void* ly_f,
                    void* tbk, void* scratch, void* stream) {
  return launch(xt, yt, mlens, nlens, B, M, N, Xp, go, ge, MatchParams{ma, mi}, xcp, xcs,
                ycp, ycs, tb, lx, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
}

// K15-LUT: K15 fed by the LUT.
int sw_scan_columns_lut(const void* xt, const void* yt, const void* mlens,
                        const void* nlens, int B, int M, int N, int Xp, int go, int ge,
                        const void* lut, int xcp, int xcs, int ycp, int ycs,
                        void* tb, void* lx, void* s_f, void* i_f, void* sn_f,
                        void* ly_f, void* tbk, void* scratch, void* stream) {
  return launch(xt, yt, mlens, nlens, B, M, N, Xp, go, ge, Lut{static_cast<const int*>(lut)},
                xcp, xcs, ycp, ycs, tb, lx, s_f, i_f, sn_f, ly_f, tbk, scratch,
                stream);
}

}  // extern "C"
