// K9 sw_scan_custom: the affine-gap DP with all four clip penalties, for
// constant match/mismatch scoring. Replaces rust_bio_tpu/ops/sw_pallas.py
// scan_custom_pallas_mp -> _kernel_scan_custom_mp (runs="ins"). K7 (K9 at
// clips 0) and K9 fed by a LUT (K9-LUT) are csrc/sw_warp.cu's, one warp a
// pair.
//
// Outputs: the traceback cells of columns j = 0..nlens (column 0, the init
// column, at index 0) for rows i = 0..mlens, 12 bits plus the vertical
// insertion-run nibble; lx, the x-suffix clip length of each column's row
// mlens; and the finals at j = nlens that the suffix fixups read: S, I, Sn,
// Ly and the cells tbk, each (B, M+1). A null tb skips the tb and lx stores
// (score-only calls).
//
// Design: K5's (sw_semiglobal.cu). One thread per pair walks columns in
// order and rows i = 0..mlens in order, so the insertion score is a scalar
// carry, the prefix maximum P[i] = max(P[i-1], T[i] - i * ge), I = P + i * ge,
// of the Pallas kernels' scan (sw_global.cu); the previous column's S, D, s-bits, Sn and Ly live in shared
// memory as [row][pair], 32 pairs a block (96.6 KB at M = 150) or as many as
// fit (one pair's layers take 20 * (M+1) bytes: one pair a block at
// M = 11,000), or in a (5, M+1, B) device scratch when one pair's do not fit
// (M >= 11,622). What the TPU kernel does
// as a masked column reduction, the row-m replacement by the x-suffix clip,
// is here a running maximum of S + xcs over rows 1..m-1 (strict '>', so the
// first row that reaches it gives Lx), applied when the thread reaches row m.
// The substitution source is a template parameter, as in sw_global.cu (here
// only MatchParams); the Match/Subst bit is byte equality.
//
// Bound on this card: like K5, it writes (N+1) * (M+1) * B uint16 cells and
// five (B, M+1) int32 finals, and the per-cell dependency chain (about 45
// integer operations, one thread per pair) makes it latency-bound.
//
// The final I of a lane with nlens = 0 is column 0's I0 (rows >= 1), as the
// reference's column 0 holds it; the suffix fixups read it. Lanes with
// nlens >= 1 overwrite it in column 1.
//
// Exactness (sw_pallas.py:1601-1881): int32 arithmetic wraps as in XLA; D
// starts at MIN_I32 = -858993459; the running maximum starts at
// -2^31 + 1 and counts only when it exceeds MIN_I32; every selection is a
// strict '>' with priority Match/Subst > Ins > Del > Xclip-prefix >
// Yclip-prefix; the per-row y-prefix clip ycp + go + ge*(i-1) and the
// per-column x-prefix clip xcp + max(ycp, go + ge*(j-1)) enter
// S~ = max(m, D, yclip, xclip), hence the I-open candidate; row 0 takes Del
// or the y-prefix clip, and in the last column the y-suffix accumulator may
// take row 0 over; the Sn/Ly update reads S after the row-m replacement.

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
constexpr int PAIRS = 32;            // most pairs (threads) per block
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

// TB: store tb and lx; RUNS: the run nibble
template <bool TB, bool RUNS, class Subst>
__global__ void __launch_bounds__(PAIRS) scan_clip_kernel(
    const uint8_t* __restrict__ xt,  // (M, B)
    const uint8_t* __restrict__ yt,  // (N, B)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M,
    int go, int ge, Subst sub, int xcp, int xcs, int ycp, int ycs,
    uint16_t* __restrict__ tb,    // (N + 1, M + 1, B), or null
    int* __restrict__ lx,         // (N + 1, B), or null
    int* __restrict__ s_f,        // (B, M + 1) each
    int* __restrict__ i_f,
    int* __restrict__ sn_f,
    int* __restrict__ ly_f,
    int* __restrict__ tbk,
    int* __restrict__ scratch) {  // (5, M + 1, B) or null
  static_assert(TB || !RUNS, "the run nibble rides in tb cells");
  extern __shared__ int smem[];
  const int pairs = blockDim.x;
  const int b = blockIdx.x * pairs + threadIdx.x;
  if (b >= B) return;
  const int rows = M + 1;
  Column st;
  st.stride = scratch ? static_cast<size_t>(B) : static_cast<size_t>(pairs);
  st.base = scratch ? scratch + b : smem + threadIdx.x;
  st.layer = static_cast<size_t>(rows) * st.stride;
  const int ml = mlens[b];
  const int nl = nlens[b];
  const size_t fb = static_cast<size_t>(b) * rows;

  // column 0 (sw_pallas.py:1648-1711): I0 takes a gap or the x-prefix clip,
  // S the better of I0 and the clip, row m the x-suffix replacement
  {
    const int clip_i = add(xcp, go);
    int acc = SENT;  // running max of S + xcs over rows 1..m-1
    int first = 0;
    int run = 0;
    for (int i = 0; i <= ml; ++i) {
      int s0 = 0;
      int sb = TB_START;
      int ib = TB_START;
      int i0 = MIN_I32;
      if (i >= 1) {
        const int gap_i = add(go, mul(ge, i - 1));
        const bool ins_wins = gap_i > clip_i;
        i0 = i == 1 ? go : (ins_wins ? gap_i : clip_i);
        if (i >= 2) ib = ins_wins ? TB_INS : TB_XCLIP_PREFIX;
        if (i < ml) {
          s0 = MIN_I32;
          take(s0, sb, i0, TB_INS);
          take(s0, sb, xcp, TB_XCLIP_PREFIX);
          const int v = add(s0, xcs);
          if (v > acc) {
            acc = v;
            first = i;
          }
        } else {
          s0 = acc > MIN_I32 ? acc : MIN_I32;
          sb = TB_XCLIP_SUFFIX;
          take(s0, sb, i0, TB_INS);
          take(s0, sb, xcp, TB_XCLIP_PREFIX);
        }
      }
      const int cell = ib | (TB_START << 4) | (sb << 8);
      if constexpr (TB) {
        int word = cell;
        if constexpr (RUNS) {
          run = ib == TB_INS ? run + 1 : 0;
          word |= min(run, 15) << 12;
        }
        tb[static_cast<size_t>(i) * B + b] = static_cast<uint16_t>(word);
      }
      st.at(0, i) = s0;
      st.at(1, i) = MIN_I32;
      st.at(2, i) = sb;
      const int sn = add(s0, ycs);
      const bool live = i == 0 || sn > MIN_I32;
      st.at(3, i) = i == 0 ? ycs : (live ? sn : MIN_I32);
      st.at(4, i) = live ? nl : 0;
      if (nl == 0) {
        i_f[fb + i] = i0;
        tbk[fb + i] = cell;
      }
    }
    if constexpr (TB) lx[b] = acc > MIN_I32 ? ml - first : 0;
  }

  const int d_clip = add(ycp, go);
  for (int j = 1; j <= nl; ++j) {
    const bool last = j == nl;
    const int yj = yt[static_cast<size_t>(j - 1) * B + b];
    uint16_t* tbcol = TB ? tb + static_cast<size_t>(j) * rows * B + b : nullptr;

    // row 0: Del against the y-prefix clip, then the y-suffix takeover
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
    int s0j = dj0 > ycp ? dj0 : ycp;
    int sb0 = dj0 > ycp ? TB_DEL : TB_YCLIP_PREFIX;
    const int sn0 = st.at(3, 0);
    if (last && sn0 > s0j) {
      s0j = sn0;
      sb0 = TB_YCLIP_SUFFIX;
    } else if (add(s0j, ycs) > sn0) {
      st.at(3, 0) = add(s0j, ycs);
      st.at(4, 0) = nl - j;
    }
    const int cell0 = TB_START | (db0 << 4) | (sb0 << 8);
    if constexpr (TB) tbcol[0] = static_cast<uint16_t>(cell0);
    int s_up_old = st.at(0, 0);  // previous column's S, row i - 1
    int st_up = s0j;             // this column's S~, row i - 1
    int p_up = MIN_I32;          // this column's P, row i - 1
    int rge = 0;                 // i * ge
    int sbits_up = sb0;          // this column's s-bits, row i - 1
    int run = 0;                 // Ins i-bits run ending at row i - 1
    st.at(0, 0) = s0j;
    st.at(1, 0) = dj0;
    st.at(2, 0) = sb0;
    if (last) {
      i_f[fb] = MIN_I32;
      tbk[fb] = cell0;
    }

    // the column's x-prefix clip score (0 at clips 0 while go + ge*(j-1)
    // does not wrap)
    const int xclip = add(xcp, max(ycp, d_gap));
    int yclip = d_clip;  // ycp + go + ge*(i-1), row i
    int acc = SENT;      // running max of S + xcs over rows 1..m-1
    int first = 0;
    // x's byte two rows ahead and the substitution score one row ahead: their
    // loads (x from L2; the shared memory leaves L1 small) then overlap a
    // row's dependency chain
    auto x_of = [&](int r) { return r <= ml ? static_cast<int>(xt[static_cast<size_t>(r - 1) * B + b]) : 0; };
    const int x1 = x_of(1);
    int x_ahead = x_of(2);
    int sc_ahead = sub.score(x1, yj);
    int eq_ahead = x1 == yj;
    for (int i = 1; i <= ml; ++i) {
      const int sp = st.at(0, i);
      const int dp = st.at(1, i);
      const int sbp = st.at(2, i);
      const int snp = st.at(3, i);
      const int eq = eq_ahead;
      const int m_val = add(s_up_old, sc_ahead);
      sc_ahead = sub.score(x_ahead, yj);  // row i + 1
      eq_ahead = x_ahead == yj;
      x_ahead = x_of(i + 2);
      const int m_bits = TB_SUBST + eq;  // TB_MATCH = TB_SUBST + 1
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
      int cell = i_bits | (d_bits << 4) | (s_bits << 8);
      if constexpr (RUNS) {  // the run nibble, in tbk too (as in the Pallas kernel)
        run = i_bits == TB_INS ? run + 1 : 0;
        cell |= min(run, 15) << 12;
      }
      if constexpr (TB) tbcol[static_cast<size_t>(i) * B] = static_cast<uint16_t>(cell);
      if (add(s_col, ycs) > snp) {
        st.at(3, i) = add(s_col, ycs);
        st.at(4, i) = nl - j;
      }
      s_up_old = sp;
      st_up = max(max(max(m_val, best_d), yclip), xclip);
      p_up = p;
      sbits_up = s_bits;
      st.at(0, i) = s_col;
      st.at(1, i) = best_d;
      st.at(2, i) = s_bits;
      if (last) {
        i_f[fb + i] = best_i;
        tbk[fb + i] = cell;
      }
      yclip = add(yclip, ge);
    }
    if constexpr (TB) lx[static_cast<size_t>(j) * B + b] = acc > MIN_I32 ? ml - first : 0;
  }
  for (int i = 0; i <= ml; ++i) {
    s_f[fb + i] = st.at(0, i);
    sn_f[fb + i] = st.at(3, i);
    ly_f[fb + i] = st.at(4, i);
  }
}

template <bool TB, bool RUNS, class Subst>
int launch(const void* xt, const void* yt, const void* mlens, const void* nlens,
           int B, int M, int go, int ge, Subst sub, int xcp, int xcs,
           int ycp, int ycs, void* tb, void* lx, void* s_f, void* i_f,
           void* sn_f, void* ly_f, void* tbk, void* scratch, void* stream) {
  // pairs a block: 32 with the state in the device scratch, else as many as
  // the shared memory holds (the wrapper passes a scratch when not one fits)
  const size_t per_pair = static_cast<size_t>(LAYERS) * (M + 1) * sizeof(int);
  const size_t fit = SMEM_MAX / per_pair;
  const int pairs = scratch ? PAIRS : static_cast<int>(fit < PAIRS ? fit : PAIRS);
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scratch ? 0 : per_pair * pairs;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        scan_clip_kernel<TB, RUNS, Subst>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  scan_clip_kernel<TB, RUNS, Subst><<<(B + pairs - 1) / pairs, pairs, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xt), static_cast<const uint8_t*>(yt),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, go,
      ge, sub, xcp, xcs, ycp, ycs, static_cast<uint16_t*>(tb),
      static_cast<int*>(lx), static_cast<int*>(s_f), static_cast<int*>(i_f),
      static_cast<int*>(sn_f), static_cast<int*>(ly_f), static_cast<int*>(tbk),
      static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Entry points: tb/lx null for a score-only call; scratch null to keep the
// column state in shared memory (5 * (M+1) * 4 bytes a pair, up to 32 pairs
// a block), else a (5, M+1, B) int32 buffer.

// K9.
int sw_scan_custom(const void* xt, const void* yt, const void* mlens,
                   const void* nlens, int B, int M, int go, int ge, int ma,
                   int mi, int xcp, int xcs, int ycp, int ycs, void* tb,
                   void* lx, void* s_f, void* i_f, void* sn_f, void* ly_f,
                   void* tbk, void* scratch, void* stream) {
  auto fn = tb ? launch<true, true, MatchParams> : launch<false, false, MatchParams>;
  return fn(xt, yt, mlens, nlens, B, M, go, ge, MatchParams{ma, mi}, xcp, xcs,
            ycp, ycs, tb, lx, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
}

}  // extern "C"
