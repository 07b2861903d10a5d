// K5 sw_scan_semiglobal: affine-gap DP of the semiglobal family for constant
// match/mismatch scoring. Replaces rust_bio_tpu/ops/sw_pallas.py
// scan_semiglobal_pallas_mp -> _kernel_scan_semiglobal_mp (runs="ins").
// Its LUT twin K12 (sw_scan_semiglobal_lut, the same DP with the score read
// from a (256, 256) LUT) is one warp a pair in sw_warp.cu.
//
// The x-clips are disabled (MIN_SCORE by contract); the y-clip penalties
// ycp (prefix) and ycs (suffix) are live arguments, 0/0 for semiglobal mode.
// Outputs: 12-bit traceback cells plus the vertical insertion-run nibble,
// for columns j = 1..nlens and rows i = 0..mlens; and the finals at
// j = nlens that the suffix fixups read: S, I, Sn (best y-suffix-clip score
// per row), Ly (its clip length) and the cells tbk, each (B, M+1).
//
// Design: the first K1's. One thread per pair walks columns
// j = 1..nlens and rows i = 0..mlens in order, so the insertion score is a
// scalar carry, the JAX kernels' prefix maximum P[i] = max(P[i-1], S~[i-1] + go - i * ge),
// I = P + i * ge (equal to max(I[i-1] + ge, S~[i-1] + go) until a sum
// wraps int32). The previous
// column's S, D, s-bits, Sn and Ly live in shared memory as [row][pair],
// 32 pairs a block (5 * 151 * 32 * 4 = 96.6 KB at M = 150), or in a
// (5, M+1, B) device scratch when they do not fit. The I layer is not part
// of the recurrence: I_f and tbk are written from column nlens (from the
// init column when nlens == 0). The substitution source is a template
// parameter, as in sw_warp.cu (here only MatchParams). The Match/Subst
// bit is byte equality.
//
// Bound on this card: it writes N * (M+1) * B uint16 cells (coalesced: a
// warp stores 64 contiguous bytes per cell row) and five (B, M+1) int32
// finals; the per-cell dependency chain (about 40 integer ops, one thread
// per pair) makes it latency-bound at mapper batch sizes, as K1 is.
//
// Exactness (sw_pallas.py:855-1054): int32 arithmetic wraps as in XLA; D
// starts at MIN_SCORE = -858993459; every selection is a strict '>' with
// priority Match/Subst > Ins > Del > Yclip-prefix; the y-prefix clip of
// row i (ycp + go + ge*(i-1)) also enters S~ = max(m, D, yclip), hence the
// I-open candidate; row 0 takes Del or the y-prefix clip, and in the last
// column the y-suffix accumulator may take row 0 over.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB_START = 0;
constexpr int TB_INS = 1;
constexpr int TB_DEL = 2;
constexpr int TB_SUBST = 3;
constexpr int TB_YCLIP_PREFIX = 7;
constexpr int TB_YCLIP_SUFFIX = 8;
constexpr int MIN_I32 = -858993459;  // reference MIN_SCORE
constexpr int PAIRS = 32;            // pairs (threads) per block
constexpr int LAYERS = 5;            // S, D, s-bits, Sn, Ly

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

template <class Subst>
__global__ void __launch_bounds__(PAIRS) scan_semiglobal_kernel(
    const uint8_t* __restrict__ xt,  // (M, B)
    const uint8_t* __restrict__ yt,  // (N, B)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M,
    int go, int ge, Subst sub, int ycp, int ycs,
    uint16_t* __restrict__ tb,    // (N, M + 1, B)
    int* __restrict__ s_f,        // (B, M + 1) each
    int* __restrict__ i_f,
    int* __restrict__ sn_f,
    int* __restrict__ ly_f,
    int* __restrict__ tbk,
    int* __restrict__ scratch) {  // (5, M + 1, B) or null
  extern __shared__ int smem[];
  const int b = blockIdx.x * PAIRS + threadIdx.x;
  if (b >= B) return;
  const int rows = M + 1;
  Column st;
  st.stride = scratch ? static_cast<size_t>(B) : static_cast<size_t>(PAIRS);
  st.base = scratch ? scratch + b : smem + threadIdx.x;
  st.layer = static_cast<size_t>(rows) * st.stride;
  const int ml = mlens[b];
  const int nl = nlens[b];
  const size_t fb = static_cast<size_t>(b) * rows;

  // column 0: S[i] = go + ge*(i-1), s-bits Ins (i >= 1); i-bits Start at
  // i <= 1; Sn/Ly = (ycs, nl) at row 0 and (S + ycs, nl) below
  for (int i = 0; i <= ml; ++i) {
    const int s0 = i == 0 ? 0 : add(go, mul(ge, i - 1));
    st.at(0, i) = s0;
    st.at(1, i) = MIN_I32;
    st.at(2, i) = i == 0 ? TB_START : TB_INS;
    st.at(3, i) = i == 0 ? ycs : add(s0, ycs);
    st.at(4, i) = nl;
    if (nl == 0) {
      i_f[fb + i] = MIN_I32;
      tbk[fb + i] = (i <= 1 ? TB_START : TB_INS) | ((i == 0 ? TB_START : TB_INS) << 8);
    }
  }

  const int d_clip = add(ycp, go);
  for (int j = 1; j <= nl; ++j) {
    const bool last = j == nl;
    const int yj = yt[static_cast<size_t>(j - 1) * B + b];
    uint16_t* tbcol = tb + static_cast<size_t>(j - 1) * rows * B + b;

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
    const bool take_sn = last && sn0 > s0j;
    if (take_sn) {
      s0j = sn0;
      sb0 = TB_YCLIP_SUFFIX;
    } else if (add(s0j, ycs) > sn0) {
      st.at(3, 0) = add(s0j, ycs);
      st.at(4, 0) = nl - j;
    }
    const int cell0 = TB_START | (db0 << 4) | (sb0 << 8);
    tbcol[0] = static_cast<uint16_t>(cell0);
    int s_up_old = st.at(0, 0);  // previous column's S, row i - 1
    int st_up = s0j;             // this column's S~ = max(m, D, yclip), row i - 1
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

    int yclip = d_clip;  // ycp + go + ge*(i-1), row i
    for (int i = 1; i <= ml; ++i) {
      const int sp = st.at(0, i);
      const int dp = st.at(1, i);
      const int sbp = st.at(2, i);
      const int snp = st.at(3, i);
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
      if (yclip > s_col) {
        s_col = yclip;
        s_bits = TB_YCLIP_PREFIX;
      }
      run = i_bits == TB_INS ? run + 1 : 0;
      const int cell = i_bits | (d_bits << 4) | (s_bits << 8) | (min(run, 15) << 12);
      tbcol[static_cast<size_t>(i) * B] = static_cast<uint16_t>(cell);
      if (add(s_col, ycs) > snp) {
        st.at(3, i) = add(s_col, ycs);
        st.at(4, i) = nl - j;
      }
      s_up_old = sp;
      st_up = max(max(m_val, best_d), yclip);
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
  }
  for (int i = 0; i <= ml; ++i) {
    s_f[fb + i] = st.at(0, i);
    sn_f[fb + i] = st.at(3, i);
    ly_f[fb + i] = st.at(4, i);
  }
}

// scratch: null to keep the column state in shared memory
// (5 * (M+1) * 32 * 4 bytes per block), else a (5, M+1, B) int32 buffer.
template <class Subst>
int launch(const void* xt, const void* yt, const void* mlens, const void* nlens,
           int B, int M, int go, int ge, Subst sub, int ycp, int ycs, void* tb,
           void* s_f, void* i_f, void* sn_f, void* ly_f, void* tbk,
           void* scratch, void* stream) {
  const size_t smem =
      scratch ? 0 : static_cast<size_t>(LAYERS) * (M + 1) * PAIRS * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        scan_semiglobal_kernel<Subst>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  scan_semiglobal_kernel<Subst><<<(B + PAIRS - 1) / PAIRS, PAIRS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xt), static_cast<const uint8_t*>(yt),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, go,
      ge, sub, ycp, ycs, static_cast<uint16_t*>(tb), static_cast<int*>(s_f),
      static_cast<int*>(i_f), static_cast<int*>(sn_f), static_cast<int*>(ly_f),
      static_cast<int*>(tbk), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K5.
int sw_scan_semiglobal(const void* xt, const void* yt, const void* mlens,
                       const void* nlens, int B, int M, int go, int ge, int ma,
                       int mi, int ycp, int ycs, void* tb, void* s_f, void* i_f,
                       void* sn_f, void* ly_f, void* tbk, void* scratch,
                       void* stream) {
  return launch(xt, yt, mlens, nlens, B, M, go, ge, MatchParams{ma, mi}, ycp,
                ycs, tb, s_f, i_f, sn_f, ly_f, tbk, scratch, stream);
}

}  // extern "C"
