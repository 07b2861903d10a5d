// K16 sw_scan_banded: the banded clip-mode DP of the banded aligner. Replaces
// rust_bio_tpu/ops/sw_pallas.py scan_banded_pallas_mp -> _kernel_scan_banded_mp
// (itself the device twin of alignment/pairwise/banded.py compute_alignment,
// banded.rs:406-766): the general-clip DP restricted to per-column row bands
// [starts[j], ends[j]).
//
// Outputs (the Pallas contract, sw_pallas.py:2865-2869): tb (N, M + 1, B)
// uint16, column j's 12-bit cells i | d << 4 | s << 8 at index j - 1, 0 (the
// caller zero-fills) outside the cells the host writes; lx (N, B), column
// j's x-suffix clip length (zero-filled); the finals after column nlens S,
// I, Sn, Ly and the cells tbk, each (B, M + 1). Columns past nlens are left
// 0 (the Pallas kernel writes them from the frozen state; nothing reads them).
//
// Design: one thread a pair, columns in order, and in each column only the
// rows the host touches: row 0, the band rows [max(1, st), en) in order,
// row m, and the fringe resets (row st - 1 and rows [en, min(m + 1,
// ends[min(n, j + 1)]))). The TPU kernel vectorizes over all M + 1 rows with
// band masks and solves the insertion chain with a cummax; here I is a scalar
// carry down the band. The work is the band's cells, not N x (M + 1). Its
// results are the Pallas kernel's, bit for bit, including what the host's
// two-buffer state leaves out of the band:
//  - S and D live in two parity buffers (column j writes buffer j % 2): a row
//    outside the band and the resets keeps the value of column j - 2, which
//    the suffix fixups read at row ends[n] (banded_device.py:127-130);
//  - I has one buffer, as in the Pallas kernel: outside the band a row keeps
//    the previous column's value, or MIN after a reset;
//  - the chain's first band row opens from MIN + ge (the reset row above), and
//    in the last column also from Sn[i - 1] + go on every row above the band
//    (the Pallas chain runs over all rows); in columns where gap_open ==
//    gap_extend the first band row's i-bits may copy the s-bits of the row
//    above the band, so that one row's take chain is evaluated too;
//  - the previous column's s-bits are read back from this kernel's own tb
//    (column 0's, which the caller writes from its torch twin, from a layer).
// Per-pair state: S and D twice, I, Sn, Ly and column 0's s-bits, 8 int32
// layers of M + 1 rows: in shared memory as [row][pair] for as many pairs as
// fit a block (one at M = 7,263, 179 KB at M = 5,600), else in a (8, M + 1, B)
// device scratch.
//
// Bound on this card: the dense tb the caller zero-fills (bytes), or 56 32-bit
// operations a band cell (operations; chip_smoke.py K16_OPS_PER_CELL counts
// them from the band loop below); one thread a pair in order over its cells
// makes it latency-bound.
//
// Exactness: int32 arithmetic wraps as in XLA; MIN_I32 = -858993459; the
// x-suffix running maximum starts at -2^31 + 1 and counts only above MIN_I32;
// every selection is a strict '>' with priority Match/Subst > Ins > Del >
// Xclip-prefix > Yclip-prefix; the chain sentinel is -1,500,000,000.
// Requires starts, ends <= mlens + 1 (banded.Band's rows) and 1 <= mlens;
// the lengths are clamped into [0, M] / [0, N] and the rows into
// [0, mlens + 1], so no read or write leaves the tensors whatever the caller
// passes (the caller checks them on the host).

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
constexpr int SENT2 = -1500000000;   // the Pallas chain sentinel
constexpr int PAIRS = 32;            // most pairs (threads) per block
constexpr int LAYERS = 8;            // S0, S1, D0, D1, I, Sn, Ly, column 0's s-bits
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may opt into

// int32 add / multiply that wrap like XLA's (signed overflow is UB in C++)
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// s, bits <- cand, cbits when cand is strictly greater
__device__ __forceinline__ void take(int& s, int& bits, int cand, int cbits) {
  if (cand > s) {
    s = cand;
    bits = cbits;
  }
}

struct Pens {
  int go, ge, xcp, xcs, ycp, ycs, ma, mi;
};

__global__ void __launch_bounds__(PAIRS) scan_banded_kernel(
    const uint8_t* __restrict__ xt,  // (M, B)
    const uint8_t* __restrict__ yt,  // (N, B)
    const int* __restrict__ mlens, const int* __restrict__ nlens,
    const int* __restrict__ starts,  // (B, N + 1)
    const int* __restrict__ ends,    // (B, N + 1)
    int B, int M, int N, Pens p,
    uint16_t* __restrict__ tb,       // (N, M + 1, B), zeroed
    int* __restrict__ lx,            // (N, B), zeroed
    int* __restrict__ s_f, int* __restrict__ i_f, int* __restrict__ sn_f,
    int* __restrict__ ly_f, int* __restrict__ tbk,  // (B, M + 1) each
    int* __restrict__ scratch) {                    // (8, M + 1, B) or null
  extern __shared__ int smem[];
  const int pairs = blockDim.x;
  const int b = blockIdx.x * pairs + threadIdx.x;
  if (b >= B) return;
  const int rows = M + 1;
  const size_t stride = scratch ? static_cast<size_t>(B) : static_cast<size_t>(pairs);
  int* const base = scratch ? scratch + b : smem + threadIdx.x;
  const size_t layer = static_cast<size_t>(rows) * stride;
  auto L = [&](int k, int i) -> int& { return base[k * layer + static_cast<size_t>(i) * stride]; };
  // layers: S buffers 0/1, D buffers 2/3, I 4, Sn 5, Ly 6, column 0's s-bits 7
  constexpr int I_ = 4, SN = 5, LY = 6, SB0 = 7;
  const int ml = min(max(mlens[b], 0), M);
  const int nl = min(max(nlens[b], 0), N);
  const int* st_b = starts + static_cast<size_t>(b) * (N + 1);
  const int* en_b = ends + static_cast<size_t>(b) * (N + 1);
  const size_t cstride = static_cast<size_t>(rows) * B;  // one tb column
  const int go = p.go, ge = p.ge, xcp = p.xcp, xcs = p.xcs, ycp = p.ycp, ycs = p.ycs;
  auto x_at = [&](int r) { return static_cast<int>(xt[static_cast<size_t>(r - 1) * B + b]); };

  // ---- column 0 (sw_pallas.py:2567-2638) ----
  const int st0 = min(max(st_b[0], 0), ml + 1);
  const int en0 = min(max(en_b[0], 0), ml + 1);
  {
    const int clip_i = add(xcp, go);
    int acc = SENT;  // max of S + xcs over in-band rows 1..m-1
    for (int i = 0; i <= ml; ++i) {
      const bool in_b0 = i >= 1 && i >= st0 && i < en0;
      const int gap_i = add(go, mul(ge, i - 1));
      const int i0 = i == 1 ? go : (gap_i > clip_i ? gap_i : clip_i);
      int s = MIN_I32, sb = TB_START;
      take(s, sb, i0, TB_INS);
      take(s, sb, xcp, TB_XCLIP_PREFIX);
      if (in_b0 && i <= ml - 1) acc = max(acc, add(s, xcs));
      L(0, i) = in_b0 ? s : MIN_I32;
      L(1, i) = MIN_I32;
      L(2, i) = MIN_I32;
      L(3, i) = MIN_I32;
      L(I_, i) = in_b0 ? i0 : MIN_I32;
      L(SB0, i) = in_b0 ? sb : TB_START;
      L(SN, i) = i == 0 ? (ycp > ycs ? ycp : ycs) : MIN_I32;
      L(LY, i) = (i == 0 && !(ycp > ycs)) ? nl : 0;
    }
    if (ml >= 1) {
      const bool upd = acc > MIN_I32;
      int s_m = upd ? acc : MIN_I32;
      int sb_m = TB_XCLIP_SUFFIX;
      take(s_m, sb_m, L(I_, ml), TB_INS);
      take(s_m, sb_m, xcp, TB_XCLIP_PREFIX);
      if (!(ml >= st0 && ml < en0)) {
        s_m = MIN_I32;
        sb_m = upd ? TB_XCLIP_SUFFIX : TB_START;
      }
      L(0, ml) = s_m;
      L(SB0, ml) = sb_m;
    }
    L(0, 0) = st0 == 0 ? 0 : MIN_I32;
    L(SB0, 0) = TB_START;
  }

  // ---- columns 1..nlens ----
  const int d_clip = add(ycp, go);
  for (int j = 1; j <= nl; ++j) {
    const int cur = j & 1, prv = cur ^ 1;  // S layer; D layer is 2 + parity
    const bool last = j == nl;
    const int stj = min(max(st_b[j], 0), ml + 1);
    const int enj = min(max(en_b[j], 0), ml + 1);
    const int r_end = min(ml + 1, en_b[min(j + 1, nl)]);  // the post-reset bound
    const bool r0 = stj == 0;
    const int yj = yt[static_cast<size_t>(j - 1) * B + b];
    uint16_t* tbcol = tb + static_cast<size_t>(j - 1) * cstride + b;
    const uint16_t* tbprev = j >= 2 ? tbcol - cstride : nullptr;
    auto sb_prev = [&](int r) { return tbprev ? (tbprev[static_cast<size_t>(r) * B] >> 8) & 0xF : L(SB0, r); };

    // row 0: Del against the y-prefix clip, computed iff the band starts at
    // 0; no Sn merge into S
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
    const int s0j = dj0 > ycp ? dj0 : ycp;
    const int sb0j = dj0 > ycp ? TB_DEL : TB_YCLIP_PREFIX;
    int sn0 = L(SN, 0);
    if (r0 && add(s0j, ycs) > sn0) {
      sn0 = add(s0j, ycs);
      L(SN, 0) = sn0;
      L(LY, 0) = nl - j;
    }
    const int xclip = add(xcp, max(last ? max(ycp, sn0) : ycp, d_gap));

    // fringe resets on this column's buffers (computed rows overwrite them)
    if (stj >= 1) {
      L(cur, stj - 1) = MIN_I32;
      L(2 + cur, stj - 1) = MIN_I32;
      L(I_, stj - 1) = MIN_I32;
    }
    for (int r = enj; r < r_end; ++r) {
      L(cur, r) = MIN_I32;
      L(2 + cur, r) = MIN_I32;
      L(I_, r) = MIN_I32;
    }
    if (r0) {
      L(cur, 0) = s0j;
      L(2 + cur, 0) = dj0;
      L(I_, 0) = MIN_I32;
      tbcol[0] = static_cast<uint16_t>((db0 << 4) | (sb0j << 8));
    }

    // band rows [s, enj), I as a carry
    const int s = max(1, stj);
    int acc = SENT;  // max of S + xcs over band rows < m, first row on ties
    int first = 0;
    if (s < enj) {
      int carry;  // this column's I at row s - 1 (the Pallas cummax)
      if (last) {
        carry = MIN_I32;
        for (int r = 1; r < s; ++r) {
          const int t_sn = add(r == 1 ? sn0 : L(SN, r - 1), go);
          carry = max(add(carry, ge), max(add(SENT2, go), t_sn));
        }
      } else {
        carry = add(MIN_I32, mul(s - 1, ge));
      }
      // the s-bits of row s - 1, which a tie opens from
      int sbits_up = sb0j;
      if (s >= 2) {
        const int r = s - 1;
        const int xr = x_at(r);
        int sc = add(L(prv, r - 1), xr == yj ? p.ma : p.mi);
        int bits = TB_SUBST + (xr == yj);
        const int d_ext = add(L(2 + prv, r), ge);
        const int d_open = add(L(prv, r), go);
        take(sc, bits, carry, TB_INS);
        take(sc, bits, d_ext > d_open ? d_ext : d_open, TB_DEL);
        take(sc, bits, xclip, TB_XCLIP_PREFIX);
        take(sc, bits, add(d_clip, mul(ge, r - 1)), TB_YCLIP_PREFIX);
        sbits_up = bits;
      }
      int st_up = stj == 0 ? s0j : MIN_I32;   // S~ of row s - 1 (reset row: MIN)
      int sn_up = s == 1 ? sn0 : L(SN, s - 1);  // Sn of row s - 1, before this column
      for (int r = s; r < enj; ++r) {
        const int xr = x_at(r);
        const int eq = xr == yj;
        const int m_val = add(L(prv, r - 1), eq ? p.ma : p.mi);
        const int m_bits = TB_SUBST + eq;  // TB_MATCH = TB_SUBST + 1
        const int sp = L(prv, r);
        const int d_ext = add(L(2 + prv, r), ge);
        const int d_open = add(sp, go);
        const bool d_wins = d_ext > d_open;
        const int best_d = d_wins ? d_ext : d_open;
        const int d_bits = d_wins ? TB_DEL : sb_prev(r);
        const int yclip = add(d_clip, mul(ge, r - 1));
        const int s_tilde = max(max(max(m_val, best_d), yclip), xclip);
        const int t_s = add(st_up, go);
        const int t_sn = last ? add(sn_up, go) : SENT2;
        const int t_seed = r == s ? add(MIN_I32, ge) : SENT2;
        const int i_ext = add(carry, ge);
        const int best_i = max(i_ext, max(max(t_s, t_sn), t_seed));
        const int i_eff = max(i_ext, t_seed);
        const int i_bits = t_sn > max(i_eff, t_s) ? TB_YCLIP_SUFFIX : (i_eff > t_s ? TB_INS : sbits_up);
        int s_col = m_val;
        int s_bits = m_bits;
        take(s_col, s_bits, best_i, TB_INS);
        take(s_col, s_bits, best_d, TB_DEL);
        take(s_col, s_bits, xclip, TB_XCLIP_PREFIX);
        take(s_col, s_bits, yclip, TB_YCLIP_PREFIX);
        if (r < ml) {
          const int v = add(s_col, xcs);
          if (v > acc) {
            acc = v;
            first = r;
          }
        } else {
          // row m in band: the x-suffix clip seeds it, the cell's own
          // candidates take it over where strictly greater
          s_col = acc > MIN_I32 ? acc : MIN_I32;
          s_bits = TB_XCLIP_SUFFIX;
          take(s_col, s_bits, m_val, m_bits);
          take(s_col, s_bits, best_i, TB_INS);
          take(s_col, s_bits, best_d, TB_DEL);
          take(s_col, s_bits, xclip, TB_XCLIP_PREFIX);
          take(s_col, s_bits, yclip, TB_YCLIP_PREFIX);
        }
        const int sn_old = L(SN, r);
        if (add(s_col, ycs) > sn_old) {
          L(SN, r) = add(s_col, ycs);
          L(LY, r) = nl - j;
        }
        L(cur, r) = s_col;
        L(2 + cur, r) = best_d;
        L(I_, r) = best_i;
        tbcol[static_cast<size_t>(r) * B] = static_cast<uint16_t>(i_bits | (d_bits << 4) | (s_bits << 8));
        carry = best_i;
        st_up = s_tilde;
        sbits_up = s_bits;
        sn_up = sn_old;
      }
    }
    lx[static_cast<size_t>(j - 1) * B + b] = acc > MIN_I32 ? ml - first : 0;

    // row m: Sn[m] from the accumulated S[m], then, out of band, S[m] = MIN
    // and the x-suffix clip s-bits
    if (ml >= 1) {
      const bool m_in = ml >= stj && ml < enj;
      const int s_m = m_in ? L(cur, ml) : (acc > MIN_I32 ? acc : MIN_I32);
      if (add(s_m, ycs) > L(SN, ml)) {
        L(SN, ml) = add(s_m, ycs);
        L(LY, ml) = nl - j;
      }
      if (!m_in) {
        L(cur, ml) = MIN_I32;
        tbcol[static_cast<size_t>(ml) * B] = static_cast<uint16_t>(TB_XCLIP_SUFFIX << 8);
      }
    }
  }

  // ---- finals: the state after column nlens; rows past mlens stay at
  // their initial values ----
  const size_t fb = static_cast<size_t>(b) * rows;
  const uint16_t* tblast = nl >= 1 ? tb + static_cast<size_t>(nl - 1) * cstride + b : nullptr;
  const int clip_i = add(xcp, go);
  for (int i = 0; i <= M; ++i) {
    if (i > ml) {
      s_f[fb + i] = MIN_I32;
      i_f[fb + i] = MIN_I32;
      sn_f[fb + i] = MIN_I32;
      ly_f[fb + i] = 0;
      tbk[fb + i] = 0;
      continue;
    }
    s_f[fb + i] = L(nl & 1, i);
    i_f[fb + i] = L(I_, i);
    sn_f[fb + i] = L(SN, i);
    ly_f[fb + i] = L(LY, i);
    if (tblast) {
      tbk[fb + i] = tblast[static_cast<size_t>(i) * B];
    } else {  // column 0's own cells
      const bool in_b0 = i >= 1 && i >= st0 && i < en0;
      const int gap_i = add(go, mul(ge, i - 1));
      const int ib0 = (!in_b0 || i == 1) ? TB_START : (gap_i > clip_i ? TB_INS : TB_XCLIP_PREFIX);
      tbk[fb + i] = ib0 | (L(SB0, i) << 8);
    }
  }
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K16. tb and lx must be zeroed by the caller; scratch null keeps the state
// in shared memory (8 * (M + 1) * 4 bytes a pair, up to 32 pairs a block),
// else a (8, M + 1, B) int32 buffer.
int sw_scan_banded(const void* xt, const void* yt, const void* mlens, const void* nlens,
                   const void* starts, const void* ends, int B, int M, int N, int go,
                   int ge, int xcp, int xcs, int ycp, int ycs, int ma, int mi, void* tb,
                   void* lx, void* s_f, void* i_f, void* sn_f, void* ly_f, void* tbk,
                   void* scratch, void* stream) {
  const size_t per_pair = static_cast<size_t>(LAYERS) * (M + 1) * sizeof(int);
  const size_t fit = SMEM_MAX / per_pair;
  const int pairs = scratch ? PAIRS : static_cast<int>(fit < PAIRS ? fit : PAIRS);
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scratch ? 0 : per_pair * pairs;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        scan_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  scan_banded_kernel<<<(B + pairs - 1) / pairs, pairs, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xt), static_cast<const uint8_t*>(yt),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens),
      static_cast<const int*>(starts), static_cast<const int*>(ends), B, M, N,
      Pens{go, ge, xcp, xcs, ycp, ycs, ma, mi}, static_cast<uint16_t*>(tb),
      static_cast<int*>(lx), static_cast<int*>(s_f), static_cast<int*>(i_f),
      static_cast<int*>(sn_f), static_cast<int*>(ly_f), static_cast<int*>(tbk),
      static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
