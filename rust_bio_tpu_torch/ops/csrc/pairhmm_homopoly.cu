// K17-homopoly pairhmm_fwd_homopoly: batched 14-state HomopolyPairHMM
// forward, one warp a pair over lane column stripes, on float and double. Replaces the XLA engine
// rust_bio_tpu/stats/pairhmm/homopoly_device.py
// BatchHomopolyPairHMM._forward (:114-286). The JAX package has no Pallas
// kernel for it.
//
// States a column: the match states M_A, M_C, M_G, M_T, GapX, GapY, the hop-X
// states HX_A..HX_T and the hop-Y states HY_A..HY_T. With lae the logaddexp
// of device.py _lae (NEG the surrogate -3e38 / -1e308, CLAMP -87 / -700)
// and lse(...) a left fold of lae, for a row i < xlen (homopoly_device.py
// :138-270, in its order of operations):
//   semiglobal: vm[k][0] = lae(vm[k][0], -ln 4)
//   pre[j]   = lse(match_any + lse4(vm[.][j-1]), from_gx + vgx[j-1],
//                  from_gy + vgy[j-1], from_hx[k] + vhx[k][j-1] (k = 0..3),
//                  from_hy[k] + vhy[k][j-1] (k = 0..3))
//   vm'[k][j] = (x_i == base_k or y_j == base_k) ? ep_j + pre[j] : NEG,
//              ep_j = pm if x_i == y_j else pmm - ln 2
//   vgy'[j]  = pe_x + lae(pgx + lse4(vm[.][j]), pgxe + vgy[j])
//   vhy'[k][j] = lae(hy[k] + vm[k][j], hye[k] + vhy[k][j])
//   vgx'[j]  = lae((pe_y + pgy) + lse4(vm'[.][j-1]), (pe_y + pgye) + vgx'[j-1])
//   vhx'[k][j] = lae(hx[k] + vm'[k][j-1], hxe[k] + vhx'[k][j-1])
//   (vgx'[1], vhx'[k][1]: the first terms; column 0 of every state NEG)
// the GapX/GapY crossing of the reference's transition table sits in which
// parameter feeds which state (homopoly_device.py :97-110). The 14 values
// at column ylen form the row's column c_i. Global mode: acc = lse(c_i).
// Semiglobal mode: acc = lae(acc, lae(lse(s + ln(ylen - 1)), lse(c_i))) over
// s the column of row i - 2 with its match entries NEG (the closed form of
// the reference's per-cell accumulation, :250-263; ln(ylen - 1) is NEG when
// ylen <= 1). out = min(acc, 0). Lanes stop at their xlen; the JAX twin's
// frozen lanes reset vm to NEG (:218-228), which no later value reads.
// Only columns up to ylen feed the result. The two in-row recurrences run
// in sequence over j (the XLA engine uses an associative scan). The quarter
// initial mass sits on the four match states of column 0. Built with
// -fmad=false (ops/_build.py).
//
// Design: csrc/pairhmm_log.cu's, with 14 states a column. One warp a pair;
// lane t owns the columns [t * C + 1, t * C + C] of y, C the wrapper's
// stripe width (ops/pairhmm.py pairhmm_log_geometry with 14 states, 32 * C
// >= N), and at step s computes row i = s - t: a pair takes xlen + t_end
// steps, t_end the lane of column ylen (lane 0 when ylen <= C). At the end
// of a step lane t hands the 14 states of its last column to lane t + 1
// with __shfl_up_sync (a double as two 32-bit shuffles): one step later
// vm', vgx' and vhx' are the left neighbours of lane t + 1's first column,
// and one step after that all 14 are its diagonal. No barrier in the row
// loop. Lane 0 stands in for column 0 as the one-thread kernel before this
// one did: the diagonal vm is the quarter mass on row 0 and NEG after
// (semiglobal: lae(., -ln 4) of it), the other diagonal states and the left
// neighbours NEG, and vgx'[1], vhx'[k][1] take their first terms. Lane
// t_end keeps column ylen's 14 values and folds each row into acc itself,
// in row order, with the two rows of history the semiglobal stale term
// reads. Every cell evaluates the one-thread kernel's expressions in its
// order on the same operands, so the outputs are that kernel's bits
// whatever C and wherever the state lives. Lanes whose stripe starts past
// ylen only take part in the shuffles.
//
// State: a lane's 14 states of each of its columns from the previous row.
// In registers while 14 * C values take at most ops/pairhmm.py's
// HOMOPOLY_REG_BYTES a lane (C a power of two; every column computed,
// those past ylen feeding nothing, so that no branch parts the columns,
// and lae branch-free, as in pairhmm_log.cu: with an early return the
// columns ran one after another); else in the pair's slice of a (B, 14, C, 32) device
// scratch as [state][C][32], lane innermost, the columns up to ylen only,
// y's bytes read per cell through the read-only path. The 34 parameters
// sit in registers. x_i is read a step ahead. Warps a block: the
// wrapper's.
//
// Bound on this card: operations. A cell is 34 logaddexps (an exp and a
// log1p each) and about 40 adds and compares. A step is a chain of C
// cells' in-row recurrences (vgx', vhx') beside the stripe's pre, vm',
// vgy' and vhy', which depend on the row above only. The one-thread-a-pair
// kernel before this one ran the 2048 bench pairs on 64 warps of the
// card's 132 SMs, each cell's 34 exp/log1p in order.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int MAX_WARPS = 8;  // warps (pairs) a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int S = 14;         // states a column: vm 0-3, vgx 4, vgy 5, vhx 6-9, vhy 10-13

template <typename T>
struct Lim;
template <>
struct Lim<float> {
  static constexpr float NEG = -3.0e38f;
  static constexpr float CLAMP = -87.0f;
};
template <>
struct Lim<double> {
  static constexpr double NEG = -1.0e308;
  static constexpr double CLAMP = -700.0;
};

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float log1p_(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_(double v) { return log1p(v); }
__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }

// Branch-free (pairhmm_log.cu): the sum is computed for every operand pair
// and the surrogate test selects hi, the bits of the early-return form.
template <typename T>
__device__ __forceinline__ T lae(T a, T b) {
  const T hi = a > b ? a : b;
  const T lo = a > b ? b : a;
  const T d = lo - hi;
  const T sum = hi + log1p_(exp_(d > Lim<T>::CLAMP ? d : Lim<T>::CLAMP));
  return lo <= Lim<T>::NEG / 2 ? hi : sum;
}

template <typename T>
__device__ __forceinline__ T lse4(const T* v) {
  return lae(lae(lae(v[0], v[1]), v[2]), v[3]);
}

// par: 0 match_any, 1 pgx, 2 pgy, 3 pgxe, 4 pgye, 5 from_gx, 6 from_gy,
// 7-10 hx, 11-14 hy, 15-18 hxe, 19-22 hye, 23-26 from_hx, 27-30 from_hy,
// 31 ln 2, 32 ln 0.25, 33 -ln 4.
// CR > 0: the state in registers, C = CR; CR = 0: in the scratch, C = C_rt.
template <typename T, int CR, bool SEMI>
__global__ void __launch_bounds__(MAX_WARPS * LANES) pairhmm_homopoly_warp_kernel(
    const uint8_t* __restrict__ xs, const uint8_t* __restrict__ ys,
    const int* __restrict__ xlens, const int* __restrict__ ylens,
    const T* __restrict__ par,   // (34,)
    const T* __restrict__ emit,  // (4,) or (B, 4): pm, pmm, pe_x, pe_y
    int emit_stride, int B, int M, int N, int C_rt, T* __restrict__ out,
    T* __restrict__ scratch) {   // (B, 14, C, 32), or null when CR > 0
  constexpr bool REGS = CR > 0;
  const int C = REGS ? CR : C_rt;
  const T NEG = Lim<T>::NEG;
  const int lane = threadIdx.x % LANES;
  const int w = threadIdx.x / LANES;
  const int b = blockIdx.x * (blockDim.x / LANES) + w;
  if (b >= B) return;  // the whole warp

  int xlen = xlens[b];
  int ylen = ylens[b];
  xlen = xlen < 0 ? 0 : (xlen > M ? M : xlen);
  ylen = ylen < 0 ? 0 : (ylen > N ? N : ylen);
  const int j0 = lane * C;                          // columns j0 + 1 .. j0 + C
  const int t_end = ylen > 0 ? (ylen - 1) / C : 0;  // the lane of column ylen
  const int kn = ylen - j0 < 0 ? 0 : (ylen - j0 > C ? C : ylen - j0);  // columns up to ylen

  const T match_any = par[0], pgx = par[1], pgy = par[2], pgxe = par[3], pgye = par[4];
  const T from_gx = par[5], from_gy = par[6];
  T hx[4], hy[4], hxe[4], hye[4], from_hx[4], from_hy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hx[k] = par[7 + k];
    hy[k] = par[11 + k];
    hxe[k] = par[15 + k];
    hye[k] = par[19 + k];
    from_hx[k] = par[23 + k];
    from_hy[k] = par[27 + k];
  }
  const T ln2 = par[31], quarter = par[32], neg_ln4 = par[33];
  const T* e = emit + static_cast<size_t>(b) * emit_stride;
  const T pm = e[0], pmm = e[1], pe_x = e[2], pe_y = e[3];
  const T pmm_half = pmm - ln2;
  const T a_gx = pe_y + pgy;
  const T b_gx = pe_y + pgye;
  const uint8_t* xrow = xs + static_cast<size_t>(b) * M;
  const uint8_t* ystripe = ys + static_cast<size_t>(b) * N + j0;
  const int bases[4] = {'A', 'C', 'G', 'T'};

  // the previous row's 14 states of this lane's columns (row -1: NEG)
  T reg[REGS ? S : 1][REGS ? CR : 1];
  uint32_t yw[REGS ? (CR + 3) / 4 : 1];  // y's bytes of the stripe, packed
  T* mem = nullptr;                      // else state q, column k at mem[(q * C + k) * 32]
  if constexpr (REGS) {
#pragma unroll
    for (int q = 0; q < (CR + 3) / 4; ++q) yw[q] = 0;
#pragma unroll
    for (int k = 0; k < CR; ++k) {
#pragma unroll
      for (int q = 0; q < S; ++q) reg[q][k] = NEG;
      if (k < kn) yw[k / 4] |= static_cast<uint32_t>(ystripe[k]) << (8 * (k % 4));
    }
  } else {
    mem = scratch + static_cast<size_t>(b) * S * C * LANES + lane;
    for (int k = 0; k < kn; ++k) {
      for (int q = 0; q < S; ++q) mem[(q * C + k) * LANES] = NEG;
    }
  }

  T dg[S];  // lane t - 1's last column, row i - 1 (row -1: NEG)
  T in[S];  // lane t - 1's last column, from the last shuffle
#pragma unroll
  for (int q = 0; q < S; ++q) dg[q] = in[q] = NEG;
  // lane t_end: the rows i - 1 and i - 2 at column ylen, states 4-13 (the
  // stale term reads no match state)
  T col1[S], col2[S];
#pragma unroll
  for (int q = 0; q < S; ++q) col1[q] = col2[q] = NEG;
  T acc = NEG;
  // ln(ylen - 1) of the stale copies, NEG without any
  const T ln_nstale = ylen - 1 > 0 ? log_(static_cast<T>(ylen - 1)) : NEG;
  int x_next = xlen > 0 ? xrow[0] : 0;  // x_i, read a step ahead
  const int steps = xlen > 0 ? xlen + t_end : 0;
  for (int s = 0; s < steps; ++s) {
    const int i = s - lane;
    T c[S];  // this lane's last column, row i, for lane + 1
#pragma unroll
    for (int q = 0; q < S; ++q) c[q] = NEG;
    if (lane <= t_end && i >= 0 && i < xlen) {
      const int xi = x_next;
      if (i + 1 < xlen) x_next = xrow[i + 1];
      bool exg[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) exg[k] = xi == bases[k];
      // the diagonal (row i - 1, column j - 1) and the left neighbour (row
      // i, column j - 1) of the stripe's first column
      T dvm[4], dhx[4], dhy[4], lvm[4], lhx[4];
      T dgx, dgy, lgx;
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          T v = i == 0 ? quarter : NEG;
          if (SEMI) v = lae(v, neg_ln4);
          dvm[k] = v;
          dhx[k] = dhy[k] = lvm[k] = lhx[k] = NEG;
        }
        dgx = dgy = lgx = NEG;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          dvm[k] = dg[k];
          dhx[k] = dg[6 + k];
          dhy[k] = dg[10 + k];
          lvm[k] = in[k];
          lhx[k] = in[6 + k];
        }
        dgx = dg[4];
        dgy = dg[5];
        lgx = in[4];
#pragma unroll
        for (int q = 0; q < S; ++q) dg[q] = in[q];
      }
      T lgy = NEG, lhy[4] = {NEG, NEG, NEG, NEG};  // the last column's vgy', vhy'
      T fresh[S];  // column ylen of row i (lane t_end; NEG when ylen = 0)
#pragma unroll
      for (int q = 0; q < S; ++q) fresh[q] = NEG;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        // in registers every column, those past ylen too (they feed
        // nothing): no branch between the columns; in memory the columns
        // up to ylen
        if (!REGS && k >= kn) break;
        T uvm[4], uhx[4], uhy[4], ugx, ugy;
        int yk;
        if constexpr (REGS) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uvm[q] = reg[q][k];
            uhx[q] = reg[6 + q][k];
            uhy[q] = reg[10 + q][k];
          }
          ugx = reg[4][k];
          ugy = reg[5][k];
          yk = (yw[k / 4] >> (8 * (k % 4))) & 0xFF;
        } else {
          for (int q = 0; q < 4; ++q) {
            uvm[q] = mem[(q * C + k) * LANES];
            uhx[q] = mem[((6 + q) * C + k) * LANES];
            uhy[q] = mem[((10 + q) * C + k) * LANES];
          }
          ugx = mem[(4 * C + k) * LANES];
          ugy = mem[(5 * C + k) * LANES];
          yk = __ldg(ystripe + k);
        }
        const bool first = lane == 0 && k == 0;  // column 1
        T pre = match_any + lse4(dvm);
        pre = lae(pre, from_gx + dgx);
        pre = lae(pre, from_gy + dgy);
#pragma unroll
        for (int q = 0; q < 4; ++q) pre = lae(pre, from_hx[q] + dhx[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q) pre = lae(pre, from_hy[q] + dhy[q]);
        const T v = (xi == yk ? pm : pmm_half) + pre;
        T vm[4], vhx[4], vhy[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) vm[q] = (exg[q] || yk == bases[q]) ? v : NEG;
        const T vgy = pe_x + lae(pgx + lse4(uvm), pgxe + ugy);
#pragma unroll
        for (int q = 0; q < 4; ++q) vhy[q] = lae(hy[q] + uvm[q], hye[q] + uhy[q]);
        const T agx = a_gx + lse4(lvm);
        const T vgx = first ? agx : lae(agx, b_gx + lgx);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T a = hx[q] + lvm[q];
          vhx[q] = first ? a : lae(a, hxe[q] + lhx[q]);
        }
        if constexpr (REGS) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            reg[q][k] = vm[q];
            reg[6 + q][k] = vhx[q];
            reg[10 + q][k] = vhy[q];
          }
          reg[4][k] = vgx;
          reg[5][k] = vgy;
        } else {
          for (int q = 0; q < 4; ++q) {
            mem[(q * C + k) * LANES] = vm[q];
            mem[((6 + q) * C + k) * LANES] = vhx[q];
            mem[((10 + q) * C + k) * LANES] = vhy[q];
          }
          mem[(4 * C + k) * LANES] = vgx;
          mem[(5 * C + k) * LANES] = vgy;
        }
        if (k == kn - 1) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            fresh[q] = vm[q];
            fresh[6 + q] = vhx[q];
            fresh[10 + q] = vhy[q];
          }
          fresh[4] = vgx;
          fresh[5] = vgy;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dvm[q] = uvm[q];
          dhx[q] = uhx[q];
          dhy[q] = uhy[q];
          lvm[q] = vm[q];
          lhx[q] = vhx[q];
          lhy[q] = vhy[q];
        }
        dgx = ugx;
        dgy = ugy;
        lgx = vgx;
        lgy = vgy;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        c[q] = lvm[q];
        c[6 + q] = lhx[q];
        c[10 + q] = lhy[q];
      }
      c[4] = lgx;
      c[5] = lgy;
      if (lane == t_end) {
        T row_mass = fresh[0];
#pragma unroll
        for (int q = 1; q < S; ++q) row_mass = lae(row_mass, fresh[q]);
        if (SEMI) {
          T stale = NEG + ln_nstale;  // the match entries of the stale column are NEG
#pragma unroll
          for (int q = 1; q < S; ++q) stale = lae(stale, (q < 4 ? NEG : col2[q]) + ln_nstale);
          acc = lae(acc, lae(stale, row_mass));
        } else {
          acc = row_mass;
        }
#pragma unroll
        for (int q = 4; q < S; ++q) {
          col2[q] = col1[q];
          col1[q] = fresh[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < S; ++q) in[q] = __shfl_up_sync(FULL, c[q], 1);
  }
  if (lane == t_end) out[b] = acc < T(0) ? acc : T(0);
}

template <typename T, bool SEMI>
cudaError_t launch(const void* xs, const void* ys, const void* xlens, const void* ylens,
                   const void* par, const void* emit, int emit_stride, int B, int M, int N, int C,
                   int warps, void* out, void* scratch, cudaStream_t stream) {
  if (B < 1 || M < 0 || N < 0 || C < 1 || static_cast<long long>(C) * LANES < N || warps < 1 ||
      warps > MAX_WARPS)
    return cudaErrorInvalidValue;
  auto kernel = pairhmm_homopoly_warp_kernel<T, 0, SEMI>;
  if (!scratch) {
    switch (C) {
      case 1: kernel = pairhmm_homopoly_warp_kernel<T, 1, SEMI>; break;
      case 2: kernel = pairhmm_homopoly_warp_kernel<T, 2, SEMI>; break;
      case 4: kernel = pairhmm_homopoly_warp_kernel<T, 4, SEMI>; break;
      default: return cudaErrorInvalidValue;
    }
  }
  kernel<<<(B + warps - 1) / warps, warps * LANES, 0, stream>>>(
      static_cast<const uint8_t*>(xs), static_cast<const uint8_t*>(ys),
      static_cast<const int*>(xlens), static_cast<const int*>(ylens),
      static_cast<const T*>(par), static_cast<const T*>(emit), emit_stride, B, M, N, C,
      static_cast<T*>(out), static_cast<T*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// f64 selects the double instantiation (par, emit, out and scratch double).
// C and warps are ops/pairhmm.py pairhmm_log_geometry's at 14 states,
// 32 * C >= N; scratch null keeps the state in registers (C 1, 2 or 4),
// else a (B, 14, C, 32) buffer holds it.
int pairhmm_fwd_homopoly(const void* xs, const void* ys, const void* xlens,
                         const void* ylens, const void* par, const void* emit, int emit_stride,
                         int B, int M, int N, int semiglobal, int f64, int C, int warps, void* out,
                         void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (f64) {
    rc = semiglobal ? launch<double, true>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N,
                                           C, warps, out, scratch, s)
                    : launch<double, false>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M,
                                            N, C, warps, out, scratch, s);
  } else {
    rc = semiglobal ? launch<float, true>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N,
                                          C, warps, out, scratch, s)
                    : launch<float, false>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M,
                                           N, C, warps, out, scratch, s);
  }
  return static_cast<int>(rc);
}

}  // extern "C"
