// K17-log pairhmm_fwd_log: batched log-space PairHMM forward, one warp a
// pair over lane column stripes, on float and double. Replaces the XLA
// engine rust_bio_tpu/stats/pairhmm/device.py BatchPairHMM._forward
// (:85-190), the forward of BatchPairHMM and the exact re-run of
// BatchPairHMMLinear's underflowed lanes. The JAX package has no Pallas
// kernel for it.
//
// Semantics (device.py), with lae(a, b) the logaddexp of _lae (:33-40):
// hi + log1p(exp(max(lo - hi, CLAMP))), or hi when lo <= NEG / 2, NEG the
// surrogate of -inf (-3e38 in f32, -1e308 in f64) and CLAMP -87 / -700:
//   row i < xlen:  semiglobal: fm[0] = ln 2 on row 0, else 0
//     fm'[j] = emit_j + lae(lae(ng + fm[j-1], ngxe + fx[j-1]), ngye + fy[j-1])
//     fx'[j] = pge + lae(gy + fm[j], gye + fx[j])
//     fy'[j] = lae((pge + gx) + fm'[j-1], (pge + gxe) + fy'[j-1])  (fy'[1] its
//              first term; column 0 of every state is NEG)
//     semiglobal: acc = lae(acc, lae(lae(fm', fx'), fy')[ylen])
//   out = min(acc, 0) (semiglobal) or min(lae(lae(fm, fx), fy)[ylen], 0).
// emit_j = pm when x_i == y_j, else pmm; emissions per lane (stride 3) or
// shared (stride 0). Only columns up to ylen feed the result. The Y
// recurrence runs in sequence over j, where the
// XLA engine uses an associative scan (rounding differs in the last bits).
// Built with -fmad=false (ops/_build.py); log1p and exp are the accurate
// libdevice functions.
//
// Design: one warp a pair. Lane t owns the columns [t * C + 1, t * C + C]
// of y, C the wrapper's stripe width (ops/pairhmm.py pairhmm_log_geometry,
// 32 * C >= N), and at step s computes row i = s - t: a pair takes xlen +
// t_end steps, t_end the lane of column ylen (lane 0 when ylen = 0). At the
// end of a step lane t hands fm', fx' and fy' of its last column to lane
// t + 1 with __shfl_up_sync: one step later fm' and fy' are the left
// neighbours of lane t + 1's first column, and one step after that the
// three are its diagonal. No barrier in the row loop. Lane 0 stands in for
// column 0 as the one-thread kernel before this one did: the diagonal fm is
// 0 on row 0 and NEG after (semiglobal: ln 2, then 0), fx and fy NEG, and
// fy'[1] takes its first term. Lane t_end keeps column ylen's values and,
// in semiglobal mode, folds each row's end into acc itself, in row order.
// Every cell evaluates the one-thread kernel's expressions in its order on
// the same operands, so the outputs are that kernel's bits whatever C and
// wherever the state lives. Lanes whose stripe starts past ylen only take
// part in the shuffles.
//
// State: a lane's fm, fx, fy of each of its columns from the previous row.
// In registers while they take at most 192 bytes a lane, C a power of two
// (16 float columns, N <= 512; 8 double columns, N <= 256: f64 at 16 took
// 246 registers and ran slower than in memory on the read-as-x lanes,
// H100), y's bytes of the stripe packed beside them and every column
// computed (those past ylen feed nothing) so that no branch parts the
// columns. Above that, where the
// wrapper passes a scratch, in the pair's slice of a (B, 3, C, 32) device
// scratch as [layer][C][32], lane innermost (a warp's accesses coalesce;
// 12 KB a pair in f64 at N = 500; a slice of shared memory instead timed
// the same on every input tried): the columns up to ylen only, y's bytes
// read per cell through the read-only path. x_i is read a step ahead.
// Warps a block: the wrapper's (one while the card holds every pair at 32
// blocks an SM, so that few pairs spread over the SMs). lae is branch-free
// for the same reason as the registers' columns: with its early return the
// columns ran one after another (f32 read-as-x 1.40 ms against 0.88-0.96).
//
// Bound on this card: operations. A cell is 4 logaddexps (an exp and a
// log1p each, about 20 instructions in f32, 40 in f64) and 8 adds; the f64
// peak is half the f32 one. A step is a dependent chain of C fy'
// logaddexps, the stripe's fm' and fx' (independent of each other) beside
// it. The one-thread-a-pair kernel before this kept 32 pairs a block: the
// 64 read-as-x pairs ran on 2 warps of the card, each cell's chain of 4
// exp/log1p exposed.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int MAX_WARPS = 8;           // warps (pairs) a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_BYTES = 192;         // a lane's state in registers, at most

template <typename T>
struct Lim;
template <>
struct Lim<float> {
  static constexpr float NEG = -3.0e38f;
  static constexpr float CLAMP = -87.0f;
  static constexpr float LN2 = 0.693147182464599609375f;  // float32(log(2))
};
template <>
struct Lim<double> {
  static constexpr double NEG = -1.0e308;
  static constexpr double CLAMP = -700.0;
  static constexpr double LN2 = 0.69314718055994528623;  // log(2)
};

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float log1p_(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_(double v) { return log1p(v); }

// Branch-free: the sum is computed for every operand pair and the
// surrogate test selects hi (the sum is then finite or -inf, never read),
// so that a stripe's logaddexps form one basic block the compiler can
// interleave.
template <typename T>
__device__ __forceinline__ T lae(T a, T b) {
  const T hi = a > b ? a : b;
  const T lo = a > b ? b : a;
  const T d = lo - hi;
  const T sum = hi + log1p_(exp_(d > Lim<T>::CLAMP ? d : Lim<T>::CLAMP));
  return lo <= Lim<T>::NEG / 2 ? hi : sum;
}

// CR > 0: the state in registers, C = CR; CR = 0: in the scratch, C = C_rt.
template <typename T, int CR>
__global__ void __launch_bounds__(MAX_WARPS * LANES) pairhmm_log_warp_kernel(
    const uint8_t* __restrict__ xs, const uint8_t* __restrict__ ys,
    const int* __restrict__ xlens, const int* __restrict__ ylens,
    const T* __restrict__ par,   // (7,) no_gap, ngxe, ngye, gx, gy, gxe, gye
    const T* __restrict__ emit,  // (3,) or (B, 3): pm, pmm, pge
    int emit_stride, int B, int M, int N, int C_rt, int semi, T* __restrict__ out,
    T* __restrict__ scratch) {   // (B, 3, C, 32), or null when CR > 0
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

  const T ng = par[0], ngxe = par[1], ngye = par[2], gx = par[3], gy = par[4];
  const T gxe = par[5], gye = par[6];
  const T* e = emit + static_cast<size_t>(b) * emit_stride;
  const T pm = e[0], pmm = e[1], pge = e[2];
  const T a_open = pge + gx;
  const T b_ext = pge + gxe;
  const uint8_t* xrow = xs + static_cast<size_t>(b) * M;
  const uint8_t* ystripe = ys + static_cast<size_t>(b) * N + j0;

  // the previous row's fm, fx, fy of this lane's columns (row -1: NEG)
  T rm[REGS ? CR : 1], rx[REGS ? CR : 1], ry[REGS ? CR : 1];
  uint32_t yw[REGS ? (CR + 3) / 4 : 1];  // y's bytes of the stripe, packed
  T* mem = nullptr;                      // else layer l, column k at mem[(l * C + k) * 32]
  if constexpr (REGS) {
#pragma unroll
    for (int q = 0; q < (CR + 3) / 4; ++q) yw[q] = 0;
#pragma unroll
    for (int k = 0; k < CR; ++k) {
      rm[k] = rx[k] = ry[k] = NEG;
      if (k < kn) yw[k / 4] |= static_cast<uint32_t>(ystripe[k]) << (8 * (k % 4));
    }
  } else {
    mem = scratch + static_cast<size_t>(b) * 3 * C * LANES + lane;
    for (int k = 0; k < kn; ++k) {
      mem[k * LANES] = NEG;
      mem[(C + k) * LANES] = NEG;
      mem[(2 * C + k) * LANES] = NEG;
    }
  }

  T d_m = NEG, d_x = NEG, d_y = NEG;     // lane t - 1's column j0, row i - 1 (row -1: NEG)
  T in_m = NEG, in_x = NEG, in_y = NEG;  // lane t - 1's column j0, from the last shuffle
  T e_m = ylen == 0 ? T(0) : NEG;        // column ylen of the last row (lane t_end)
  T e_x = NEG, e_y = NEG;
  T acc = NEG;
  int x_next = xlen > 0 ? xrow[0] : 0;  // x_i, read a step ahead
  const int steps = xlen > 0 ? xlen + t_end : 0;
  for (int s = 0; s < steps; ++s) {
    const int i = s - lane;
    T c_m = NEG, c_x = NEG, c_y = NEG;  // this lane's last column, row i, for lane + 1
    if (lane <= t_end && i >= 0 && i < xlen) {
      const int xi = x_next;
      if (i + 1 < xlen) x_next = xrow[i + 1];
      T dm, dx, dy, lm, ly;  // the diagonal, row i - 1; the left neighbour, row i
      if (lane == 0) {
        dm = semi ? (i == 0 ? Lim<T>::LN2 : T(0)) : (i == 0 ? T(0) : NEG);
        dx = dy = lm = ly = NEG;
      } else {
        dm = d_m;
        dx = d_x;
        dy = d_y;
        lm = in_m;
        ly = in_y;
        d_m = in_m;
        d_x = in_x;
        d_y = in_y;
      }
      T fx = NEG;
      T r_m = NEG, r_x = NEG, r_y = NEG;  // column ylen of row i (lane t_end)
#pragma unroll
      for (int k = 0; k < C; ++k) {
        // in registers every column, those past ylen too (they feed
        // nothing): no branch between the columns, so that the stripe's
        // fm' and fx' run ahead of the fy' chain; in memory the columns up
        // to ylen
        if (!REGS && k >= kn) break;
        T um, ux, uy;
        int yk;
        if constexpr (REGS) {
          um = rm[k];
          ux = rx[k];
          uy = ry[k];
          yk = (yw[k / 4] >> (8 * (k % 4))) & 0xFF;
        } else {
          um = mem[k * LANES];
          ux = mem[(C + k) * LANES];
          uy = mem[(2 * C + k) * LANES];
          yk = __ldg(ystripe + k);
        }
        const T m_in = lae(lae(ng + dm, ngxe + dx), ngye + dy);
        const T fm = (yk == xi ? pm : pmm) + m_in;
        fx = pge + lae(gy + um, gye + ux);
        const T a = a_open + lm;
        const T fy = (lane == 0 && k == 0) ? a : lae(a, b_ext + ly);
        if constexpr (REGS) {
          rm[k] = fm;
          rx[k] = fx;
          ry[k] = fy;
        } else {
          mem[k * LANES] = fm;
          mem[(C + k) * LANES] = fx;
          mem[(2 * C + k) * LANES] = fy;
        }
        dm = um;
        dx = ux;
        dy = uy;
        lm = fm;
        ly = fy;
        if (k == kn - 1) {
          r_m = fm;
          r_x = fx;
          r_y = fy;
        }
      }
      c_m = lm;
      c_x = fx;
      c_y = ly;
      if (lane == t_end) {
        e_m = r_m;
        e_x = r_x;
        e_y = r_y;
        if (semi) acc = lae(acc, lae(lae(e_m, e_x), e_y));
      }
    }
    in_m = __shfl_up_sync(FULL, c_m, 1);
    in_x = __shfl_up_sync(FULL, c_x, 1);
    in_y = __shfl_up_sync(FULL, c_y, 1);
  }
  if (lane == t_end) {
    const T p = semi ? acc : lae(lae(e_m, e_x), e_y);
    out[b] = p < T(0) ? p : T(0);
  }
}

template <typename T>
cudaError_t launch(const void* xs, const void* ys, const void* xlens, const void* ylens,
                   const void* par, const void* emit, int emit_stride, int B, int M, int N,
                   int semi, int C, int warps, void* out, void* scratch, cudaStream_t stream) {
  if (B < 1 || M < 0 || N < 0 || C < 1 || static_cast<long long>(C) * LANES < N || warps < 1 ||
      warps > MAX_WARPS)
    return cudaErrorInvalidValue;
  auto kernel = pairhmm_log_warp_kernel<T, 0>;
  if (!scratch) {
    switch (C) {
      case 1: kernel = pairhmm_log_warp_kernel<T, 1>; break;
      case 2: kernel = pairhmm_log_warp_kernel<T, 2>; break;
      case 4: kernel = pairhmm_log_warp_kernel<T, 4>; break;
      case 8: kernel = pairhmm_log_warp_kernel<T, 8>; break;
      case 16:
        if constexpr (3 * 16 * sizeof(T) <= REG_BYTES) {
          kernel = pairhmm_log_warp_kernel<T, 16>;
          break;
        }
        return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
  }
  kernel<<<(B + warps - 1) / warps, warps * LANES, 0, stream>>>(
      static_cast<const uint8_t*>(xs), static_cast<const uint8_t*>(ys),
      static_cast<const int*>(xlens), static_cast<const int*>(ylens),
      static_cast<const T*>(par), static_cast<const T*>(emit), emit_stride, B, M, N, C, semi,
      static_cast<T*>(out), static_cast<T*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// f64 selects the double instantiation (par, emit, out and scratch double).
// C and warps are ops/pairhmm.py pairhmm_log_geometry's, 32 * C >= N;
// scratch null keeps the state in registers (C a power of two up to 16 in
// float and 8 in double), else a (B, 3, C, 32) buffer holds it.
int pairhmm_fwd_log(const void* xs, const void* ys, const void* xlens, const void* ylens,
                    const void* par, const void* emit, int emit_stride, int B, int M, int N,
                    int semiglobal, int f64, int C, int warps, void* out, void* scratch,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      f64 ? launch<double>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N, semiglobal, C,
                           warps, out, scratch, s)
          : launch<float>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N, semiglobal, C,
                          warps, out, scratch, s);
  return static_cast<int>(rc);
}

}  // extern "C"
