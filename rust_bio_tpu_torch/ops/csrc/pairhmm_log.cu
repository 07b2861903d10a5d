// K17-log pairhmm_fwd_log: batched log-space PairHMM forward, one thread a
// pair, on float and double. Replaces the XLA engine
// rust_bio_tpu/stats/pairhmm/device.py BatchPairHMM._forward (:85-190), the
// forward of BatchPairHMM and the exact re-run of BatchPairHMMLinear's
// underflowed lanes. The JAX package has no Pallas kernel for it.
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
// shared (stride 0). Only columns up to ylen are computed: no later
// column feeds them. The Y recurrence runs in sequence over j, where the
// XLA engine uses an associative scan (rounding differs in the last bits).
// Built with -fmad=false (ops/_build.py); log1p and exp are the accurate
// libdevice functions.
//
// Layout: the three state rows as [column][pair] words in shared memory,
// then y's bytes; up to 32 pairs a block; a (3, N+1, B) device scratch
// when one pair's rows do not fit (y then read from device memory).
//
// Bound on this card: operations. A cell is 4 logaddexps (an exp and a
// log1p each, about 20 instructions in f32, 40 in f64) and 8 adds; the f64
// peak is half the f32 one. One thread a pair: far off the bound at a few
// thousand pairs (see pairhmm_scaled.cu).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int PAIRS = 32;
constexpr int SMEM_MAX = 232448;

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

template <typename T>
__device__ __forceinline__ T lae(T a, T b) {
  const T hi = a > b ? a : b;
  const T lo = a > b ? b : a;
  if (lo <= Lim<T>::NEG / 2) return hi;
  const T d = lo - hi;
  return hi + log1p_(exp_(d > Lim<T>::CLAMP ? d : Lim<T>::CLAMP));
}

template <typename T>
__host__ __device__ inline size_t per_pair_bytes(int N) {
  return 3 * static_cast<size_t>(N + 1) * sizeof(T) + static_cast<size_t>(N);
}

template <typename T, bool SEMI>
__global__ void __launch_bounds__(PAIRS) pairhmm_log_kernel(
    const uint8_t* __restrict__ xs, const uint8_t* __restrict__ ys,
    const int* __restrict__ xlens, const int* __restrict__ ylens,
    const T* __restrict__ par,   // (7,) no_gap, ngxe, ngye, gx, gy, gxe, gye
    const T* __restrict__ emit,  // (3,) or (B, 3): pm, pmm, pge
    int emit_stride, int B, int M, int N, T* __restrict__ out,
    T* __restrict__ scratch) {   // (3, N + 1, B) or null
  extern __shared__ __align__(16) unsigned char smem[];
  const T NEG = Lim<T>::NEG;
  const int pairs = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * pairs + t;
  if (b >= B) return;

  int xlen = xlens[b];
  int ylen = ylens[b];
  xlen = xlen < 0 ? 0 : (xlen > M ? M : xlen);
  ylen = ylen < 0 ? 0 : (ylen > N ? N : ylen);
  T* base;
  size_t stride;
  const uint8_t* yrow;
  size_t ystride;
  const uint8_t* ysrc = ys + static_cast<size_t>(b) * N;
  if (scratch) {
    base = scratch + b;
    stride = static_cast<size_t>(B);
    yrow = ysrc;
    ystride = 1;
  } else {
    base = reinterpret_cast<T*>(smem) + t;
    stride = static_cast<size_t>(pairs);
    uint8_t* ysm = smem + 3 * static_cast<size_t>(N + 1) * pairs * sizeof(T) + t;
    for (int j = 0; j < ylen; ++j) ysm[static_cast<size_t>(j) * pairs] = ysrc[j];
    yrow = ysm;
    ystride = static_cast<size_t>(pairs);
  }
  T* FM = base;
  T* FX = base + static_cast<size_t>(N + 1) * stride;
  T* FY = base + 2 * static_cast<size_t>(N + 1) * stride;

  const T ng = par[0], ngxe = par[1], ngye = par[2], gx = par[3], gy = par[4];
  const T gxe = par[5], gye = par[6];
  const T* e = emit + static_cast<size_t>(b) * emit_stride;
  const T pm = e[0], pmm = e[1], pge = e[2];
  const T a_open = pge + gx;
  const T b_ext = pge + gxe;
  const uint8_t* xrow = xs + static_cast<size_t>(b) * M;

  for (int j = 0; j <= ylen; ++j) {
    const size_t o = static_cast<size_t>(j) * stride;
    FM[o] = j == 0 ? T(0) : NEG;
    FX[o] = NEG;
    FY[o] = NEG;
  }
  T acc = NEG;

  for (int i = 0; i < xlen; ++i) {
    T dm = FM[0];
    if (SEMI) dm = i == 0 ? Lim<T>::LN2 : T(0);
    T dx = FX[0];
    T dy = FY[0];
    FM[0] = NEG;
    FX[0] = NEG;
    FY[0] = NEG;
    const uint8_t xi = xrow[i];
    T fm_left = NEG;
    T fy_left = NEG;
    T fxn = NEG;
    for (int j = 1; j <= ylen; ++j) {
      const size_t o = static_cast<size_t>(j) * stride;
      const T um = FM[o];
      const T ux = FX[o];
      const T uy = FY[o];
      const T m_in = lae(lae(ng + dm, ngxe + dx), ngye + dy);
      const T em = yrow[static_cast<size_t>(j - 1) * ystride] == xi ? pm : pmm;
      const T fmn = em + m_in;
      fxn = pge + lae(gy + um, gye + ux);
      const T a = a_open + fm_left;
      const T fyn = j == 1 ? a : lae(a, b_ext + fy_left);
      FM[o] = fmn;
      FX[o] = fxn;
      FY[o] = fyn;
      dm = um;
      dx = ux;
      dy = uy;
      fm_left = fmn;
      fy_left = fyn;
    }
    if (SEMI) acc = lae(acc, lae(lae(fm_left, fxn), fy_left));
  }
  T p;
  if (SEMI) {
    p = acc;
  } else {
    const size_t o = static_cast<size_t>(ylen) * stride;
    p = lae(lae(FM[o], FX[o]), FY[o]);
  }
  out[b] = p < T(0) ? p : T(0);
}

template <typename T, bool SEMI>
cudaError_t launch(const void* xs, const void* ys, const void* xlens, const void* ylens,
                   const void* par, const void* emit, int emit_stride, int B, int M, int N,
                   void* out, void* scratch, cudaStream_t stream) {
  const size_t per_pair = per_pair_bytes<T>(N);
  const size_t fit = SMEM_MAX / per_pair;
  const int pairs = scratch ? PAIRS : static_cast<int>(fit < PAIRS ? fit : PAIRS);
  if (pairs < 1) return cudaErrorInvalidValue;
  const size_t smem = scratch ? 0 : per_pair * pairs;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        pairhmm_log_kernel<T, SEMI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  pairhmm_log_kernel<T, SEMI><<<(B + pairs - 1) / pairs, pairs, smem, stream>>>(
      static_cast<const uint8_t*>(xs), static_cast<const uint8_t*>(ys),
      static_cast<const int*>(xlens), static_cast<const int*>(ylens),
      static_cast<const T*>(par), static_cast<const T*>(emit), emit_stride, B, M, N,
      static_cast<T*>(out), static_cast<T*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// f64 selects the double instantiation (par, emit, out and scratch double).
int pairhmm_fwd_log(const void* xs, const void* ys, const void* xlens, const void* ylens,
                    const void* par, const void* emit, int emit_stride, int B, int M, int N,
                    int semiglobal, int f64, void* out, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (f64) {
    rc = semiglobal ? launch<double, true>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M,
                                           N, out, scratch, s)
                    : launch<double, false>(xs, ys, xlens, ylens, par, emit, emit_stride, B,
                                            M, N, out, scratch, s);
  } else {
    rc = semiglobal ? launch<float, true>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M,
                                          N, out, scratch, s)
                    : launch<float, false>(xs, ys, xlens, ylens, par, emit, emit_stride, B,
                                           M, N, out, scratch, s);
  }
  return static_cast<int>(rc);
}

}  // extern "C"
