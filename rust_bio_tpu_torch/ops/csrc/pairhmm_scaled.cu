// K17 pairhmm_fwd_scaled: batched scaled linear-space PairHMM forward, one
// thread a pair. Replaces rust_bio_tpu/ops/pairhmm_pallas.py _kernel (the
// Pallas kernel behind pairhmm_fwd_scaled) and the XLA engine
// stats/pairhmm/device.py BatchPairHMMLinear._forward (per-lane emissions).
//
// Semantics, in the Pallas kernel's order of operations (pairhmm_pallas.py
// :48-133), f32 probabilities:
//   row i < xlen:  semiglobal: fm[0] = exp(-LS) (twice that on row 0)
//     m_in[j]  = ng * fm[j-1] + ngx * fx[j-1] + ngy * fy[j-1]
//     fm'[j]   = emit_j * m_in[j]       emit_j = pmm + (pm - pmm) * (x_i == y_j)
//     fx'[j]   = pge * (gy * fm[j] + gye * fx[j])
//     fy'[j]   = (pge * gx) * fm'[j-1] + (pge * gxe) * fy'[j-1]
//     semiglobal: ACC += (fm' + fx' + fy')[ylen]
//     scale = max(max_j(fm', fx', fy'), 1e-30); inv = 1 / scale;
//     every state and ACC times inv; LS += log(scale)
//   out = p_lin > 0 ? min(log(max(p_lin, 1e-38)) + LS, 0) : -3e38, with p_lin
//   ACC (semiglobal) or (fm + fx + fy)[ylen] (global).
// f32 subnormals flush to zero, as on the TPU and in XLA's CPU backend (the
// tests' interpret mode): the source is built with -ftz=true. A lane whose
// scaled probability is below the smallest normal float thus reads 0 and
// goes to the log-space re-run; kept as a subnormal it would give a
// log-likelihood cut off at about -87.5 + LS.
// Every column of the padded width N is computed, as the Pallas kernel does:
// the row maximum, and so the scale, sees the columns past ylen.
// The Y state's in-row recurrence runs in sequence over j; the Pallas
// kernel's log-step prefix exists only for the TPU's sublanes. The scaling
// is applied when a row is read back (stored value times the previous
// row's inv): the same product the Pallas kernel stores, one pass a row.
// Emissions come through a pointer with a lane stride: 0 for shared
// emissions, 3 for per-lane ones. Built with -fmad=false (ops/_build.py),
// so every product and sum rounds as the plain version's does.
//
// Layout: the three state rows of a pair as [column][pair] words in shared
// memory, then its y bytes as [column][pair], so a warp's 32 pairs touch
// 32 consecutive words; a block holds up to 32 pairs. When one pair's rows
// do not fit a block's shared memory the wrapper passes a (3, N+1, B)
// device scratch and y is read from device memory.
//
// Bound on this card: operations. A cell is 13 f32 operations (the
// compares and selects of the emission, 9 multiply/add, 3 max); bytes are
// the inputs once. One thread a pair keeps B threads busy: 4096 pairs fill
// 128 blocks of one warp, about one warp an SM, so the kernel runs far off
// that bound (latency of one dependent chain a warp); the wavefront design
// of gpuPairHMM is a later step.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int PAIRS = 32;
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline size_t per_pair_bytes(int N) {
  return 3 * static_cast<size_t>(N + 1) * sizeof(float) + static_cast<size_t>(N);
}

template <bool SEMI>
__global__ void __launch_bounds__(PAIRS) pairhmm_scaled_kernel(
    const uint8_t* __restrict__ xs,    // (B, M)
    const uint8_t* __restrict__ ys,    // (B, N)
    const int* __restrict__ xlens,     // (B,)
    const int* __restrict__ ylens,     // (B,)
    const float* __restrict__ par,     // (7,) no_gap, ngx, ngy, gx, gy, gxe, gye
    const float* __restrict__ emit,    // (3,) or (B, 3): pm, pmm, pge
    int emit_stride, int B, int M, int N,
    float* __restrict__ out,           // (B,)
    float* __restrict__ scratch) {     // (3, N + 1, B) or null
  extern __shared__ __align__(16) unsigned char smem[];
  const int pairs = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * pairs + t;
  if (b >= B) return;  // no barrier below: each thread touches its own column

  float* base;
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
    base = reinterpret_cast<float*>(smem) + t;
    stride = static_cast<size_t>(pairs);
    uint8_t* ysm = smem + 3 * static_cast<size_t>(N + 1) * pairs * sizeof(float) + t;
    for (int j = 0; j < N; ++j) ysm[static_cast<size_t>(j) * pairs] = ysrc[j];
    yrow = ysm;
    ystride = static_cast<size_t>(pairs);
  }
  float* FM = base;
  float* FX = base + static_cast<size_t>(N + 1) * stride;
  float* FY = base + 2 * static_cast<size_t>(N + 1) * stride;

  const float ng = par[0], ngx = par[1], ngy = par[2], gx = par[3], gy = par[4];
  const float gxe = par[5], gye = par[6];
  const float* e = emit + static_cast<size_t>(b) * emit_stride;
  const float pm = e[0], pmm = e[1], pge = e[2];
  const float em_match = pmm + (pm - pmm);
  const float c_open = pge * gx;
  const float c_ext = pge * gxe;
  int xlen = xlens[b];
  int ylen = ylens[b];
  xlen = xlen < 0 ? 0 : (xlen > M ? M : xlen);
  ylen = ylen < 0 ? 0 : (ylen > N ? N : ylen);
  const uint8_t* xrow = xs + static_cast<size_t>(b) * M;

  for (int j = 0; j <= N; ++j) {
    const size_t o = static_cast<size_t>(j) * stride;
    FM[o] = j == 0 ? 1.0f : 0.0f;
    FX[o] = 0.0f;
    FY[o] = 0.0f;
  }
  float ls = 0.0f;
  float acc = 0.0f;
  float inv_prev = 1.0f;  // the stored row times this is the scaled row

  for (int i = 0; i < xlen; ++i) {
    float dm = FM[0] * inv_prev;  // the previous row at column j - 1
    if (SEMI) {
      const float unit = expf(-ls);
      dm = i == 0 ? 2.0f * unit : unit;
    }
    float dx = FX[0] * inv_prev;
    float dy = FY[0] * inv_prev;
    FM[0] = 0.0f;
    FX[0] = 0.0f;
    FY[0] = 0.0f;
    const uint8_t xi = xrow[i];
    float fm_left = 0.0f;
    float fy_left = 0.0f;
    float mx = 0.0f;
    float row_p = 0.0f;
    for (int j = 1; j <= N; ++j) {
      const size_t o = static_cast<size_t>(j) * stride;
      const float um = FM[o] * inv_prev;
      const float ux = FX[o] * inv_prev;
      const float uy = FY[o] * inv_prev;
      const float m_in = ng * dm + ngx * dx + ngy * dy;
      const float em = yrow[static_cast<size_t>(j - 1) * ystride] == xi ? em_match : pmm;
      const float fmn = em * m_in;
      const float fxn = pge * (gy * um + gye * ux);
      const float fyn = c_open * fm_left + c_ext * fy_left;
      FM[o] = fmn;
      FX[o] = fxn;
      FY[o] = fyn;
      mx = fmaxf(mx, fmaxf(fmaxf(fmn, fxn), fyn));
      if (SEMI && j == ylen) row_p = fmn + fxn + fyn;
      dm = um;
      dx = ux;
      dy = uy;
      fm_left = fmn;
      fy_left = fyn;
    }
    const float scale = fmaxf(mx, 1e-30f);
    const float inv = 1.0f / scale;
    if (SEMI) acc = (acc + row_p) * inv;
    ls = ls + logf(scale);
    inv_prev = inv;
  }

  float p_lin;
  if (SEMI) {
    p_lin = acc;
  } else {
    const size_t o = static_cast<size_t>(ylen) * stride;
    p_lin = FM[o] * inv_prev + FX[o] * inv_prev + FY[o] * inv_prev;
  }
  out[b] = p_lin > 0.0f ? fminf(logf(fmaxf(p_lin, 1e-38f)) + ls, 0.0f) : -3.0e38f;
}

template <bool SEMI>
cudaError_t launch(const void* xs, const void* ys, const void* xlens, const void* ylens,
                   const void* par, const void* emit, int emit_stride, int B, int M, int N,
                   void* out, void* scratch, cudaStream_t stream) {
  const size_t per_pair = per_pair_bytes(N);
  const size_t fit = SMEM_MAX / per_pair;
  const int pairs = scratch ? PAIRS : static_cast<int>(fit < PAIRS ? fit : PAIRS);
  if (pairs < 1) return cudaErrorInvalidValue;  // the wrapper passes a scratch then
  const size_t smem = scratch ? 0 : per_pair * pairs;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        pairhmm_scaled_kernel<SEMI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  pairhmm_scaled_kernel<SEMI><<<(B + pairs - 1) / pairs, pairs, smem, stream>>>(
      static_cast<const uint8_t*>(xs), static_cast<const uint8_t*>(ys),
      static_cast<const int*>(xlens), static_cast<const int*>(ylens),
      static_cast<const float*>(par), static_cast<const float*>(emit), emit_stride, B, M,
      N, static_cast<float*>(out), static_cast<float*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int pairhmm_fwd_scaled(const void* xs, const void* ys, const void* xlens, const void* ylens,
                       const void* par, const void* emit, int emit_stride, int B, int M,
                       int N, int semiglobal, void* out, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      semiglobal ? launch<true>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N, out,
                                scratch, s)
                 : launch<false>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N, out,
                                 scratch, s);
  return static_cast<int>(rc);
}

}  // extern "C"
