// K17-exact pairhmm_fwd_exact: batched oracle-order f64 PairHMM forward,
// one thread a pair. Replaces the XLA engine
// rust_bio_tpu/stats/pairhmm/exact.py BatchPairHMMExact._forward
// (:150-361). The JAX package has no Pallas kernel for it.
//
// Each thread runs the host oracle's loop (stats/pairhmm/__init__.py
// PairHMM.prob_related, :173-277, itself rust-bio's pairhmm.rs:104-280)
// statement for statement:
// - two rolling rows of fm, fx, fy and med; only fm is cleared between
//   rows, so a skipped cell keeps fx, fy and med from two rows back;
// - med is uint64 with the oracle's saturating add at usize::MAX, and a
//   cell is skipped when min(topleft, top, left) > max_edit_dist;
// - ln_sum3_exp_approx with its partial sort and 10-nat shortcut, and
//   LogProb.ln_add_exp / ln_sum_exp with the oracle's branch order
//   (first strict maximum skipped, terms summed in index order);
// - the reference's fastexp, bit for bit: the clamp to -500, the (long
//   long) truncation, the exponent bits through __longlong_as_double;
// - semiglobal mode stores each row's three end values in a (B, 3M) f64
//   scratch and takes ln_sum_exp over them in index order at the end.
// The source is built with -fmad=false (ops/_build.py), so no product and
// sum are fused: every operation rounds as numpy's does. log1p is
// libdevice's (within an ulp of the host libm the oracle uses). When the
// caller passes a skip mask, (B, M, N) bytes zeroed by the wrapper, every
// banded `continue` writes 1 at its (i, j), as the oracle's skip_trace
// records it.
//
// The H100 computes IEEE f64, where the TPU emulated it (exact.py:14-21),
// so this kernel is held to the host oracle.
//
// Layout: the rolling rows as [column][pair] 8-byte words in shared memory
// (fm, fx, fy twice each, med twice when banded), then y's bytes; up to 32
// pairs a block; a (L, N+1, B) device scratch when one pair's rows do not
// fit (y then read from device memory).
//
// Bound on this card: f64 operations. A cell is up to 3 fastexps (9 flops
// each), 3 log1ps and some 12 adds and compares; the shortcut skips the
// sum's fastexps and log1p on most cells. One thread a pair: far off the
// bound (see pairhmm_scaled.cu).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int PAIRS = 32;
constexpr int SMEM_MAX = 232448;
constexpr unsigned long long USIZE_MAX = ~0ull;

__device__ __forceinline__ double neg_inf() { return __longlong_as_double(0xFFF0000000000000ll); }
__device__ __forceinline__ double pos_inf() { return __longlong_as_double(0x7FF0000000000000ll); }

// utils/fastexp.py fastexp: Kopczynski's polynomial and exponent bits
__device__ __forceinline__ double fastexp(double v) {
  if (!(v > -500.0)) return 0.0;
  double x = 1.442695041 * v;
  long long bits = static_cast<long long>(x);  // truncation toward zero
  x = x - static_cast<double>(bits);
  double f2 = x;
  double x_tmp = x;
  bits = static_cast<long long>(static_cast<unsigned long long>(bits + 1023) << 52);
  f2 = f2 * 0.006935931;
  x_tmp = x_tmp + 4.831794110;
  f2 = f2 + 0.019890581;
  x_tmp = x_tmp * x;
  f2 = f2 * x;
  f2 = f2 + 0.143440676;
  f2 = f2 * x_tmp;
  f2 = f2 + 1.0;
  return __longlong_as_double(bits) * f2;
}

// LogProb(self).ln_add_exp(other)
__device__ __forceinline__ double ln_add_exp(double self, double other) {
  if (other == neg_inf()) return self;
  double p0 = self;
  double p1 = other;
  if (p1 > p0) {
    const double t = p0;
    p0 = p1;
    p1 = t;
  }
  if (p0 == neg_inf()) return neg_inf();
  if (p0 == pos_inf()) return pos_inf();
  return p0 + log1p(fastexp(p1 - p0));
}

// LogProb.ln_sum_exp over three values
__device__ __forceinline__ double ln_sum_exp3(double a, double b, double c) {
  double pmax = a;
  int imax = 0;
  if (b > pmax) {
    pmax = b;
    imax = 1;
  }
  if (c > pmax) {
    pmax = c;
    imax = 2;
  }
  if (pmax == neg_inf()) return neg_inf();
  if (pmax == pos_inf()) return pos_inf();
  double s = 0.0;
  if (imax != 0 && a != neg_inf()) s += fastexp(a - pmax);
  if (imax != 1 && b != neg_inf()) s += fastexp(b - pmax);
  if (imax != 2 && c != neg_inf()) s += fastexp(c - pmax);
  return pmax + log1p(s);
}

// pairhmm.rs ln_sum3_exp_approx
__device__ __forceinline__ double ln_sum3_exp_approx(double p0, double p1, double p2) {
  if (p1 < p2) {
    const double t = p1;
    p1 = p2;
    p2 = t;
  }
  if (p1 > p0) {
    const double t = p1;
    p1 = p0;
    p0 = t;
  }
  if (p0 - p1 > 10.0) return p0;
  return ln_sum_exp3(p0, p1, p2);
}

__device__ __forceinline__ unsigned long long sat_inc(unsigned long long a) {
  return a == USIZE_MAX ? a : a + 1;
}

__host__ __device__ inline int n_layers(bool banded) { return banded ? 8 : 6; }

__host__ __device__ inline size_t per_pair_bytes(int N, bool banded) {
  return static_cast<size_t>(n_layers(banded)) * (N + 1) * 8 + static_cast<size_t>(N);
}

template <bool SEMI, bool BANDED>
__global__ void __launch_bounds__(PAIRS) pairhmm_exact_kernel(
    const uint8_t* __restrict__ xs, const uint8_t* __restrict__ ys,
    const int* __restrict__ xlens, const int* __restrict__ ylens,
    const double* __restrict__ par,   // (7,) no_gap, ngxe, ngye, gx, gy, gxe, gye
    const double* __restrict__ emit,  // (3,) or (B, 3): pm, pmm, pge
    int emit_stride, int B, int M, int N, long long max_edit_dist,
    double* __restrict__ out,          // (B,)
    double* __restrict__ ends,         // (B, 3M) when SEMI
    uint8_t* __restrict__ skip,        // (B, M, N) or null
    double* __restrict__ scratch) {    // (layers, N + 1, B) or null
  extern __shared__ __align__(16) unsigned char smem[];
  const int pairs = blockDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x * pairs + t;
  if (b >= B) return;

  int xlen = xlens[b];
  int ylen = ylens[b];
  xlen = xlen < 0 ? 0 : (xlen > M ? M : xlen);
  ylen = ylen < 0 ? 0 : (ylen > N ? N : ylen);
  double* base;
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
    base = reinterpret_cast<double*>(smem) + t;
    stride = static_cast<size_t>(pairs);
    uint8_t* ysm =
        smem + static_cast<size_t>(n_layers(BANDED)) * (N + 1) * pairs * 8 + t;
    for (int j = 0; j < ylen; ++j) ysm[static_cast<size_t>(j) * pairs] = ysrc[j];
    yrow = ysm;
    ystride = static_cast<size_t>(pairs);
  }
  // layers: fm of row buffers 0 and 1, then fx, fy and med the same way;
  // buffer k of a state is its layer pair's base plus k layers
  const size_t layer = static_cast<size_t>(N + 1) * stride;
  double* const fm0 = base;
  double* const fx0 = base + 2 * layer;
  double* const fy0 = base + 4 * layer;
  unsigned long long* const med0 = reinterpret_cast<unsigned long long*>(base + 6 * layer);

  const double no_gap = par[0], ngxe = par[1], ngye = par[2], gx = par[3], gy = par[4];
  const double gxe = par[5], gye = par[6];
  const bool do_gxe = gxe != neg_inf();
  const bool do_gye = gye != neg_inf();
  const double* e = emit + static_cast<size_t>(b) * emit_stride;
  const double pm = e[0], pmm = e[1], pge = e[2];
  const double start_gap = SEMI ? 0.0 : neg_inf();
  const uint8_t* xrow = xs + static_cast<size_t>(b) * M;
  uint8_t* skip_row = skip ? skip + static_cast<size_t>(b) * M * N : nullptr;
  double* ends_row = SEMI ? ends + static_cast<size_t>(b) * 3 * M : nullptr;

  for (int k = 0; k < 2; ++k) {
    for (int j = 0; j <= ylen; ++j) {
      const size_t o = k * layer + static_cast<size_t>(j) * stride;
      fm0[o] = neg_inf();
      fx0[o] = neg_inf();
      fy0[o] = neg_inf();
      if (BANDED) med0[o] = USIZE_MAX;
    }
  }
  int prev = 0;
  int curr = 1;
  fm0[0] = 0.0;

  for (int i = 0; i < xlen; ++i) {
    const size_t po = prev * layer;
    const size_t co = curr * layer;
    double* const fm_p = fm0 + po;
    double* const fm_c = fm0 + co;
    double* const fx_p = fx0 + po;
    double* const fx_c = fx0 + co;
    double* const fy_p = fy0 + po;
    double* const fy_c = fy0 + co;
    unsigned long long* const med_p = med0 + po;
    unsigned long long* const med_c = med0 + co;
    fm_p[0] = ln_add_exp(fm_p[0], start_gap);
    if (BANDED && SEMI) med_p[0] = 0;
    const double prob_emit_x = pge;
    const uint8_t xi = xrow[i];
    for (int j = 0; j < ylen; ++j) {
      const size_t o = static_cast<size_t>(j + 1) * stride;  // j_
      const size_t om = static_cast<size_t>(j) * stride;     // j_ - 1
      unsigned long long med_tl = 0, med_top = 0, med_left = 0;
      if (BANDED) {
        med_tl = med_p[om];
        med_top = med_c[om];
        med_left = med_p[o];
        unsigned long long lo = med_tl < med_top ? med_tl : med_top;
        lo = lo < med_left ? lo : med_left;
        if (max_edit_dist < 0 || lo > static_cast<unsigned long long>(max_edit_dist)) {
          if (skip_row) skip_row[static_cast<size_t>(i) * N + j] = 1;
          continue;
        }
      }
      const bool is_match = yrow[static_cast<size_t>(j) * ystride] == xi;
      const double emit_xy = is_match ? pm : pmm;
      const double prob_match_mismatch =
          emit_xy + ln_sum3_exp_approx(no_gap + fm_p[om], ngxe + fx_p[om],
                                       ngye + fy_p[om]);
      double prob_gap_y = prob_emit_x + (gy + fm_p[o]);
      if (do_gye) prob_gap_y = ln_add_exp(prob_gap_y, gye + fx_p[o]);
      double prob_gap_x = pge + (gx + fm_c[om]);
      if (do_gxe) prob_gap_x = ln_add_exp(prob_gap_x, gxe + fy_c[om]);
      fm_c[o] = prob_match_mismatch;
      fx_c[o] = prob_gap_y;
      fy_c[o] = prob_gap_x;
      if (BANDED) {
        const unsigned long long m = is_match ? med_tl : sat_inc(med_tl);
        const unsigned long long l = sat_inc(med_left);
        const unsigned long long tp = sat_inc(med_top);
        unsigned long long nm = m < l ? m : l;
        med_c[o] = nm < tp ? nm : tp;
      }
    }
    if (SEMI) {
      const size_t o = static_cast<size_t>(ylen) * stride;
      ends_row[3 * i] = fm_c[o];
      ends_row[3 * i + 1] = fx_c[o];
      ends_row[3 * i + 2] = fy_c[o];
    }
    const int tmp = curr;
    curr = prev;
    prev = tmp;
    for (int j = 0; j <= ylen; ++j) fm_p[static_cast<size_t>(j) * stride] = neg_inf();
  }

  double p;
  if (SEMI) {
    // LogProb.ln_sum_exp(prob_cols)
    const int K = 3 * xlen;
    if (K == 0) {
      p = neg_inf();
    } else {
      double pmax = ends_row[0];
      int imax = 0;
      for (int k = 1; k < K; ++k) {
        if (ends_row[k] > pmax) {
          pmax = ends_row[k];
          imax = k;
        }
      }
      if (pmax == neg_inf()) {
        p = neg_inf();
      } else if (pmax == pos_inf()) {
        p = pos_inf();
      } else {
        double s = 0.0;
        for (int k = 0; k < K; ++k) {
          const double v = ends_row[k];
          if (k == imax || v == neg_inf()) continue;
          s += fastexp(v - pmax);
        }
        p = pmax + log1p(s);
      }
    }
  } else {
    const size_t o = static_cast<size_t>(ylen) * stride;
    p = ln_sum_exp3(fm0[prev * layer + o], fx0[prev * layer + o], fy0[prev * layer + o]);
  }
  out[b] = p > 0.0 ? 0.0 : p;
}

template <bool SEMI, bool BANDED>
cudaError_t launch(const void* xs, const void* ys, const void* xlens, const void* ylens,
                   const void* par, const void* emit, int emit_stride, int B, int M, int N,
                   long long max_edit_dist, void* out, void* ends, void* skip, void* scratch,
                   cudaStream_t stream) {
  const size_t per_pair = per_pair_bytes(N, BANDED);
  const size_t fit = SMEM_MAX / per_pair;
  const int pairs = scratch ? PAIRS : static_cast<int>(fit < PAIRS ? fit : PAIRS);
  if (pairs < 1) return cudaErrorInvalidValue;
  const size_t smem = scratch ? 0 : per_pair * pairs;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        pairhmm_exact_kernel<SEMI, BANDED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  pairhmm_exact_kernel<SEMI, BANDED><<<(B + pairs - 1) / pairs, pairs, smem, stream>>>(
      static_cast<const uint8_t*>(xs), static_cast<const uint8_t*>(ys),
      static_cast<const int*>(xlens), static_cast<const int*>(ylens),
      static_cast<const double*>(par), static_cast<const double*>(emit), emit_stride, B, M,
      N, max_edit_dist, static_cast<double*>(out), static_cast<double*>(ends),
      static_cast<uint8_t*>(skip), static_cast<double*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// banded 0 ignores max_edit_dist; ends may be null in global mode, skip
// whenever no mask is asked for.
int pairhmm_fwd_exact(const void* xs, const void* ys, const void* xlens, const void* ylens,
                      const void* par, const void* emit, int emit_stride, int B, int M,
                      int N, int semiglobal, int banded, long long max_edit_dist, void* out,
                      void* ends, void* skip, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (semiglobal) {
    rc = banded ? launch<true, true>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N,
                                     max_edit_dist, out, ends, skip, scratch, s)
                : launch<true, false>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N,
                                      max_edit_dist, out, ends, skip, scratch, s);
  } else {
    rc = banded ? launch<false, true>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N,
                                      max_edit_dist, out, ends, skip, scratch, s)
                : launch<false, false>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M,
                                       N, max_edit_dist, out, ends, skip, scratch, s);
  }
  return static_cast<int>(rc);
}

}  // extern "C"
