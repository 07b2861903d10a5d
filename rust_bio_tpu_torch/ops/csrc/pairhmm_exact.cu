// K17-exact pairhmm_fwd_exact: batched oracle-order f64 PairHMM forward,
// one warp a pair over lane column stripes. Replaces the XLA engine
// rust_bio_tpu/stats/pairhmm/exact.py BatchPairHMMExact._forward
// (:150-361). The JAX package has no Pallas kernel for it.
//
// Every cell runs the host oracle's statements (stats/pairhmm/__init__.py
// PairHMM.prob_related, :173-277, itself rust-bio's pairhmm.rs:104-280)
// in their order on the same operands:
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
//   buffer and takes ln_sum_exp over them in index order at the end, on
//   one lane.
// The source is built with -fmad=false (ops/_build.py), so no product and
// sum are fused: every operation rounds as numpy's does. log1p is
// libdevice's (within an ulp of the host libm the oracle uses). The
// branches of those functions are selects here: both sides are computed
// with the oracle's operations and the oracle's side is taken, so the bits
// are the same, and the lanes of a warp do not part. When the caller
// passes a skip mask, (B, M, N) bytes zeroed by the wrapper, every skipped
// cell writes 1 at its (i, j), as the oracle's skip_trace records it.
//
// The H100 computes IEEE f64, where the TPU emulated it (exact.py:14-21),
// so this kernel is held to the host oracle.
//
// Design (csrc/pairhmm_log.cu's; gpuPairHMM, arXiv 2411.11547, spreads a
// pair's columns over a warp's lanes the same way): one warp a pair. Lane
// t owns the columns [t * C + 1, t * C + C] of y, C the wrapper's stripe
// width (ops/pairhmm.py pairhmm_exact_geometry, 32 * C >= N), and at step
// s computes row i = s - t: a pair takes xlen + t_end steps, t_end the
// lane of column ylen (lane 0 when ylen = 0). At the end of a step lane t
// hands what its last column's buffer now holds (fm, fx, fy and med: a
// skipped cell's stale fx, fy and med included) to lane t + 1 with
// __shfl_up_sync: one step later they are the left neighbour of lane
// t + 1's first column (fm, fy, med), and one step after that the
// diagonal (all four). No barrier in the row loop. Lane 0 stands in for
// column 0 as the oracle's buffers hold it: the diagonal fm is
// ln_add_exp(0 on row 0 and -inf after, start_gap), fx and fy -inf, med 0
// in banded semiglobal mode and usize::MAX otherwise; the left fm and fy
// -inf, med usize::MAX on row 0 and, in banded semiglobal mode, 0 after.
// Lane t_end keeps column ylen's values, writes each row's ends in
// semiglobal mode and takes the result.
//
// State: a lane's two buffers of each of its columns: fm once (its other
// buffer is the cleared one), fx, fy and (banded) med twice, as the
// previous row's and the stale one. In registers while they take at most
// 192 bytes a lane (C a power of two: 8 columns unbanded, 2 banded), y's
// bytes of the stripe packed beside them and every column computed (those
// past ylen feed nothing) so that no branch parts the columns. Above that,
// where the wrapper passes a scratch, in the pair's slice of a (B, L, C,
// 32) device scratch as [layer][C][32], lane innermost (L = 3 unbanded:
// fm, fx, fy; 7 banded: fm, then fx, fy and med by row parity, as the
// oracle's two buffers): the columns up to ylen only, y's bytes read per
// cell through the read-only path. Warps a block: the wrapper's (one while
// the card holds every pair at 32 blocks an SM, so that few pairs spread
// over the SMs).
//
// Bound on this card: f64 operations. A cell is up to 5 fastexps (9 flops
// each), 3 log1ps and some 20 adds, compares and selects, all computed
// here (the one-thread kernel before this skipped the sum's fastexps and
// log1p on most cells). A step is a chain of C cells through fy's
// ln_add_exp. The one-thread-a-pair kernel before this ran 1024 pairs on
// 32 warps of the card, 1,500x its bound.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int MAX_WARPS = 8;        // warps (pairs) a block
constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_BYTES = 192;      // a lane's state in registers, at most
constexpr int SLOTS = 3;            // fm, fx, fy a column, unbanded
constexpr int BANDED_SLOTS = 7;     // fm, fx and fy twice, med twice
constexpr unsigned long long USIZE_MAX = ~0ull;

__device__ __forceinline__ double neg_inf() { return __longlong_as_double(0xFFF0000000000000ll); }
__device__ __forceinline__ double pos_inf() { return __longlong_as_double(0x7FF0000000000000ll); }

// utils/fastexp.py fastexp: Kopczynski's polynomial and exponent bits (0 at
// and below -500, and for NaN)
__device__ __forceinline__ double fastexp(double v) {
  const bool live = v > -500.0;
  double x = 1.442695041 * (live ? v : 0.0);
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
  return live ? __longlong_as_double(bits) * f2 : 0.0;
}

// LogProb(self).ln_add_exp(other): self when other is -inf; the larger
// (other where strictly greater) when it is infinite; else the larger plus
// log1p(fastexp(smaller - larger))
__device__ __forceinline__ double ln_add_exp(double self, double other) {
  const bool swap = other > self;
  const double p0 = swap ? other : self;
  const double p1 = swap ? self : other;
  const double sum = p0 + log1p(fastexp(p1 - p0));
  const double out = (p0 == neg_inf() || p0 == pos_inf()) ? p0 : sum;
  return other == neg_inf() ? self : out;
}

// LogProb.ln_sum_exp over three values: the first strict maximum, the
// others' fastexps summed in index order (a -inf term adds nothing; adding
// 0.0 to the sum, which is at least +0, leaves it as it was)
__device__ __forceinline__ double ln_sum_exp3(double a, double b, double c) {
  const bool b_max = b > a;
  const double ab = b_max ? b : a;
  const bool c_max = c > ab;
  const double pmax = c_max ? c : ab;
  const int imax = c_max ? 2 : (b_max ? 1 : 0);
  double s = 0.0;
  s = s + ((imax != 0 && a != neg_inf()) ? fastexp(a - pmax) : 0.0);
  s = s + ((imax != 1 && b != neg_inf()) ? fastexp(b - pmax) : 0.0);
  s = s + ((imax != 2 && c != neg_inf()) ? fastexp(c - pmax) : 0.0);
  const double sum = pmax + log1p(s);
  return (pmax == neg_inf() || pmax == pos_inf()) ? pmax : sum;
}

// pairhmm.rs ln_sum3_exp_approx
__device__ __forceinline__ double ln_sum3_exp_approx(double p0, double p1, double p2) {
  const bool s1 = p1 < p2;
  const double q1 = s1 ? p2 : p1;
  const double q2 = s1 ? p1 : p2;
  const bool s2 = q1 > p0;
  const double r0 = s2 ? q1 : p0;
  const double r1 = s2 ? p0 : q1;
  const double full = ln_sum_exp3(r0, r1, q2);
  return r0 - r1 > 10.0 ? r0 : full;
}

__device__ __forceinline__ unsigned long long sat_inc(unsigned long long a) {
  return a == USIZE_MAX ? a : a + 1;
}

__device__ __forceinline__ unsigned long long umin(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}

// The values a cell reads from its neighbours' buffers.
struct Around {
  double m, x, y;          // fm, fx, fy
  unsigned long long med;  // banded only
};

// CR > 0: the state in registers, C = CR; CR = 0: in the scratch, C = C_rt.
template <bool BANDED, int CR>
__global__ void __launch_bounds__(MAX_WARPS * LANES) pairhmm_exact_warp_kernel(
    const uint8_t* __restrict__ xs, const uint8_t* __restrict__ ys,
    const int* __restrict__ xlens, const int* __restrict__ ylens,
    const double* __restrict__ par,   // (7,) no_gap, ngxe, ngye, gx, gy, gxe, gye
    const double* __restrict__ emit,  // (3,) or (B, 3): pm, pmm, pge
    int emit_stride, int B, int M, int N, int C_rt, int semi, long long max_edit_dist,
    double* __restrict__ out,       // (B,)
    double* __restrict__ ends,      // (B, 3M) when semi
    uint8_t* __restrict__ skip,     // (B, M, N) or null
    double* __restrict__ scratch) { // (B, L, C, 32), or null when CR > 0
  constexpr bool REGS = CR > 0;
  constexpr int L = BANDED ? BANDED_SLOTS : SLOTS;
  const int C = REGS ? CR : C_rt;
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

  const double no_gap = par[0], ngxe = par[1], ngye = par[2], gx = par[3], gy = par[4];
  const double gxe = par[5], gye = par[6];
  const bool do_gxe = gxe != neg_inf();
  const bool do_gye = gye != neg_inf();
  const double* e = emit + static_cast<size_t>(b) * emit_stride;
  const double pm = e[0], pmm = e[1], pge = e[2];
  const double prob_emit_x = pge;
  const double start_gap = semi ? 0.0 : neg_inf();
  const bool skip_all = max_edit_dist < 0;
  const unsigned long long med_max = static_cast<unsigned long long>(max_edit_dist);
  const unsigned long long med_col0 = BANDED && semi ? 0 : USIZE_MAX;  // med_p[0] on every row
  const uint8_t* xrow = xs + static_cast<size_t>(b) * M;
  const uint8_t* ystripe = ys + static_cast<size_t>(b) * N + j0;
  uint8_t* skip_row = skip ? skip + static_cast<size_t>(b) * M * N + j0 : nullptr;
  double* ends_row = semi ? ends + static_cast<size_t>(b) * 3 * M : nullptr;

  // registers: the previous row's buffer (A) and the stale one (S) of each
  // column; fm's stale buffer is the cleared one, -inf
  double am[REGS ? CR : 1], ax[REGS ? CR : 1], ay[REGS ? CR : 1];
  double sx[REGS && BANDED ? CR : 1], sy[REGS && BANDED ? CR : 1];
  unsigned long long amed[REGS && BANDED ? CR : 1], smed[REGS && BANDED ? CR : 1];
  uint32_t yw[REGS ? (CR + 3) / 4 : 1];  // y's bytes of the stripe, packed
  double* mem = nullptr;  // else layer l, column k at mem[(l * C + k) * 32]
  if constexpr (REGS) {
#pragma unroll
    for (int q = 0; q < (CR + 3) / 4; ++q) yw[q] = 0;
#pragma unroll
    for (int k = 0; k < CR; ++k) {
      am[k] = ax[k] = ay[k] = neg_inf();
      if constexpr (BANDED) {
        sx[k] = sy[k] = neg_inf();
        amed[k] = smed[k] = USIZE_MAX;
      }
      if (k < kn) yw[k / 4] |= static_cast<uint32_t>(ystripe[k]) << (8 * (k % 4));
    }
  } else {
    mem = scratch + static_cast<size_t>(b) * L * C * LANES + lane;
    for (int l = 0; l < L; ++l) {
      const double v = l < 5 ? neg_inf() : __longlong_as_double(static_cast<long long>(USIZE_MAX));
      for (int k = 0; k < kn; ++k) mem[(l * C + k) * LANES] = v;
    }
  }
  auto at = [&](int l, int k) -> double& { return mem[(l * C + k) * LANES]; };
  auto med_at = [&](int l, int k) -> unsigned long long& {
    return reinterpret_cast<unsigned long long*>(mem)[(l * C + k) * LANES];
  };

  // lane t - 1's column j0: its buffers a row ago (the diagonal) and from
  // the last shuffle (the left neighbour); row -1 holds the buffers' start
  Around d{neg_inf(), neg_inf(), neg_inf(), USIZE_MAX};
  Around in{neg_inf(), neg_inf(), neg_inf(), USIZE_MAX};
  // column ylen of the last row's buffer (lane t_end): fm[0] = 0 before row 0
  double e_m = ylen == 0 ? 0.0 : neg_inf(), e_x = neg_inf(), e_y = neg_inf();
  int x_next = xlen > 0 ? xrow[0] : 0;  // x_i, read a step ahead
  const int steps = xlen > 0 ? xlen + t_end : 0;
  for (int s = 0; s < steps; ++s) {
    const int i = s - lane;
    Around c{neg_inf(), neg_inf(), neg_inf(), USIZE_MAX};  // this lane's last column, for lane + 1
    if (lane <= t_end && i >= 0 && i < xlen) {
      const int xi = x_next;
      if (i + 1 < xlen) x_next = xrow[i + 1];
      Around dg, lf;  // the diagonal (previous row's buffer), the left neighbour (this row's)
      if (lane == 0) {
        dg = {ln_add_exp(i == 0 ? 0.0 : neg_inf(), start_gap), neg_inf(), neg_inf(), med_col0};
        lf = {neg_inf(), neg_inf(), neg_inf(), BANDED && semi && i > 0 ? 0 : USIZE_MAX};
      } else {
        dg = d;
        lf = in;
        d = in;
      }
      const int p = i & 1;  // scratch, banded: the previous row's buffer p, this row's 1 - p
      Around r{neg_inf(), neg_inf(), neg_inf(), USIZE_MAX};  // column ylen of row i
#pragma unroll
      for (int k = 0; k < C; ++k) {
        // in registers every column, those past ylen too (they feed
        // nothing): no branch between the columns; in memory the columns
        // up to ylen
        if (!REGS && k >= kn) break;
        // this column: the previous row's buffer, and this row's (banded:
        // what a skipped cell leaves)
        Around up, stale{neg_inf(), 0.0, 0.0, 0};
        int yk;
        if constexpr (REGS) {
          up = {am[k], ax[k], ay[k], 0};
          if constexpr (BANDED) {
            up.med = amed[k];
            stale = {neg_inf(), sx[k], sy[k], smed[k]};
          }
          yk = (yw[k / 4] >> (8 * (k % 4))) & 0xFF;
        } else if constexpr (BANDED) {
          up = {at(0, k), at(1 + p, k), at(3 + p, k), med_at(5 + p, k)};
          stale = {neg_inf(), at(2 - p, k), at(4 - p, k), med_at(6 - p, k)};
          yk = __ldg(ystripe + k);
        } else {
          up = {at(0, k), at(1, k), at(2, k), 0};
          yk = __ldg(ystripe + k);
        }
        bool skipped = false;
        if constexpr (BANDED) {
          const unsigned long long lo = umin(umin(dg.med, lf.med), up.med);
          skipped = skip_all || lo > med_max;
        }
        const bool is_match = yk == xi;
        const double emit_xy = is_match ? pm : pmm;
        const double prob_match_mismatch =
            emit_xy + ln_sum3_exp_approx(no_gap + dg.m, ngxe + dg.x, ngye + dg.y);
        double prob_gap_y = prob_emit_x + (gy + up.m);
        if (do_gye) prob_gap_y = ln_add_exp(prob_gap_y, gye + up.x);
        double prob_gap_x = pge + (gx + lf.m);
        if (do_gxe) prob_gap_x = ln_add_exp(prob_gap_x, gxe + lf.y);
        Around now = {prob_match_mismatch, prob_gap_y, prob_gap_x, 0};
        if constexpr (BANDED) {
          const unsigned long long m = is_match ? dg.med : sat_inc(dg.med);
          now.med = umin(umin(m, sat_inc(up.med)), sat_inc(lf.med));
          if (skipped) {
            now = stale;  // fm cleared, fx, fy and med as the buffer holds them
            if (skip_row && k < kn) skip_row[static_cast<size_t>(i) * N + k] = 1;
          }
        }
        if constexpr (REGS) {
          am[k] = now.m;
          ax[k] = now.x;
          ay[k] = now.y;
          if constexpr (BANDED) {
            sx[k] = up.x;
            sy[k] = up.y;
            smed[k] = up.med;
            amed[k] = now.med;
          }
        } else if constexpr (BANDED) {
          at(0, k) = now.m;
          if (!skipped) {
            at(2 - p, k) = now.x;
            at(4 - p, k) = now.y;
            med_at(6 - p, k) = now.med;
          }
        } else {
          at(0, k) = now.m;
          at(1, k) = now.x;
          at(2, k) = now.y;
        }
        dg = up;
        lf = now;
        if (k == kn - 1) r = now;
      }
      c = lf;
      if (lane == t_end) {
        e_m = r.m;
        e_x = r.x;
        e_y = r.y;
        if (semi) {
          ends_row[3 * i] = e_m;
          ends_row[3 * i + 1] = e_x;
          ends_row[3 * i + 2] = e_y;
        }
      }
    }
    in.m = __shfl_up_sync(FULL, c.m, 1);
    in.x = __shfl_up_sync(FULL, c.x, 1);
    in.y = __shfl_up_sync(FULL, c.y, 1);
    if constexpr (BANDED) in.med = __shfl_up_sync(FULL, c.med, 1);
  }
  if (lane != t_end) return;
  double p;
  if (semi) {
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
    p = ln_sum_exp3(e_m, e_x, e_y);
  }
  out[b] = p > 0.0 ? 0.0 : p;
}

template <bool BANDED>
cudaError_t launch(const void* xs, const void* ys, const void* xlens, const void* ylens,
                   const void* par, const void* emit, int emit_stride, int B, int M, int N, int semi,
                   long long max_edit_dist, int C, int warps, void* out, void* ends, void* skip,
                   void* scratch, cudaStream_t stream) {
  if (B < 1 || M < 0 || N < 0 || C < 1 || static_cast<long long>(C) * LANES < N || warps < 1 ||
      warps > MAX_WARPS || (semi && !ends))
    return cudaErrorInvalidValue;
  constexpr int column_bytes = 8 * (BANDED ? BANDED_SLOTS : SLOTS);
  auto kernel = pairhmm_exact_warp_kernel<BANDED, 0>;
  if (!scratch) {
    switch (C) {
      case 1: kernel = pairhmm_exact_warp_kernel<BANDED, 1>; break;
      case 2: kernel = pairhmm_exact_warp_kernel<BANDED, 2>; break;
      case 4:
        if constexpr (4 * column_bytes <= REG_BYTES) {
          kernel = pairhmm_exact_warp_kernel<BANDED, 4>;
          break;
        }
        return cudaErrorInvalidValue;
      case 8:
        if constexpr (8 * column_bytes <= REG_BYTES) {
          kernel = pairhmm_exact_warp_kernel<BANDED, 8>;
          break;
        }
        return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
  }
  kernel<<<(B + warps - 1) / warps, warps * LANES, 0, stream>>>(
      static_cast<const uint8_t*>(xs), static_cast<const uint8_t*>(ys),
      static_cast<const int*>(xlens), static_cast<const int*>(ylens),
      static_cast<const double*>(par), static_cast<const double*>(emit), emit_stride, B, M, N, C,
      semi, max_edit_dist, static_cast<double*>(out), static_cast<double*>(ends),
      static_cast<uint8_t*>(skip), static_cast<double*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// banded 0 ignores max_edit_dist; ends may be null in global mode, skip
// whenever no mask is asked for. C and warps are ops/pairhmm.py
// pairhmm_exact_geometry's, 32 * C >= N; scratch null keeps the state in
// registers (C a power of two, up to 8 unbanded and 2 banded), else a
// (B, L, C, 32) float64 buffer holds it (L 3 unbanded, 7 banded).
int pairhmm_fwd_exact(const void* xs, const void* ys, const void* xlens, const void* ylens,
                      const void* par, const void* emit, int emit_stride, int B, int M, int N,
                      int semiglobal, int banded, long long max_edit_dist, int C, int warps,
                      void* out, void* ends, void* skip, void* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      banded ? launch<true>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N, semiglobal,
                            max_edit_dist, C, warps, out, ends, skip, scratch, s)
             : launch<false>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N, semiglobal,
                             max_edit_dist, C, warps, out, ends, skip, scratch, s);
  return static_cast<int>(rc);
}

}  // extern "C"
