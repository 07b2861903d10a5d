// K17-homopoly pairhmm_fwd_homopoly: batched 14-state HomopolyPairHMM
// forward, one thread a pair, on float and double. Replaces the XLA engine
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
// Only columns up to ylen are computed. The two in-row recurrences run in
// sequence over j (the XLA engine uses an associative scan). The quarter
// initial mass sits on the four match states of column 0. Built with
// -fmad=false (ops/_build.py).
//
// Layout: the 14 state rows as [column][pair] words in shared memory,
// then y's bytes; up to 32 pairs a block; a (14, N+1, B) device scratch
// when one pair's rows do not fit (y then read from device memory).
//
// Bound on this card: operations. A cell is 34 logaddexps (an exp and a
// log1p each) and about 40 adds and compares. One thread a pair: far off
// the bound (see pairhmm_scaled.cu).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int PAIRS = 32;
constexpr int SMEM_MAX = 232448;
constexpr int LAYERS = 14;
constexpr int NPAR = 34;

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

template <typename T>
__device__ __forceinline__ T lae(T a, T b) {
  const T hi = a > b ? a : b;
  const T lo = a > b ? b : a;
  if (lo <= Lim<T>::NEG / 2) return hi;
  const T d = lo - hi;
  return hi + log1p_(exp_(d > Lim<T>::CLAMP ? d : Lim<T>::CLAMP));
}

template <typename T>
__device__ __forceinline__ T lse4(const T* v) {
  return lae(lae(lae(v[0], v[1]), v[2]), v[3]);
}

template <typename T>
__host__ __device__ inline size_t per_pair_bytes(int N) {
  return static_cast<size_t>(LAYERS) * (N + 1) * sizeof(T) + static_cast<size_t>(N);
}

// par: 0 match_any, 1 pgx, 2 pgy, 3 pgxe, 4 pgye, 5 from_gx, 6 from_gy,
// 7-10 hx, 11-14 hy, 15-18 hxe, 19-22 hye, 23-26 from_hx, 27-30 from_hy,
// 31 ln 2, 32 ln 0.25, 33 -ln 4
template <typename T, bool SEMI>
__global__ void __launch_bounds__(PAIRS) pairhmm_homopoly_kernel(
    const uint8_t* __restrict__ xs, const uint8_t* __restrict__ ys,
    const int* __restrict__ xlens, const int* __restrict__ ylens,
    const T* __restrict__ par,   // (NPAR,)
    const T* __restrict__ emit,  // (4,) or (B, 4): pm, pmm, pe_x, pe_y
    int emit_stride, int B, int M, int N, T* __restrict__ out,
    T* __restrict__ scratch) {   // (14, N + 1, B) or null
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
    uint8_t* ysm = smem + static_cast<size_t>(LAYERS) * (N + 1) * pairs * sizeof(T) + t;
    for (int j = 0; j < ylen; ++j) ysm[static_cast<size_t>(j) * pairs] = ysrc[j];
    yrow = ysm;
    ystride = static_cast<size_t>(pairs);
  }
  // layer s holds state s in the order of a column: vm 0-3, vgx 4, vgy 5,
  // vhx 6-9, vhy 10-13
  const size_t layer = static_cast<size_t>(N + 1) * stride;

  const T match_any = par[0], pgx = par[1], pgy = par[2], pgxe = par[3], pgye = par[4];
  const T from_gx = par[5], from_gy = par[6];
  const T ln2 = par[31], quarter = par[32], neg_ln4 = par[33];
  const T* e = emit + static_cast<size_t>(b) * emit_stride;
  const T pm = e[0], pmm = e[1], pe_x = e[2], pe_y = e[3];
  const T pmm_half = pmm - ln2;
  const T a_gx = pe_y + pgy;
  const T b_gx = pe_y + pgye;
  const uint8_t* xrow = xs + static_cast<size_t>(b) * M;
  const uint8_t bases[4] = {'A', 'C', 'G', 'T'};

  for (int s = 0; s < LAYERS; ++s) {
    for (int j = 0; j <= ylen; ++j) {
      base[s * layer + static_cast<size_t>(j) * stride] = (s < 4 && j == 0) ? quarter : NEG;
    }
  }
  T col1[LAYERS];
  T col2[LAYERS];
  for (int s = 0; s < LAYERS; ++s) {
    col1[s] = NEG;
    col2[s] = NEG;
  }
  T acc = NEG;
  // ln(ylen - 1) of the stale copies, NEG without any
  const T ln_nstale = ylen - 1 > 0 ? log_(static_cast<T>(ylen - 1)) : NEG;

  for (int i = 0; i < xlen; ++i) {
    const uint8_t xi = xrow[i];
    bool exg[4];
    for (int k = 0; k < 4; ++k) exg[k] = xi == bases[k];
    // the previous row at column j - 1 (diagonal) and this row at j - 1 (left)
    T dvm[4], dhx[4], dhy[4], lvm[4], lhx[4];
    for (int k = 0; k < 4; ++k) {
      T v = base[k * layer];
      if (SEMI) v = lae(v, neg_ln4);
      dvm[k] = v;
      dhx[k] = base[(6 + k) * layer];
      dhy[k] = base[(10 + k) * layer];
      lvm[k] = NEG;
      lhx[k] = NEG;
    }
    T dgx = base[4 * layer];
    T dgy = base[5 * layer];
    T lgx = NEG;
    for (int s = 0; s < LAYERS; ++s) base[s * layer] = NEG;
    T fresh[LAYERS];
    for (int s = 0; s < LAYERS; ++s) fresh[s] = NEG;

    for (int j = 1; j <= ylen; ++j) {
      const size_t o = static_cast<size_t>(j) * stride;
      const uint8_t yj = yrow[static_cast<size_t>(j - 1) * ystride];
      T uvm[4], uhx[4], uhy[4];
      for (int k = 0; k < 4; ++k) {
        uvm[k] = base[k * layer + o];
        uhx[k] = base[(6 + k) * layer + o];
        uhy[k] = base[(10 + k) * layer + o];
      }
      const T ugx = base[4 * layer + o];
      const T ugy = base[5 * layer + o];

      T pre = match_any + lse4(dvm);
      pre = lae(pre, from_gx + dgx);
      pre = lae(pre, from_gy + dgy);
      for (int k = 0; k < 4; ++k) pre = lae(pre, par[23 + k] + dhx[k]);
      for (int k = 0; k < 4; ++k) pre = lae(pre, par[27 + k] + dhy[k]);
      const T v = (xi == yj ? pm : pmm_half) + pre;
      T vm[4], vhx[4], vhy[4];
      for (int k = 0; k < 4; ++k) vm[k] = (exg[k] || yj == bases[k]) ? v : NEG;
      const T vgy = pe_x + lae(pgx + lse4(uvm), pgxe + ugy);
      for (int k = 0; k < 4; ++k) vhy[k] = lae(par[11 + k] + uvm[k], par[19 + k] + uhy[k]);
      const T agx = a_gx + lse4(lvm);
      const T vgx = j == 1 ? agx : lae(agx, b_gx + lgx);
      for (int k = 0; k < 4; ++k) {
        const T a = par[7 + k] + lvm[k];
        vhx[k] = j == 1 ? a : lae(a, par[15 + k] + lhx[k]);
      }
      for (int k = 0; k < 4; ++k) {
        base[k * layer + o] = vm[k];
        base[(6 + k) * layer + o] = vhx[k];
        base[(10 + k) * layer + o] = vhy[k];
      }
      base[4 * layer + o] = vgx;
      base[5 * layer + o] = vgy;
      if (j == ylen) {
        for (int k = 0; k < 4; ++k) {
          fresh[k] = vm[k];
          fresh[6 + k] = vhx[k];
          fresh[10 + k] = vhy[k];
        }
        fresh[4] = vgx;
        fresh[5] = vgy;
      }
      for (int k = 0; k < 4; ++k) {
        dvm[k] = uvm[k];
        dhx[k] = uhx[k];
        dhy[k] = uhy[k];
        lvm[k] = vm[k];
        lhx[k] = vhx[k];
      }
      dgx = ugx;
      dgy = ugy;
      lgx = vgx;
    }

    T row_mass = fresh[0];
    for (int s = 1; s < LAYERS; ++s) row_mass = lae(row_mass, fresh[s]);
    if (SEMI) {
      T stale = NEG + ln_nstale;  // the match entries of the stale column are NEG
      for (int s = 1; s < LAYERS; ++s) stale = lae(stale, (s < 4 ? NEG : col2[s]) + ln_nstale);
      acc = lae(acc, lae(stale, row_mass));
    } else {
      acc = row_mass;
    }
    for (int s = 0; s < LAYERS; ++s) {
      col2[s] = col1[s];
      col1[s] = fresh[s];
    }
  }
  out[b] = acc < T(0) ? acc : T(0);
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
        pairhmm_homopoly_kernel<T, SEMI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  pairhmm_homopoly_kernel<T, SEMI><<<(B + pairs - 1) / pairs, pairs, smem, stream>>>(
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
int pairhmm_fwd_homopoly(const void* xs, const void* ys, const void* xlens,
                         const void* ylens, const void* par, const void* emit, int emit_stride,
                         int B, int M, int N, int semiglobal, int f64, void* out, void* scratch,
                         void* stream) {
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
