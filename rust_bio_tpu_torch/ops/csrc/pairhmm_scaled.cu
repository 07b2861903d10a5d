// K17 pairhmm_fwd_scaled: batched scaled linear-space PairHMM forward, one
// warp a pair over lane column stripes. Replaces
// rust_bio_tpu/ops/pairhmm_pallas.py _kernel (the Pallas kernel behind
// pairhmm_fwd_scaled) and the XLA engine stats/pairhmm/device.py
// BatchPairHMMLinear._forward (per-lane emissions).
//
// Semantics, in the Pallas kernel's order of operations (pairhmm_pallas.py
// :48-133), f32 probabilities:
//   row i < xlen:  semiglobal: fm[0] = exp(-LS) (twice that on row 0)
//     m_in[j]  = ng * fm[j-1] + ngx * fx[j-1] + ngy * fy[j-1]
//     fm'[j]   = emit_j * m_in[j]       emit_j = pmm + (pm - pmm) * (x_i == y_j)
//     fx'[j]   = pge * (gy * fm[j] + gye * fx[j])
//     fy'[j]   = A[j-1] + c_ext * fy'[j-1],  A[j] = c_open * fm'[j],
//                c_open = pge * gx, c_ext = pge * gxe
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
// the row maximum, and so the scale, sees the columns past ylen. The
// scaling is applied when a row is read back (stored value times the
// previous row's inv): the same product the Pallas kernel stores.
// Emissions come through a pointer with a lane stride: 0 for shared
// emissions, 3 for per-lane ones. Built with -fmad=false (ops/_build.py),
// so every product and sum rounds as the plain version's does.
//
// Design: one warp a pair, K17-log's lanes (pairhmm_log.cu). Lane t owns
// the columns [t * C + 1, t * C + C] of y, C the wrapper's stripe width
// (ops/pairhmm.py pairhmm_scaled_geometry, 32 * C >= N). K17-log runs a
// wavefront; this kernel cannot: row i's scale is a maximum over every
// column, and row i + 1 reads row i times its inverse. So the warp computes
// a row at a time:
//  1. each lane reads its columns' fm, fx, fy of row i - 1 times inv; the
//     diagonal of its first column is lane t - 1's last (__shfl_up_sync);
//     lane 0 stands in for column 0 (1 on row 0, then 0; semiglobal: the
//     exp(-LS) bound, twice that on row 0);
//  2. fm' and fx' of its columns, independent of each other;
//  3. fy': the recurrence fy'[j] = A[j-1] + c_ext * fy'[j-1] split at the
//     stripes. Each lane's carry x_t = fy'[t * C + 1], its first column,
//     comes from a scan: x_{t+1} = g_C + c_ext^C * x_t, with g_0 = 0 and
//     g_k = A[t * C + k] + c_ext * g_{k-1} over the lane's own A (its
//     columns' fm'); the lanes' maps x -> c_ext^C * x + g_C are composed
//     by a 5-step inclusive scan (__shfl_up_sync at distance d, the slope
//     c_ext^(C * d), the same for every lane), x_0 = fy'[1] = 0, and each
//     lane takes x_t from lane t - 1: the log-step affine prefix of the
//     Pallas kernel (pairhmm_pallas.py:35-45 _prefix_affine), on the lanes.
//     g and the scan run on values times 2^64, which rounds nothing (a
//     power of two) but keeps products of small slopes and carries from
//     flushing to zero. From its carry each lane then runs the recurrence
//     over its C columns in sequence, the plain version's operations: with
//     flush-to-zero a chain split at the stripes parts from the chain in
//     sequence where small A join a sum near the smallest normal (an end
//     column 60 columns right of the diagonal, its mass 1e-38 of the
//     row's, parted by 0.9% when the stripe's values came from the scan).
//     Only the carries are rounded otherwise. Where c_ext is 0 (no gap
//     extension) the slope is 0, the scan adds nothing and is skipped, and
//     fy'[j] = A[j-1]: the plain version's bits;
//  4. the lane of column ylen folds (fm' + fx' + fy')[ylen] into ACC
//     (semiglobal);
//  5. the row maximum: each lane's maximum over its columns up to N, then
//     __reduce_max_sync over the warp on the float bits read as int (every
//     value is >= +0, where the int order is the float order: exact, like
//     fmaxf in any order); inv = 1 / scale and LS += log(scale), the same
//     on every lane.
// Only step 3's carries round otherwise than the plain version, which runs
// the Y recurrence in sequence: the kernel holds it to 1e-5 of max(1, |p|).
// State: a lane's fm, fx, fy of each of its columns from row i - 1 (stored
// before scaling). In registers while they take at most REG_BYTES a lane,
// C a power of two up to 16 (N <= 512), y's bytes of the stripe packed
// beside them and every column computed; above that, where the wrapper
// passes a scratch, in the pair's slice of a (B, 3, C, 32) device scratch
// as [layer][C][32], lane innermost, in two passes over the stripe (the
// first stores A in place of fy), y read through the read-only path.
// Warps a block: the wrapper's (one while the card holds every pair at 32
// blocks an SM, up to MAX_WARPS beyond that).
//
// Bound on this card: operations. A cell is 22 f32 operations (the
// rescaling products, the emission's compare and select, m_in, fm', fx',
// A and fy', the maximum; the carries' chain g not counted); bytes are the
// inputs once. The one-thread
// kernel before this one kept 32 pairs a block in shared memory, one or two
// warps an SM on the main path's batches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int MAX_WARPS = 8;      // warps (pairs) a block
constexpr int REG_BYTES = 192;    // a lane's state in registers, at most
constexpr unsigned FULL = 0xffffffffu;
constexpr float CARRY_UP = 18446744073709551616.0f;     // 2^64
constexpr float CARRY_DOWN = 5.42101086242752217e-20f;  // 2^-64

// CR > 0: the state in registers, C = CR; CR = 0: in the scratch, C = C_rt.
template <bool SEMI, int CR>
__global__ void __launch_bounds__(MAX_WARPS * LANES) pairhmm_scaled_warp_kernel(
    const uint8_t* __restrict__ xs,    // (B, M)
    const uint8_t* __restrict__ ys,    // (B, N)
    const int* __restrict__ xlens,     // (B,)
    const int* __restrict__ ylens,     // (B,)
    const float* __restrict__ par,     // (7,) no_gap, ngx, ngy, gx, gy, gxe, gye
    const float* __restrict__ emit,    // (3,) or (B, 3): pm, pmm, pge
    int emit_stride, int B, int M, int N, int C_rt,
    float* __restrict__ out,           // (B,)
    float* __restrict__ scratch) {     // (B, 3, C, 32), or null when CR > 0
  constexpr bool REGS = CR > 0;
  const int C = REGS ? CR : C_rt;
  const int lane = threadIdx.x % LANES;
  const int b = blockIdx.x * (blockDim.x / LANES) + threadIdx.x / LANES;
  if (b >= B) return;  // the whole warp

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
  const int j0 = lane * C;                              // columns j0 + 1 .. j0 + C
  const int live = N - j0 < 0 ? 0 : (N - j0 > C ? C : N - j0);  // columns up to N
  const int t_end = ylen > 0 ? (ylen - 1) / C : 0;      // the lane of column ylen
  const int k_end = ylen > 0 ? ylen - 1 - t_end * C : -1;  // its column there (-1: column 0)
  const uint8_t* ystripe = ys + static_cast<size_t>(b) * N + j0;

  const float c_open_up = c_open * CARRY_UP;  // A times 2^64
  // the scan's slopes c_ext^(C * d), d = 1, 2, 4, 8, 16
  float slope[5];
  slope[0] = 1.0f;
  for (int k = 0; k < C; ++k) slope[0] = slope[0] * c_ext;
#pragma unroll
  for (int d = 1; d < 5; ++d) slope[d] = slope[d - 1] * slope[d - 1];

  // row -1: every state 0 (column 0's fm stands in lane 0: 1)
  float rm[REGS ? CR : 1], rx[REGS ? CR : 1], ry[REGS ? CR : 1];
  uint32_t yw[REGS ? (CR + 3) / 4 : 1];  // y's bytes of the stripe, packed
  float* mem = nullptr;                  // else layer l, column k at mem[(l * C + k) * 32]
  if constexpr (REGS) {
#pragma unroll
    for (int q = 0; q < (CR + 3) / 4; ++q) yw[q] = 0;
#pragma unroll
    for (int k = 0; k < CR; ++k) {
      rm[k] = rx[k] = ry[k] = 0.0f;
      if (k < live) yw[k / 4] |= static_cast<uint32_t>(ystripe[k]) << (8 * (k % 4));
    }
  } else {
    mem = scratch + static_cast<size_t>(b) * 3 * C * LANES + lane;
    for (int k = 0; k < C; ++k) {
      mem[k * LANES] = 0.0f;
      mem[(C + k) * LANES] = 0.0f;
      mem[(2 * C + k) * LANES] = 0.0f;
    }
  }

  float ls = 0.0f;
  float acc = 0.0f;
  float inv_prev = 1.0f;  // the stored row times this is the scaled row
  int x_next = xlen > 0 ? xrow[0] : 0;  // x_i, read a row ahead
  for (int i = 0; i < xlen; ++i) {
    const int xi = x_next;
    if (i + 1 < xlen) x_next = xrow[i + 1];
    // 1. the diagonal of the first column: column j0 of row i - 1
    float last_m, last_x, last_y;  // this lane's last column, row i - 1, scaled
    if constexpr (REGS) {
      last_m = rm[CR - 1] * inv_prev;
      last_x = rx[CR - 1] * inv_prev;
      last_y = ry[CR - 1] * inv_prev;
    } else {
      last_m = mem[(C - 1) * LANES] * inv_prev;
      last_x = mem[(2 * C - 1) * LANES] * inv_prev;
      last_y = mem[(3 * C - 1) * LANES] * inv_prev;
    }
    float dm = __shfl_up_sync(FULL, last_m, 1);
    float dx = __shfl_up_sync(FULL, last_x, 1);
    float dy = __shfl_up_sync(FULL, last_y, 1);
    if (lane == 0) {
      if (SEMI) {
        const float unit = expf(-ls);
        dm = i == 0 ? 2.0f * unit : unit;
      } else {
        dm = i == 0 ? 1.0f : 0.0f;  // column 0's fm (1, then 0 * inv)
      }
      dx = dy = 0.0f;
    }
    // 2.-3. fm', fx', A and the stripe's chain g (times 2^64) from a carry of 0
    float mx = 0.0f;
    float g = 0.0f;
    float fm_end = 0.0f, fx_end = 0.0f;  // column ylen's fm', fx' (lane t_end)
    if constexpr (REGS) {
#pragma unroll
      for (int k = 0; k < CR; ++k) {
        const float um = k == CR - 1 ? last_m : rm[k] * inv_prev;
        const float ux = k == CR - 1 ? last_x : rx[k] * inv_prev;
        const float uy = k == CR - 1 ? last_y : ry[k] * inv_prev;
        const float m_in = ng * dm + ngx * dx + ngy * dy;
        const int yk = (yw[k / 4] >> (8 * (k % 4))) & 0xFF;
        const float fmn = (yk == xi ? em_match : pmm) * m_in;
        const float fxn = pge * (gy * um + gye * ux);
        rm[k] = fmn;
        rx[k] = fxn;
        ry[k] = c_open * fmn;  // A
        g = c_open_up * fmn + c_ext * g;
        if (k < live) mx = fmaxf(mx, fmaxf(fmn, fxn));
        if (k == k_end) {
          fm_end = fmn;
          fx_end = fxn;
        }
        dm = um;
        dx = ux;
        dy = uy;
      }
    } else {
      for (int k = 0; k < C; ++k) {
        const float um = mem[k * LANES] * inv_prev;
        const float ux = mem[(C + k) * LANES] * inv_prev;
        const float uy = mem[(2 * C + k) * LANES] * inv_prev;
        const float m_in = ng * dm + ngx * dx + ngy * dy;
        const int yk = k < live ? __ldg(ystripe + k) : 0;
        const float fmn = (yk == xi ? em_match : pmm) * m_in;
        const float fxn = pge * (gy * um + gye * ux);
        mem[k * LANES] = fmn;
        mem[(C + k) * LANES] = fxn;
        mem[(2 * C + k) * LANES] = c_open * fmn;  // A
        g = c_open_up * fmn + c_ext * g;
        if (k < live) mx = fmaxf(mx, fmaxf(fmn, fxn));
        if (k == k_end) {
          fm_end = fmn;
          fx_end = fxn;
        }
        dm = um;
        dx = ux;
        dy = uy;
      }
    }
    // the scan of the lanes' maps x -> slope * x + g, x_0 = 0, on x * 2^64
    float carry = g;
    if (c_ext != 0.0f) {
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const float up = __shfl_up_sync(FULL, carry, 1 << s);
        if (lane >= (1 << s)) carry = carry + slope[s] * up;
      }
    }
    float fyn = __shfl_up_sync(FULL, carry, 1) * CARRY_DOWN;  // x_t
    if (lane == 0) fyn = 0.0f;
    // fy' of the stripe in sequence from x_t: fy'[j + 1] = A[j] + c_ext * fy'[j]
    float fy_end = 0.0f;
    if constexpr (REGS) {
#pragma unroll
      for (int k = 0; k < CR; ++k) {
        const float a = ry[k];
        ry[k] = fyn;
        if (k < live) mx = fmaxf(mx, fyn);
        if (k == k_end) fy_end = fyn;
        fyn = a + c_ext * fyn;
      }
    } else {
      for (int k = 0; k < C; ++k) {
        const float a = mem[(2 * C + k) * LANES];
        mem[(2 * C + k) * LANES] = fyn;
        if (k < live) mx = fmaxf(mx, fyn);
        if (k == k_end) fy_end = fyn;
        fyn = a + c_ext * fyn;
      }
    }
    // 4.-5. the row end, the scale
    const float row_p = fm_end + fx_end + fy_end;  // 0 at column 0
    const float scale = fmaxf(__int_as_float(__reduce_max_sync(FULL, __float_as_int(mx))), 1e-30f);
    const float inv = 1.0f / scale;
    if (SEMI) acc = (acc + row_p) * inv;
    ls = ls + logf(scale);
    inv_prev = inv;
  }

  if (lane != t_end) return;
  float p_lin;
  if (SEMI) {
    p_lin = acc;
  } else if (k_end < 0) {
    p_lin = xlen == 0 ? 1.0f : 0.0f;  // column 0: fm 1 on row -1, 0 after
  } else {
    float m, x, y;
    if constexpr (REGS) {
      m = x = y = 0.0f;
#pragma unroll
      for (int k = 0; k < CR; ++k) {
        if (k == k_end) {
          m = rm[k];
          x = rx[k];
          y = ry[k];
        }
      }
    } else {
      m = mem[k_end * LANES];
      x = mem[(C + k_end) * LANES];
      y = mem[(2 * C + k_end) * LANES];
    }
    p_lin = m * inv_prev + x * inv_prev + y * inv_prev;
  }
  out[b] = p_lin > 0.0f ? fminf(logf(fmaxf(p_lin, 1e-38f)) + ls, 0.0f) : -3.0e38f;
}

template <bool SEMI>
cudaError_t launch(const void* xs, const void* ys, const void* xlens, const void* ylens,
                   const void* par, const void* emit, int emit_stride, int B, int M, int N, int C,
                   int warps, void* out, void* scratch, cudaStream_t stream) {
  if (B < 1 || M < 0 || N < 0 || C < 1 || static_cast<long long>(C) * LANES < N || warps < 1 ||
      warps > MAX_WARPS)
    return cudaErrorInvalidValue;
  auto kernel = pairhmm_scaled_warp_kernel<SEMI, 0>;
  if (!scratch) {
    switch (C) {
      case 1: kernel = pairhmm_scaled_warp_kernel<SEMI, 1>; break;
      case 2: kernel = pairhmm_scaled_warp_kernel<SEMI, 2>; break;
      case 4: kernel = pairhmm_scaled_warp_kernel<SEMI, 4>; break;
      case 8: kernel = pairhmm_scaled_warp_kernel<SEMI, 8>; break;
      case 16: kernel = pairhmm_scaled_warp_kernel<SEMI, 16>; break;
      default: return cudaErrorInvalidValue;
    }
  }
  kernel<<<(B + warps - 1) / warps, warps * LANES, 0, stream>>>(
      static_cast<const uint8_t*>(xs), static_cast<const uint8_t*>(ys),
      static_cast<const int*>(xlens), static_cast<const int*>(ylens),
      static_cast<const float*>(par), static_cast<const float*>(emit), emit_stride, B, M, N, C,
      static_cast<float*>(out), static_cast<float*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// C and warps are ops/pairhmm.py pairhmm_scaled_geometry's, 32 * C >= N;
// scratch null keeps the state in registers (C a power of two up to 16),
// else a (B, 3, C, 32) float buffer holds it.
int pairhmm_fwd_scaled(const void* xs, const void* ys, const void* xlens, const void* ylens,
                       const void* par, const void* emit, int emit_stride, int B, int M,
                       int N, int semiglobal, int C, int warps, void* out, void* scratch,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      semiglobal ? launch<true>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N, C, warps,
                                out, scratch, s)
                 : launch<false>(xs, ys, xlens, ylens, par, emit, emit_stride, B, M, N, C, warps,
                                 out, scratch, s);
  return static_cast<int>(rc);
}

}  // extern "C"
