// K16-walk walk_banded: the lockstep traceback walk of the banded aligner.
// Replaces rust_bio_tpu/alignment/pairwise/banded_device.py _walk_banded (XLA
// device code, a lax.while_loop of M + N + 8 steps over the whole batch).
//
// Inputs: K16's tb (N, M + 1, B) uint16 (columns 1..N), read through its
// element strides (K16 returns the view of a pair-major tensor, a pair's
// column contiguous); tb0 (B, M + 1) int32,
// column 0's cells; tbfix (B, M + 1) int32, the suffix-fixed final column's
// 12-bit cells with Ly << 12, read in place of column nlens[b] (and its Ly
// on y-suffix clip steps); lx (B, N + 1) int32, each column's x-suffix clip
// length. Outputs: op_codes (T, B) uint8 and op_lens (T, B) uint16, end ->
// start, zeroed by the caller (a finished lane writes nothing more, as the
// while_loop leaves 0 there); xstart, ystart, xend, yend (B,).
//
// Design: one thread a pair, in order over its steps from (mlens, nlens) with
// the s-bits layer, as K15-walk (walk_steps.cu), plus what the banded host
// does around its DP: the s-bits of row 0 (j >= 1, not the fixed column) and
// of column 0 (i >= 1) are rewritten at read time as banded.py:595-620
// rewrites them after the DP; and a path that stops at TB_START away from the
// origin emits the out-of-band ending fixups (banded.rs:833-856) as up to two
// ops: Ins x i (or an x-prefix clip of i) back to row 0, then Del x j (or a
// y-prefix clip of j) back to column 0. An op's length is 1 for Match/Subst,
// the clip length for a clip, i or j for a fixup, 0 for Ins and Del, as the
// JAX walk packs it. Rows and columns read are clamped into the tensors.
// Bound on this card: one 2-byte cell a step; the chain of dependent reads
// makes it latency-bound.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB_START = 0;
constexpr int TB_INS = 1;
constexpr int TB_DEL = 2;
constexpr int TB_SUBST = 3;
constexpr int TB_MATCH = 4;
constexpr int TB_XCLIP_PREFIX = 5;
constexpr int TB_XCLIP_SUFFIX = 6;
constexpr int TB_YCLIP_PREFIX = 7;
constexpr int TB_YCLIP_SUFFIX = 8;
constexpr int THREADS = 32;

__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(THREADS) walk_banded_kernel(
    const uint16_t* __restrict__ tb,  // (N, M + 1, B) through the strides
    const int* __restrict__ tb0,      // (B, M + 1)
    const int* __restrict__ tbfix,    // (B, M + 1)
    const int* __restrict__ lx,       // (B, N + 1)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M,
    int N, int T, int go, int ge, int xcp, int xcs, int ycp, int ycs,
    long long sj, long long si, long long sb,
    uint8_t* __restrict__ op_codes,   // (T, B), zeroed
    uint16_t* __restrict__ op_lens,   // (T, B), zeroed
    int* __restrict__ xstart, int* __restrict__ ystart, int* __restrict__ xend,
    int* __restrict__ yend) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const size_t rows = static_cast<size_t>(M) + 1;
  const int ml = mlens[b];
  const int nl = nlens[b];
  const int* fix = tbfix + static_cast<size_t>(b) * rows;
  const int* col0 = tb0 + static_cast<size_t>(b) * rows;
  const int* lx_b = lx + static_cast<size_t>(b) * (N + 1);
  int i = ml, j = nl;
  int xs = 0, ys = 0, xe = ml, ye = nl;
  int carried = TB_START;
  bool use_s = true;  // the first step reads the s-bits at (m, n)
  bool phase1 = false;  // the x fixup is done, the y fixup may follow
  for (int t = 0; t < T; ++t) {
    const int ic = min(max(i, 0), M);
    const int jc = min(max(j, 0), N);
    const bool use_fix = j == nl;
    const int cf = fix[ic];
    int cell = use_fix ? cf : (jc == 0 ? col0[ic] : tb[(jc - 1) * sj + ic * si + b * sb]);
    cell &= 0xFFF;
    int sb = (cell >> 8) & 0xF;
    if (i == 0 && j >= 1 && !use_fix) sb = add(go, mul(ge, j - 1)) > ycp ? TB_DEL : TB_YCLIP_PREFIX;
    if (j == 0 && i >= 1) {
      const int c_i = add(go, mul(ge, i - 1));
      sb = c_i > xcp ? TB_INS : TB_XCLIP_PREFIX;
      if (i == ml && xcs > max(c_i, xcp)) sb = TB_XCLIP_SUFFIX;
    }
    const int layer = use_s ? sb : carried;
    const size_t at = static_cast<size_t>(t) * B + b;
    if (layer == TB_START) {
      if (!phase1 && i > 0) {  // Ins x i or an x-prefix clip, back to row 0
        const bool iw = add(go, mul(ge, i - 1)) > xcp;
        op_codes[at] = iw ? TB_INS : TB_XCLIP_PREFIX;
        op_lens[at] = static_cast<uint16_t>(i);
        xs = iw ? 0 : i;
        i = 0;
        phase1 = true;
        carried = TB_START;
        use_s = false;
        continue;
      }
      if (j > 0 && (phase1 || i == 0)) {  // Del x j or a y-prefix clip
        const bool dw = add(go, mul(ge, j - 1)) > ycp;
        op_codes[at] = dw ? TB_DEL : TB_YCLIP_PREFIX;
        op_lens[at] = static_cast<uint16_t>(j);
        ys = dw ? 0 : j;
        j = 0;
      }
      break;
    }
    int len = 0;
    int ni = i, nj = j;
    switch (layer) {
      case TB_INS:
        ni = i - 1;
        break;
      case TB_DEL:
        nj = j - 1;
        break;
      case TB_MATCH:
      case TB_SUBST:
        len = 1;
        ni = i - 1;
        nj = j - 1;
        break;
      case TB_XCLIP_PREFIX:
        len = i;
        xs = i;
        ni = 0;
        break;
      case TB_XCLIP_SUFFIX:
        len = lx_b[jc];
        ni = i - len;
        xe = ni;
        break;
      case TB_YCLIP_PREFIX:
        len = j;
        ys = j;
        nj = 0;
        break;
      case TB_YCLIP_SUFFIX:
        len = cf >> 12;
        nj = j - len;
        ye = nj;
        break;
      default:
        break;
    }
    op_codes[at] = static_cast<uint8_t>(layer);
    op_lens[at] = static_cast<uint16_t>(len);
    carried = layer == TB_INS ? cell & 0xF : (cell >> 4) & 0xF;
    use_s = layer != TB_INS && layer != TB_DEL;
    i = ni;
    j = nj;
  }
  xstart[b] = xs;
  ystart[b] = ys;
  xend[b] = xe;
  yend[b] = ye;
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K16-walk. op_codes / op_lens must be zeroed by the caller; sj, si, sb
// are tb's element strides (column, row, pair).
int walk_banded(const void* tb, const void* tb0, const void* tbfix, const void* lx,
                const void* mlens, const void* nlens, int B, int M, int N, int T, int go,
                int ge, int xcp, int xcs, int ycp, int ycs, long long sj, long long si,
                long long sb, void* op_codes, void* op_lens, void* xstart, void* ystart,
                void* xend, void* yend, void* stream) {
  walk_banded_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(tb0),
      static_cast<const int*>(tbfix), static_cast<const int*>(lx),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, N, T, go, ge, xcp,
      xcs, ycp, ycs, sj, si, sb, static_cast<uint8_t*>(op_codes), static_cast<uint16_t*>(op_lens),
      static_cast<int*>(xstart), static_cast<int*>(ystart), static_cast<int*>(xend),
      static_cast<int*>(yend));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
