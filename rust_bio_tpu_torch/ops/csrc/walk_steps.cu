// K15-walk walk_steps: the per-step traceback walk of the clip-mode engine.
// Replaces rust_bio_tpu/alignment/pairwise/batched.py _walk (XLA device code,
// the traceback of _align_batch_device) in its three-gather form: each step
// reads one cell tb[j, i, b], and lx[j, b] / Ly[b, i] where the step is an
// x- / y-suffix clip, and emits one op code and one clip length.
//
// Inputs: tb (N + 1, M + 1, B) uint16, the 12-bit cells i | d << 4 | s << 8
// of K15 with column 0 at index 0 and the suffix-fixed column written at
// column nlens[b]; lx (N + 1, B) int32 with the fixed column's clip length;
// Ly (B, M + 1) int32, the y-suffix clip lengths of the last column.
// Outputs: op_codes (T, B) uint8 and op_lens (T, B) uint16, end -> start,
// which the caller zeroes (a finished lane writes nothing more, as JAX's
// early-exit while_loop leaves 0 there); xstart, ystart, xend, yend (B,).
//
// Design: one thread a pair, in order over its T = M + N + 8 steps, from
// (mlens, nlens) with the s-bits layer. A step takes the layer from the
// cell's s-bits, or carries it from the previous cell's i-bits (after an
// Ins) or d-bits (after a Del); it moves by one row and/or column, or jumps
// a clip (Xclip-prefix to row 0, Xclip-suffix up lx rows, Yclip-prefix to
// column 0, Yclip-suffix left Ly columns), and stops at TB_START. The rows and
// columns a lane indexes are clamped into the tensor. Bound on this card: one
// 2-byte cell read a step; the chain of dependent gathers makes it
// latency-bound (about one DRAM round trip a step).

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

__global__ void __launch_bounds__(THREADS) walk_steps_kernel(
    const uint16_t* __restrict__ tb,  // (N + 1, M + 1, B)
    const int* __restrict__ lx,       // (N + 1, B)
    const int* __restrict__ ly,       // (B, M + 1)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M,
    int N, int T,
    uint8_t* __restrict__ op_codes,   // (T, B), zeroed
    uint16_t* __restrict__ op_lens,   // (T, B), zeroed
    int* __restrict__ xstart, int* __restrict__ ystart, int* __restrict__ xend,
    int* __restrict__ yend) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const size_t rows = static_cast<size_t>(M) + 1;
  int i = mlens[b];
  int j = nlens[b];
  int xs = 0, ys = 0, xe = i, ye = j;
  int carried = TB_START;
  bool use_s = true;  // the first step reads the s-bits at (m, n)
  for (int t = 0; t < T; ++t) {
    const int ic = min(max(i, 0), M);
    const int jc = min(max(j, 0), N);
    const int cell = tb[(static_cast<size_t>(jc) * rows + ic) * B + b];
    const int layer = use_s ? (cell >> 8) & 0xF : carried;
    if (layer == TB_START) break;
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
        ni = i - 1;
        nj = j - 1;
        break;
      case TB_XCLIP_PREFIX:
        len = i;
        xs = i;
        ni = 0;
        break;
      case TB_XCLIP_SUFFIX:
        len = lx[static_cast<size_t>(jc) * B + b];
        ni = i - len;
        xe = ni;
        break;
      case TB_YCLIP_PREFIX:
        len = j;
        ys = j;
        nj = 0;
        break;
      case TB_YCLIP_SUFFIX:
        len = ly[static_cast<size_t>(b) * rows + ic];
        nj = j - len;
        ye = nj;
        break;
      default:
        break;
    }
    op_codes[static_cast<size_t>(t) * B + b] = static_cast<uint8_t>(layer);
    op_lens[static_cast<size_t>(t) * B + b] = static_cast<uint16_t>(len);
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

// K15-walk. op_codes / op_lens must be zeroed by the caller.
int walk_steps(const void* tb, const void* lx, const void* ly, const void* mlens,
               const void* nlens, int B, int M, int N, int T, void* op_codes,
               void* op_lens, void* xstart, void* ystart, void* xend, void* yend,
               void* stream) {
  walk_steps_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(lx),
      static_cast<const int*>(ly), static_cast<const int*>(mlens),
      static_cast<const int*>(nlens), B, M, N, T, static_cast<uint8_t*>(op_codes),
      static_cast<uint16_t*>(op_lens), static_cast<int*>(xstart),
      static_cast<int*>(ystart), static_cast<int*>(xend), static_cast<int*>(yend));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
