// K15-walk walk_steps: the per-step traceback walk of the clip-mode engine,
// and K16-walk walk_banded, the banded aligner's (its section at the end).
// K15-walk replaces rust_bio_tpu/alignment/pairwise/batched.py _walk (XLA
// device code, the traceback of _align_batch_device) in its three-gather
// form: each step reads one cell tb[j, i, b], and lx[j, b] / Ly[b, i] where
// the step is an x- / y-suffix clip, and emits one op code and one clip
// length.
//
// Inputs: tb, the 12-bit cells i | d << 4 | s << 8 of K15 (csrc/sw_columns.cu)
// with column 0 at index 0 and the suffix-fixed column written at column
// nlens[b], read at tb[j * sj + i * si + b * sb] through element strides it
// is given: K15's pair-major (B, N + 1, Xp) tensor (sj = Xp, si = 1,
// sb = (N + 1) * Xp), or a contiguous (N + 1, M + 1, B) one (sj = (M + 1) * B,
// si = B, sb = 1), as the plain versions' are; ops/walk.py takes those two
// and raises on others. lx (N + 1, B) int32 with the fixed column's clip
// length; Ly (B, M + 1) int32, the y-suffix clip lengths of the last column.
// Outputs: op_codes (T, B) uint8 and op_lens (T, B) uint16, end -> start,
// which the caller zeroes (a finished lane writes nothing more, as JAX's
// early-exit while_loop leaves 0 there); xstart, ystart, xend, yend (B,).
//
// The walk: from (mlens, nlens) with the s-bits layer, at most T = M + N + 8
// steps. A step takes the layer from the cell's s-bits, or carries it from
// the previous cell's i-bits (after an Ins) or d-bits (after a Del); it
// moves by one row and/or column, or jumps a clip (Xclip-prefix to row 0,
// Xclip-suffix up lx rows, Yclip-prefix to column 0, Yclip-suffix left Ly
// columns), and stops at TB_START. The rows and columns a lane indexes are
// clamped into the tensor.
//
// Bound on this card: per pair it reads the cells of its path (about M + N
// of them plus its clip steps, 5.1 k a pair on phase 3e's STR pairs) and
// writes 3 bytes a step: 0.002 ms of bytes. What bounds it is the chain:
// each step's address comes from the step before. The one-thread-a-pair
// kernel before this one made one dependent device-memory load a step,
// 3.8-4.1 ms on phase 3e's 128 STR pairs; a warp stepping once a round
// through tiles in shared memory took 0.98-1.23 (200-240 ns a step,
// PERF.md).
//
// Design: csrc/walk_global_seg.cu's tiles, one warp a pair, WARPS pairs a
// block, so that 128 pairs spread over 64 SMs. The warp fetches a tile of
// the path's neighbourhood into its slice of shared memory at once: the
// columns jt - 31..jt (one a lane) by the TILE_ROWS rows that end at the
// 8-row group holding the path's row (from row 0 at the top of a column);
// on the pair-major layout a lane copies its column's rows with
// TILE_ROWS / 8 aligned 16-byte asynchronous copies (cp.async), all in
// flight together. The control flow is warp-uniform: each round reads the
// path's cell (a broadcast) and its layer. A Match/Subst, Ins or Del layer
// starts a run of such steps: step t + l lies l rows and/or columns on
// along the one direction, and its layer is the s-bits of its own cell
// (Match/Subst) or the i-bits (Ins) / d-bits (Del) of step t + l - 1's, so
// lane l reads step t + l's cell from the tile, a ballot ends the run at
// the first step of another kind or outside the tile, and each lane stores
// its step's op code; the round takes up to 32 steps. A clip, a layer that
// does not move, and a cell the walk clamps take one step a round. A read
// outside the tile makes the warp take the second buffer where it
// holds the cell, else fetch the tile anew. The second buffer is on its way
// while the warp walks: the tile above the current one when the path left
// the last tile through its top (an Ins run up a column), else the 32
// columns to the left, ending AHEAD rows above the row the tile was
// fetched for (a path near the diagonal); a clip jump sends for the tile it
// lands in as soon as the step reads its layer (the prefix clips' lengths
// are the path's row or column; the suffix clips' lengths of the first
// step, lx[nlens] and Ly[mlens], are loaded with the first tile). A layout
// whose rows are not of stride 1, or whose columns or pairs are not 16-byte
// aligned (the contiguous one), fills the tile one cell at a time and
// fetches nothing ahead.
//
// K16-walk replaces rust_bio_tpu/alignment/pairwise/banded_device.py
// _walk_banded (XLA device code, a lax.while_loop of M + N + 8 steps over
// the whole batch). Inputs: K16's tb (N, M + 1, B) uint16, columns 1..N,
// through its element strides (K16's pair-major view, or a contiguous
// tensor); tb0 (B, M + 1) int32, column 0's cells; tbfix (B, M + 1) int32,
// the suffix-fixed column's 12-bit cells with Ly << 12, read in place of
// column nlens[b] (and its Ly on y-suffix clip steps); lx (B, N + 1) int32,
// each column's x-suffix clip length. Outputs as K15-walk's; an op's length
// is 1 for Match/Subst, the clip length for a clip, i or j for a fixup, 0
// for Ins and Del, as the JAX walk packs it. It is K15-walk's walk and
// tiles with three things more. A tile lane whose column is 0 or nlens
// fills it from tb0 or tbfix, a cell a load (BandedColumns). Each step,
// and each lane of a run, rewrites the s-bits it reads on row 0 and column
// 0 as banded.py:595-620 rewrites them after the DP (Rewrite), so that a
// Match run ends where the rewrite sends it elsewhere. A path that stops at
// TB_START away from the origin emits the out-of-band ending fixups
// (banded.rs:833-856): Ins x i (or an x-prefix clip of i) back to row 0,
// then Del x j (or a y-prefix clip of j) back to column 0, a step each.
// Cells outside the band are 0 (TB_START) in the tb, so a path that reads
// one stops there. Rows and columns outside the tensors are clamped, and
// such a cell is read from device memory as the plain version reads it.
// Bound on this card: as K15-walk, a 2-byte cell a step (about 1.2 k steps
// a pair on phase 3f's 1 kb reads, 5.6 k on its STR pairs) and 3 bytes of
// output a step; the chain of steps bounds it, one dependent
// device-memory load a step in the one-thread-a-pair kernel before this
// one (1.04-1.10 ms on the 1 kb reads).

#include <cstddef>
#include <cstdint>

#include <cuda_pipeline_primitives.h>
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
constexpr int LANES = 32;             // tile columns: one a lane; steps a round at most
constexpr int WARPS = 2;              // pairs a block
constexpr int TILE_ROWS = 96;         // rows of a tile column, a multiple of 8
constexpr int PITCH = TILE_ROWS + 8;  // uint16 between tile columns: 208 bytes, so a quarter
                                      // warp's 16-byte shared stores fall in different banks
constexpr int AHEAD = 16;             // the tile to the left ends this many rows above
                                      // the current one's row
constexpr unsigned FULL = 0xffffffffu;

// One pair's tb, through its strides.
struct Tb {
  const uint16_t* base;  // the pair's cell (0, 0) (K16-walk: where it would lie)
  long long sj, si;
  int X;                 // rows, M + 1
  bool vec;              // rows of stride 1, columns 16-byte aligned: 8 rows a copy
  __device__ const uint16_t* column(int j) const { return base + j * sj; }
};

// A tile: the cell (i, j) at s[(jt - j) * PITCH + i - r0] for
// jt - LANES < j <= jt and r0 <= i < r0 + TILE_ROWS.
struct Tile {
  uint16_t* s;
  int jt, r0;
  __device__ bool holds(int i, int j) const {
    return j <= jt && j > jt - LANES && i >= r0 && i < r0 + TILE_ROWS;
  }
  __device__ int at(int i, int j) const { return s[(jt - j) * PITCH + (i - r0)]; }
};

// The warp's tiles: the one it reads, and the one on its way.
struct Tiles {
  Tile cur, next;
  bool pending;  // next's copies are in flight
};

// K15-walk's columns: every one from the tb.
struct TbColumns {
  __device__ bool own(int) const { return false; }
  __device__ void fill(uint16_t*, int, int, int) const {}
};

// K16-walk's columns that K16's tb does not hold: column nlens, the
// suffix-fixed column (tbfix's 12 bits; it takes the place of the tb's
// column there), and column 0 (tb0); a cell a load.
struct BandedColumns {
  const int* fix;   // the pair's tbfix, (M + 1)
  const int* col0;  // the pair's tb0, (M + 1)
  int nl;
  __device__ bool own(int j) const { return j == nl || j == 0; }
  // rows r0..r1 - 1 of column j (one of its own) into dst
  __device__ void fill(uint16_t* dst, int j, int r0, int r1) const {
    const int* src = j == nl ? fix : col0;
    for (int r = r0; r < r1; ++r) dst[r - r0] = static_cast<uint16_t>(__ldg(src + r) & 0xFFF);
  }
};

// Load into tl the tile of columns j - 31..j whose bottom 8-row group holds
// row i (rows from 0 at a column's top), 0 <= i < X, 0 <= j: with 16-byte
// cp.async copies committed as one group and not waited for (tb.vec), else
// a cell at a time; the columns cols owns from its own arrays.
template <class Cols>
__device__ void load_tile(Tile& tl, const Tb& tb, const Cols& cols, int i, int j) {
  const int lane = threadIdx.x % LANES;
  tl.jt = j;
  tl.r0 = max((i + 8) / 8 * 8 - TILE_ROWS, 0);
  const int jc = j - lane;
  if (jc >= 0) {
    uint16_t* dst = tl.s + lane * PITCH;
    if (cols.own(jc)) {
      cols.fill(dst, jc, tl.r0, min(tl.r0 + TILE_ROWS, tb.X));
    } else {
      const uint16_t* col = tb.column(jc);
      if (tb.vec) {
#pragma unroll
        for (int g = 0; g < TILE_ROWS / 8; ++g) {
          const int r = tl.r0 + 8 * g;
          if (r < tb.X) __pipeline_memcpy_async(dst + 8 * g, col + r, 16);
        }
      } else {
        for (int r = tl.r0; r < min(tl.r0 + TILE_ROWS, tb.X); ++r) dst[r - tl.r0] = __ldg(col + r * tb.si);
      }
    }
  }
  if (tb.vec) __pipeline_commit();
}

// Send for the tile that holds cell (i, j) into the second buffer, unless
// it is on its way there (tb.vec; nothing outside the tensor).
template <class Cols>
__device__ void prefetch(Tiles& t, const Tb& tb, const Cols& cols, int i, int j) {
  if (!tb.vec || i < 0 || j < 0) return;
  if (t.pending) {
    if (t.next.holds(i, j)) return;
    __pipeline_wait_prior(0);  // the copies in flight land before the buffer is reused
  }
  load_tile(t.next, tb, cols, i, j);
  t.pending = true;
}

// Make the current tile hold cell (i, j), 0 <= i < X, 0 <= j. Warp-uniform.
template <class Cols>
__device__ void fill(Tiles& t, const Tb& tb, const Cols& cols, int i, int j) {
  // the path left the current tile through its top row: an Ins run
  const bool up = t.cur.jt >= 0 && j > t.cur.jt - LANES;
  __syncwarp();  // every lane is done with the current tile
  bool swapped = false;
  if (t.pending) {
    __pipeline_wait_prior(0);
    __syncwarp();
    t.pending = false;
    if (t.next.holds(i, j)) {
      const Tile held = t.cur;
      t.cur = t.next;
      t.next = held;
      swapped = true;
    }
  }
  if (!swapped) {
    load_tile(t.cur, tb, cols, i, j);
    if (tb.vec) __pipeline_wait_prior(0);
    __syncwarp();
  }
  if (up) {
    prefetch(t, tb, cols, t.cur.r0 - 1, t.cur.jt);
  } else {
    prefetch(t, tb, cols, max(i - AHEAD, 0), t.cur.jt - LANES);
  }
}

__global__ void __launch_bounds__(WARPS * LANES) walk_steps_kernel(
    const uint16_t* __restrict__ tb,  // through the strides
    const int* __restrict__ lx,       // (N + 1, B)
    const int* __restrict__ ly,       // (B, M + 1)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M,
    int N, int T, long long sj, long long si, long long sb, int vec,
    uint8_t* __restrict__ op_codes,   // (T, B), zeroed
    uint16_t* __restrict__ op_lens,   // (T, B), zeroed
    int* __restrict__ xstart, int* __restrict__ ystart, int* __restrict__ xend,
    int* __restrict__ yend) {
  __shared__ __align__(16) uint16_t tiles[WARPS][2][LANES * PITCH];
  const int lane = threadIdx.x % LANES;
  const int w = threadIdx.x / LANES;
  const int b = blockIdx.x * WARPS + w;
  if (b >= B) return;  // the whole warp
  const size_t rows = static_cast<size_t>(M) + 1;
  const Tb tbs{tb + b * sb, sj, si, M + 1, vec != 0};
  Tiles tl{{tiles[w][0], -1, 0}, {tiles[w][1], -1, 0}, false};  // jt = -1: empty
  int i = mlens[b];
  int j = nlens[b];
  // the clip lengths a suffix clip at (mlens, nlens) takes, loaded beside
  // the first tile
  const int lx0 = lx[static_cast<size_t>(j) * B + b];
  const int ly0 = ly[static_cast<size_t>(b) * rows + i];
  int xs = 0, ys = 0, xe = i, ye = j;
  int carried = TB_START;
  bool use_s = true;  // the first step reads the s-bits at (m, n)
  int t = 0;
  while (t < T) {
    const int ic = min(max(i, 0), M);
    const int jc = min(max(j, 0), N);
    if (!tl.cur.holds(ic, jc)) fill(tl, tbs, TbColumns{}, ic, jc);
    const int cell = tl.cur.at(ic, jc);
    const int layer = use_s ? (cell >> 8) & 0xF : carried;
    if (layer == TB_START) break;
    const bool mm = layer == TB_MATCH || layer == TB_SUBST;
    if ((mm || layer == TB_INS || layer == TB_DEL) && i == ic && j == jc) {
      // a run of steps of this layer's kind: step t + l is at row
      // i - l * di, column j - l * dj, and its layer is the s-bits of its
      // own cell (Match/Subst) or the i-bits (Ins) / d-bits (Del) of step
      // t + l - 1's cell; lane l reads step t + l's cell from the tile
      const int di = layer != TB_DEL;
      const int dj = layer != TB_INS;
      const int li = i - lane * di;
      const int lj = j - lane * dj;
      const bool valid = li >= 0 && lj >= 0 && tl.cur.holds(li, lj);
      const int c = valid ? tl.cur.at(li, lj) : 0;
      const int prev = __shfl_up_sync(FULL, c, 1);
      int my = mm ? (c >> 8) & 0xF : (layer == TB_INS ? prev & 0xF : (prev >> 4) & 0xF);
      if (lane == 0) my = layer;
      const bool same = mm ? my == TB_MATCH || my == TB_SUBST : my == layer;
      // the run ends at the first step of another kind, or at the first
      // cell outside the tile (every step of the run has its cell read)
      const unsigned out = __ballot_sync(FULL, !valid);
      const unsigned other = __ballot_sync(FULL, lane > 0 && !same);
      int k = min(out ? __ffs(out) - 1 : LANES, other ? __ffs(other) - 1 : LANES);
      k = min(k, T - t);
      if (lane < k) op_codes[static_cast<size_t>(t + lane) * B + b] = static_cast<uint8_t>(my);
      const int last = __shfl_sync(FULL, c, k - 1);  // the run's last cell
      i -= k * di;
      j -= k * dj;
      carried = layer == TB_INS ? last & 0xF : (last >> 4) & 0xF;
      use_s = mm;
      t += k;
      continue;
    }
    // one step: a clip jump, a layer of no move, or a clamped cell
    int len = 0;
    int ni = i - (layer == TB_INS || mm);
    int nj = j - (layer == TB_DEL || mm);
    if (layer >= TB_XCLIP_PREFIX && layer <= TB_YCLIP_SUFFIX) {
      switch (layer) {
        case TB_XCLIP_PREFIX:
          len = i;
          xs = i;
          ni = 0;
          break;
        case TB_XCLIP_SUFFIX:
          len = t == 0 ? lx0 : lx[static_cast<size_t>(jc) * B + b];
          ni = i - len;
          xe = ni;
          break;
        case TB_YCLIP_PREFIX:
          len = j;
          ys = j;
          nj = 0;
          break;
        default:  // TB_YCLIP_SUFFIX
          len = t == 0 ? ly0 : ly[static_cast<size_t>(b) * rows + ic];
          nj = j - len;
          ye = nj;
          break;
      }
      const int nic = min(max(ni, 0), M);
      const int njc = min(max(nj, 0), N);
      if (!tl.cur.holds(nic, njc)) prefetch(tl, tbs, TbColumns{}, nic, njc);
    }
    if (lane == 0) {
      op_codes[static_cast<size_t>(t) * B + b] = static_cast<uint8_t>(layer);
      op_lens[static_cast<size_t>(t) * B + b] = static_cast<uint16_t>(len);
    }
    carried = layer == TB_INS ? cell & 0xF : (cell >> 4) & 0xF;
    use_s = layer != TB_INS && layer != TB_DEL;
    i = ni;
    j = nj;
    ++t;
  }
  if (lane == 0) {
    xstart[b] = xs;
    ystart[b] = ys;
    xend[b] = xe;
    yend[b] = ye;
  }
  __pipeline_wait_prior(0);  // no copy outlives the warp
}

// int32 add / multiply that wrap like XLA's (signed overflow is UB in C++)
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// The banded host's rewrites of row 0 and column 0 (banded.py:595-620,
// after its DP), made where a step reads a cell's s-bits: row 0 (j >= 1,
// not the fixed column) a Del or a y-prefix clip, column 0 (i >= 1) an Ins
// or an x-prefix clip, row mlens of column 0 an x-suffix clip where that
// beats both.
struct Rewrite {
  int go, ge, xcp, xcs, ycp, ml, nl;
  __device__ int sbits(int cell, int i, int j) const {
    int sb = (cell >> 8) & 0xF;
    if (i == 0 && j >= 1 && j != nl) sb = add(go, mul(ge, j - 1)) > ycp ? TB_DEL : TB_YCLIP_PREFIX;
    if (j == 0 && i >= 1) {
      const int c_i = add(go, mul(ge, i - 1));
      sb = c_i > xcp ? TB_INS : TB_XCLIP_PREFIX;
      if (i == ml && xcs > max(c_i, xcp)) sb = TB_XCLIP_SUFFIX;
    }
    return sb;
  }
};

// K16-walk: K15-walk's tile walk over K16's tb, its columns 1..N; column 0
// from tb0 and column nlens from tbfix (BandedColumns), the s-bits
// rewritten as they are read (Rewrite), and the ending fixups.
__global__ void __launch_bounds__(WARPS * LANES) walk_banded_kernel(
    const uint16_t* __restrict__ tb,  // (N, M + 1, B) through the strides: columns 1..N
    const int* __restrict__ tb0,      // (B, M + 1)
    const int* __restrict__ tbfix,    // (B, M + 1): 12-bit cells | Ly << 12
    const int* __restrict__ lx,       // (B, N + 1)
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int M,
    int N, int T, int go, int ge, int xcp, int xcs, int ycp, long long sj, long long si,
    long long sb, int vec,
    uint8_t* __restrict__ op_codes,   // (T, B), zeroed
    uint16_t* __restrict__ op_lens,   // (T, B), zeroed
    int* __restrict__ xstart, int* __restrict__ ystart, int* __restrict__ xend,
    int* __restrict__ yend) {
  __shared__ __align__(16) uint16_t tiles[WARPS][2][LANES * PITCH];
  const int lane = threadIdx.x % LANES;
  const int w = threadIdx.x / LANES;
  const int b = blockIdx.x * WARPS + w;
  if (b >= B) return;  // the whole warp
  const size_t rows = static_cast<size_t>(M) + 1;
  const int ml = mlens[b];
  const int nl = nlens[b];
  const int* fix = tbfix + static_cast<size_t>(b) * rows;
  const int* col0 = tb0 + static_cast<size_t>(b) * rows;
  const int* lx_b = lx + static_cast<size_t>(b) * (N + 1);
  const uint16_t* tb_b = tb + b * sb;
  // DP column j >= 1 is the tb's column j - 1
  const Tb tbs{tb_b - sj, sj, si, M + 1, vec != 0};
  const BandedColumns cols{fix, col0, nl};
  const Rewrite rw{go, ge, xcp, xcs, ycp, ml, nl};
  Tiles tl{{tiles[w][0], -1, 0}, {tiles[w][1], -1, 0}, false};  // jt = -1: empty
  int i = ml;
  int j = nl;
  int xs = 0, ys = 0, xe = i, ye = j;
  int carried = TB_START;
  bool use_s = true;  // the first step reads the s-bits at (m, n)
  int t = 0;
  while (t < T) {
    const int ic = min(max(i, 0), M);
    const int jc = min(max(j, 0), N);
    const bool inside = i == ic && j == jc;
    int cell;
    if (inside) {
      if (!tl.cur.holds(i, j)) fill(tl, tbs, cols, i, j);
      cell = tl.cur.at(i, j);
    } else {  // a clamped cell, from the array the plain version reads it from
      cell = j == nl ? fix[ic] : (jc == 0 ? col0[ic] : tb_b[(jc - 1) * sj + ic * si]);
    }
    const int layer = use_s ? rw.sbits(cell, i, j) : carried;
    if (layer == TB_START) {
      // a path that stops away from the origin (banded.rs:833-856): Ins x i
      // or an x-prefix clip of i back to row 0, then Del x j or a y-prefix
      // clip of j back to column 0, a step each
      int f = t;
      if (i > 0) {
        const bool iw = add(go, mul(ge, i - 1)) > xcp;
        if (lane == 0) {
          op_codes[static_cast<size_t>(f) * B + b] = iw ? TB_INS : TB_XCLIP_PREFIX;
          op_lens[static_cast<size_t>(f) * B + b] = static_cast<uint16_t>(i);
        }
        xs = iw ? 0 : i;
        ++f;
      }
      if (i >= 0 && j > 0 && f < T) {
        const bool dw = add(go, mul(ge, j - 1)) > ycp;
        if (lane == 0) {
          op_codes[static_cast<size_t>(f) * B + b] = dw ? TB_DEL : TB_YCLIP_PREFIX;
          op_lens[static_cast<size_t>(f) * B + b] = static_cast<uint16_t>(j);
        }
        ys = dw ? 0 : j;
      }
      break;
    }
    const bool mm = layer == TB_MATCH || layer == TB_SUBST;
    if ((mm || layer == TB_INS || layer == TB_DEL) && inside) {
      // a run, as K15-walk's; a Match/Subst step's layer is its cell's
      // s-bits rewritten, its length 1
      const int di = layer != TB_DEL;
      const int dj = layer != TB_INS;
      const int li = i - lane * di;
      const int lj = j - lane * dj;
      const bool valid = li >= 0 && lj >= 0 && tl.cur.holds(li, lj);
      const int c = valid ? tl.cur.at(li, lj) : 0;
      const int prev = __shfl_up_sync(FULL, c, 1);
      int my = mm ? rw.sbits(c, li, lj) : (layer == TB_INS ? prev & 0xF : (prev >> 4) & 0xF);
      if (lane == 0) my = layer;
      const bool same = mm ? my == TB_MATCH || my == TB_SUBST : my == layer;
      const unsigned out = __ballot_sync(FULL, !valid);
      const unsigned other = __ballot_sync(FULL, lane > 0 && !same);
      int k = min(out ? __ffs(out) - 1 : LANES, other ? __ffs(other) - 1 : LANES);
      k = min(k, T - t);
      if (lane < k) {
        op_codes[static_cast<size_t>(t + lane) * B + b] = static_cast<uint8_t>(my);
        if (mm) op_lens[static_cast<size_t>(t + lane) * B + b] = 1;
      }
      const int last = __shfl_sync(FULL, c, k - 1);  // the run's last cell
      i -= k * di;
      j -= k * dj;
      carried = layer == TB_INS ? last & 0xF : (last >> 4) & 0xF;
      use_s = mm;
      t += k;
      continue;
    }
    // one step: a clip jump, a layer of no move, or a clamped cell
    int len = mm;
    int ni = i - (layer == TB_INS || mm);
    int nj = j - (layer == TB_DEL || mm);
    if (layer >= TB_XCLIP_PREFIX && layer <= TB_YCLIP_SUFFIX) {
      switch (layer) {
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
        default:  // TB_YCLIP_SUFFIX: Ly from the fixed column's cell
          len = fix[ic] >> 12;
          nj = j - len;
          ye = nj;
          break;
      }
      const int nic = min(max(ni, 0), M);
      const int njc = min(max(nj, 0), N);
      if (!tl.cur.holds(nic, njc)) prefetch(tl, tbs, cols, nic, njc);
    }
    if (lane == 0) {
      op_codes[static_cast<size_t>(t) * B + b] = static_cast<uint8_t>(layer);
      op_lens[static_cast<size_t>(t) * B + b] = static_cast<uint16_t>(len);
    }
    carried = layer == TB_INS ? cell & 0xF : (cell >> 4) & 0xF;
    use_s = layer != TB_INS && layer != TB_DEL;
    i = ni;
    j = nj;
    ++t;
  }
  if (lane == 0) {
    xstart[b] = xs;
    ystart[b] = ys;
    xend[b] = xe;
    yend[b] = ye;
  }
  __pipeline_wait_prior(0);  // no copy outlives the warp
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K15-walk. op_codes / op_lens must be zeroed by the caller. tb's element
// strides: sj between columns, si between rows, sb between pairs; vec
// nonzero when si is 1, sj and sb (or B = 1) are multiples of 8, tb is
// 16-byte aligned and its storage holds each column's rows up to M + 1
// rounded up to 8 (ops/walk.py _vector_rows checks it).
int walk_steps(const void* tb, const void* lx, const void* ly, const void* mlens,
               const void* nlens, int B, int M, int N, int T, long long sj, long long si,
               long long sb, int vec, void* op_codes, void* op_lens, void* xstart,
               void* ystart, void* xend, void* yend, void* stream) {
  if (vec && (si != 1 || sj % 8 || (B > 1 && sb % 8) || reinterpret_cast<uintptr_t>(tb) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  walk_steps_kernel<<<(B + WARPS - 1) / WARPS, WARPS * LANES, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(lx),
      static_cast<const int*>(ly), static_cast<const int*>(mlens),
      static_cast<const int*>(nlens), B, M, N, T, sj, si, sb, vec,
      static_cast<uint8_t*>(op_codes), static_cast<uint16_t*>(op_lens),
      static_cast<int*>(xstart), static_cast<int*>(ystart), static_cast<int*>(xend),
      static_cast<int*>(yend));
  return static_cast<int>(cudaGetLastError());
}

// K16-walk. op_codes / op_lens must be zeroed by the caller; sj, si, sb
// are tb's element strides (column, row, pair), vec as K15-walk's. The
// penalties are the first five of (go, ge, xcp, xcs, ycp, ycs): a y-suffix
// clip takes its length from tbfix.
int walk_banded(const void* tb, const void* tb0, const void* tbfix, const void* lx,
                const void* mlens, const void* nlens, int B, int M, int N, int T, int go,
                int ge, int xcp, int xcs, int ycp, long long sj, long long si, long long sb,
                int vec, void* op_codes, void* op_lens, void* xstart, void* ystart, void* xend,
                void* yend, void* stream) {
  if (vec && (si != 1 || sj % 8 || (B > 1 && sb % 8) || reinterpret_cast<uintptr_t>(tb) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  walk_banded_kernel<<<(B + WARPS - 1) / WARPS, WARPS * LANES, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(tb0),
      static_cast<const int*>(tbfix), static_cast<const int*>(lx),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, M, N, T, go, ge, xcp,
      xcs, ycp, sj, si, sb, vec, static_cast<uint8_t*>(op_codes), static_cast<uint16_t*>(op_lens),
      static_cast<int*>(xstart), static_cast<int*>(ystart), static_cast<int*>(xend),
      static_cast<int*>(yend));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
