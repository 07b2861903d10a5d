// K14 sweep_walk_global_seg: the global-mode traceback walk over the
// traceback tensor of K13 (csrc/sw_global_rows.cu). Replaces
// rust_bio_tpu/ops/walk_pallas.py _sweep_walk_global_seg ->
// _make_seg_walk_kernel.
//
// Layouts: it reads the cell of DP cell (i, j) of pair b at
// tb[(j - 1) * sj + i * si + b * sb], element strides it is given: K13's
// pair-major (B, N, Xp) tensor (sj = Xp, si = 1, sb = N * Xp), or a
// contiguous (N, X, B) one (sj = X * B, si = B, sb = 1), as K1's and the
// plain versions' are; ops/walk.py takes those two and raises on others.
//
// Output is K2's (csrc/walk_sweep.cu): per DP column j and pair,
// ins_cnt[j-1] Ins ops then one exit op exit_op[j-1] (TB_MATCH / TB_SUBST /
// TB_DEL, 0 where the pair never is), walking end -> start, and ins0, the
// Ins run left in column 0. Every (j, b) is written.
//
// K13's cells carry no run nibble, and at the first row of each row block
// an i-layer pointer may read TB_REREAD: "the s-bits of the cell above".
// The TPU kernel resolves both over whole column segments (a cummax of the
// rows that break an Ins chain, two passes a column). The walk itself is
// K2's state machine: at the path's column j, from row icur, an Ins run up
// the column (each i-layer from the cell itself or, where it reads
// TB_REREAD, from the cell above), then the exit read at the row that
// breaks the chain, with the d-bits of the cell above it.
//
// Bound on this card: per pair it reads the cells of its path (about
// M + N of them, 11 k on phase 3d's STR pairs) and writes 2 * N uint16:
// 0.0012 ms of bytes. What bounds it is the chain: each step's address
// comes from the step before. The one-thread-a-pair kernel before this one
// made one dependent device-memory load a step (a column, or a row up an
// Ins run): 11 k round trips of about 0.37 us, 4.1 ms, 64 pairs a block on
// 2 SMs.
//
// Design: one warp a pair, WARPS pairs a block, so that 128 pairs spread
// over 64 SMs. The warp fetches a tile of the path's neighbourhood into its
// slice of shared memory at once: the DP columns jt - 31..jt (one lane a
// column) by the TILE_ROWS rows that end at the 8-row group holding the
// path's row, 6.5 KB; on the pair-major layout a lane copies its column's
// rows with TILE_ROWS / 8 aligned 16-byte asynchronous copies (cp.async),
// all in flight together, so one round trip serves up to 32 columns of
// path. Every lane then runs the same state machine on the same values
// (the control flow is warp-uniform, the shared reads broadcasts); a read
// outside the tile makes the warp fetch the tile whose bottom-right cell
// it is (the path only moves up and left). While the warp walks a tile,
// the next one is on its way into a second buffer: the 32 columns to the
// left, ending AHEAD rows above the row the tile was fetched for (the
// path's arrival there if it runs near the diagonal, with room for AHEAD
// more deletions than insertions); a read outside the tile takes that
// buffer where it holds the cell, else fetches anew. An Ins run that
// leaves the tile through its top row is followed by the warp down the
// column's memory instead: each lane tests 8 rows (one 16-byte load and
// the cell above them), and a ballot gives the first row that breaks the
// chain, 256 rows a round trip (the insertion pairs' runs are 4.2-4.8 k
// rows). The lanes keep the outputs of 32 columns, one each, and store
// them together. A layout whose rows are not of stride 1, or whose
// columns or pairs are not 16-byte aligned (the contiguous (N, X, B) one),
// fills the tile one cell at a time and fetches nothing ahead.

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
constexpr int TB_REREAD = 9;
constexpr int LANES = 32;          // tile columns: one a lane
constexpr int WARPS = 2;           // pairs a block
constexpr int TILE_ROWS = 96;      // rows of a tile column, a multiple of 8
constexpr int PITCH = TILE_ROWS + 8;  // uint16 between tile columns: 208 bytes, so a quarter
                                      // warp's 16-byte shared stores fall in different banks
constexpr int AHEAD = 16;          // the next tile ends this many rows above the current one's row
constexpr unsigned FULL = 0xffffffffu;

// One pair's tb, through its strides.
struct Tb {
  const uint16_t* base;  // the pair's cell (0, 1)
  long long sj, si;
  int X;                 // rows: cells of row X and below are outside (-1)
  bool vec;              // rows of stride 1, columns 16-byte aligned: 8 rows a load
  __device__ const uint16_t* column(int j) const { return base + (j - 1) * sj; }
};

// A tile: the cell (i, j) at s[(jt - j) * PITCH + i - r0] for
// jt - LANES < j <= jt and r0 <= i < r0 + TILE_ROWS.
struct Tile {
  uint16_t* s;
  int jt, r0;
  __device__ bool holds(int i, int j) const {
    return j <= jt && j > jt - LANES && i >= r0 && i < r0 + TILE_ROWS;
  }
};

// The warp's tiles: the one it reads, and the one on its way.
struct Tiles {
  Tile cur, next;
  bool pending;  // next's copies are in flight
};

// Start the copies of the tile whose bottom-right 8-row group holds cell
// (i, j), 0 <= i < X, 1 <= j, into tl: 16-byte cp.async copies of rows of
// stride 1 (tb.vec), committed as one group and not waited for.
__device__ void start_copies(Tile& tl, const Tb& tb, int i, int j) {
  const int lane = threadIdx.x % LANES;
  tl.jt = j;
  tl.r0 = (i + 8) / 8 * 8 - TILE_ROWS;
  const int jc = j - lane;
  if (jc >= 1) {
    const uint16_t* col = tb.column(jc);
    uint16_t* dst = tl.s + lane * PITCH;
#pragma unroll
    for (int g = 0; g < TILE_ROWS / 8; ++g) {
      const int r = tl.r0 + 8 * g;
      if (r >= 0 && r < tb.X) __pipeline_memcpy_async(dst + 8 * g, col + r, 16);
    }
  }
  __pipeline_commit();
}

// Send for the tile the path likely enters next (the head note), the
// current one having been fetched for row i.
__device__ void fetch_ahead(Tiles& t, const Tb& tb, int i) {
  const int j = t.cur.jt - LANES;
  if (!tb.vec || j < 1 || i - AHEAD < 0) return;
  start_copies(t.next, tb, i - AHEAD, j);
  t.pending = true;
}

// Make the current tile hold cell (i, j), 0 <= i < X, 1 <= j. Warp-uniform.
__device__ void fill(Tiles& t, const Tb& tb, int i, int j) {
  const int lane = threadIdx.x % LANES;
  __syncwarp();  // every lane is done with the current tile
  if (t.pending) {
    __pipeline_wait_prior(0);
    __syncwarp();
    t.pending = false;
    if (t.next.holds(i, j)) {
      const Tile held = t.cur;
      t.cur = t.next;
      t.next = held;
      fetch_ahead(t, tb, i);
      return;
    }
  }
  if (tb.vec) {
    start_copies(t.cur, tb, i, j);
    __pipeline_wait_prior(0);
  } else {
    t.cur.jt = j;
    t.cur.r0 = (i + 8) / 8 * 8 - TILE_ROWS;
    const int jc = j - lane;
    if (jc >= 1) {
      const uint16_t* col = tb.column(jc);
      uint16_t* dst = t.cur.s + lane * PITCH;
      for (int r = max(t.cur.r0, 0); r < min(t.cur.r0 + TILE_ROWS, tb.X); ++r) dst[r - t.cur.r0] = __ldg(col + r * tb.si);
    }
  }
  __syncwarp();
  fetch_ahead(t, tb, i);
}

// Cell (i, j), or -1 outside the column (i < 0 or i >= X). Warp-uniform.
__device__ __forceinline__ int cell(Tiles& t, const Tb& tb, int i, int j) {
  if (i < 0 || i >= tb.X) return -1;
  if (!t.cur.holds(i, j)) fill(t, tb, i, j);
  return t.cur.s[(t.cur.jt - j) * PITCH + (i - t.cur.r0)];
}

// The i-layer of a cell, TB_REREAD resolved to the s-bits of the cell above.
__device__ __forceinline__ int layer_of(int c, int above) {
  const int ib = c & 0xF;
  return ib == TB_REREAD ? (above >> 8) & 0xF : ib;
}

// The Ins run up column j from row r >= 1 on, in device memory: the first
// row brk <= r whose i-layer is not TB_INS (-1 where rows 0..r all are),
// its i-layer and the d-bits of the cell above it. Warp-uniform: lane l
// tests the 8 rows of group G - l, G - 32 - l, ... from G = r / 8 down.
__device__ void run_up(const Tb& tb, int j, int r, int& brk, int& layer2, int& db2) {
  const int lane = threadIdx.x % LANES;
  const uint16_t* col = tb.column(j);
  for (int G = r / 8;; G -= LANES) {
    const int g = G - lane;
    int found = -2, lay = 0, dbits = 0;
    if (g < 0) {  // row -1: cell -1, i-layer 15
      found = -1;
      lay = dbits = 15;
    } else {
      int c[9];  // c[k] the cell of row 8g + k - 1 (rows past r unread)
      c[0] = g > 0 ? __ldg(col + (8 * g - 1) * tb.si) : -1;
      if (tb.vec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(col + 8 * g));
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k + 1] = (w[k / 2] >> (16 * (k & 1))) & 0xFFFF;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k + 1] = 8 * g + k <= r ? __ldg(col + (8 * g + k) * tb.si) : 0;
      }
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        const int l = layer_of(c[k + 1], c[k]);
        if (found == -2 && 8 * g + k <= r && l != TB_INS) {
          found = 8 * g + k;
          lay = l;
          dbits = (c[k] >> 4) & 0xF;
        }
      }
    }
    const unsigned hit = __ballot_sync(FULL, found != -2);
    if (hit) {  // the lowest such lane holds the highest such rows
      const int src = __ffs(hit) - 1;
      brk = __shfl_sync(FULL, found, src);
      layer2 = __shfl_sync(FULL, lay, src);
      db2 = __shfl_sync(FULL, dbits, src);
      return;
    }
  }
}

__global__ void __launch_bounds__(WARPS * LANES) sweep_walk_global_seg_kernel(
    const uint16_t* __restrict__ tb,  // (N, X, B) through the strides
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int X,
    int N, long long sj, long long si, long long sb, int vec,
    uint16_t* __restrict__ ins_cnt,   // (N, B)
    uint16_t* __restrict__ exit_op,   // (N, B)
    uint16_t* __restrict__ ins0) {    // (B,)
  __shared__ __align__(16) uint16_t tiles[WARPS][2][LANES * PITCH];
  const int lane = threadIdx.x % LANES;
  const int w = threadIdx.x / LANES;
  const int b = blockIdx.x * WARPS + w;
  if (b >= B) return;  // the whole warp
  const Tb t{tb + b * sb, sj, si, X, vec != 0};
  Tiles tl{{tiles[w][0], 0, 0}, {tiles[w][1], 0, 0}, false};  // jt = 0: empty
  int icur = mlens[b];
  int jcur = nlens[b];
  int carried = TB_START;
  bool use_s = true;
  bool done = false;
  bool live = true;  // the path moved a column left at every column so far

  for (int jb = N; jb >= 1; jb -= LANES) {
    int my_cnt = 0, my_code = 0;  // the outputs of column jb - lane
    const int jlo = max(jb - LANES + 1, 1);
    // the path's column lies in the chunk once it lies at or after jlo:
    // the chunks above held every column past it
    while (live && jcur >= jlo) {
      const int j = jcur;
      // the entry cell; icur < X always (the path only moves up from mlens)
      int g1 = -1;
      if (icur >= 0) {
        if (!tl.cur.holds(icur, j)) fill(tl, t, icur, j);
        g1 = tl.cur.s[(tl.cur.jt - j) * PITCH + (icur - tl.cur.r0)];
      }
      const int entry = use_s ? (g1 >> 8) & 0xF : carried;
      int layer2 = entry;
      int db2 = (g1 >> 4) & 0xF;
      int i2 = icur;
      int cnt = 0;
      if (entry == TB_INS) {
        int brk = icur;  // the row tested next
        for (;;) {
          if (tl.cur.r0 > 0 && brk <= tl.cur.r0) {  // its layer reads above the tile
            run_up(t, j, brk, brk, layer2, db2);
            break;
          }
          layer2 = layer_of(cell(tl, t, brk, j), cell(tl, t, brk - 1, j));
          if (layer2 != TB_INS) {
            db2 = (cell(tl, t, brk - 1, j) >> 4) & 0xF;
            break;
          }
          --brk;
        }
        cnt = icur - brk + 1;
        i2 = brk - 1;
      }
      // the exit: selects, no branches
      const bool is_mm = layer2 == TB_MATCH || layer2 == TB_SUBST;
      const bool is_del = layer2 == TB_DEL;
      live = is_mm || is_del;  // else the path stops: at TB_START, or stuck
      icur = is_mm ? i2 - 1 : (is_del ? i2 : icur);
      jcur = live ? j - 1 : j;
      carried = is_del ? db2 : carried;
      use_s = is_mm;
      done = done || layer2 == TB_START;
      const bool mine = lane == jb - j;
      my_cnt = mine ? cnt : my_cnt;
      my_code = mine ? (live ? layer2 : 0) : my_code;
    }
    const int jc = jb - lane;
    if (jc >= 1) {
      ins_cnt[static_cast<size_t>(jc - 1) * B + b] = static_cast<uint16_t>(my_cnt);
      exit_op[static_cast<size_t>(jc - 1) * B + b] = static_cast<uint16_t>(my_code);
    }
  }
  // column 0 is the analytic init column: a live pair emits icur Ins
  if (lane == 0) ins0[b] = static_cast<uint16_t>(done ? 0 : icur);
  __pipeline_wait_prior(0);  // no copy outlives the warp
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tb's element strides: sj between columns, si between rows, sb between
// pairs; vec nonzero when si is 1, sj and sb (or B = 1) are multiples of 8,
// tb is 16-byte aligned and its storage holds each column's rows up to X
// rounded up to 8 (ops/walk.py _walk_strides checks it)
int sweep_walk_global_seg(const void* tb, const void* mlens, const void* nlens,
                          int B, int X, int N, long long sj, long long si,
                          long long sb, int vec, void* ins_cnt, void* exit_op, void* ins0,
                          void* stream) {
  if (vec && (si != 1 || sj % 8 || (B > 1 && sb % 8) || reinterpret_cast<uintptr_t>(tb) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  sweep_walk_global_seg_kernel<<<(B + WARPS - 1) / WARPS, WARPS * LANES, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(mlens),
      static_cast<const int*>(nlens), B, X, N, sj, si, sb, vec, static_cast<uint16_t*>(ins_cnt),
      static_cast<uint16_t*>(exit_op), static_cast<uint16_t*>(ins0));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
