// K2 sweep_walk_global and K6 sweep_walk_semiglobal: the column-sweep
// traceback walks of global mode and of the semiglobal family. K2 replaces
// rust_bio_tpu/ops/walk_pallas.py sweep_walk_global ->
// _kernel_sweep_walk_global; K6 replaces sweep_walk_semiglobal ->
// _kernel_sweep_walk_semi together with its XLA prolog
// _resolve_fixed_column, which it resolves itself. K8 sweep_walk_local and
// K10 sweep_walk_custom, the walks of the clip modes over the (N + 1, X, B)
// tb of K7 / K9 / K7-LUT / K9-LUT, replace sweep_walk_local ->
// _kernel_sweep_walk_local and sweep_walk_custom ->
// _kernel_sweep_walk_custom with their XLA prolog
// _resolve_fixed_column_custom (and K8's cell gather, K10's coordinate
// epilog); their section below says what they read and write.
//
// Inputs: tb, the 16-bit cells i | d << 4 | s << 8 | run << 12 of K1 or K11
// (K2) and of K5 or K12 (K6) (csrc/sw_warp.cu), DP column j >= 1 of pair b
// at tb[(j - 1) * sj + i * si + b * sb] through the element strides it is
// given: the scans' pair-major (B, N, Xp) tensor read in place (sj = Xp,
// si = 1, sb = N * Xp) or a contiguous (N, X, B) one (sj = X * B, si = B,
// sb = 1), as the plain versions' are; ops/walk.py takes those two and
// raises on others. mlens, nlens (B,) int32. K6 also reads tbfix (B, X)
// int32, the suffix-fixed final column's 12-bit cells with Ly << 12.
//
// Outputs, the column-RLE form of the path walked end -> start: per DP
// column j and pair, ins_cnt[j - 1] Ins ops then one exit op
// exit_op[j - 1] (TB_MATCH / TB_SUBST / TB_DEL, in K6 also
// TB_YCLIP_PREFIX; 0 where the pair is not), (N, B) uint16, every column
// written; ins0 (B,) uint16, the Ins run left in column 0. K6 also writes
// the fixed column's ops and the y-coordinates, (B,) int32 each: fix_ins,
// fix_exit, fix_ly, ystart, yend.
//
// The walk is the plain versions' (ops/walk.py _sweep_plain,
// resolve_fixed_column). At column j from row i the entry layer is the
// s-bits of cell (i, j), or the d-bits carried from a Del exit. An Ins
// entry takes m + 1 Ins, m read from the run nibble of row i (bits 12-15,
// capped at 15: while the last read was 15, m grows by the nibble of row
// i - m), and the column's exit is the i-bits of row i - m; any other entry
// is the exit itself. Match/Subst goes on at (i - 1, j - 1) from its
// s-bits, Del at row i of column j - 1 carrying the d-bits of the cell it
// leaves (row i - m - 1 after an Ins run), a Yclip-prefix exit (K6) jumps
// to column 0, TB_START ends the walk, and any other layer stops it where
// it is. A cell outside rows 0..X - 1 reads -1, as the Pallas row gather.
// K6 first resolves the fixed column, column nlens, from tbfix: its Ins
// run is the run of Ins i-bits ending at row mlens (one that reaches row 0
// counts 2^20 more, and its row i2 = -1 wraps to X - 1, as the JAX
// version's sentinel and gather do).
//
// Design: one warp a pair, WARPS pairs a block, the control flow
// warp-uniform. The column-RLE path is made of three kinds of run: columns
// that each exit Match/Subst with no Ins (a diagonal), columns that each
// exit Del with no Ins (a row), and one column's Ins run with its exit. A
// round walks one run: lane l loads the cell of step l straight from device
// memory (diagonal (i - l, j - l), row (i, j - l), or the column's rows
// i - l, where up to three 15-row nibble hops resolve in a round); a ballot
// finds the first step that leaves the run, and each lane of it stores its
// column's outputs. So a round waits on one dependent load, where the
// one-thread-a-pair kernels before these waited on one a column (an Ins
// run on one a cell). A diagonal or row round loads as many steps as the
// last such run took (8 to 32; twice as many after a run that filled its
// round): every cell of a diagonal or a row lies in its own 32-byte
// sector, so a lane past the run's end costs a random sector read, and
// random 150 bp pairs take runs of 5 columns on average. The
// cell that ends a diagonal gives the next entry; after a run that filled
// its round and after an Ins run's Match/Subst exit the next round loads
// the diagonal before it knows the entry, on the guess that the path goes
// on along it. K6's warp resolves the fixed column the same way: 32 rows of
// tbfix a load, a ballot for the first row that is not Ins. The column
// outputs, one 2-byte store a column at stride B, are staged in shared
// memory for the block's WARPS pairs and written out a 32-byte sector a
// column when the block's walks are done (while 4 * WARPS * N bytes fit
// STAGE_MAX_BYTES; else each lane stores its column's outputs itself). A
// tile of the tb in shared memory (K15-walk's) was slower here: a fill
// reads two sectors a column where the path reads one, and a 150 bp path
// leaves a 32-column tile within a round or two (scripts/sweep_trial.py).
//
// K8 and K10 take the same rounds over columns N..0 (column 0 a column of
// the tb like the others), each clip step a one-column round, and resolve
// their pair's fixed column first, three steps with the JAX index rules;
// their column outputs (K8 two, K10 five) are staged while they fit
// CLIP_STAGE_MAX_BYTES, past 48 KB by opting in to the larger dynamic
// shared memory (K10 on a 457-column homolog view: 73,280 bytes, 2.4x
// faster than direct stores on an H100, scripts/sweep_trial.py).
//
// Bound on this card: per pair it reads the cells of its path (about M + N
// of them, a random 32-byte sector each on the pair-major layout; a round
// loads up to 32) and writes 2 * N uint16; what bounds it is the random
// sector reads, with every pair's walk resident on the card at once.

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
constexpr int LANES = 32;      // steps a round at most
constexpr int WARPS = 16;      // pairs a block: their outputs of a column fill a 32-byte sector
constexpr int STAGE_MAX_BYTES = 48 * 1024;  // a block's staged column outputs, 4 * WARPS * N bytes
constexpr int NIBBLE_CAP = 15;  // the run nibble's cap
constexpr int UNREAD = -2;     // the entry of a column whose s-bits are not loaded yet
constexpr int UNLOADED = -3;   // a step past the round's width: its cell is not loaded
constexpr int MIN_WIDTH = 8;   // steps a diagonal or row round loads at least
constexpr unsigned FULL = 0xffffffffu;
// K8 and K10: their (N + 1, B) uint16 column outputs, and the most bytes a
// block stages (2 * outputs * WARPS * (N + 1)), past 48 KB by opting in
constexpr int LOCAL_OUTPUTS = 2;
constexpr int CUSTOM_OUTPUTS = 5;
constexpr int CLIP_STAGE_MAX_BYTES = 96 * 1024;
constexpr int SENTINEL_RUN = 1 << 20;  // the prolog's Ins run that reaches row 0 counts this much more

__device__ __forceinline__ bool is_mm(int layer) { return layer == TB_MATCH || layer == TB_SUBST; }

// One pair: its tb through the strides, and where its column outputs go:
// the (N, B) tensors, or the block's stage in shared memory, (N, WARPS)
// each, which the block writes out when its walks are done.
struct Pair {
  static constexpr int FIRST = 1;  // the first DP column in the tb
  const uint16_t* tb;  // the pair's cell (0, 1)
  long long sj, si;
  int X, N, lane;
  uint16_t* ins_cnt;  // column j's output at [(j - 1) * stride + col]
  uint16_t* exit_op;
  int stride, col;
  bool staged;  // the stage starts zeroed
  // cell (i, j) of DP column j >= 1; -1 outside rows 0..X - 1
  __device__ int cell(int i, int j) const {
    return i >= 0 && i < X ? static_cast<int>(__ldg(tb + (j - 1) * sj + i * si)) : -1;
  }
  __device__ void put(int j, int cnt, int code) const {
    const size_t at = static_cast<size_t>(j - 1) * stride + col;
    ins_cnt[at] = static_cast<uint16_t>(cnt);
    exit_op[at] = static_cast<uint16_t>(code);
  }
  __device__ void put_exit(int j, int code) const { put(j, 0, code); }
  // no op in columns lo..hi, a lane a column
  __device__ void clear(int lo, int hi) const {
    if (staged) return;
    for (int j = lo + lane; j <= hi; j += LANES) put(j, 0, 0);
  }
};

// The block's stage (N columns of WARPS pairs, ins_cnt then exit_op) zeroed
// before its walks, or null where it would not fit (direct stores).
__device__ uint16_t* stage_open(uint16_t* smem, int staged, int N) {
  if (!staged) return nullptr;
  for (int e = threadIdx.x; e < 2 * N * WARPS; e += blockDim.x) smem[e] = 0;
  __syncthreads();
  return smem;
}

// The stage written out after the block's walks: a column's WARPS pairs in
// one 32-byte sector of each output.
__device__ void stage_close(const uint16_t* stage, int N, int B, uint16_t* ins_cnt, uint16_t* exit_op) {
  if (!stage) return;
  __syncthreads();
  const int n = N * WARPS;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int b = blockIdx.x * WARPS + e % WARPS;
    if (b < B) {
      const size_t at = static_cast<size_t>(e / WARPS) * B + b;
      ins_cnt[at] = stage[e];
      exit_op[at] = stage[n + e];
    }
  }
}

__device__ Pair pair_of(const uint16_t* tb, long long sj, long long si, long long sb, int X, int N, int B,
                        int b, uint16_t* ins_cnt, uint16_t* exit_op, uint16_t* stage) {
  const int lane = threadIdx.x % LANES;
  const uint16_t* tbb = tb + b * sb;
  if (stage) return Pair{tbb, sj, si, X, N, lane, stage, stage + N * WARPS, WARPS, b % WARPS, true};
  return Pair{tbb, sj, si, X, N, lane, ins_cnt, exit_op, B, b, false};
}

// The rounds of K2, K6, K8 and K10, over a pair P whose DP columns run
// P::FIRST..N. ``width``: the steps a diagonal or row round loads, the last
// such run's, at least MIN_WIDTH, twice as many after a run that filled its
// round, at most LANES (a lane past it reads UNLOADED and ends the run).
//
// A diagonal: step l exits column j - l at row i - l, its layer the s-bits
// of its cell (step 0's the entry; UNREAD: read from its cell, and nothing
// is walked where that is no Match/Subst).
template <class P>
__device__ __forceinline__ void diagonal_round(const P& p, int& i, int& j, int& entry, int& width) {
  const int lane = p.lane;
  const int lj = j - lane;
  const int c = lane >= width ? UNLOADED : (lj >= P::FIRST ? p.cell(i - lane, lj) : -1);
  if (entry == UNREAD) {
    entry = (__shfl_sync(FULL, c, 0) >> 8) & 0xF;
    if (!is_mm(entry)) return;
  }
  const int layer = lane == 0 ? entry : (c >> 8) & 0xF;
  const unsigned out = __ballot_sync(FULL, lj < P::FIRST || !is_mm(layer));
  const int k = out ? __ffs(out) - 1 : LANES;
  if (lane < k) p.put_exit(lj, layer);
  const int next = __shfl_sync(FULL, c, k % LANES);  // the cell that ends the run
  i -= k;
  j -= k;
  entry = k < LANES && next != UNLOADED ? (next >> 8) & 0xF : UNREAD;
  width = k < width ? max(k, MIN_WIDTH) : min(2 * width, LANES);
}

// A row: step l exits column j - l at row i, its layer the d-bits of step
// l - 1's cell; entry becomes the layer carried into the column after it.
template <class P>
__device__ __forceinline__ void row_round(const P& p, int i, int& j, int& entry, int& width) {
  const int lane = p.lane;
  const int lj = j - lane;
  const int c = lane >= width ? UNLOADED : (lj >= P::FIRST ? p.cell(i, lj) : -1);
  const int prev = __shfl_up_sync(FULL, c, 1);
  const int layer = lane == 0 ? TB_DEL : (prev >> 4) & 0xF;
  const unsigned out = __ballot_sync(FULL, lj < P::FIRST || layer != TB_DEL || c == UNLOADED);
  const int k = out ? __ffs(out) - 1 : LANES;
  if (lane < k) p.put_exit(lj, TB_DEL);
  j -= k;
  entry = (__shfl_sync(FULL, c, k - 1) >> 4) & 0xF;  // carried into column j
  width = k < width ? max(k, MIN_WIDTH) : min(2 * width, LANES);
}

// The Ins run entered at row ip of column j: returns m (m + 1 Ins, m from
// the run nibbles' hops), with the cells of row ip - m (its i-bits: the
// exit) and row ip - m - 1 (its d-bits: the layer a Del exit carries).
template <class P>
__device__ __forceinline__ int ins_run(const P& p, int ip, int j, int& ga, int& gb) {
  const int lane = p.lane;
  // lane l holds row top - l; the nibble of row ip - m sits on lane h
  int m = 0;
  int h;
  int c;
  for (;;) {
    const int top = ip - m;
    c = p.cell(top - lane, j);
    int nib;
    h = 0;
    do {
      nib = __shfl_sync(FULL, c, h) >> 12;  // -1 outside the column
      m += nib;
      h += nib;
    } while (nib == NIBBLE_CAP && h < LANES);
    if (nib != NIBBLE_CAP) break;
  }
  if (h >= 0 && h + 1 < LANES) {
    ga = __shfl_sync(FULL, c, h);
    gb = __shfl_sync(FULL, c, h + 1);
  } else {
    ga = p.cell(ip - m, j);
    gb = p.cell(ip - m - 1, j);
  }
  return m;
}

// The column sweep from column j, row i, with the entry layer there
// (UNREAD: the s-bits of cell (i, j)); done: the walk has ended before it.
// Writes every column 1..N; ys takes the column of a Yclip-prefix exit
// (SEMI). Returns ins0.
template <bool SEMI>
__device__ int sweep(const Pair& p, int i, int j, int entry, bool done, int& ys) {
  const int lane = p.lane;
  if (done || j < 1 || j > p.N) {
    p.clear(1, p.N);
    return done ? 0 : i;
  }
  p.clear(j + 1, p.N);
  int width = LANES;
  while (j >= 1) {
    if (entry == UNREAD || is_mm(entry)) {
      diagonal_round(p, i, j, entry, width);
    } else if (entry == TB_DEL) {
      row_round(p, i, j, entry, width);
    } else {
      // one column: an Ins run and its exit, or an entry that ends the walk
      int cnt = 0;
      int layer = entry;
      int carry = 0;
      int i2 = i;
      if (entry == TB_INS) {
        int ga;
        int gb;
        const int m = ins_run(p, i, j, ga, gb);
        cnt = m + 1;
        layer = ga & 0xF;
        carry = (gb >> 4) & 0xF;
        i2 = i - m - 1;
        if (is_mm(layer) || layer == TB_DEL) {
          if (lane == 0) p.put(j, cnt, layer);
          i = is_mm(layer) ? i2 - 1 : i2;
          j -= 1;
          entry = is_mm(layer) ? UNREAD : carry;
          continue;
        }
      }
      const bool ycp = SEMI && layer == TB_YCLIP_PREFIX;
      if (lane == 0) p.put(j, cnt, ycp ? layer : 0);
      p.clear(1, j - 1);
      if (ycp) {  // to column 0, from row i2
        ys = max(ys, j);
        return i2;
      }
      return layer == TB_START ? 0 : i;
    }
  }
  return i;  // column 0 is the analytic init column: a live pair emits i Ins
}

__global__ void __launch_bounds__(WARPS * LANES) sweep_walk_global_kernel(
    const uint16_t* __restrict__ tb,  // through the strides
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int X, int N,
    long long sj, long long si, long long sb, int staged,
    uint16_t* __restrict__ ins_cnt,  // (N, B)
    uint16_t* __restrict__ exit_op,  // (N, B)
    uint16_t* __restrict__ ins0) {   // (B,)
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* stage = stage_open(smem, staged, N);
  const int b = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (b < B) {  // the whole warp
    const Pair p = pair_of(tb, sj, si, sb, X, N, B, b, ins_cnt, exit_op, stage);
    int ys = 0;
    const int ins = sweep<false>(p, mlens[b], nlens[b], UNREAD, false, ys);
    if (p.lane == 0) ins0[b] = static_cast<uint16_t>(ins);
  }
  stage_close(stage, N, B, ins_cnt, exit_op);
}

// K6's prolog, the walk's steps inside the fixed column, then its sweep.
__device__ void semiglobal_pair(const Pair& p, const int* fix, int ml, int nl, int b, uint16_t* ins0,
                                int* fix_ins, int* fix_exit, int* fix_ly, int* ystart, int* yend) {
  const int lane = p.lane;
  const int X = p.X;
  // the fixed column: lane l holds row top - l (0 above row 0)
  int top = ml;
  int f = top - lane >= 0 ? __ldg(fix + top - lane) : 0;
  const int entry = (__shfl_sync(FULL, f, 0) >> 8) & 0xF;
  const bool ins = entry == TB_INS;
  int m = 0;
  int layer = entry;
  if (ins) {
    // the Ins run of the i-bits ending at row mlens, up to the first row
    // that is not Ins; layer: that row's i-bits
    for (;;) {
      const unsigned brk = __ballot_sync(FULL, top - lane >= 0 && (f & 0xF) != TB_INS);
      if (brk) {
        const int l = __ffs(brk) - 1;
        m = ml - (top - l);
        layer = __shfl_sync(FULL, f, l) & 0xF;
        break;
      }
      if (top < LANES) {  // Ins down to row 0: the sentinel run, the layer of row 0
        m = ml + (1 << 20);
        layer = __shfl_sync(FULL, f, top) & 0xF;
        break;
      }
      top -= LANES;
      f = top - lane >= 0 ? __ldg(fix + top - lane) : 0;
    }
  }
  const int i2 = ins ? ml - m - 1 : ml;
  // the cell of row i2, a negative row wrapped to the end
  const int w = (i2 % X + X) % X;
  const int off = top - w;
  const int g = off >= 0 && off < LANES ? __shfl_sync(FULL, f, off) : __ldg(fix + w);
  const int ly = g >> 12;
  const bool mm = is_mm(layer);
  const bool del = layer == TB_DEL;
  const bool ycs = layer == TB_YCLIP_SUFFIX;
  const bool ycp = layer == TB_YCLIP_PREFIX;
  const bool start = layer == TB_START;
  int ys = ycp ? nl : 0;
  const int i1 = mm ? i2 - 1 : i2;
  const int j1 = mm || del ? nl - 1 : (ycs ? nl - ly : (ycp ? 0 : nl));
  const int ins_left = sweep<true>(p, i1, j1, del ? (g >> 4) & 0xF : UNREAD, start, ys);
  if (lane == 0) {
    ins0[b] = static_cast<uint16_t>(ins_left);
    fix_ins[b] = ins ? m + 1 : 0;
    fix_exit[b] = start ? 0 : layer;
    fix_ly[b] = ycs ? ly : (ycp ? nl : 0);
    ystart[b] = ys;
    yend[b] = ycs ? nl - ly : nl;
  }
}

__global__ void __launch_bounds__(WARPS * LANES) sweep_walk_semiglobal_kernel(
    const uint16_t* __restrict__ tb,  // through the strides
    const int* __restrict__ tbfix,    // (B, X): 12-bit cells | Ly << 12
    const int* __restrict__ mlens, const int* __restrict__ nlens, int B, int X, int N,
    long long sj, long long si, long long sb, int staged,
    uint16_t* __restrict__ ins_cnt,  // (N, B)
    uint16_t* __restrict__ exit_op,  // (N, B)
    uint16_t* __restrict__ ins0,     // (B,)
    int* __restrict__ fix_ins, int* __restrict__ fix_exit, int* __restrict__ fix_ly,
    int* __restrict__ ystart, int* __restrict__ yend) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* stage = stage_open(smem, staged, N);
  const int b = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (b < B) {  // the whole warp
    const Pair p = pair_of(tb, sj, si, sb, X, N, B, b, ins_cnt, exit_op, stage);
    semiglobal_pair(p, tbfix + static_cast<size_t>(b) * X, mlens[b], nlens[b], b, ins0, fix_ins, fix_exit,
                    fix_ly, ystart, yend);
  }
  stage_close(stage, N, B, ins_cnt, exit_op);
}


// ---- K8 and K10: the clip-mode walks over the (N + 1, X, B) tb ----------

// One pair of K8 (CUSTOM false) or K10: its tb through the strides, column
// 0 at index 0, and where its column outputs go: the (OUT, N + 1, B) tensor
// or the block's stage, (OUT, N + 1, WARPS), which the block writes out when
// its walks are done. Output k of column j lies at [k * plane + j * stride
// + col].
template <bool CUSTOM>
struct ClipPair {
  static constexpr int OUT = CUSTOM ? CUSTOM_OUTPUTS : LOCAL_OUTPUTS;
  static constexpr int FIRST = 0;
  const uint16_t* tb;  // the pair's cell (0, 0)
  long long sj, si;
  int X, N, lane;  // N: the last column
  uint16_t* out;
  size_t plane;
  int stride, col;
  bool staged;  // the stage starts zeroed
  // cell (i, j); -1 outside rows 0..X - 1
  __device__ int cell(int i, int j) const {
    return i >= 0 && i < X ? static_cast<int>(__ldg(tb + j * sj + i * si)) : -1;
  }
  // K10: pre, ins_cnt, exit_op, exit_len, post; K8: ins_cnt, exit_op
  __device__ void put(int j, int pre, int cnt, int code, int elen, int post) const {
    uint16_t* o = out + static_cast<size_t>(j) * stride + col;
    if (CUSTOM) {
      o[0] = static_cast<uint16_t>(pre);
      o[plane] = static_cast<uint16_t>(cnt);
      o[2 * plane] = static_cast<uint16_t>(code);
      o[3 * plane] = static_cast<uint16_t>(elen);
      o[4 * plane] = static_cast<uint16_t>(post);
    } else {
      o[0] = static_cast<uint16_t>(cnt);
      o[plane] = static_cast<uint16_t>(code);
    }
  }
  __device__ void put_exit(int j, int code) const { put(j, 0, 0, code, 0, 0); }
  // no op in columns lo..hi, a lane a column
  __device__ void clear(int lo, int hi) const {
    if (staged) return;
    for (int j = lo + lane; j <= hi; j += LANES) put(j, 0, 0, 0, 0, 0);
  }
};

// The stage (OUT outputs of N + 1 columns of WARPS pairs, n uint16) zeroed
// before the block's walks, or null where it does not fit (direct stores).
__device__ uint16_t* clip_stage_open(uint16_t* smem, int staged, int n) {
  if (!staged) return nullptr;
  for (int e = threadIdx.x; e < n; e += blockDim.x) smem[e] = 0;
  __syncthreads();
  return smem;
}

// What a clip walk leaves for the pair's coordinates.
struct ClipEnd {
  int xs, ys;    // K8: the prolog's xstart / ystart, maxed with the finishing step's row and column
  int xcp, ycp;  // K10: the largest Xclip-prefix exit_len (as stored), the rightmost Yclip-prefix column
  int pre;       // K10: the largest x-suffix clip (as stored); 0: none
};

// The stage written out after the block's walks: a column's WARPS pairs in
// one 32-byte sector of each output.
__device__ void clip_stage_close(const uint16_t* stage, int n, int B, uint16_t* outs) {
  if (!stage) return;
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int b = blockIdx.x * WARPS + e % WARPS;
    if (b < B) outs[static_cast<size_t>(e / WARPS) * B + b] = stage[e];
  }
}

// The clip sweep from column j, row i, with the entry layer there (UNREAD:
// the s-bits of cell (i, j)), as ops/walk.py _sweep_clip_plain steps it:
// K2's rounds (a diagonal, a row, or one column's Ins run and exit) over
// columns N..0, each clip step a one-column round. K10: an Xclip-suffix
// entry jumps lx[j] rows up the column and takes the s-bits there; an
// Xclip-prefix exit gives exit_len i2 and post, row 0's s-bits: a Del post
// goes on at (0, j - 1) with row 0's d-bits, a Yclip-prefix post jumps to
// column 0, any other ends the walk; a Yclip-prefix exit gives exit_len j
// and jumps to column 0. K8: Start, Xclip-prefix and Yclip-prefix end the
// walk (xs, ys). Any layer the walk does not handle stops it where it is.
template <bool CUSTOM>
__device__ void clip_sweep(const ClipPair<CUSTOM>& p, const int* lx, int B, int i, int j, int entry,
                           ClipEnd& e) {
  const int lane = p.lane;
  p.clear(j + 1, p.N);
  int width = LANES;
  while (j >= 0) {
    if (entry == UNREAD || is_mm(entry)) {
      diagonal_round(p, i, j, entry, width);
    } else if (entry == TB_DEL) {
      row_round(p, i, j, entry, width);
    } else {
      // one column: an x-suffix jump (K10), an Ins run, and its exit
      int pre = 0;
      int ip = i;
      int g = 0;  // cell (ip, j) after a jump
      if (CUSTOM && entry == TB_XCLIP_SUFFIX) {
        pre = __ldg(lx + static_cast<size_t>(j) * B);
        ip = i - pre;
        g = p.cell(ip, j);
        entry = (g >> 8) & 0xF;
        e.pre = max(e.pre, pre & 0xFFFF);  // as pre_out stores it
      }
      int cnt = 0;
      int layer = entry;
      int carry = (g >> 4) & 0xF;
      int i2 = ip;
      if (entry == TB_INS) {
        int ga;
        int gb;
        const int m = ins_run(p, ip, j, ga, gb);
        cnt = m + 1;
        layer = ga & 0xF;
        carry = (gb >> 4) & 0xF;
        i2 = ip - m - 1;
      }
      if (is_mm(layer) || layer == TB_DEL) {
        if (lane == 0) p.put(j, pre, cnt, layer, 0, 0);
        i = is_mm(layer) ? i2 - 1 : i2;
        j -= 1;
        entry = is_mm(layer) ? UNREAD : carry;
        continue;
      }
      if (CUSTOM && layer == TB_XCLIP_PREFIX) {
        // the op after the clip, from row 0 of this column
        const int g0 = p.cell(0, j);
        const int post = (g0 >> 8) & 0xF;
        if (lane == 0) p.put(j, pre, cnt, layer, i2, post);
        e.xcp = max(e.xcp, i2 & 0xFFFF);
        i = 0;
        if (post == TB_DEL) {
          j -= 1;
          entry = (g0 >> 4) & 0xF;
          continue;
        }
        if (post == TB_YCLIP_PREFIX) {
          e.ycp = max(e.ycp, j);
          if (j > 0) {  // to column 0, row 0
            p.clear(1, j - 1);
            j = 0;
            entry = UNREAD;
            continue;
          }
        }
        p.clear(0, j - 1);
        return;
      }
      if (CUSTOM && layer == TB_YCLIP_PREFIX) {
        if (lane == 0) p.put(j, pre, cnt, layer, j, 0);
        e.ycp = max(e.ycp, j);
        if (j > 0) {  // to column 0, row i2
          p.clear(1, j - 1);
          i = i2;
          j = 0;
          entry = UNREAD;
          continue;
        }
        return;
      }
      // K10's Start or any layer it does not handle, K8's every layer but
      // Match, Subst and Del: the walk ends in this column
      if (lane == 0) p.put(j, pre, cnt, 0, 0, 0);
      if (!CUSTOM && (layer == TB_START || layer == TB_XCLIP_PREFIX || layer == TB_YCLIP_PREFIX)) {
        e.xs = max(i2, e.xs);
        e.ys = max(j, e.ys);
      }
      p.clear(0, j - 1);
      return;
    }
  }
}

// JAX's index rules for the fixed column (ops/walk.py _gather_cols): a
// negative row counts from the end once, a row still outside is clamped.
__device__ __forceinline__ int jax_row(int r, int X) {
  r = r < 0 ? r + X : r;
  return min(max(r, 0), X - 1);
}

// A pair's fixed column, tbfix's 12-bit cells with Ly << 12: lane l holds
// row top - l (0 above row 0).
struct FixCol {
  const int* fix;
  int X, lane, top, f;
  __device__ void load(int t) {
    top = t;
    f = t - lane >= 0 ? __ldg(fix + t - lane) : 0;
  }
  // the cell of row jax_row(r)
  __device__ int get(int r) const {
    r = jax_row(r, X);
    const int off = top - r;
    return off >= 0 && off < LANES ? __shfl_sync(FULL, f, off) : __ldg(fix + r);
  }
  // the run of Ins i-bits ending at row jax_row(r) (0 where that row's
  // i-bits are not Ins; SENTINEL_RUN more where the run reaches row 0)
  __device__ int ins_run(int r) {
    r = jax_row(r, X);
    if (r != top) load(r);
    for (;;) {
      const unsigned brk = __ballot_sync(FULL, top - lane >= 0 && (f & 0xF) != TB_INS);
      if (brk) return r - (top - (__ffs(brk) - 1));
      if (top < LANES) return r + SENTINEL_RUN;
      load(top - LANES);
    }
  }
};

// The prolog's state: the sweep's entry, the coordinates it fixed, and the
// op slots, slot s on lane s (an emit past the fourth slot is dropped).
struct ClipEntry {
  int i, j, carried, xstart, ystart, xend, yend, nslot, code, len;
  bool use_s, done;
  __device__ void emit(int lane, int c, int n) {
    if (lane == nslot) {
      code = c;
      len = n;
    }
    ++nslot;
  }
};

// ops/walk.py resolve_fixed_column_custom for one pair, every lane alike:
// up to three steps in the fixed column (an x-suffix jump of lx_n rows, an
// Ins run, one exit) until the walk leaves the column or ends.
__device__ ClipEntry clip_prolog(FixCol& fx, int lxn, int ml, int nl) {
  ClipEntry s{ml, nl, TB_START, 0, 0, ml, nl, 0, 0, 0, true, false};
  const int lane = fx.lane;
  fx.load(jax_row(ml, fx.X));
  for (int step = 0; step < 3 && !s.done; ++step) {
    int entry = s.use_s ? (fx.get(s.i) >> 8) & 0xF : s.carried;
    if (entry == TB_XCLIP_SUFFIX) {
      s.emit(lane, TB_XCLIP_SUFFIX, lxn);
      s.i -= lxn;
      s.xend = s.i;
      s.use_s = true;
      entry = (fx.get(s.i) >> 8) & 0xF;
    }
    int layer = entry;
    int i2 = s.i;
    if (entry == TB_INS) {
      const int m = fx.ins_run(s.i);
      s.emit(lane, TB_INS, m + 1);
      i2 = s.i - m - 1;
      layer = fx.get(max(s.i - m, 0)) & 0xF;
    }
    const int g2 = fx.get(i2);
    const int ly2 = g2 >> 12;
    const bool mm = is_mm(layer);
    const bool del = layer == TB_DEL;
    const bool ycs = layer == TB_YCLIP_SUFFIX;
    const bool ycp = layer == TB_YCLIP_PREFIX;
    const bool xcp = layer == TB_XCLIP_PREFIX;
    if (mm || del || ycs || ycp || xcp) {
      s.emit(lane, layer, ycs ? ly2 : (ycp ? s.j : (xcp ? i2 : 0)));
      if (!del) s.use_s = true;
    }
    s.i = mm ? i2 - 1 : (xcp ? 0 : i2);
    if (ycs) s.yend = s.j - ly2;
    if (ycp) s.ystart = s.j;
    if (xcp) s.xstart = i2;
    if (del) {
      s.carried = (g2 >> 4) & 0xF;
      s.use_s = false;
    }
    s.done = layer == TB_START;
    s.j = mm || del ? s.j - 1 : (ycp ? 0 : (ycs ? s.j - ly2 : s.j));
    if (mm || del || ycp || ycs) break;  // left the fixed column
  }
  return s;
}

// K8 and K10 for one pair: the prolog, (K8) the landing cell of a
// Yclip-suffix exit, the sweep, then the pair's slots and coordinates.
template <bool CUSTOM>
__device__ void clip_pair(const ClipPair<CUSTOM>& p, const int* fix, const int* lx, int B, int lxn, int ml,
                          int nl, int b, int* fix_codes, int* fix_lens, int* coords) {
  const int lane = p.lane;
  FixCol fx{fix, p.X, lane, 0, 0};
  ClipEntry s = clip_prolog(fx, lxn, ml, nl);
  if (!CUSTOM && !s.done && s.use_s && s.j < nl && s.j > 0) {
    // ops/walk.py local_entry: an x-suffix clip at the cell a Yclip-suffix
    // exit lands on, into the next free slot
    const int g = p.cell(jax_row(s.i, p.X), s.j);
    if (((g >> 8) & 0xF) == TB_XCLIP_SUFFIX) {
      const int lxj = __ldg(lx + static_cast<size_t>(s.j) * B + b);
      s.i -= lxj;
      s.xend = s.i;
      s.nslot = min(s.nslot, 4);
      s.emit(lane, TB_XCLIP_SUFFIX, lxj);
    }
  }
  ClipEnd e{s.xstart, s.ystart, 0, 0, 0};
  if (s.done || s.j < 0 || s.j > p.N) {
    p.clear(0, p.N);
  } else {
    clip_sweep<CUSTOM>(p, lx + b, B, s.i, s.j, s.use_s ? UNREAD : s.carried, e);
  }
  if (lane < 4) {
    fix_codes[4 * b + lane] = lane < s.nslot ? s.code : 0;
    fix_lens[4 * b + lane] = lane < s.nslot ? s.len : 0;
  }
  if (lane == 0) {
    if (CUSTOM) {
      coords[b] = max(e.xcp, s.xstart);
      coords[B + b] = max(e.ycp, s.ystart);
      coords[2 * B + b] = e.pre > 0 ? ml - e.pre : s.xend;
    } else {
      // the Pallas kernel stores the coordinates as uint16
      coords[b] = e.xs & 0xFFFF;
      coords[B + b] = e.ys & 0xFFFF;
      coords[2 * B + b] = s.xend;
    }
    coords[3 * B + b] = s.yend;
  }
}

template <bool CUSTOM>
__global__ void __launch_bounds__(WARPS * LANES) sweep_walk_clip_kernel(
    const uint16_t* __restrict__ tb,  // (N + 1, X, B) through the strides
    const int* __restrict__ tbfix,    // (B, X): 12-bit cells | Ly << 12
    const int* __restrict__ lx,       // (N + 1, B)
    const int* __restrict__ lx_n, const int* __restrict__ mlens, const int* __restrict__ nlens, int B,
    int X, int N, long long sj, long long si, long long sb, int staged,
    uint16_t* __restrict__ outs,       // (OUT, N + 1, B)
    int* __restrict__ fix_codes,       // (B, 4)
    int* __restrict__ fix_lens,        // (B, 4)
    int* __restrict__ coords) {        // (4, B): xstart, ystart, xend, yend
  using Pair = ClipPair<CUSTOM>;
  extern __shared__ __align__(16) uint16_t smem[];
  const int n = Pair::OUT * (N + 1) * WARPS;
  uint16_t* stage = clip_stage_open(smem, staged, n);
  const int b = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (b < B) {  // the whole warp
    const int lane = threadIdx.x % LANES;
    const uint16_t* tbb = tb + b * sb;
    const size_t cols = static_cast<size_t>(N) + 1;
    const Pair p = stage ? Pair{tbb, sj, si, X, N, lane, stage, cols * WARPS, WARPS, b % WARPS, true}
                         : Pair{tbb, sj, si, X, N, lane, outs, cols * B, B, b, false};
    clip_pair<CUSTOM>(p, tbfix + static_cast<size_t>(b) * X, lx, B, lx_n[b], mlens[b], nlens[b], b, fix_codes,
                      fix_lens, coords);
  }
  clip_stage_close(stage, n, B, outs);
}

// The block's shared bytes for K8 (LOCAL_OUTPUTS) or K10 (CUSTOM_OUTPUTS):
// its staged column outputs where they fit CLIP_STAGE_MAX_BYTES, else none
// (direct stores).
int clip_stage_bytes(int outputs, int N) {
  const long long bytes = 2LL * outputs * WARPS * (N + 1);
  return bytes <= CLIP_STAGE_MAX_BYTES ? static_cast<int>(bytes) : 0;
}

// K8 or K10's launch: a stage past 48 KB opts in to the larger dynamic
// shared memory first.
template <bool CUSTOM>
int sweep_walk_clip(const void* tb, const void* tbfix, const void* lx, const void* lx_n, const void* mlens,
                    const void* nlens, int B, int X, int N, long long sj, long long si, long long sb, void* outs,
                    void* fix_codes, void* fix_lens, void* coords, void* stream) {
  const int smem = clip_stage_bytes(CUSTOM ? CUSTOM_OUTPUTS : LOCAL_OUTPUTS, N);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(sweep_walk_clip_kernel<CUSTOM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sweep_walk_clip_kernel<CUSTOM><<<(B + WARPS - 1) / WARPS, WARPS * LANES, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(tbfix), static_cast<const int*>(lx),
      static_cast<const int*>(lx_n), static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, X, N, sj,
      si, sb, smem > 0, static_cast<uint16_t*>(outs), static_cast<int*>(fix_codes), static_cast<int*>(fix_lens),
      static_cast<int*>(coords));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The block's shared bytes: its staged column outputs where they fit
// STAGE_MAX_BYTES, else none (direct stores).
static int stage_bytes(int N) {
  const long long bytes = 4LL * WARPS * N;
  return bytes <= STAGE_MAX_BYTES ? static_cast<int>(bytes) : 0;
}

// K2. tb's element strides: sj between columns, si between rows, sb
// between pairs.
int sweep_walk_global(const void* tb, const void* mlens, const void* nlens, int B, int X, int N,
                      long long sj, long long si, long long sb, void* ins_cnt, void* exit_op,
                      void* ins0, void* stream) {
  const int smem = stage_bytes(N);
  sweep_walk_global_kernel<<<(B + WARPS - 1) / WARPS, WARPS * LANES, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(mlens),
      static_cast<const int*>(nlens), B, X, N, sj, si, sb, smem > 0 || N == 0,
      static_cast<uint16_t*>(ins_cnt), static_cast<uint16_t*>(exit_op), static_cast<uint16_t*>(ins0));
  return static_cast<int>(cudaGetLastError());
}

// K6 with its fixed-column prolog. tb's strides as K2's.
int sweep_walk_semiglobal(const void* tb, const void* tbfix, const void* mlens, const void* nlens,
                          int B, int X, int N, long long sj, long long si, long long sb,
                          void* ins_cnt, void* exit_op, void* ins0, void* fix_ins, void* fix_exit,
                          void* fix_ly, void* ystart, void* yend, void* stream) {
  const int smem = stage_bytes(N);
  sweep_walk_semiglobal_kernel<<<(B + WARPS - 1) / WARPS, WARPS * LANES, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(tbfix),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens), B, X, N, sj, si, sb,
      smem > 0 || N == 0, static_cast<uint16_t*>(ins_cnt), static_cast<uint16_t*>(exit_op),
      static_cast<uint16_t*>(ins0), static_cast<int*>(fix_ins), static_cast<int*>(fix_exit),
      static_cast<int*>(fix_ly), static_cast<int*>(ystart), static_cast<int*>(yend));
  return static_cast<int>(cudaGetLastError());
}

// K8 with its prolog (resolve_fixed_column_custom and local_entry) and
// K10 with its prolog and coordinate epilog; tb's strides as K2's, over
// columns 0..N. outs (LOCAL_OUTPUTS or CUSTOM_OUTPUTS, N + 1, B) uint16,
// fix_codes and fix_lens (B, 4) int32, coords (4, B) int32.
int sweep_walk_local(const void* tb, const void* tbfix, const void* lx, const void* lx_n, const void* mlens,
                     const void* nlens, int B, int X, int N, long long sj, long long si, long long sb, void* outs,
                     void* fix_codes, void* fix_lens, void* coords, void* stream) {
  return sweep_walk_clip<false>(tb, tbfix, lx, lx_n, mlens, nlens, B, X, N, sj, si, sb, outs, fix_codes, fix_lens,
                                coords, stream);
}

int sweep_walk_custom(const void* tb, const void* tbfix, const void* lx, const void* lx_n, const void* mlens,
                      const void* nlens, int B, int X, int N, long long sj, long long si, long long sb, void* outs,
                      void* fix_codes, void* fix_lens, void* coords, void* stream) {
  return sweep_walk_clip<true>(tb, tbfix, lx, lx_n, mlens, nlens, B, X, N, sj, si, sb, outs, fix_codes, fix_lens,
                               coords, stream);
}

}  // extern "C"
