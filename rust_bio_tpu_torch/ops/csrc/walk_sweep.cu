// K2 sweep_walk_global and K6 sweep_walk_semiglobal: the column-sweep
// traceback walks of global mode and of the semiglobal family. K2 replaces
// rust_bio_tpu/ops/walk_pallas.py sweep_walk_global ->
// _kernel_sweep_walk_global; K6 replaces sweep_walk_semiglobal ->
// _kernel_sweep_walk_semi together with its XLA prolog
// _resolve_fixed_column, which it resolves itself.
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

__device__ __forceinline__ bool is_mm(int layer) { return layer == TB_MATCH || layer == TB_SUBST; }

// One pair: its tb through the strides, and where its column outputs go:
// the (N, B) tensors, or the block's stage in shared memory, (N, WARPS)
// each, which the block writes out when its walks are done.
struct Pair {
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
  // the steps a diagonal or row round loads: the last such run's, at least
  // MIN_WIDTH, twice as many after a run that filled its round, at most
  // LANES (a lane past it reads UNLOADED and ends the run)
  int width = LANES;
  while (j >= 1) {
    if (entry == UNREAD || is_mm(entry)) {
      // a diagonal: step l exits column j - l at row i - l, its layer the
      // s-bits of its cell (step 0's the entry)
      const int lj = j - lane;
      const int c = lane >= width ? UNLOADED : (lj >= 1 ? p.cell(i - lane, lj) : -1);
      if (entry == UNREAD) {
        entry = (__shfl_sync(FULL, c, 0) >> 8) & 0xF;
        if (!is_mm(entry)) continue;
      }
      const int layer = lane == 0 ? entry : (c >> 8) & 0xF;
      const unsigned out = __ballot_sync(FULL, lj < 1 || !is_mm(layer));
      const int k = out ? __ffs(out) - 1 : LANES;
      if (lane < k) p.put(lj, 0, layer);
      const int next = __shfl_sync(FULL, c, k % LANES);  // the cell that ends the run
      i -= k;
      j -= k;
      entry = k < LANES && next != UNLOADED ? (next >> 8) & 0xF : UNREAD;
      width = k < width ? max(k, MIN_WIDTH) : min(2 * width, LANES);
    } else if (entry == TB_DEL) {
      // a row: step l exits column j - l at row i, its layer the d-bits of
      // step l - 1's cell
      const int lj = j - lane;
      const int c = lane >= width ? UNLOADED : (lj >= 1 ? p.cell(i, lj) : -1);
      const int prev = __shfl_up_sync(FULL, c, 1);
      const int layer = lane == 0 ? TB_DEL : (prev >> 4) & 0xF;
      const unsigned out = __ballot_sync(FULL, lj < 1 || layer != TB_DEL || c == UNLOADED);
      const int k = out ? __ffs(out) - 1 : LANES;
      if (lane < k) p.put(lj, 0, TB_DEL);
      j -= k;
      entry = (__shfl_sync(FULL, c, k - 1) >> 4) & 0xF;  // carried into column j
      width = k < width ? max(k, MIN_WIDTH) : min(2 * width, LANES);
    } else {
      // one column: an Ins run and its exit, or an entry that ends the walk
      int cnt = 0;
      int layer = entry;
      int carry = 0;
      int i2 = i;
      if (entry == TB_INS) {
        // lane l holds row top - l; the nibble of row i - m sits on lane h
        int m = 0;
        int h;
        int c;
        for (;;) {
          const int top = i - m;
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
        // row i - m (its i-bits: the exit) and row i - m - 1 (its d-bits)
        int ga;
        int gb;
        if (h >= 0 && h + 1 < LANES) {
          ga = __shfl_sync(FULL, c, h);
          gb = __shfl_sync(FULL, c, h + 1);
        } else {
          ga = p.cell(i - m, j);
          gb = p.cell(i - m - 1, j);
        }
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

}  // extern "C"
