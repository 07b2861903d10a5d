// K10 sweep_walk_custom and K8 sweep_walk_local: the traceback walks of the
// general-clip family over the traceback tensor of K9 / K7 / K9-LUT /
// K7-LUT (sw_warp.cu). Replace rust_bio_tpu/ops/walk_pallas.py
// sweep_walk_custom -> _kernel_sweep_walk_custom and sweep_walk_local ->
// _kernel_sweep_walk_local.
//
// Layouts: they read the cell of DP cell (i, j) of pair b at
// tb[j * sj + i * si + b * sb], element strides they are given: a
// contiguous (N+1, X, B) tensor (sj = X * B, si = B, sb = 1), as the plain
// versions', or the scans' pair-major (B, N+1, Xp) one (sj = Xp, si = 1,
// sb = (N+1) * Xp), read in place; ops/walk.py takes those two and raises
// on others.
//
// The walk's steps inside the suffix-fixed final column (j = nlens) are
// resolved before the launch, in plain torch (ops/walk.py
// resolve_fixed_column_custom); a kernel starts from the state that leaves
// behind (row i1, column j1, carried layer ca1, use-s flag us1, done dn1)
// and steps the columns j = N..0, column 0 included, in lockstep with its
// warp, so a warp's stores of one column are contiguous.
//
// K10 emits, per column and pair (0 where the pair is not in that column):
// pre, the length of an Xclip-suffix taken at the entry row (a jump of
// lx[j] rows up the column); ins_cnt Ins ops; exit_op (Match, Subst, Del,
// Xclip-prefix or Yclip-prefix) with its length exit_len (i for an
// Xclip-prefix, j for a Yclip-prefix); and post, the op an Xclip-prefix exit
// continues with from row 0 of the same column (Del, Yclip-prefix or Start).
// K8 is the local-mode walk (all clips 0 and gap_open + gap_extend < 0):
// no interior cell carries a clip op, Xclip-prefix, Yclip-prefix and Start
// end the path, and their row and column give xstart and ystart.
//
// Design: one thread per pair keeps the Pallas
// kernel's state machine. An Ins run's length comes from the 15-capped
// nibble in bits 12-15 plus the re-read chain for runs of 15 or more; the
// Pallas kernel's speculative second gather (TPU vector rules) is a plain
// branch here.
//
// Bound on this card: per pair it reads the cells of its path (about
// M + N, scattered: one 32-byte sector each) and writes (N+1) uint16 per
// output; each step waits on a dependent load, so it is latency-bound.

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
constexpr int THREADS = 64;  // 8192 pairs -> 128 blocks: one per SM

// One column of the traceback tensor for one pair.
struct Col {
  const uint16_t* base;  // cell (0, j) of this pair
  int X;
  long long si;          // the row stride
  // cell (i, j), or -1 outside the column (as the Pallas row gather)
  __device__ int operator()(int i) const {
    return (i >= 0 && i < X) ? static_cast<int>(base[i * si]) : -1;
  }
};

// The Ins run entered at row i through an s-bits (or carried) Ins: its
// i-bits run length m, from the nibble of cell g at row i and the re-read
// chain while a nibble is capped at 15.
__device__ __forceinline__ int ins_run(const Col& col, int i, int g) {
  int m = g >> 12;
  int nib = m;
  while (nib == 15) {
    nib = col(i - m) >> 12;
    m += nib;
  }
  return m;
}

__global__ void __launch_bounds__(THREADS) sweep_walk_custom_kernel(
    const uint16_t* __restrict__ tb,  // (N + 1, X, B) through the strides
    const int* __restrict__ lx,       // (N + 1, B)
    const int* __restrict__ i1, const int* __restrict__ j1,
    const int* __restrict__ ca1, const int* __restrict__ us1,
    const int* __restrict__ dn1, int B, int X, int N, long long sj,
    long long si, long long sb,
    uint16_t* __restrict__ pre_out,   // (N + 1, B) each
    uint16_t* __restrict__ ins_out,
    uint16_t* __restrict__ exit_out,
    uint16_t* __restrict__ elen_out,
    uint16_t* __restrict__ post_out) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  int icur = i1[b];
  int jcur = j1[b];
  int carried = ca1[b];
  bool use_s = us1[b] != 0;
  bool done = dn1[b] != 0;

  for (int j = N; j >= 0; --j) {
    int pre = 0, cnt = 0, code = 0, elen = 0, post = 0;
    if (jcur == j && !done) {
      const Col col{tb + j * sj + b * sb, X, si};
      int g = col(icur);
      int entry = use_s ? (g >> 8) & 0xF : carried;
      int ip = icur;
      if (entry == TB_XCLIP_SUFFIX) {  // row mlens only: jump up lx[j] rows
        pre = lx[static_cast<size_t>(j) * B + b];
        ip = icur - pre;
        g = col(ip);
        entry = (g >> 8) & 0xF;
      }
      int layer2, db2, i2;
      if (entry == TB_INS) {
        const int m = ins_run(col, ip, g);
        cnt = m + 1;
        layer2 = col(ip - m) & 0xF;
        db2 = (col(ip - m - 1) >> 4) & 0xF;
        i2 = ip - m - 1;
      } else {
        layer2 = entry;
        db2 = (g >> 4) & 0xF;
        i2 = ip;
      }
      const bool is_mm = layer2 == TB_MATCH || layer2 == TB_SUBST;
      const bool is_del = layer2 == TB_DEL;
      const bool is_ycp = layer2 == TB_YCLIP_PREFIX;
      const bool is_xcp = layer2 == TB_XCLIP_PREFIX;
      if (is_mm || is_del || is_ycp || is_xcp) code = layer2;
      elen = is_xcp ? i2 : (is_ycp ? j : 0);
      int sb0 = -1, db0 = 0;
      if (is_xcp) {  // the op after the clip, from row 0 of this column
        const int g0 = col(0);
        sb0 = (g0 >> 8) & 0xF;
        db0 = (g0 >> 4) & 0xF;
        post = sb0;
      }
      const bool post_del = sb0 == TB_DEL;
      const bool post_ycp = sb0 == TB_YCLIP_PREFIX;
      icur = is_mm ? i2 - 1 : (is_xcp ? 0 : i2);
      if (is_mm || is_del || post_del) {
        jcur = j - 1;
      } else if (is_ycp || post_ycp) {
        jcur = 0;
      }
      if (is_del) {
        carried = db2;
      } else if (post_del) {
        carried = db0;
      }
      use_s = !(is_del || post_del);
      if (layer2 == TB_START || sb0 == TB_START) done = true;
    }
    const size_t o = static_cast<size_t>(j) * B + b;
    pre_out[o] = static_cast<uint16_t>(pre);
    ins_out[o] = static_cast<uint16_t>(cnt);
    exit_out[o] = static_cast<uint16_t>(code);
    elen_out[o] = static_cast<uint16_t>(elen);
    post_out[o] = static_cast<uint16_t>(post);
  }
}

__global__ void __launch_bounds__(THREADS) sweep_walk_local_kernel(
    const uint16_t* __restrict__ tb,  // (N + 1, X, B) through the strides
    const int* __restrict__ i1, const int* __restrict__ j1,
    const int* __restrict__ ca1, const int* __restrict__ us1,
    const int* __restrict__ dn1, const int* __restrict__ xs0,
    const int* __restrict__ ys0, int B, int X, int N, long long sj,
    long long si, long long sb,
    uint16_t* __restrict__ ins_out,   // (N + 1, B) each
    uint16_t* __restrict__ exit_out,
    int* __restrict__ xstart,         // (B,) each
    int* __restrict__ ystart) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  int icur = i1[b];
  int jcur = j1[b];
  int carried = ca1[b];
  bool use_s = us1[b] != 0;
  bool done = dn1[b] != 0;
  int xs = xs0[b];
  int ys = ys0[b];

  for (int j = N; j >= 0; --j) {
    int cnt = 0, code = 0;
    if (jcur == j && !done) {
      const Col col{tb + j * sj + b * sb, X, si};
      const int g = col(icur);
      const int entry = use_s ? (g >> 8) & 0xF : carried;
      int layer2, db2, i2;
      if (entry == TB_INS) {
        const int m = ins_run(col, icur, g);
        cnt = m + 1;
        layer2 = col(icur - m) & 0xF;
        db2 = (col(icur - m - 1) >> 4) & 0xF;
        i2 = icur - m - 1;
      } else {
        layer2 = entry;
        db2 = (g >> 4) & 0xF;
        i2 = icur;
      }
      const bool is_mm = layer2 == TB_MATCH || layer2 == TB_SUBST;
      const bool is_del = layer2 == TB_DEL;
      if (is_mm || is_del) {
        code = layer2;
        jcur = j - 1;
      }
      icur = is_mm ? i2 - 1 : i2;
      if (is_del) carried = db2;
      use_s = is_mm;
      // Start, Xclip-prefix and Yclip-prefix end the path; the prolog may
      // have resolved a prefix clip already (at most one source is nonzero)
      if (layer2 == TB_START || layer2 == TB_XCLIP_PREFIX || layer2 == TB_YCLIP_PREFIX) {
        done = true;
        xs = max(i2, xs);
        ys = max(j, ys);
      }
    }
    const size_t o = static_cast<size_t>(j) * B + b;
    ins_out[o] = static_cast<uint16_t>(cnt);
    exit_out[o] = static_cast<uint16_t>(code);
  }
  // the Pallas kernel stores the coordinates as uint16
  xstart[b] = xs & 0xFFFF;
  ystart[b] = ys & 0xFFFF;
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sweep_walk_custom(const void* tb, const void* lx, const void* i1,
                      const void* j1, const void* ca1, const void* us1,
                      const void* dn1, int B, int X, int N, long long sj,
                      long long si, long long sb, void* pre, void* ins_cnt,
                      void* exit_op, void* exit_len, void* post, void* stream) {
  sweep_walk_custom_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(lx),
      static_cast<const int*>(i1), static_cast<const int*>(j1),
      static_cast<const int*>(ca1), static_cast<const int*>(us1),
      static_cast<const int*>(dn1), B, X, N, sj, si, sb, static_cast<uint16_t*>(pre),
      static_cast<uint16_t*>(ins_cnt), static_cast<uint16_t*>(exit_op),
      static_cast<uint16_t*>(exit_len), static_cast<uint16_t*>(post));
  return static_cast<int>(cudaGetLastError());
}

int sweep_walk_local(const void* tb, const void* i1, const void* j1,
                     const void* ca1, const void* us1, const void* dn1,
                     const void* xs0, const void* ys0, int B, int X, int N,
                     long long sj, long long si, long long sb, void* ins_cnt,
                     void* exit_op, void* xstart, void* ystart, void* stream) {
  sweep_walk_local_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tb), static_cast<const int*>(i1),
      static_cast<const int*>(j1), static_cast<const int*>(ca1),
      static_cast<const int*>(us1), static_cast<const int*>(dn1),
      static_cast<const int*>(xs0), static_cast<const int*>(ys0), B, X, N, sj, si, sb,
      static_cast<uint16_t*>(ins_cnt), static_cast<uint16_t*>(exit_op),
      static_cast<int*>(xstart), static_cast<int*>(ystart));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
