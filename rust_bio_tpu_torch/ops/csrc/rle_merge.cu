// K-merge rle_merge: the run merge of the column-RLE walk streams of K2
// (global) and K6 (semiglobal) into at most R (kind, length) runs a pair,
// stored straight into the (5 + R, B) uint16 compact pack. Replaces no
// Pallas kernel: the XLA functions
// rust_bio_tpu/alignment/pairwise/batched.py _merge_rle_device (the merge,
// an associative-scan forward fill and R masked sums over the stream) and
// _pack_rle_merged (the pack), folded into its stores.
//
// Semantics (ops/walk.py merge_rle_plain, the torch transcription of the
// two): a pair's stream, in op order, is [Ins x ins0], per DP column j <
// nlens (exit_op[j] x 1, Ins x ins_cnt[j]), [fix_exit x 1], [Ins x
// fix_ins]; an entry is kept when its kind is Ins, Del, Subst or Match
// (1-4) and its length is positive, and a kept entry starts a new run when
// its kind differs from the previous kept entry's (dropped entries -- 0,
// clips -- do not break a run). Run r's kind and summed length go to row 5
// + r as kind << 12 | min(len, 4095) for r < R (0 past the pair's runs);
// rows 0-4 are the score's high and low halves, xstart, xend and n_runs |
// ovf << 15, where ovf means more than R runs or a run of the first R
// longer than 4095 (12 bits): the host re-runs such lanes densely.
//
// Design: one warp a pair, WARPS pairs a block. The warp reads its pair's
// stream 32 entries a round (16 columns' exit and Ins run: lane l entry e0
// + l), where the walk left it (K2's and K6's (N, B) column outputs, no
// transpose): a ballot of the kept entries and the kind of the nearest
// kept lane below (a shuffle) decide which entries start runs, a second
// ballot and a popcount number them, and an inclusive shuffle scan of the
// kept lengths gives each run's sum within the round; the run still open at
// the round's end carries its id, kind and length into the next round.
// A lane whose run closes in the round stores its pack entry. What bounds
// it on this card: the streams' bytes (4 N B, 2.5 MB at 8192 150 bp pairs)
// and the pack's ((5 + R) * 2 B); each round's loads are 2-byte reads at
// stride 2 B, a 32-byte sector each, from L2 where the walk just wrote them.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // ops/walk.py MERGE_WARPS
constexpr int LANES = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int TB_INS = 1;
constexpr int TB_MATCH = 4;
constexpr int LEN_MAX = 0xFFF;

__global__ void __launch_bounds__(WARPS * LANES) rle_merge_kernel(
    const int* __restrict__ score,        // (B,)
    const uint16_t* __restrict__ ins_cnt, // (N, B)
    const uint16_t* __restrict__ exit_op, // (N, B)
    const uint16_t* __restrict__ ins0,    // (B,)
    const int* __restrict__ fix_ins,      // (B,) or null (global: 0)
    const int* __restrict__ fix_exit,     // (B,) or null (global: 0)
    const int* __restrict__ nlens,        // (B,)
    const int* __restrict__ xstart,       // (B,) or null (0)
    const int* __restrict__ xend,         // (B,)
    int B, int N, int R, uint16_t* __restrict__ pack) {
  const int lane = threadIdx.x % LANES;
  const int b = blockIdx.x * WARPS + threadIdx.x / LANES;
  if (b >= B) return;  // warp-uniform
  const int nl = min(__ldg(nlens + b), N);
  const int W = 2 * nl + 3;  // columns past nlens hold no kept entry
  const unsigned below = (1u << lane) - 1;
  int runs = 0;       // runs started before this round
  int cur_kind = 0;   // the open run's kind (0: none yet)
  int cur_len = 0;    // its length so far
  bool len_ovf = false;
  for (int e0 = 0; e0 < W; e0 += LANES) {
    const int e = e0 + lane;
    int kind = 0;
    int len = 0;
    if (e == 0) {
      kind = TB_INS;
      len = __ldg(ins0 + b);
    } else if (e <= 2 * nl) {
      const size_t at = static_cast<size_t>((e - 1) >> 1) * B + b;
      if (e & 1) {
        kind = __ldg(exit_op + at);
        len = 1;
      } else {
        kind = TB_INS;
        len = __ldg(ins_cnt + at);
      }
    } else if (e == 2 * nl + 1) {
      kind = fix_exit ? __ldg(fix_exit + b) : 0;
      len = 1;
    } else if (e == 2 * nl + 2) {
      kind = TB_INS;
      len = fix_ins ? __ldg(fix_ins + b) : 0;
    }
    const bool kept = kind >= TB_INS && kind <= TB_MATCH && len > 0;
    const unsigned kmask = __ballot_sync(FULL, kept);
    const unsigned kbelow = kmask & below;
    const int src = kbelow ? 31 - __clz(kbelow) : 0;
    const int kind_below = __shfl_sync(FULL, kind, src);
    const int prev = kbelow ? kind_below : cur_kind;
    const bool starts = kept && kind != prev;
    const unsigned smask = __ballot_sync(FULL, starts);
    // inclusive scan of the kept lengths over the lanes
    int sum = kept ? len : 0;
    for (int d = 1; d < LANES; d <<= 1) {
      const int up = __shfl_up_sync(FULL, sum, d);
      if (lane >= d) sum += up;
    }
    const int total = __shfl_sync(FULL, sum, LANES - 1);
    const int before = __shfl_up_sync(FULL, sum, 1);
    const int excl = lane > 0 ? before : 0;  // the kept lengths below this lane
    if (smask == 0) {
      cur_len += total;
      continue;
    }
    // each run start's length within the round: up to the next start
    const unsigned later = lane < LANES - 1 ? smask & ~((2u << lane) - 1) : 0;
    const int next = later ? __ffs(later) - 1 : LANES;
    const int sum_next = __shfl_sync(FULL, excl, next & (LANES - 1));
    const int end_excl = later ? sum_next : total;
    const int first = __ffs(smask) - 1;
    const int first_excl = __shfl_sync(FULL, excl, first);
    // the run open at the round's start closes at the first start
    if (lane == 0 && runs > 0) {
      const int len_c = cur_len + first_excl;
      len_ovf |= runs - 1 < R && len_c > LEN_MAX;
      if (runs - 1 < R) {
        pack[static_cast<size_t>(5 + runs - 1) * B + b] =
            static_cast<uint16_t>((cur_kind << 12) | min(len_c, LEN_MAX));
      }
    }
    const int rid = runs + __popc(smask & below);
    const int last = 31 - __clz(smask);
    if (starts && lane != last) {
      const int len_r = end_excl - excl;
      len_ovf |= rid < R && len_r > LEN_MAX;
      if (rid < R) {
        pack[static_cast<size_t>(5 + rid) * B + b] =
            static_cast<uint16_t>((kind << 12) | min(len_r, LEN_MAX));
      }
    }
    runs += __popc(smask);
    cur_kind = __shfl_sync(FULL, kind, last);
    cur_len = total - __shfl_sync(FULL, excl, last);
  }
  // the last run closes at the stream's end
  if (lane == 0 && runs > 0) {
    len_ovf |= runs - 1 < R && cur_len > LEN_MAX;
    if (runs - 1 < R) {
      pack[static_cast<size_t>(5 + runs - 1) * B + b] =
          static_cast<uint16_t>((cur_kind << 12) | min(cur_len, LEN_MAX));
    }
  }
  for (int r = runs + lane; r < R; r += LANES) pack[static_cast<size_t>(5 + r) * B + b] = 0;
  const bool ovf = runs > R || __any_sync(FULL, len_ovf);
  if (lane == 0) {
    const int s = __ldg(score + b);
    pack[b] = static_cast<uint16_t>((s >> 16) & 0xFFFF);
    pack[static_cast<size_t>(B) + b] = static_cast<uint16_t>(s & 0xFFFF);
    pack[2 * static_cast<size_t>(B) + b] = static_cast<uint16_t>(xstart ? __ldg(xstart + b) : 0);
    pack[3 * static_cast<size_t>(B) + b] = static_cast<uint16_t>(__ldg(xend + b));
    pack[4 * static_cast<size_t>(B) + b] = static_cast<uint16_t>(runs | (ovf ? 0x8000 : 0));
  }
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rle_merge(const void* score, const void* ins_cnt, const void* exit_op, const void* ins0,
              const void* fix_ins, const void* fix_exit, const void* nlens, const void* xstart,
              const void* xend, int B, int N, int R, void* pack, void* stream) {
  rle_merge_kernel<<<(B + WARPS - 1) / WARPS, WARPS * LANES, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(score), static_cast<const uint16_t*>(ins_cnt),
      static_cast<const uint16_t*>(exit_op), static_cast<const uint16_t*>(ins0),
      static_cast<const int*>(fix_ins), static_cast<const int*>(fix_exit), static_cast<const int*>(nlens),
      static_cast<const int*>(xstart), static_cast<const int*>(xend), B, N, R,
      static_cast<uint16_t*>(pack));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
