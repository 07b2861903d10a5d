// K4 fm_backward_search: batched FM-index backward search. Replaces
// rust_bio_tpu/ops/fm_pallas.py backward_search_fused -> _kernel_fm_search
// (and serves every n < 2^31, where the TPU kernel stops at n < 2^23).
// K4-locate fm_locate: the batched LF-walk from suffix-array rows to text
// positions. Replaces no Pallas kernel: the XLA while_loop
// rust_bio_tpu/data_structures/fm_device.py _locate_impl, the hot loop of
// the read mapper's locate (suffix_array.rs:157-184).
//
// Search semantics (fmindex.rs:144-208, fm_pallas.py:148-231): starting from
// the whole suffix-array interval [0, n-1], step t reads the pattern byte
// pats[q, plen-1-t] and narrows
//   l' = less[a] + rank(l - 1, a),   r' = less[a] + rank(r, a) - 1.
// A step fails when the byte is outside the alphabet (sym -1), when
// rank(r, a) == 0 (rust-bio's occ_r == 0 guard, fmindex.rs) or when l' > r';
// the query then stops and keeps the interval before that step (PARTIAL, or
// ABSENT when nothing matched). status is ABSENT 0 / PARTIAL 1 /
// COMPLETE 2, upper = r + 1, and a length-0 pattern is ABSENT.
//
// Rank is the gather path of fm_device.py _search_impl (bit-identical to
// the fused TPU kernel): one 8-byte read of the (S, nw, 2) int32 table
// {bit-plane word, exclusive checkpoint} plus __popc(word & mask), with
// rank(pos < 0) = 0. The TPU kernel instead scans a bf16 byte-plane table
// with a one-hot matmul, because a per-query gather scalarizes there; on
// Hopper a gather is one memory transaction, so none of that carries over.
//
// What bounds K4 on this card: 65,536 queries are 512 blocks of 128
// threads, all resident at once (about 500 threads an SM of 2,048); the
// table (6-7 MB at 4.6 Mbp) sits in the 50 MB L2, and each step is one or
// two random 8-byte gathers from it, a 32-byte L2 sector each. The chain of
// a query's steps sets the time, so the design keeps one L2 round trip a
// step on it:
// - both ranks of a step are issued together (one load where l - 1 and r
//   share a word, as they do once the interval is narrow): a rank that the
//   occ_r == 0 guard throws away changes no output;
// - the next step's pattern byte, its symbol and its less are loaded during
//   the step before, off the rank chain.
// On an H100 the 65,536 20-mers take about 0.013 ms of device time this
// way, 0.016 with the first design's loop (the byte, sym_of and less read
// in the chain, the rank at l - 1 after the one at r), 0.014 with only the
// ranks paired; staging a thread's pattern in shared memory (0.017) or
// keeping sym_of and less there did not help (scripts/fm_trial.py --k4).
//
// Locate semantics (fm_device.py _locate_impl): from row pos, while
// pos % s != 0 and bwt_sym[pos] != 0 (symbol index 0, the sentinel), step
// pos = less_sym[sym] + rank(pos - 1, sym) and count the step; at a sampled
// row the base is sa_sample[pos / s], at a sentinel row the exact stored
// value found by a binary search of sent_rows / sent_vals; the result is
// base + steps. One thread a row: the walk is a chain of two dependent
// reads a step (the symbol, then its rank), the rows' walks part after a
// few steps, so nothing is shared between them, and the longest walk
// (sampling is by row: about s ln(rows) steps) sets the time. Reading the
// symbol from the S bit-planes of pos's word instead, all S loaded
// together with the rank in one round trip, took twice as long on an H100
// (S = 11 for DNA). A row outside [0, n) gives -1 (the callers reject such
// rows before the launch).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // ops/fm.py FM_THREADS
constexpr int ABSENT = 0;
constexpr int PARTIAL = 1;
constexpr int COMPLETE = 2;

// occurrences in a rank-table entry {word, exclusive count} up to and
// including bit ``bitpos`` (0..31)
__device__ __forceinline__ int count_to(int2 e, int bitpos) {
  return e.y + __popc(static_cast<unsigned>(e.x) & (0xFFFFFFFFu >> (31 - bitpos)));
}

__device__ __forceinline__ int rank(const int2* __restrict__ fused, int nw,
                                    int pos, int sym) {
  if (pos < 0) return 0;
  return count_to(__ldg(fused + static_cast<size_t>(sym) * nw + (pos >> 5)), pos & 31);
}

__global__ void __launch_bounds__(THREADS) fm_search_kernel(
    const int2* __restrict__ fused,     // (S, nw) {word, checkpoint}
    const int* __restrict__ less,       // (256,) less by byte
    const int* __restrict__ sym_of,     // (256,) symbol index, -1 outside
    const uint8_t* __restrict__ pats,   // (B, L)
    const int* __restrict__ plens,      // (B,)
    int B, int L, int nw, int n,
    int* __restrict__ status, int* __restrict__ lower,
    int* __restrict__ upper, int* __restrict__ mlen_out) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= B) return;
  const int plen = __ldg(plens + q);
  const uint8_t* pat = pats + static_cast<size_t>(q) * L;
  int l = 0;
  int r = n - 1;
  int pl = l;
  int pr = r;
  int mlen = 0;
  bool complete = true;
  // step t's byte, symbol and less, loaded during step t - 1
  int a = plen > 0 ? __ldg(pat + (plen - 1)) : 0;
  int sym = __ldg(sym_of + a);
  int less_a = __ldg(less + a);
  for (int t = 0; t < plen; ++t) {
    pl = l;
    pr = r;
    if (sym < 0) {
      complete = false;
      break;
    }
    // r < 0 only for an empty text, where rank(r) is 0
    const int2* plane = fused + static_cast<size_t>(sym) * nw;
    const int lm1 = l - 1;
    const int2 er = r >= 0 ? __ldg(plane + (r >> 5)) : make_int2(0, 0);
    const int2 el = lm1 >= 0 && (lm1 >> 5) != (r >> 5) ? __ldg(plane + (lm1 >> 5)) : er;
    const int a1 = t + 1 < plen ? __ldg(pat + (plen - 2 - t)) : 0;
    const int sym1 = __ldg(sym_of + a1);
    const int less1 = __ldg(less + a1);
    const int occ_r = r >= 0 ? count_to(er, r & 31) : 0;
    const int occ_l = lm1 >= 0 ? count_to(el, lm1 & 31) : 0;
    const int l_new = less_a + occ_l;
    const int r_new = less_a + occ_r - 1;
    if (occ_r == 0 || l_new > r_new) {
      complete = false;
      break;
    }
    l = l_new;
    r = r_new;
    ++mlen;
    sym = sym1;
    less_a = less1;
  }
  status[q] = mlen > 0 ? (complete ? COMPLETE : PARTIAL) : ABSENT;
  lower[q] = complete ? l : pl;
  upper[q] = (complete ? r : pr) + 1;
  mlen_out[q] = mlen;
}

__global__ void __launch_bounds__(THREADS) fm_locate_kernel(
    const int2* __restrict__ fused,       // (S, nw) {word, checkpoint}
    const uint8_t* __restrict__ bwt_sym,  // (n,) symbol index a row
    const int* __restrict__ less_sym,     // (S,) less by symbol index
    int S,
    const int* __restrict__ sa_sample,    // (ceil(n / s),) sa[::s]
    const int* __restrict__ sent_rows,    // (k,) sorted sentinel rows
    const int* __restrict__ sent_vals,    // (k,) their suffix-array values
    int n_sent,
    const int* __restrict__ rows,         // (B,)
    int B, int nw, int n, int s, int* __restrict__ out) {
  __shared__ int less_s[256];
  for (int i = threadIdx.x; i < S; i += THREADS) less_s[i] = __ldg(less_sym + i);
  __syncthreads();
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= B) return;
  int pos = __ldg(rows + q);
  if (pos < 0 || pos >= n) {
    out[q] = -1;
    return;
  }
  int offset = 0;
  while (pos % s != 0) {
    const int sym = __ldg(bwt_sym + pos);
    if (sym == 0) break;
    pos = less_s[sym] + rank(fused, nw, pos - 1, sym);
    ++offset;
  }
  int base = 0;
  if (pos % s == 0) {
    base = __ldg(sa_sample + pos / s);
  } else if (n_sent > 0) {
    // searchsorted (left) over the sorted sentinel rows, clamped
    int lo = 0;
    int hi = n_sent;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(sent_rows + mid) < pos) lo = mid + 1;
      else hi = mid;
    }
    const int si = min(lo, n_sent - 1);
    if (__ldg(sent_rows + si) == pos) base = __ldg(sent_vals + si);
  }
  out[q] = base + offset;
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fm_backward_search(const void* fused, const void* less, const void* sym_of,
                       const void* pats, const void* plens, int B, int L,
                       int nw, int n, void* status, void* lower, void* upper,
                       void* mlen, void* stream) {
  fm_search_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(fused), static_cast<const int*>(less),
      static_cast<const int*>(sym_of), static_cast<const uint8_t*>(pats),
      static_cast<const int*>(plens), B, L, nw, n, static_cast<int*>(status),
      static_cast<int*>(lower), static_cast<int*>(upper),
      static_cast<int*>(mlen));
  return static_cast<int>(cudaGetLastError());
}

int fm_locate(const void* fused, const void* bwt_sym, const void* less_sym,
              int S, const void* sa_sample, const void* sent_rows,
              const void* sent_vals, int n_sent, const void* rows, int B,
              int nw, int n, int s, void* out, void* stream) {
  fm_locate_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(fused), static_cast<const uint8_t*>(bwt_sym),
      static_cast<const int*>(less_sym), S,
      static_cast<const int*>(sa_sample), static_cast<const int*>(sent_rows),
      static_cast<const int*>(sent_vals), n_sent,
      static_cast<const int*>(rows), B, nw, n, s, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
