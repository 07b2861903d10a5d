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
//
// The uint32 index (2^31 <= n < 2^32 - 1, or force_u32; fm_device.py _rank
// and the u32 _locate_impl): K4, K4-LUT and K4-locate are templated on the
// index type Idx, int or unsigned, and K4 and K4-LUT run one loop,
// search_steps. With unsigned, 0xFFFFFFFF takes the role of -1 (an l - 1
// or a row -1 wraps to exactly that value); the word index pos >> 5 stays
// below 2^27 and the rank counts, per symbol, below 2^31, so both stay int.
//
// K4-LUT fm_search_lut: K4 entered at step q from one gather of a (4^q, 2)
// table of the intervals of every DNA q-mer (fm_device.py build_kmer_lut),
// indexed by the pattern's q-suffix code sum_t lut_rank[byte_t] * 4^t (step
// t reads pats[q, plen-1-t]). Replaces no Pallas kernel: the XLA search
// fm_device.py _search_lut_impl, whose miss lanes (plen < q, a byte outside
// the four DNA bytes, or an empty q-mer interval l0 > r0) go back to the
// host and re-run in a second search; here a miss lane runs K4's whole
// loop in the same launch, so the result is K4's on every lane, and the
// kernel writes the miss mask beside it. What bounds it: the q code bytes
// (one coalesced load each, off the chain) and one 8-byte LUT gather
// replace q dependent rank steps; the remaining L - q steps are K4's chain.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // ops/fm.py FM_THREADS
constexpr int ABSENT = 0;
constexpr int PARTIAL = 1;
constexpr int COMPLETE = 2;

// a position that is not -1 (int) / 0xFFFFFFFF (unsigned)
template <typename Idx>
__device__ __forceinline__ bool live(Idx p) {
  if constexpr (std::is_signed<Idx>::value) {
    return p >= 0;
  } else {
    return p != ~0u;
  }
}

// occurrences in a rank-table entry {word, exclusive count} up to and
// including bit ``bitpos`` (0..31)
__device__ __forceinline__ int count_to(int2 e, int bitpos) {
  return e.y + __popc(static_cast<unsigned>(e.x) & (0xFFFFFFFFu >> (31 - bitpos)));
}

template <typename Idx>
__device__ __forceinline__ int rank(const int2* __restrict__ fused, int nw,
                                    Idx pos, int sym) {
  if (!live(pos)) return 0;
  return count_to(__ldg(fused + static_cast<size_t>(sym) * nw + (pos >> 5)),
                  static_cast<int>(pos & 31));
}

// K4's loop from step t0 with the interval [l, r] and
// mlen matched steps: the query's outputs. Step t's byte, symbol and less
// are loaded during step t - 1.
template <typename Idx>
__device__ __forceinline__ void search_steps(
    const int2* __restrict__ fused, const Idx* __restrict__ less,
    const int* __restrict__ sym_of, const uint8_t* pat, int plen, int nw,
    int t0, Idx l, Idx r, int mlen, int q, int* __restrict__ status,
    Idx* __restrict__ lower, Idx* __restrict__ upper,
    int* __restrict__ mlen_out) {
  Idx pl = l;
  Idx pr = r;
  bool complete = true;
  int a = plen > t0 ? __ldg(pat + (plen - 1 - t0)) : 0;
  int sym = __ldg(sym_of + a);
  Idx less_a = __ldg(less + a);
  for (int t = t0; t < plen; ++t) {
    pl = l;
    pr = r;
    if (sym < 0) {
      complete = false;
      break;
    }
    // r is -1 only for an empty text, where rank(r) is 0
    const int2* plane = fused + static_cast<size_t>(sym) * nw;
    const Idx lm1 = l - 1;
    const int2 er = live(r) ? __ldg(plane + (r >> 5)) : make_int2(0, 0);
    const int2 el = live(lm1) && (lm1 >> 5) != (r >> 5) ? __ldg(plane + (lm1 >> 5)) : er;
    const int a1 = t + 1 < plen ? __ldg(pat + (plen - 2 - t)) : 0;
    const int sym1 = __ldg(sym_of + a1);
    const Idx less1 = __ldg(less + a1);
    const int occ_r = live(r) ? count_to(er, static_cast<int>(r & 31)) : 0;
    const int occ_l = live(lm1) ? count_to(el, static_cast<int>(lm1 & 31)) : 0;
    const Idx l_new = less_a + occ_l;
    const Idx r_new = less_a + occ_r - 1;
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

// K4: the loop from step 0 over the whole interval [0, n - 1].
template <typename Idx>
__global__ void __launch_bounds__(THREADS) fm_search_kernel(
    const int2* __restrict__ fused,     // (S, nw) {word, checkpoint}
    const Idx* __restrict__ less,       // (256,) less by byte
    const int* __restrict__ sym_of,     // (256,) symbol index, -1 outside
    const uint8_t* __restrict__ pats,   // (B, L)
    const int* __restrict__ plens,      // (B,)
    int B, int L, int nw, Idx n,
    int* __restrict__ status, Idx* __restrict__ lower,
    Idx* __restrict__ upper, int* __restrict__ mlen_out) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= B) return;
  search_steps<Idx>(fused, less, sym_of, pats + static_cast<size_t>(q) * L,
                    __ldg(plens + q), nw, 0, 0, n - 1, 0, q, status, lower,
                    upper, mlen_out);
}

template <typename Idx>
__global__ void __launch_bounds__(THREADS) fm_search_lut_kernel(
    const int2* __restrict__ fused,     // (S, nw) {word, checkpoint}
    const Idx* __restrict__ less,       // (256,) less by byte
    const int* __restrict__ sym_of,     // (256,) symbol index, -1 outside
    const int* __restrict__ lut_rank,   // (256,) DNA rank 0-3 by byte, -1 else
    const Idx* __restrict__ lut,        // (4^q, 2) {l0, r0} by q-suffix code
    int lut_q,
    const uint8_t* __restrict__ pats,   // (B, L)
    const int* __restrict__ plens,      // (B,)
    int B, int L, int nw, Idx n,
    int* __restrict__ status, Idx* __restrict__ lower,
    Idx* __restrict__ upper, int* __restrict__ mlen_out,
    uint8_t* __restrict__ miss_out) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= B) return;
  const int plen = __ldg(plens + q);
  const uint8_t* pat = pats + static_cast<size_t>(q) * L;
  bool miss = plen < lut_q;
  int code = 0;
  for (int t = 0; t < lut_q && !miss; ++t) {
    const int lr = __ldg(lut_rank + __ldg(pat + (plen - 1 - t)));
    miss = lr < 0;
    code |= lr << (2 * t);
  }
  Idx l0 = 0;
  Idx r0 = n - 1;
  if (!miss) {
    l0 = __ldg(lut + 2 * static_cast<size_t>(code));
    r0 = __ldg(lut + 2 * static_cast<size_t>(code) + 1);
    miss = l0 > r0;
  }
  miss_out[q] = miss;
  if (miss) {
    search_steps<Idx>(fused, less, sym_of, pat, plen, nw, 0, 0, n - 1, 0, q,
                      status, lower, upper, mlen_out);
  } else {
    search_steps<Idx>(fused, less, sym_of, pat, plen, nw, lut_q, l0, r0,
                      lut_q, q, status, lower, upper, mlen_out);
  }
}

template <typename Idx>
__global__ void __launch_bounds__(THREADS) fm_locate_kernel(
    const int2* __restrict__ fused,       // (S, nw) {word, checkpoint}
    const uint8_t* __restrict__ bwt_sym,  // (n,) symbol index a row
    const Idx* __restrict__ less_sym,     // (S,) less by symbol index
    int S,
    const Idx* __restrict__ sa_sample,    // (ceil(n / s),) sa[::s]
    const Idx* __restrict__ sent_rows,    // (k,) sorted sentinel rows
    const Idx* __restrict__ sent_vals,    // (k,) their suffix-array values
    int n_sent,
    const Idx* __restrict__ rows,         // (B,)
    int B, int nw, Idx n, Idx s, Idx* __restrict__ out) {
  __shared__ Idx less_s[256];
  for (int i = threadIdx.x; i < S; i += THREADS) less_s[i] = __ldg(less_sym + i);
  __syncthreads();
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= B) return;
  Idx pos = __ldg(rows + q);
  if (!live(pos) || pos >= n) {
    out[q] = static_cast<Idx>(-1);
    return;
  }
  Idx offset = 0;
  while (pos % s != 0) {
    const int sym = __ldg(bwt_sym + pos);
    if (sym == 0) break;
    pos = less_s[sym] + rank(fused, nw, pos - 1, sym);
    ++offset;
  }
  Idx base = 0;
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

template <typename Idx>
int search(const void* fused, const void* less, const void* sym_of,
           const void* pats, const void* plens, int B, int L, int nw, Idx n,
           void* status, void* lower, void* upper, void* mlen, void* stream) {
  fm_search_kernel<Idx><<<(B + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(fused), static_cast<const Idx*>(less),
      static_cast<const int*>(sym_of), static_cast<const uint8_t*>(pats),
      static_cast<const int*>(plens), B, L, nw, n, static_cast<int*>(status),
      static_cast<Idx*>(lower), static_cast<Idx*>(upper),
      static_cast<int*>(mlen));
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int search_lut(const void* fused, const void* less, const void* sym_of,
               const void* lut_rank, const void* lut, int lut_q,
               const void* pats, const void* plens, int B, int L, int nw,
               Idx n, void* status, void* lower, void* upper, void* mlen,
               void* miss, void* stream) {
  fm_search_lut_kernel<Idx><<<(B + THREADS - 1) / THREADS, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(fused), static_cast<const Idx*>(less),
      static_cast<const int*>(sym_of), static_cast<const int*>(lut_rank),
      static_cast<const Idx*>(lut), lut_q, static_cast<const uint8_t*>(pats),
      static_cast<const int*>(plens), B, L, nw, n, static_cast<int*>(status),
      static_cast<Idx*>(lower), static_cast<Idx*>(upper),
      static_cast<int*>(mlen), static_cast<uint8_t*>(miss));
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int locate(const void* fused, const void* bwt_sym, const void* less_sym,
           int S, const void* sa_sample, const void* sent_rows,
           const void* sent_vals, int n_sent, const void* rows, int B, int nw,
           Idx n, Idx s, void* out, void* stream) {
  fm_locate_kernel<Idx><<<(B + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(fused), static_cast<const uint8_t*>(bwt_sym),
      static_cast<const Idx*>(less_sym), S,
      static_cast<const Idx*>(sa_sample), static_cast<const Idx*>(sent_rows),
      static_cast<const Idx*>(sent_vals), n_sent,
      static_cast<const Idx*>(rows), B, nw, n, s, static_cast<Idx*>(out));
  return static_cast<int>(cudaGetLastError());
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
  return search<int>(fused, less, sym_of, pats, plens, B, L, nw, n, status,
                     lower, upper, mlen, stream);
}

int fm_backward_search_u32(const void* fused, const void* less,
                           const void* sym_of, const void* pats,
                           const void* plens, int B, int L, int nw,
                           long long n, void* status, void* lower,
                           void* upper, void* mlen, void* stream) {
  return search<unsigned>(fused, less, sym_of, pats, plens, B, L, nw,
                          static_cast<unsigned>(n), status, lower, upper,
                          mlen, stream);
}

int fm_search_lut(const void* fused, const void* less, const void* sym_of,
                  const void* lut_rank, const void* lut, int lut_q,
                  const void* pats, const void* plens, int B, int L, int nw,
                  int n, void* status, void* lower, void* upper, void* mlen,
                  void* miss, void* stream) {
  return search_lut<int>(fused, less, sym_of, lut_rank, lut, lut_q, pats,
                         plens, B, L, nw, n, status, lower, upper, mlen, miss,
                         stream);
}

int fm_search_lut_u32(const void* fused, const void* less, const void* sym_of,
                      const void* lut_rank, const void* lut, int lut_q,
                      const void* pats, const void* plens, int B, int L,
                      int nw, long long n, void* status, void* lower,
                      void* upper, void* mlen, void* miss, void* stream) {
  return search_lut<unsigned>(fused, less, sym_of, lut_rank, lut, lut_q, pats,
                              plens, B, L, nw, static_cast<unsigned>(n),
                              status, lower, upper, mlen, miss, stream);
}

int fm_locate(const void* fused, const void* bwt_sym, const void* less_sym,
              int S, const void* sa_sample, const void* sent_rows,
              const void* sent_vals, int n_sent, const void* rows, int B,
              int nw, int n, int s, void* out, void* stream) {
  return locate<int>(fused, bwt_sym, less_sym, S, sa_sample, sent_rows,
                     sent_vals, n_sent, rows, B, nw, n, s, out, stream);
}

int fm_locate_u32(const void* fused, const void* bwt_sym, const void* less_sym,
                  int S, const void* sa_sample, const void* sent_rows,
                  const void* sent_vals, int n_sent, const void* rows, int B,
                  int nw, long long n, int s, void* out, void* stream) {
  return locate<unsigned>(fused, bwt_sym, less_sym, S, sa_sample, sent_rows,
                          sent_vals, n_sent, rows, B, nw,
                          static_cast<unsigned>(n), static_cast<unsigned>(s),
                          out, stream);
}

}  // extern "C"
