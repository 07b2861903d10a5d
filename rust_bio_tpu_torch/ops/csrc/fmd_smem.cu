// K-SMEM fmd_smems: batched SMEM search over an FMD index. Replaces no
// Pallas kernel: the XLA function
// rust_bio_tpu/data_structures/fmd_device.py _smems_impl, two
// lax.while_loops over a slot axis, the hot loop of the SMEM read mapper's
// seeding (fmindex.rs:367-434 FMDIndex::smems). ops/fmd.py states the
// semantics and holds the plain version; the outputs are bit for bit the
// XLA function's, the overflow flags and the carried lower_rev of mapper
// mode included.
//
// One warp a query (a pattern and a position i), WARPS queries a block.
// - Phase 1 is one dependent chain of forward extensions. A step ranks the
//   KE extension-order symbols at both ends of the reverse interval: lanes
//   0..KE-1 read their symbol's {word, checkpoint} at the low end from the
//   row layout (nw, 2S), lanes 16..16+KE-1 at the high end, so that the two
//   rows (88 bytes each for the 11 DNA symbols, a few 32-byte sectors) are
//   the step's only reads; a 16-lane scan gives the cumulative sizes and a
//   shuffle from the queried symbol's lane the extension. The slot of the
//   n-th append lives in lane n's registers; the phase ends by reversing
//   the slots with one shuffle (newest first, XLA's clipped gather).
// - Phase 2 puts slot e on lane e (E = 16 uses half the warp, the wide
//   retry E = 32 all of it). Each lane ranks its own slot: in mapper mode
//   the queried symbol only, one 8-byte {word, checkpoint} read of the
//   (S, nw, 2) table at each end; in full mode the extension-order
//   symbols up to the queried one from the row layout. The XLA per-slot
//   loop becomes ballots: a slot appends where it can (valid, size != 0)
//   and its size differs from that of the nearest earlier slot that can
//   (a slot that could but did not append had the last appended size), so
//   the dedup is a ballot, a __clz and a shuffle; the emitting slot is the
//   first slot that meets the emit test with no appended slot below it.
//   Slots stay in place between stages, as XLA's; at a stage's end the
//   live slots are compacted in order through shared memory (a ballot and
//   a popcount prefix), and a query with more live slots than the next
//   width retires with ovf.
// - seed_pick (mapper mode, the read mapper's chain head): the warp tracks
//   the first longest stored match and writes the picked row and (start,
//   length, found, ovf) in its epilog, not the (B, MC) outputs.
//
// What bounds it: the chain of dependent rank reads, two a step in phase 1
// and one round of slot reads a step in phase 2 (about (L - i) + i steps a
// query, each an L2 or HBM round trip); the tables (2 x 25 MB for a
// 4.6 Mbp genome's 9.3 M-symbol text) mostly fit the 50 MB L2. The
// arithmetic (popcounts, a 4-step scan, a few ballots) is far below the
// card's rate. Keeping 8192 queries in flight as 8192 warps (all resident
// at 4 warps a block) hides the latency across queries. On an H100 80GB
// HBM3 (700 W) the 8192 middles of chip_smoke.py's 100 bp reads over a
// 4.6 Mbp genome take 0.118 ms of device time in mapper mode at E = 16,
// 3.9x the 0.030 ms that their rank sectors take at the card's memory
// rate (about 30 phase-1 and 30 phase-2 steps a query).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // ops/fmd.py SMEM_WARPS
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int INT32_MIN_V = -2147483647 - 1;
constexpr int DOLLAR = 36;

struct Tables {
  const int2* fused;        // (S, nw) {word, checkpoint}
  const int* rows;          // (nw, 2S): S words, then S checkpoints
  int S;
  int nw;
  const int* less_b;        // (257,) by byte
  const int* sym_of;        // (256,)
  const uint8_t* comp;      // (256,)
  const int* ext_pos;       // (256,) position in $TGCNAtgcna, -1 outside
  const int* ext_sym;       // (11,) symbol index, -1 absent
  int KE;
};

// int32 arithmetic that wraps, as XLA's
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int count_to(int word, int ck, int r) {
  return ck + __popc(static_cast<unsigned>(word) & (0xFFFFFFFFu >> (31 - (r & 31))));
}

// rank of symbol index sym at r: 0 for r < 0, the word clamped into the
// table (XLA's gather)
__device__ __forceinline__ int rank_fused(const Tables& t, int sym, int r) {
  if (r < 0) return 0;
  const int2 e = __ldg(t.fused + static_cast<size_t>(sym) * t.nw + min(r >> 5, t.nw - 1));
  return count_to(e.x, e.y, r);
}

__device__ __forceinline__ int rank_row(const Tables& t, int sym, int r) {
  if (r < 0) return 0;
  const int* row = t.rows + static_cast<size_t>(min(r >> 5, t.nw - 1)) * 2 * t.S;
  return count_to(__ldg(row + sym), __ldg(row + t.S + sym), r);
}

// the queried byte's extension-order column: -1 wraps to KE - 1, a column
// past KE reads XLA's fill value
__device__ __forceinline__ int ext_col(const Tables& t, int a) {
  const int p = __ldg(t.ext_pos + a);
  return p < 0 ? p + t.KE : p;
}

// The backward extension of the warp-uniform bi-interval (lo, lor, sz) by
// byte a, every lane taking part (phase 1).
__device__ __forceinline__ void backward_ext_warp(const Tables& t, int lane, int lo, int lor, int sz, int a,
                                                  int& lo_out, int& lor_out, int& sz_out) {
  const int e = lane & 15;
  const int pos = lane < 16 ? wsub(lo, 1) : wsub(wadd(lo, sz), 1);
  int r = 0;
  if (e < t.KE) {
    const int sym = __ldg(t.ext_sym + e);
    if (sym >= 0) r = rank_row(t, sym, pos);
  }
  const int r_hi = __shfl_down_sync(FULL, r, 16);
  const int o = lo > 0 ? r : 0;
  const int s = wsub(r_hi, o);
  int cum = s;
#pragma unroll
  for (int d = 1; d < 16; d <<= 1) {
    const int v = __shfl_up_sync(FULL, cum, d);
    if (e >= d) cum = wadd(cum, v);
  }
  const int col = ext_col(t, a);
  const bool fill = col >= t.KE;
  const int src = fill ? 0 : col;
  const int ssel = fill ? INT32_MIN_V : __shfl_sync(FULL, s, src);
  const int csel = fill ? INT32_MIN_V : __shfl_sync(FULL, cum, src);
  const int osel = fill ? INT32_MIN_V : __shfl_sync(FULL, o, src);
  lo_out = wadd(__ldg(t.less_b + a), osel);
  lor_out = wadd(lor, wsub(csel, ssel));
  sz_out = ssel;
}

// One lane's backward extension of its own slot, full mode: the
// extension-order symbols up to the queried one, at both ends.
__device__ __forceinline__ void backward_ext_lane(const Tables& t, int lo, int lor, int sz, int a, int col,
                                                  int& lo_out, int& lor_out, int& sz_out) {
  const int hi = wsub(wadd(lo, sz), 1);
  const int lm1 = wsub(lo, 1);
  int cum = 0;
  int ssel = INT32_MIN_V, csel = INT32_MIN_V, osel = INT32_MIN_V;
  if (col < t.KE) {
    for (int e = 0; e <= col; ++e) {
      const int sym = __ldg(t.ext_sym + e);
      int o = 0, s = 0;
      if (sym >= 0) {
        o = lo > 0 ? rank_row(t, sym, lm1) : 0;
        s = wsub(rank_row(t, sym, hi), o);
      }
      cum = wadd(cum, s);
      ssel = s;
      osel = o;
    }
    csel = cum;
  }
  lo_out = wadd(__ldg(t.less_b + a), osel);
  lor_out = wadd(lor, wsub(csel, ssel));
  sz_out = ssel;
}

template <bool MAPPER>
__global__ void __launch_bounds__(THREADS) fmd_smems_kernel(
    Tables t, const uint8_t* __restrict__ pats, const int* __restrict__ plens,
    const int* __restrict__ iis, int B, int L, int l_min, int E, int MC,
    int n_stages, int lim0, int lim1, int lim2, int w1, int w2, int w3,
    int* __restrict__ m_lo, int* __restrict__ m_lor, int* __restrict__ m_sz,
    int* __restrict__ m_st, int* __restrict__ m_ml, int* __restrict__ mcnt_out,
    uint8_t* __restrict__ ovf_out, int* __restrict__ pick_rows,
    int* __restrict__ pick) {
  __shared__ int stage_buf[WARPS][4][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= B) return;  // the whole warp
  const unsigned lt = (1u << lane) - 1u;
  const uint8_t* pat = pats + static_cast<size_t>(q) * L;
  const int plen = __ldg(plens + q);
  const int ii = min(max(__ldg(iis + q), 0), L - 1);
  const bool outs = m_lo != nullptr;
  if (outs) {
    for (int c = lane; c < MC; c += 32) {
      const size_t o = static_cast<size_t>(q) * MC + c;
      m_lo[o] = 0; m_lor[o] = 0; m_sz[o] = 0; m_st[o] = 0; m_ml[o] = 0;
    }
  }

  // ---- phase 1: forward extensions from position ii ----
  const int a0 = __ldg(pat + ii);
  int lo = __ldg(t.less_b + a0);
  int lor = __ldg(t.less_b + __ldg(t.comp + a0));
  int sz = wsub(__ldg(t.less_b + a0 + 1), lo);
  int mlen = sz != 0;
  int my_lo = 0, my_lor = 0, my_sz = 0, my_ml = 0;
  int cnt = 0;
  bool ovf = false;
  for (int step = 1; step <= L; ++step) {
    const int pos = ii + step;
    if (pos >= plen) break;
    const int a = __ldg(pat + min(pos, L - 1));
    // forward extension: the backward one of the swapped interval by the
    // complement
    int flor, flo, fsz;
    backward_ext_warp(t, lane, lor, lo, sz, __ldg(t.comp + a), flor, flo, fsz);
    if (sz != fsz) {
      if (cnt < E && lane == cnt) {
        my_lo = lo; my_lor = lor; my_sz = sz; my_ml = mlen;
      }
      ovf = ovf || cnt >= E;
      ++cnt;
    }
    if (fsz == 0) break;
    lo = flo; lor = flor; sz = fsz;
    ++mlen;
  }
  if (cnt < E && lane == cnt) {
    my_lo = lo; my_lor = lor; my_sz = sz; my_ml = mlen;
  }
  ovf = ovf || cnt >= E;
  ++cnt;
  // newest first: slot e takes append min(max(cnt - 1 - e, 0), E - 1)
  const int src = min(max(cnt - 1 - lane, 0), E - 1);
  int s_lo = __shfl_sync(FULL, my_lo, src);
  int s_lor = __shfl_sync(FULL, my_lor, src);
  int s_sz = __shfl_sync(FULL, my_sz, src);
  int s_ml = __shfl_sync(FULL, my_ml, src);
  bool valid = lane < E && lane < cnt;

  // ---- phase 2: backward sweep k = ii - 1 .. -1 ----
  int j = plen;
  int mcnt = 0;
  int best_cur = -1, best_st = 0, best_ml = 0, best_lo = 0;
  int stage = 0;
  int next_lim = n_stages > 1 ? lim0 : 0x7FFFFFFF;
  for (int tau = 1;; ++tau) {
    if (tau > next_lim) {
      // narrow the slots to the next stage's width, live slots first
      const int ec = stage == 0 ? w1 : (stage == 1 ? w2 : w3);
      const unsigned V = __ballot_sync(FULL, valid);
      const int nvalid = __popc(V);
      if (nvalid > ec) {
        ovf = true;
        break;
      }
      const int dst = __popc(V & lt);
      if (valid) {
        stage_buf[warp][0][dst] = s_lo;
        stage_buf[warp][1][dst] = s_lor;
        stage_buf[warp][2][dst] = s_sz;
        stage_buf[warp][3][dst] = s_ml;
      }
      __syncwarp();
      valid = lane < nvalid;
      if (valid) {
        s_lo = stage_buf[warp][0][lane];
        s_lor = stage_buf[warp][1][lane];
        s_sz = stage_buf[warp][2][lane];
        s_ml = stage_buf[warp][3][lane];
      }
      __syncwarp();
      ++stage;
      next_lim = stage + 1 < n_stages ? (stage == 1 ? lim1 : lim2) : 0x7FFFFFFF;
    }
    const int k = ii - tau;
    const int a = k == -1 ? DOLLAR : __ldg(pat + max(k, 0));
    int elo = 0, elor = s_lor, esz = 0;
    if (valid) {
      if (MAPPER) {
        const int sym = __ldg(t.sym_of + a);
        int o = 0, hi_rank = 0;
        if (sym >= 0) {
          o = s_lo > 0 ? rank_fused(t, sym, wsub(s_lo, 1)) : 0;
          hi_rank = rank_fused(t, sym, wsub(wadd(s_lo, s_sz), 1));
        }
        esz = wsub(hi_rank, o);
        elo = wadd(__ldg(t.less_b + a), o);
      } else {
        backward_ext_lane(t, s_lo, s_lor, s_sz, a, ext_col(t, a), elo, elor, esz);
      }
    }
    const bool can = valid && esz != 0;
    const unsigned C = __ballot_sync(FULL, can);
    const unsigned below = C & lt;
    const int p = below ? 31 - __clz(below) : 0;
    const int last_v = __shfl_sync(FULL, esz, p);
    const int last = below ? last_v : -1;
    const bool app = can && esz != last;
    const unsigned A = __ballot_sync(FULL, app);
    const bool em = valid && (esz == 0 || k == -1) && k < j && s_ml >= l_min;
    const unsigned Em = __ballot_sync(FULL, em);
    // a slot may emit where no slot below it appended: lanes 0..first app
    const unsigned allowed = A ? (2u << (__ffs(A) - 1)) - 1u : FULL;
    const unsigned Ew = Em & allowed;
    if (Ew) {
      const int es = __ffs(Ew) - 1;
      const int v_lo = __shfl_sync(FULL, s_lo, es);
      const int v_lor = __shfl_sync(FULL, s_lor, es);
      const int v_sz = __shfl_sync(FULL, s_sz, es);
      const int v_ml = __shfl_sync(FULL, s_ml, es);
      if (mcnt < MC) {
        if (outs && lane == (mcnt & 31)) {
          const size_t o = static_cast<size_t>(q) * MC + mcnt;
          m_lo[o] = v_lo; m_lor[o] = v_lor; m_sz[o] = v_sz; m_st[o] = k + 1; m_ml[o] = v_ml;
        }
        if (v_ml > best_cur) {
          best_cur = v_ml; best_st = k + 1; best_ml = v_ml; best_lo = v_lo;
        }
      } else {
        ovf = true;
      }
      ++mcnt;
      j = k;
    }
    if (app) {
      s_lo = elo; s_lor = elor; s_sz = esz; ++s_ml;
    }
    valid = app;
    if (A == 0 || k <= -1) break;
  }
  if (lane == 0) {
    if (outs) {
      mcnt_out[q] = mcnt;
      ovf_out[q] = ovf;
    }
    if (pick != nullptr) {
      const bool found = mcnt > 0 && !ovf;
      pick_rows[q] = found ? best_lo : 0;
      pick[q] = best_st;
      pick[static_cast<size_t>(B) + q] = best_ml;
      pick[2 * static_cast<size_t>(B) + q] = found;
      pick[3 * static_cast<size_t>(B) + q] = ovf;
    }
  }
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fmd_smems(const void* fused, const void* rows, int S, int nw,
              const void* less_b, const void* sym_of, const void* comp,
              const void* ext_pos, const void* ext_sym, int KE,
              const void* pats, const void* plens, const void* iis, int B,
              int L, int l_min, int E, int MC, int mapper, int n_stages,
              int lim0, int lim1, int lim2, int w1, int w2, int w3,
              void* m_lo, void* m_lor, void* m_sz, void* m_st, void* m_ml,
              void* mcnt, void* ovf, void* pick_rows, void* pick,
              void* stream) {
  const Tables t{static_cast<const int2*>(fused), static_cast<const int*>(rows), S, nw,
                 static_cast<const int*>(less_b), static_cast<const int*>(sym_of),
                 static_cast<const uint8_t*>(comp), static_cast<const int*>(ext_pos),
                 static_cast<const int*>(ext_sym), KE};
  const int blocks = (B + WARPS - 1) / WARPS;
  auto launch = mapper ? fmd_smems_kernel<true> : fmd_smems_kernel<false>;
  launch<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const uint8_t*>(pats), static_cast<const int*>(plens),
      static_cast<const int*>(iis), B, L, l_min, E, MC, n_stages, lim0, lim1,
      lim2, w1, w2, w3, static_cast<int*>(m_lo), static_cast<int*>(m_lor),
      static_cast<int*>(m_sz), static_cast<int*>(m_st), static_cast<int*>(m_ml),
      static_cast<int*>(mcnt), static_cast<uint8_t*>(ovf),
      static_cast<int*>(pick_rows), static_cast<int*>(pick));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
