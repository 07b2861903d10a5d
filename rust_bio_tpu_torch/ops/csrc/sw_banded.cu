// K16 sw_scan_banded: the banded clip-mode DP of the banded aligner. Replaces
// rust_bio_tpu/ops/sw_pallas.py scan_banded_pallas_mp -> _kernel_scan_banded_mp
// (itself the device twin of alignment/pairwise/banded.py compute_alignment,
// banded.rs:406-766): the general-clip DP restricted to per-column row bands
// [starts[j], ends[j]).
//
// Outputs (the Pallas contract, sw_pallas.py:2865-2869, in a pair-major
// layout): tb (B, N, Xp) uint16, Xp = M + 1 rounded up to 8, column j's
// 12-bit cells i | d << 4 | s << 8 at [b, j - 1, i], 0 (the caller
// zero-fills) outside the cells the host writes (ops/sw.py returns its
// (N, M + 1, B) view, which K16-walk reads through its strides); lx (N, B),
// column j's x-suffix clip length (zero-filled); the finals after column
// nlens S, I, Sn, Ly and the cells tbk, each (B, M + 1). Columns past nlens
// are left 0 (the Pallas kernel writes them from the frozen state; nothing
// reads them).
//
// Design: one warp a pair, columns in order, and in each column only the
// rows the host touches: row 0, the band rows [max(1, st), en), row m, and
// the fringe resets (row st - 1 and rows [en, min(m + 1, ends[min(n, j +
// 1)]))). The band rows go 64 at a time (a chunk), lane t on the chunk's
// rows 2t and 2t + 1: the aligner's bands are 33 rows wide at k = w = 8,
// one chunk a column (32 rows a chunk took two, 1.80 against 1.46 ms on
// the 1 kb reads; scripts/banded_trial.py). Everything a band row needs
// from the previous column is parallel over the rows; the insertion chain
// is the Pallas kernel's (max,+) prefix scan (sw_pallas.py:2731, bestI =
// cummax(T - i * ge) + i * ge): over a lane's two rows, then a warp
// inclusive max-scan of five __shfl_up_sync, carried from chunk to chunk;
// the row above's S~, Sn, I and s-bits come down one lane with
// __shfl_up_sync; the x-suffix running maximum over the rows < m and its
// first row are two warp reductions a chunk (__reduce_max_sync /
// __reduce_min_sync). Row m takes the reduced maximum after its own chunk's
// reduction, which holds every band row above it. A column is a chain of
// about 12 dependent shuffles and reductions and the cells' arithmetic.
// Its results are the Pallas kernel's, bit for bit, including what the
// host's two-buffer state leaves out of the band:
//  - S and D live in two parity buffers (column j writes buffer j % 2): a row
//    outside the band and the resets keeps the value of column j - 2, which
//    the suffix fixups read at row ends[n] (banded_device.py:127-130);
//  - I has one buffer, as in the Pallas kernel: outside the band a row keeps
//    the previous column's value, or MIN after a reset;
//  - the chain's first band row opens from MIN + ge (the reset row above), and
//    in the last column also from Sn[i - 1] + go on every row above the band
//    (the Pallas chain runs over all rows: here a warp reduction over rows
//    1..st - 1); in columns where gap_open == gap_extend the first band
//    row's i-bits may copy the s-bits of the row above the band, so that
//    one row's take chain is evaluated too;
//  - the Del cell bits copy the s-bits the previous column left in the tb:
//    0 where it wrote no cell. Each cell's s-bits also go to a layer,
//    stamped with their column (column 0's, which the caller writes from
//    its torch twin, with 0), and a stamp other than j - 1 reads as that 0;
//    reading them back from the tb instead costs a global load's latency a
//    column (scripts/banded_trial.py: 1.80 against 1.46 ms on the 1 kb
//    reads, 9.74 against 7.19 on the STR pairs).
// Per-pair state: S and D twice, I, Sn, Ly and the stamped s-bits, 8 int32
// layers of M + 1 rows as [layer][row], in the warp's slice of shared
// memory (up to M = 7,263; 179 KB at M = 5,600), else in a (B, 8, M + 1)
// device scratch; Sn and Ly of row 0 stay in registers. A block holds
// `warps` pairs (ops/sw.py banded_geometry picks them so the blocks spread
// over the SMs).
//
// Bound on this card: the dense tb the caller zero-fills (bytes), or 56 32-bit
// operations a band cell (operations; chip_smoke.py K16_OPS_PER_CELL counts
// them from the band rows below); the chain down a column makes it
// latency-bound: about 2,200 cycles a column, one or two warps an SM.
//
// Exactness: int32 arithmetic wraps as in XLA; MIN_I32 = -858993459; the
// x-suffix running maximum starts at -2^31 + 1 and counts only above MIN_I32;
// every selection is a strict '>' with priority Match/Subst > Ins > Del >
// Xclip-prefix > Yclip-prefix; the chain sentinel is -1,500,000,000.
// Requires starts, ends <= mlens + 1 (banded.Band's rows) and 1 <= mlens;
// the lengths are clamped into [0, M] / [0, N] and the rows into
// [0, mlens + 1], so no read or write leaves the tensors whatever the caller
// passes (the caller checks them on the host).

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TB_START = 0;
constexpr int TB_INS = 1;
constexpr int TB_DEL = 2;
constexpr int TB_SUBST = 3;
constexpr int TB_XCLIP_PREFIX = 5;
constexpr int TB_XCLIP_SUFFIX = 6;
constexpr int TB_YCLIP_PREFIX = 7;
constexpr int TB_YCLIP_SUFFIX = 8;
constexpr int MIN_I32 = -858993459;  // reference MIN_SCORE
constexpr int SENT = -2147483647;    // -2^31 + 1: the empty running maximum
constexpr int SENT2 = -1500000000;   // the Pallas chain sentinel
constexpr int LANES = 32;
constexpr int WARPS_MAX = 8;         // pairs (warps) a block
constexpr int LANE_ROWS = 2;         // band rows a lane computes in a chunk
constexpr int CHUNK = LANES * LANE_ROWS;
constexpr int LAYERS = 8;            // S0, S1, D0, D1, I, Sn, Ly, the stamped s-bits
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may opt into

// int32 add / multiply that wrap like XLA's (signed overflow is UB in C++)
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// s, bits <- cand, cbits when cand is strictly greater
__device__ __forceinline__ void take(int& s, int& bits, int cand, int cbits) {
  if (cand > s) {
    s = cand;
    bits = cbits;
  }
}

// v from lane - 1, or `edge` on lane 0
__device__ __forceinline__ int from_above(int v, int edge, int lane) {
  const int up = __shfl_up_sync(FULL, v, 1);
  return lane == 0 ? edge : up;
}

struct Pens {
  int go, ge, xcp, xcs, ycp, ycs, ma, mi;
};

__global__ void __launch_bounds__(WARPS_MAX * LANES) scan_banded_kernel(
    const uint8_t* __restrict__ xb,  // (B, M)
    const uint8_t* __restrict__ yb,  // (B, N)
    const int* __restrict__ mlens, const int* __restrict__ nlens,
    const int* __restrict__ starts,  // (B, N + 1)
    const int* __restrict__ ends,    // (B, N + 1)
    int B, int M, int N, int Xp, Pens p,
    uint16_t* tb,                    // (B, N, Xp), zeroed; its last column is read back
    int* __restrict__ lx,            // (N, B), zeroed
    int* __restrict__ s_f, int* __restrict__ i_f, int* __restrict__ sn_f,
    int* __restrict__ ly_f, int* __restrict__ tbk,  // (B, M + 1) each
    int* __restrict__ scratch) {                    // (B, 8, M + 1) or null
  extern __shared__ int smem[];
  const int lane = threadIdx.x % LANES;
  const int b = blockIdx.x * (blockDim.x / LANES) + threadIdx.x / LANES;
  if (b >= B) return;  // the whole warp
  const int rows = M + 1;
  const size_t per_pair = static_cast<size_t>(LAYERS) * rows;
  int* const base = scratch ? scratch + static_cast<size_t>(b) * per_pair
                            : smem + static_cast<size_t>(threadIdx.x / LANES) * per_pair;
  auto L = [&](int k, int i) -> int& { return base[static_cast<size_t>(k) * rows + i]; };
  // layers: S buffers 0/1, D buffers 2/3, I 4, Sn 5, Ly 6, the stamped s-bits 7
  constexpr int I_ = 4, SN = 5, LY = 6, SBITS = 7;
  const int ml = min(max(mlens[b], 0), M);
  const int nl = min(max(nlens[b], 0), N);
  const int* st_b = starts + static_cast<size_t>(b) * (N + 1);
  const int* en_b = ends + static_cast<size_t>(b) * (N + 1);
  const uint8_t* x_b = xb + static_cast<size_t>(b) * M;  // x_r at x_b[r - 1]
  uint16_t* const tb_b = tb + static_cast<size_t>(b) * N * Xp;
  const int go = p.go, ge = p.ge, xcp = p.xcp, xcs = p.xcs, ycp = p.ycp, ycs = p.ycs;

  // ---- column 0 (sw_pallas.py:2567-2638), rows over the lanes ----
  const int st0 = min(max(st_b[0], 0), ml + 1);
  const int en0 = min(max(en_b[0], 0), ml + 1);
  const int clip_i = add(xcp, go);
  {
    int acc = SENT;  // max of S + xcs over in-band rows 1..m-1
    for (int i = lane; i <= ml; i += LANES) {
      const bool in_b0 = i >= 1 && i >= st0 && i < en0;
      const int gap_i = add(go, mul(ge, i - 1));
      const int i0 = i == 1 ? go : (gap_i > clip_i ? gap_i : clip_i);
      int s = MIN_I32, sb = TB_START;
      take(s, sb, i0, TB_INS);
      take(s, sb, xcp, TB_XCLIP_PREFIX);
      if (in_b0 && i <= ml - 1) acc = max(acc, add(s, xcs));
      L(0, i) = in_b0 ? s : MIN_I32;
      L(1, i) = MIN_I32;
      L(2, i) = MIN_I32;
      L(3, i) = MIN_I32;
      L(I_, i) = in_b0 ? i0 : MIN_I32;
      L(SBITS, i) = in_b0 ? sb : TB_START;
      L(SN, i) = MIN_I32;
      L(LY, i) = 0;
    }
    acc = __reduce_max_sync(FULL, acc);
    __syncwarp();
    if (lane == 0) {
      if (ml >= 1) {
        const bool upd = acc > MIN_I32;
        int s_m = upd ? acc : MIN_I32;
        int sb_m = TB_XCLIP_SUFFIX;
        take(s_m, sb_m, L(I_, ml), TB_INS);
        take(s_m, sb_m, xcp, TB_XCLIP_PREFIX);
        if (!(ml >= st0 && ml < en0)) {
          s_m = MIN_I32;
          sb_m = upd ? TB_XCLIP_SUFFIX : TB_START;
        }
        L(0, ml) = s_m;
        L(SBITS, ml) = sb_m;
      }
      L(0, 0) = st0 == 0 ? 0 : MIN_I32;
      L(SBITS, 0) = TB_START;
    }
    __syncwarp();
  }
  // Sn and Ly of row 0, the same in every lane
  int sn0 = ycp > ycs ? ycp : ycs;
  int ly0 = ycp > ycs ? 0 : nl;

  // ---- columns 1..nlens; a column's band, y byte and post-reset bound are
  // read a column ahead ----
  const int d_clip = add(ycp, go);
  const uint8_t* y_b = yb + static_cast<size_t>(b) * N;  // y_j at y_b[j - 1]
  int st_raw = nl >= 1 ? st_b[1] : 0;
  int en_raw = nl >= 1 ? en_b[1] : 0;
  int en_after = nl >= 1 ? en_b[min(2, nl)] : 0;
  int y_raw = nl >= 1 ? y_b[0] : 0;
  for (int j = 1; j <= nl; ++j) {
    const int cur = j & 1, prv = cur ^ 1;  // S layer; D layer is 2 + parity
    const bool last = j == nl;
    const int stj = min(max(st_raw, 0), ml + 1);
    const int enj = min(max(en_raw, 0), ml + 1);
    const int r_end = min(ml + 1, en_after);  // the post-reset bound, ends[min(j + 1, nl)]
    const bool r0 = stj == 0;
    const int yj = y_raw;
    {
      const int jn = min(j + 1, nl);
      st_raw = st_b[jn];
      en_raw = en_b[jn];
      en_after = en_b[min(jn + 1, nl)];
      y_raw = y_b[jn - 1];
    }
    uint16_t* tbcol = tb_b + static_cast<size_t>(j - 1) * Xp;
    // the s-bits of cell (r, j - 1), 0 where column j - 1 wrote none: each
    // written cell's s-bits sit in the layer stamped with their column
    // (column 0's with 0)
    auto sb_prev = [&](int r) {
      const int w = L(SBITS, r);
      return (w >> 4) == j - 1 ? w & 0xF : TB_START;
    };
    // a cell of this column: into the tb, and its s-bits into the layer
    auto put_cell = [&](int r, int cell) {
      tbcol[r] = static_cast<uint16_t>(cell);
      L(SBITS, r) = ((cell >> 8) & 0xF) | (j << 4);
    };

    // row 0: Del against the y-prefix clip, computed iff the band starts at
    // 0; no Sn merge into S
    const int d_gap = add(go, mul(ge, j - 1));
    int dj0, db0;
    if (j == 1) {
      dj0 = go;
      db0 = TB_START;
    } else if (d_gap > d_clip) {
      dj0 = d_gap;
      db0 = TB_DEL;
    } else {
      dj0 = d_clip;
      db0 = TB_YCLIP_PREFIX;
    }
    const int s0j = dj0 > ycp ? dj0 : ycp;
    const int sb0j = dj0 > ycp ? TB_DEL : TB_YCLIP_PREFIX;
    if (r0 && add(s0j, ycs) > sn0) {
      sn0 = add(s0j, ycs);
      ly0 = nl - j;
    }
    const int xclip = add(xcp, max(last ? max(ycp, sn0) : ycp, d_gap));

    // fringe resets on this column's buffers (computed rows overwrite them;
    // a row is reset and written by one lane, in that order)
    if (lane == 0 && stj >= 1) {
      L(cur, stj - 1) = MIN_I32;
      L(2 + cur, stj - 1) = MIN_I32;
      L(I_, stj - 1) = MIN_I32;
    }
    for (int r = enj + lane; r < r_end; r += LANES) {
      L(cur, r) = MIN_I32;
      L(2 + cur, r) = MIN_I32;
      L(I_, r) = MIN_I32;
    }
    if (lane == 0 && r0) {  // row 0 is lane 0's in the loop above too
      L(cur, 0) = s0j;
      L(2 + cur, 0) = dj0;
      L(I_, 0) = MIN_I32;
      tbcol[0] = static_cast<uint16_t>((db0 << 4) | (sb0j << 8));
    }

    // band rows [s, enj), CHUNK a chunk
    const int s = max(1, stj);
    int acc = SENT;  // max of S + xcs over band rows < m, first row on ties
    int first = 0;
    if (s < enj) {
      // the chain before row s, as the (max,+) scan's running maximum of
      // U = T - r * ge: row 0's MIN, and in the last column the Sn opens of
      // rows 1..s-1 (the other opens there are the sentinel's)
      int c_u = MIN_I32;
      if (last) {
        for (int r = 1 + lane; r < s; r += LANES) {
          const int t_sn = add(r == 1 ? sn0 : L(SN, r - 1), go);
          c_u = max(c_u, add(max(add(SENT2, go), t_sn), mul(-r, ge)));
        }
        c_u = __reduce_max_sync(FULL, c_u);
      }
      int c_bi = add(c_u, mul(s - 1, ge));  // this column's I at row s - 1
      // the s-bits of row s - 1, which a tie opens from
      int c_sb = sb0j;
      if (s >= 2 && lane == 0) {
        const int r = s - 1;
        const int xr = x_b[r - 1];
        int sc = add(L(prv, r - 1), xr == yj ? p.ma : p.mi);
        int bits = TB_SUBST + (xr == yj);
        const int d_ext = add(L(2 + prv, r), ge);
        const int d_open = add(L(prv, r), go);
        take(sc, bits, c_bi, TB_INS);
        take(sc, bits, d_ext > d_open ? d_ext : d_open, TB_DEL);
        take(sc, bits, xclip, TB_XCLIP_PREFIX);
        take(sc, bits, add(d_clip, mul(ge, r - 1)), TB_YCLIP_PREFIX);
        c_sb = bits;
      }
      int c_st = r0 ? s0j : MIN_I32;               // S~ of row s - 1 (reset row: MIN)
      int c_sn = s == 1 ? sn0 : L(SN, s - 1);      // Sn of row s - 1, before this column
      for (int c0 = s; c0 < enj; c0 += CHUNK) {
        // lane t's rows c0 + t * LANE_ROWS + k, k = 0..LANE_ROWS-1; a row
        // past the band reads row c0's inputs and writes nothing
        int r[LANE_ROWS], m_val[LANE_ROWS], m_bits[LANE_ROWS], best_d[LANE_ROWS], d_bits[LANE_ROWS];
        int yclip[LANE_ROWS], s_tilde[LANE_ROWS], sn_old[LANE_ROWS];
        bool live[LANE_ROWS];
#pragma unroll
        for (int k = 0; k < LANE_ROWS; ++k) {
          r[k] = c0 + lane * LANE_ROWS + k;
          live[k] = r[k] < enj;
          const int rr = live[k] ? r[k] : c0;
          const int xr = x_b[rr - 1];
          const int eq = xr == yj;
          m_val[k] = add(L(prv, rr - 1), eq ? p.ma : p.mi);
          m_bits[k] = TB_SUBST + eq;  // TB_MATCH = TB_SUBST + 1
          const int d_ext = add(L(2 + prv, rr), ge);
          const int d_open = add(L(prv, rr), go);
          const bool d_wins = d_ext > d_open;
          best_d[k] = d_wins ? d_ext : d_open;
          d_bits[k] = d_wins ? TB_DEL : sb_prev(rr);
          yclip[k] = add(d_clip, mul(ge, rr - 1));
          s_tilde[k] = max(max(max(m_val[k], best_d[k]), yclip[k]), xclip);
          sn_old[k] = L(SN, rr);
        }
        // the chain: best_i = max over rows <= r of U = T - r * ge, plus
        // r * ge; within the lane's rows, then over the lanes
        const int st_up = from_above(s_tilde[LANE_ROWS - 1], c_st, lane);
        const int sn_up = from_above(sn_old[LANE_ROWS - 1], c_sn, lane);
        int t_s[LANE_ROWS], t_sn[LANE_ROWS], t_seed[LANE_ROWS], u[LANE_ROWS];
#pragma unroll
        for (int k = 0; k < LANE_ROWS; ++k) {
          t_s[k] = add(k == 0 ? st_up : s_tilde[k - 1], go);
          t_sn[k] = last ? add(k == 0 ? sn_up : sn_old[k - 1], go) : SENT2;
          t_seed[k] = r[k] == s ? add(MIN_I32, ge) : SENT2;
          u[k] = live[k] ? add(max(max(t_s[k], t_sn[k]), t_seed[k]), mul(-r[k], ge)) : INT_MIN;
          if (k > 0) u[k] = max(u[k], u[k - 1]);
        }
        int lane_max = u[LANE_ROWS - 1];
#pragma unroll
        for (int d = 1; d < LANES; d <<= 1) {
          const int v = __shfl_up_sync(FULL, lane_max, d);
          if (lane >= d) lane_max = max(lane_max, v);
        }
        const int before = max(from_above(lane_max, INT_MIN, lane), c_u);  // rows above the lane's
        int best_i[LANE_ROWS], s_col[LANE_ROWS], s_bits[LANE_ROWS];
#pragma unroll
        for (int k = 0; k < LANE_ROWS; ++k) {
          u[k] = max(u[k], before);
          best_i[k] = add(u[k], mul(r[k], ge));
          s_col[k] = m_val[k];
          s_bits[k] = m_bits[k];
          take(s_col[k], s_bits[k], best_i[k], TB_INS);
          take(s_col[k], s_bits[k], best_d[k], TB_DEL);
          take(s_col[k], s_bits[k], xclip, TB_XCLIP_PREFIX);
          take(s_col[k], s_bits[k], yclip[k], TB_YCLIP_PREFIX);
        }
        const int bi_up = from_above(best_i[LANE_ROWS - 1], c_bi, lane);
        const int sb_up = from_above(s_bits[LANE_ROWS - 1], c_sb, lane);
        // the x-suffix running maximum over rows < m: the lane's (first row
        // on ties), this chunk's, then strictly above the earlier chunks'
        // (their rows come first)
        int lv = INT_MIN, lr = INT_MAX;
#pragma unroll
        for (int k = 0; k < LANE_ROWS; ++k) {
          const int v = live[k] && r[k] < ml ? add(s_col[k], xcs) : INT_MIN;
          if (v > lv) {
            lv = v;
            lr = r[k];
          }
        }
        const int top = __reduce_max_sync(FULL, lv);
        if (top > acc) {
          acc = top;
          first = __reduce_min_sync(FULL, lv == top ? lr : INT_MAX);
        }
#pragma unroll
        for (int k = 0; k < LANE_ROWS; ++k) {
          if (!live[k]) continue;
          const int i_eff = max(add(k == 0 ? bi_up : best_i[k - 1], ge), t_seed[k]);
          const int i_bits = t_sn[k] > max(i_eff, t_s[k]) ? TB_YCLIP_SUFFIX
                                                           : (i_eff > t_s[k] ? TB_INS : (k == 0 ? sb_up : s_bits[k - 1]));
          int sc = s_col[k], sb = s_bits[k];
          if (r[k] == ml) {
            // row m in band (the band's last row): the x-suffix clip seeds
            // it, the cell's own candidates take it over where strictly
            // greater
            sc = acc > MIN_I32 ? acc : MIN_I32;
            sb = TB_XCLIP_SUFFIX;
            take(sc, sb, m_val[k], m_bits[k]);
            take(sc, sb, best_i[k], TB_INS);
            take(sc, sb, best_d[k], TB_DEL);
            take(sc, sb, xclip, TB_XCLIP_PREFIX);
            take(sc, sb, yclip[k], TB_YCLIP_PREFIX);
          }
          if (add(sc, ycs) > sn_old[k]) {
            L(SN, r[k]) = add(sc, ycs);
            L(LY, r[k]) = nl - j;
          }
          L(cur, r[k]) = sc;
          L(2 + cur, r[k]) = best_d[k];
          L(I_, r[k]) = best_i[k];
          put_cell(r[k], i_bits | (d_bits[k] << 4) | (sb << 8));
        }
        if (c0 + CHUNK < enj) {  // the chunk's last row, for the next chunk (lane 31 holds it)
          c_u = __shfl_sync(FULL, u[LANE_ROWS - 1], LANES - 1);
          c_bi = __shfl_sync(FULL, best_i[LANE_ROWS - 1], LANES - 1);
          c_st = __shfl_sync(FULL, s_tilde[LANE_ROWS - 1], LANES - 1);
          c_sb = __shfl_sync(FULL, s_bits[LANE_ROWS - 1], LANES - 1);
          c_sn = __shfl_sync(FULL, sn_old[LANE_ROWS - 1], LANES - 1);
        }
      }
    }
    if (lane == 0) {
      lx[static_cast<size_t>(j - 1) * B + b] = acc > MIN_I32 ? ml - first : 0;
      // row m out of band: Sn[m] from the x-suffix clip, S[m] = MIN and the
      // x-suffix clip s-bits (in band, its lane did both in the chunk)
      if (ml >= 1 && !(ml >= stj && ml < enj)) {
        const int s_m = acc > MIN_I32 ? acc : MIN_I32;
        if (add(s_m, ycs) > L(SN, ml)) {
          L(SN, ml) = add(s_m, ycs);
          L(LY, ml) = nl - j;
        }
        L(cur, ml) = MIN_I32;
        put_cell(ml, TB_XCLIP_SUFFIX << 8);
      }
    }
    __syncwarp();  // this column's state and tb, for the next column
  }

  // ---- finals: the state after column nlens; rows past mlens stay at
  // their initial values ----
  const size_t fb = static_cast<size_t>(b) * rows;
  const uint16_t* tblast = nl >= 1 ? tb_b + static_cast<size_t>(nl - 1) * Xp : nullptr;
  for (int i = lane; i <= M; i += LANES) {
    if (i > ml) {
      s_f[fb + i] = MIN_I32;
      i_f[fb + i] = MIN_I32;
      sn_f[fb + i] = MIN_I32;
      ly_f[fb + i] = 0;
      tbk[fb + i] = 0;
      continue;
    }
    s_f[fb + i] = L(nl & 1, i);
    i_f[fb + i] = L(I_, i);
    sn_f[fb + i] = i == 0 ? sn0 : L(SN, i);
    ly_f[fb + i] = i == 0 ? ly0 : L(LY, i);
    if (tblast) {
      tbk[fb + i] = tblast[i];
    } else {  // column 0's own cells
      const bool in_b0 = i >= 1 && i >= st0 && i < en0;
      const int gap_i = add(go, mul(ge, i - 1));
      const int ib0 = (!in_b0 || i == 1) ? TB_START : (gap_i > clip_i ? TB_INS : TB_XCLIP_PREFIX);
      tbk[fb + i] = ib0 | ((L(SBITS, i) & 0xF) << 8);
    }
  }
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K16. xb (B, M) and yb (B, N) uint8 row-major; tb the pair-major (B, N, Xp)
// uint16 tensor, Xp >= M + 1 a multiple of 8, and lx (N, B) int32, both
// zeroed by the caller; `warps` pairs a block (1..8); scratch null keeps
// the state in shared memory (8 * (M + 1) * 4 bytes a pair), else a (B, 8,
// M + 1) int32 buffer.
int sw_scan_banded(const void* xb, const void* yb, const void* mlens, const void* nlens,
                   const void* starts, const void* ends, int B, int M, int N, int Xp,
                   int warps, int go, int ge, int xcp, int xcs, int ycp, int ycs, int ma,
                   int mi, void* tb, void* lx, void* s_f, void* i_f, void* sn_f, void* ly_f,
                   void* tbk, void* scratch, void* stream) {
  const size_t per_pair = static_cast<size_t>(LAYERS) * (M + 1) * sizeof(int);
  const size_t smem = scratch ? 0 : per_pair * warps;
  if (B < 1 || M < 0 || N < 0 || warps < 1 || warps > WARPS_MAX || smem > SMEM_MAX || Xp < M + 1 ||
      Xp % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        scan_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  scan_banded_kernel<<<(B + warps - 1) / warps, warps * LANES, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xb), static_cast<const uint8_t*>(yb),
      static_cast<const int*>(mlens), static_cast<const int*>(nlens),
      static_cast<const int*>(starts), static_cast<const int*>(ends), B, M, N, Xp,
      Pens{go, ge, xcp, xcs, ycp, ycs, ma, mi}, static_cast<uint16_t*>(tb),
      static_cast<int*>(lx), static_cast<int*>(s_f), static_cast<int*>(i_f),
      static_cast<int*>(sn_f), static_cast<int*>(ly_f), static_cast<int*>(tbk),
      static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
