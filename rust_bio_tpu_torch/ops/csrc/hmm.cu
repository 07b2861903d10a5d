// K-HMM-vit, K-HMM-fwd, K-HMM-bwd: batched HMM inference over B
// observation sequences of one model with S states. They replace no Pallas
// kernel: the XLA time scans of rust_bio_tpu/stats/hmm/device.py,
// BatchDiscreteHMM._viterbi (:105, with the associative-scan backtrack
// _backtrack_paths :50), ._forward (:142) and ._backward (:168), and their
// Gaussian twins (:256, :287; the Gaussian backward, which JAX lacks, runs
// the same steps). ops/hmm.py states the semantics and holds the plain
// versions; every step is the JAX step's arithmetic in its order:
// - Viterbi: cand = v[k] + A[k, j], best = max_k cand + e[j], the FIRST
//   maximal k (strict > over k = 0..S-1, jnp.argmax); last = the first
//   argmax of v + end. The back-pointers go to a (B, T, S) uint8 scratch
//   (row t for the step into time t) and the epilog chases them from last:
//   map composition is exact, so the chase gives the associative scan's
//   path. The padded tail repeats the last state.
// - forward: hi = max_k (v[k] + A[k, j]), s = sum_k exp(max(x - hi, -87))
//   in k order, out = hi + log(s), or hi where hi <= NEG/2; then + e[j].
//   Rows of the frozen tail repeat v.
// - backward: over t = L-2 .. 0, the observation at t + 1, v[k] =
//   lse_j(A[k, j] + (e[j] + v[j])); v starts at `end`; rows come out in
//   reverse padded time (row T-1-t), the rows of times >= L-1 at the start
//   value; tot = lse((v + pi) + e(obs[0])).
// NEG + NEG overflows to -inf as in XLA: the build has -fmad=false and no
// fast math; expf/logf are the accurate versions.
//
// Layout. Lane `me` of a sequence's group owns state me: the destination j
// (Viterbi, forward) or the source k (backward). It keeps column me of a
// matrix M, M[i * S + me] for i < S: A for the forward scans, A's
// transpose for the backward one (the wrapper passes it), so that each
// step is "x_i = u_i + M[i][me]" over the group's values u (v, or e + v).
// - S <= 32: one warp a sequence, WARPS a block, the column in registers
//   (SMAX = 2, 8 or 32 unrolled slots), u broadcast by __shfl_sync.
// - 32 < S <= 256: one block a sequence, 32 * ceil(S / 32) threads, u
//   through a double-buffered shared array (one __syncthreads a step), M
//   in shared memory when S * S * 4 <= SHARED_M_MAX bytes (S <= 156; past
//   48 KB the launch opts in), else read from device memory (L1/L2). The
//   chase is one thread's.
// Observations come 32 at a time: lane l of each warp loads time base + l
// and a step takes its word by __shfl_sync.
//
// What bounds it: the dependent chain over time. A step is S shuffles or
// shared reads, S adds and compares (Viterbi) or S exps and one log
// (forward, backward) a lane; the outputs ((B, T, S) floats for the
// forward and backward, the (B, T) path and the back-pointers for
// Viterbi) are the bytes. At the casino model's S = 2, 30 of a warp's 32
// lanes idle: several sequences a warp is the first redesign.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // ops/hmm.py HMM_WARPS: sequences a block, warp layout
constexpr int WARP_MAX_S = 32;  // ops/hmm.py WARP_MAX_S
constexpr int MAX_S = 256;  // ops/hmm.py MAX_S: the uint8 back-pointers
constexpr int SHARED_M_MAX = 98304;  // ops/hmm.py SHARED_M_MAX: 96 KB of A in shared memory
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr float NEG_HALF = -1.5e38f;  // NEG / 2, NEG = -3.0e38
constexpr float CLAMP = -87.0f;

enum Mode { VIT = 0, FWD = 1, BWD = 2 };

struct Params {
  const float* M;      // (S, S): A, or A's transpose for the backward scan
  const float* emit;   // (S, V) table, or (3, S) mu, log_norm, inv2var
  int V;
  const float* pi;     // (S,)
  const float* end;    // (S,)
  const int* obs;      // (B, T) int32 symbols or float32 bits
  const int* lens;     // (B,) in [1, T]
  int B, T, S;
  uint8_t* bp;         // Viterbi: (B, T, S) back-pointers
  int* path;           // Viterbi: (B, T)
  float* out1;         // Viterbi: prob (B,); forward/backward: vals (B, T, S)
  float* tot;          // forward/backward: (B,)
};

// Emission of state `me` (clamped into the states: lanes past S compute
// values nobody reads).
struct Discrete {
  const float* row;
  __device__ void init(const Params& p, int me) {
    row = p.emit + static_cast<size_t>(min(me, p.S - 1)) * p.V;
  }
  __device__ float operator()(int word) const { return __ldg(row + word); }
};

struct Gauss {
  float mu, log_norm, inv2var;
  __device__ void init(const Params& p, int me) {
    const int j = min(me, p.S - 1);
    mu = p.emit[j];
    log_norm = p.emit[p.S + j];
    inv2var = p.emit[2 * p.S + j];
  }
  // JAX's _emit: log_norm - d * d * inv2var, each product rounded
  __device__ float operator()(int word) const {
    const float d = __int_as_float(word) - mu;
    return log_norm - d * d * inv2var;
  }
};

// A sequence's observations, 32 words a load, each warp its own copy.
struct Obs {
  const int* row;
  int T, lane, base, word;
  __device__ Obs(const int* r, int T_, int l) : row(r), T(T_), lane(l), base(-32), word(0) {}
  __device__ int get(int t) {
    const int b0 = t & ~31;
    if (b0 != base) {  // warp-uniform
      base = b0;
      const int i = b0 + lane;
      word = i < T ? __ldg(row + i) : 0;
    }
    return __shfl_sync(FULL, word, t & 31);
  }
};

__device__ __forceinline__ float lse_tail(float hi, float s) {
  return hi <= NEG_HALF ? hi : hi + logf(s);
}

// One warp a sequence; lane me keeps M's column me in registers.
template <int SMAX>
struct WarpGroup {
  static constexpr bool kWarp = true;
  int me, S;
  float m[SMAX];
  __device__ WarpGroup(const Params& p, int lane) : me(lane), S(p.S) {
    const int c = min(me, S - 1);
#pragma unroll
    for (int i = 0; i < SMAX; ++i) m[i] = i < S ? __ldg(p.M + static_cast<size_t>(i) * S + c) : 0.0f;
  }
  __device__ void setup() {}
  __device__ float u_at(float u, int i) const { return __shfl_sync(FULL, u, i); }
  // max_i (u_i + M[i][me]) and its first argmax
  __device__ float step_max(float u, int& arg) {
    float best = u_at(u, 0) + m[0];
    arg = 0;
#pragma unroll
    for (int i = 1; i < SMAX; ++i) {
      if (i < S) {
        const float c = u_at(u, i) + m[i];
        if (c > best) { best = c; arg = i; }
      }
    }
    return best;
  }
  // lse_i (u_i + M[i][me]) as JAX's _lse_last
  __device__ float step_lse(float u) {
    float x[SMAX];
    x[0] = u_at(u, 0) + m[0];
    float hi = x[0];
#pragma unroll
    for (int i = 1; i < SMAX; ++i) {
      if (i < S) {
        x[i] = u_at(u, i) + m[i];
        hi = fmaxf(hi, x[i]);
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < SMAX; ++i) {
      if (i < S) s += expf(fmaxf(x[i] - hi, CLAMP));
    }
    return lse_tail(hi, s);
  }
  // the first argmax of u over the states, and its value
  __device__ float all_max(float u, int& arg) {
    float best = u_at(u, 0);
    arg = 0;
    for (int i = 1; i < S; ++i) {
      const float c = u_at(u, i);
      if (c > best) { best = c; arg = i; }
    }
    return best;
  }
  __device__ float all_lse(float u) {
    float hi = u_at(u, 0);
    for (int i = 1; i < S; ++i) hi = fmaxf(hi, u_at(u, i));
    float s = 0.0f;
    for (int i = 0; i < S; ++i) s += expf(fmaxf(u_at(u, i) - hi, CLAMP));
    return lse_tail(hi, s);
  }
};

// One block a sequence; u through a double-buffered shared array, M in
// shared memory (SHARED) or device memory; `smem` is the block's dynamic
// shared array.
template <bool SHARED>
struct BlockGroup {
  static constexpr bool kWarp = false;
  int me, S, p;
  const float* Mg;
  float* ubuf;  // [2][S]
  float* Ms;    // [S][S] when SHARED
  __device__ BlockGroup(const Params& prm, int tid, float* smem) : me(tid), S(prm.S), p(0), Mg(prm.M) {
    ubuf = smem;
    Ms = smem + 2 * S;
  }
  __device__ void setup() {
    if (SHARED) {
      for (int i = me; i < S * S; i += blockDim.x) Ms[i] = __ldg(Mg + i);
    }
    __syncthreads();
  }
  __device__ float mat(int i) const {
    const int c = min(me, S - 1);
    return SHARED ? Ms[i * S + c] : __ldg(Mg + static_cast<size_t>(i) * S + c);
  }
  __device__ const float* publish(float u) {
    float* b = ubuf + p * S;
    if (me < S) b[me] = u;
    __syncthreads();
    p ^= 1;
    return b;
  }
  __device__ float step_max(float u, int& arg) {
    const float* ub = publish(u);
    float best = ub[0] + mat(0);
    arg = 0;
    for (int i = 1; i < S; ++i) {
      const float c = ub[i] + mat(i);
      if (c > best) { best = c; arg = i; }
    }
    return best;
  }
  __device__ float step_lse(float u) {
    const float* ub = publish(u);
    float hi = ub[0] + mat(0);
    for (int i = 1; i < S; ++i) hi = fmaxf(hi, ub[i] + mat(i));
    float s = 0.0f;
    for (int i = 0; i < S; ++i) s += expf(fmaxf((ub[i] + mat(i)) - hi, CLAMP));
    return lse_tail(hi, s);
  }
  __device__ float all_max(float u, int& arg) {
    const float* ub = publish(u);
    float best = ub[0];
    arg = 0;
    for (int i = 1; i < S; ++i) {
      if (ub[i] > best) { best = ub[i]; arg = i; }
    }
    return best;
  }
  __device__ float all_lse(float u) {
    const float* ub = publish(u);
    float hi = ub[0];
    for (int i = 1; i < S; ++i) hi = fmaxf(hi, ub[i]);
    float s = 0.0f;
    for (int i = 0; i < S; ++i) s += expf(fmaxf(ub[i] - hi, CLAMP));
    return lse_tail(hi, s);
  }
};

// Viterbi epilog, warp layout: lane j holds entry j of 32 back-pointer
// rows (independent loads), then 32 dependent shuffles walk them; lane i
// keeps path[t - 1 - i] and the warp stores the 32 in one go.
__device__ void chase_warp(const Params& p, int b, int L, int last, int lane) {
  const uint8_t* bpb = p.bp + static_cast<size_t>(b) * p.T * p.S;
  int* pb = p.path + static_cast<size_t>(b) * p.T;
  for (int q = L - 1 + lane; q < p.T; q += 32) pb[q] = last;
  int s = last;
  for (int t = L - 1; t >= 1; t -= 32) {
    int r[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      r[i] = (t - i >= 1 && lane < p.S) ? bpb[static_cast<size_t>(t - i) * p.S + lane] : 0;
    }
    int mine = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (t - i >= 1) {
        s = __shfl_sync(FULL, r[i], s);
        if (lane == i) mine = s;
      }
    }
    if (t - 1 - lane >= 0) pb[t - 1 - lane] = mine;
  }
}

// Viterbi epilog, block layout: one thread chases (the rows were written
// by the whole block: the barrier orders them), all write the tail.
__device__ void chase_block(const Params& p, int b, int L, int last, int me) {
  __syncthreads();
  const uint8_t* bpb = p.bp + static_cast<size_t>(b) * p.T * p.S;
  int* pb = p.path + static_cast<size_t>(b) * p.T;
  for (int q = L - 1 + me; q < p.T; q += blockDim.x) pb[q] = last;
  if (me == 0) {
    int s = last;
    for (int t = L - 1; t >= 1; --t) {
      s = bpb[static_cast<size_t>(t) * p.S + s];
      pb[t - 1] = s;
    }
  }
}

template <int MODE, class Emit, class G>
__device__ void run(const Params& p, G& g, int b, int lane) {
  const int me = g.me, S = p.S, T = p.T;
  const int L = __ldg(p.lens + b);
  const bool mine = me < S;
  const int c = min(me, S - 1);
  Emit em;
  em.init(p, me);
  Obs ob(p.obs + static_cast<size_t>(b) * T, T, lane);
  g.setup();
  if (MODE == VIT) {
    float v = __ldg(p.pi + c) + em(ob.get(0));
    uint8_t* bpb = p.bp + static_cast<size_t>(b) * T * S;
    for (int t = 1; t < L; ++t) {
      const float e = em(ob.get(t));
      int arg;
      const float best = g.step_max(v, arg);
      v = best + e;
      if (mine) bpb[static_cast<size_t>(t) * S + me] = static_cast<uint8_t>(arg);
    }
    int last;
    const float prob = g.all_max(v + __ldg(p.end + c), last);
    if (me == 0) p.out1[b] = prob;
    if (G::kWarp) {
      chase_warp(p, b, L, last, lane);
    } else {
      chase_block(p, b, L, last, me);
    }
  } else if (MODE == FWD) {
    float* vb = p.out1 + static_cast<size_t>(b) * T * S;
    float v = __ldg(p.pi + c) + em(ob.get(0));
    if (mine) vb[me] = v;
    for (int t = 1; t < L; ++t) {
      const float e = em(ob.get(t));
      v = g.step_lse(v) + e;
      if (mine) vb[static_cast<size_t>(t) * S + me] = v;
    }
    if (mine) {
      for (int t = L; t < T; ++t) vb[static_cast<size_t>(t) * S + me] = v;
    }
    const float tot = g.all_lse(v + __ldg(p.end + c));
    if (me == 0) p.tot[b] = tot;
  } else {
    float* vb = p.out1 + static_cast<size_t>(b) * T * S;
    float v = __ldg(p.end + c);
    if (mine) {
      for (int r = 0; r <= T - L; ++r) vb[static_cast<size_t>(r) * S + me] = v;
    }
    for (int t = L - 2; t >= 0; --t) {
      const float e = em(ob.get(t + 1));
      v = g.step_lse(e + v);
      if (mine) vb[static_cast<size_t>(T - 1 - t) * S + me] = v;
    }
    const float e0 = em(ob.get(0));
    const float tot = g.all_lse((v + __ldg(p.pi + c)) + e0);
    if (me == 0) p.tot[b] = tot;
  }
}

template <int MODE, class Emit, int SMAX>
__global__ void __launch_bounds__(32 * WARPS) hmm_warp_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= p.B) return;  // the whole warp leaves together
  WarpGroup<SMAX> g(p, lane);
  run<MODE, Emit>(p, g, b, lane);
}

template <int MODE, class Emit, bool SHARED>
__global__ void __launch_bounds__(MAX_S) hmm_block_kernel(Params p) {
  extern __shared__ float smem[];
  BlockGroup<SHARED> g(p, threadIdx.x, smem);
  run<MODE, Emit>(p, g, blockIdx.x, threadIdx.x & 31);
}

template <int MODE, class Emit>
int launch_mode(const Params& p, cudaStream_t st) {
  const int S = p.S;
  if (S <= WARP_MAX_S) {
    const int blocks = (p.B + WARPS - 1) / WARPS;
    auto k = S <= 2 ? hmm_warp_kernel<MODE, Emit, 2>
           : S <= 8 ? hmm_warp_kernel<MODE, Emit, 8>
                    : hmm_warp_kernel<MODE, Emit, 32>;
    k<<<blocks, 32 * WARPS, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const bool shared = static_cast<long long>(S) * S * 4 <= SHARED_M_MAX;
  const int threads = 32 * ((S + 31) / 32);
  const size_t bytes = (2 * static_cast<size_t>(S) + (shared ? static_cast<size_t>(S) * S : 0)) * sizeof(float);
  auto k = shared ? hmm_block_kernel<MODE, Emit, true> : hmm_block_kernel<MODE, Emit, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  k<<<p.B, threads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch(const void* M, const void* emit, int V, int gauss, const void* pi, const void* end,
           const void* obs, const void* lens, int B, int T, int S,
           void* bp, void* path, void* out1, void* tot, void* stream) {
  if (S < 1 || S > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const float*>(M), static_cast<const float*>(emit), V,
                 static_cast<const float*>(pi), static_cast<const float*>(end),
                 static_cast<const int*>(obs), static_cast<const int*>(lens), B, T, S,
                 static_cast<uint8_t*>(bp), static_cast<int*>(path),
                 static_cast<float*>(out1), static_cast<float*>(tot)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gauss ? launch_mode<MODE, Gauss>(p, st) : launch_mode<MODE, Discrete>(p, st);
}

}  // namespace

extern "C" {

const char* rbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int hmm_viterbi(const void* A, const void* emit, int V, int gauss, const void* pi,
                const void* end, const void* obs, const void* lens, int B, int T,
                int S, void* bp, void* path, void* prob,
                void* stream) {
  return launch<VIT>(A, emit, V, gauss, pi, end, obs, lens, B, T, S, bp, path, prob, nullptr, stream);
}

int hmm_forward(const void* A, const void* emit, int V, int gauss, const void* pi,
                const void* end, const void* obs, const void* lens, int B, int T,
                int S, void* vals, void* tot, void* stream) {
  return launch<FWD>(A, emit, V, gauss, pi, end, obs, lens, B, T, S, nullptr, nullptr, vals, tot, stream);
}

int hmm_backward(const void* At, const void* emit, int V, int gauss, const void* pi,
                 const void* end, const void* obs, const void* lens, int B, int T,
                 int S, void* vals, void* tot, void* stream) {
  return launch<BWD>(At, emit, V, gauss, pi, end, obs, lens, B, T, S, nullptr, nullptr, vals, tot, stream);
}

}  // extern "C"
