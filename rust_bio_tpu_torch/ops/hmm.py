"""Batched HMM inference: kernels K-HMM-vit, K-HMM-fwd and K-HMM-bwd, CUDA
source in ``csrc/hmm.cu``. They replace no Pallas kernel: the XLA time
scans of ``rust_bio_tpu/stats/hmm/device.py``, ``BatchDiscreteHMM._viterbi``
(:105, with the associative-scan backtrack ``_backtrack_paths`` :50),
``._forward`` (:142) and ``._backward`` (:168), and the Gaussian twins of
``BatchGaussianHMM`` (:256, :287).

One model of S states (1 <= S <= ``MAX_S``) over B sequences padded to T:
``A`` (S, S) float32 ln P(from -> to), ``pi`` and ``end`` (S,) float32,
``lens`` (B,) int32 in [1, T]. The emission source is picked by the type
of ``obs`` (B, T):

- int32 symbols: ``emit`` is the (S, V) float32 table, every entry of
  ``obs`` (padding included) in [0, V);
- float32 values: ``emit`` is the (3, S) float32 rows mu, log_norm and
  inv2var, and a state's log density is ``log_norm - d * d * inv2var``
  with d = o - mu (``BatchGaussianHMM._emit``).

``viterbi`` returns the (B, T) int32 paths (the padded tail repeats the
last state) and the (B,) float32 log-probabilities: each step is
``max_k (v[k] + A[k, j]) + e[j]`` with the first maximal k, a frozen step
(t >= len) keeps v, and the path ends at the first argmax of ``v + end``.
``forward`` returns the (B, T, S) float32 rows, the frozen tail repeating
the last one, and ``tot = lse(v + end)``. ``backward`` runs t = T-2 .. 0
while t + 1 < len with the observation at t + 1, ``v[k] = lse_j(A[k, j] +
(e[j] + v[j]))`` from ``v = end``, and returns its rows in reverse padded
time (row 0 the start value, the rows of times >= len - 1 too) and ``tot =
lse((v + pi) + e(obs[:, 0]))``. ``lse`` is JAX's ``_lse_last``: the
maximum hi, the sum of ``exp(max(x - hi, -87))``, and hi itself where
``hi <= NEG / 2`` (NEG = -3.0e38, the models' ln 0).

The kernels' arithmetic is the JAX scans' in their order (Viterbi bit for
bit; the forward and backward sums in k order, to float rounding of the
XLA reductions). Geometry (``geometry``): S <= ``WARP_MAX_S``, one warp a
sequence, ``HMM_WARPS`` a block; past it one block a sequence, A in shared
memory while its S * S * 4 bytes fit ``SHARED_M_MAX`` (S <= 156). Viterbi's
back-pointers live in a (B, T, S) uint8 scratch the wrapper allocates.
"""

from __future__ import annotations

import torch

from rust_bio_tpu_torch.ops._build import INT, PTR, CudaKernel, check, same_device

NEG = -3.0e38
LSE_CLAMP = -87.0
MAX_S = 256  # csrc/hmm.cu MAX_S: the back-pointers are uint8
WARP_MAX_S = 32  # csrc/hmm.cu WARP_MAX_S
HMM_WARPS = 4  # csrc/hmm.cu WARPS: sequences a block in the warp layout
SHARED_M_MAX = 96 * 1024  # csrc/hmm.cu SHARED_M_MAX: A's bytes in shared memory

_ARGS = [PTR, PTR, INT, INT, PTR, PTR, PTR, PTR, INT, INT, INT]
HMM_VITERBI = CudaKernel("hmm", "hmm_viterbi", _ARGS + [PTR, PTR, PTR])
HMM_FORWARD = CudaKernel("hmm", "hmm_forward", _ARGS + [PTR, PTR])
HMM_BACKWARD = CudaKernel("hmm", "hmm_backward", _ARGS + [PTR, PTR])


def geometry(S: int) -> dict:
    """The launch ``csrc/hmm.cu`` makes for S states."""
    if S <= WARP_MAX_S:
        smax = 2 if S <= 2 else 8 if S <= 8 else 32
        return {"layout": "warp", "slots": smax, "threads": 32 * HMM_WARPS, "shared_bytes": 0}
    shared = S * S * 4 <= SHARED_M_MAX
    return {
        "layout": "block", "threads": 32 * -(-S // 32), "shared_m": shared,
        "shared_bytes": 4 * (2 * S + (S * S if shared else 0)),
    }


def _check(A, emit, pi, end, obs, lens):
    """(device, B, T, S, V, gauss) after the checks the kernels rely on
    (one sync for the lengths and symbols)."""
    dev = same_device(A, emit, pi, end, obs, lens)
    if A.dim() != 2 or obs.dim() != 2:
        raise ValueError("A must be (S, S) and obs (B, T)")
    S = A.shape[0]
    B, T = obs.shape
    if not 1 <= S <= MAX_S:
        raise ValueError(f"S = {S}: the HMM kernels take 1 to {MAX_S} states")
    check(A, "A", torch.float32, (S, S))
    check(pi, "pi", torch.float32, (S,))
    check(end, "end", torch.float32, (S,))
    check(lens, "lens", torch.int32, (B,))
    gauss = obs.dtype == torch.float32
    if gauss:
        check(emit, "emit", torch.float32, (3, S))
        V = 0
    else:
        if emit.dim() != 2:
            raise ValueError("emit must be the (S, V) table for int32 observations")
        V = emit.shape[1]
        check(emit, "emit", torch.float32, (S, V))
        check(obs, "obs", torch.int32, (B, T))
    check(obs, "obs", obs.dtype, (B, T))
    if B and T == 0:
        raise ValueError("obs has no columns")
    if B:
        bad = (lens < 1) | (lens > T)
        if not gauss:
            bad = bad.any() | ((obs < 0) | (obs >= V)).any()
        if bool(bad.any()):
            raise ValueError(f"lens must lie in [1, {T}]" + ("" if gauss else f" and obs in [0, {V})"))
    return dev, B, T, S, V, gauss


def launch_only(kernel, M, emit, pi, end, obs, lens, V, gauss, *outs):
    """One launch of ``kernel`` (``HMM_VITERBI``: outs bp, paths, prob;
    ``HMM_FORWARD`` / ``HMM_BACKWARD``: vals, tot) on checked tensors, M
    being A (A's transpose for the backward scan): no checks, for timing."""
    B, T = obs.shape
    kernel.launch(
        obs.device, M.data_ptr(), emit.data_ptr(), V, int(gauss), pi.data_ptr(), end.data_ptr(),
        obs.data_ptr(), lens.data_ptr(), B, T, M.shape[0],
        *(o.data_ptr() for o in outs),
    )


def viterbi(A, emit, pi, end, obs, lens):
    """K-HMM-vit. Returns (paths (B, T) int32, prob (B,) float32)."""
    dev, B, T, S, V, gauss = _check(A, emit, pi, end, obs, lens)
    if dev.type == "cpu":
        return viterbi_plain(A, emit, pi, end, obs, lens)
    paths = torch.empty((B, T), dtype=torch.int32, device=dev)
    prob = torch.empty(B, dtype=torch.float32, device=dev)
    if B:
        bp = torch.empty((B, T, S), dtype=torch.uint8, device=dev)
        launch_only(HMM_VITERBI, A, emit, pi, end, obs, lens, V, gauss, bp, paths, prob)
    return paths, prob


def forward(A, emit, pi, end, obs, lens):
    """K-HMM-fwd. Returns (vals (B, T, S) float32, tot (B,) float32)."""
    dev, B, T, S, V, gauss = _check(A, emit, pi, end, obs, lens)
    if dev.type == "cpu":
        return forward_plain(A, emit, pi, end, obs, lens)
    vals = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    tot = torch.empty(B, dtype=torch.float32, device=dev)
    if B:
        launch_only(HMM_FORWARD, A, emit, pi, end, obs, lens, V, gauss, vals, tot)
    return vals, tot


def backward(A, emit, pi, end, obs, lens):
    """K-HMM-bwd. Returns (vals (B, T, S) float32 in reverse padded time,
    tot (B,) float32)."""
    dev, B, T, S, V, gauss = _check(A, emit, pi, end, obs, lens)
    if dev.type == "cpu":
        return backward_plain(A, emit, pi, end, obs, lens)
    vals = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    tot = torch.empty(B, dtype=torch.float32, device=dev)
    if B:
        launch_only(HMM_BACKWARD, A.t().contiguous(), emit, pi, end, obs, lens, V, gauss, vals, tot)
    return vals, tot


# ---------------------------------------------------------------------------
# plain PyTorch versions (sequences and states vectorized, time in a Python
# loop; the same freeze and tie rules)
# ---------------------------------------------------------------------------


def emissions(emit: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """(B, S) log emissions of the (B,) observations ``o``."""
    if o.dtype == torch.float32:
        mu, log_norm, inv2var = emit
        d = o[:, None] - mu[None, :]
        return log_norm[None, :] - d * d * inv2var[None, :]
    return emit.t()[o.long()]


def lse_last(x: torch.Tensor) -> torch.Tensor:
    """ln-sum-exp over the last axis, NEG-surrogate safe (JAX's ``_lse_last``)."""
    hi = x.amax(dim=-1, keepdim=True)
    s = torch.exp((x - hi).clamp_min(LSE_CLAMP)).sum(dim=-1)
    hi = hi[..., 0]
    return torch.where(hi <= NEG / 2, hi, hi + torch.log(s))


def viterbi_plain(A, emit, pi, end, obs, lens):
    B, T = obs.shape
    S = A.shape[0]
    v = pi[None, :] + emissions(emit, obs[:, 0])
    bp = torch.empty((B, T, S), dtype=torch.int64, device=obs.device)
    ident = torch.arange(S, device=obs.device).expand(B, S)
    for t in range(1, T):
        cand = v[:, :, None] + A[None, :, :]
        arg = torch.argmax(cand, dim=1)  # the first maximal k
        best = cand.amax(dim=1) + emissions(emit, obs[:, t])
        active = (t < lens)[:, None]
        v = torch.where(active, best, v)
        bp[:, t] = torch.where(active, arg, ident)
    v_end = v + end[None, :]
    last = torch.argmax(v_end, dim=1)
    prob = v_end.gather(1, last[:, None])[:, 0]
    paths = torch.empty((B, T), dtype=torch.int64, device=obs.device)
    paths[:, T - 1] = last
    for t in range(T - 1, 0, -1):
        paths[:, t - 1] = bp[:, t].gather(1, paths[:, t : t + 1])[:, 0]
    return paths.to(torch.int32), prob


def forward_plain(A, emit, pi, end, obs, lens):
    B, T = obs.shape
    S = A.shape[0]
    vals = torch.empty((B, T, S), dtype=torch.float32, device=obs.device)
    v = pi[None, :] + emissions(emit, obs[:, 0])
    vals[:, 0] = v
    for t in range(1, T):
        cand = (v[:, :, None] + A[None, :, :]).transpose(1, 2)  # (B, j, k)
        nxt = lse_last(cand) + emissions(emit, obs[:, t])
        v = torch.where((t < lens)[:, None], nxt, v)
        vals[:, t] = v
    return vals, lse_last(v + end[None, :])


def backward_plain(A, emit, pi, end, obs, lens):
    B, T = obs.shape
    S = A.shape[0]
    vals = torch.empty((B, T, S), dtype=torch.float32, device=obs.device)
    v = end[None, :].expand(B, S)
    vals[:, 0] = v
    rows = torch.arange(B, device=obs.device)
    for i, t in enumerate(range(T - 2, -1, -1)):
        o = obs[rows, torch.clamp(lens - 1, max=t + 1).long()]
        e = emissions(emit, o)
        nxt = lse_last(A[None, :, :] + (e + v)[:, None, :])
        v = torch.where(((t + 1) < lens)[:, None], nxt, v)
        vals[:, i + 1] = v
    tot = lse_last(v + pi[None, :] + emissions(emit, obs[:, 0]))
    return vals, tot
