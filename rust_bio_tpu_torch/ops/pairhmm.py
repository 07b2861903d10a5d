"""The PairHMM forwards: kernel K17 and its three siblings, CUDA sources in
``csrc/pairhmm_*.cu``, each beside its plain PyTorch version.

- K17 ``pairhmm_fwd_scaled`` (``csrc/pairhmm_scaled.cu``) replaces
  ``rust_bio_tpu/ops/pairhmm_pallas.py`` ``pairhmm_fwd_scaled`` (its
  ``_kernel``) and the XLA engine ``BatchPairHMMLinear._forward``: the f32
  scaled linear-space forward, one warp a pair over lane column stripes,
  a row at a time (``pairhmm_scaled_geometry``).
- K17-log ``pairhmm_fwd_log`` (``csrc/pairhmm_log.cu``, f32 or f64)
  replaces the XLA engine ``stats/pairhmm/device.py``
  ``BatchPairHMM._forward``: the log-space forward, one warp a pair over
  lane column stripes (``pairhmm_log_geometry``).
- K17-exact ``pairhmm_fwd_exact`` (``csrc/pairhmm_exact.cu``, f64) replaces
  the XLA engine ``stats/pairhmm/exact.py`` ``BatchPairHMMExact._forward``:
  the host oracle's loop, operation for operation, on K17-log's warp over
  lane column stripes (``pairhmm_exact_geometry``).
- K17-homopoly ``pairhmm_fwd_homopoly`` (``csrc/pairhmm_homopoly.cu``, f32
  or f64) replaces the XLA engine ``stats/pairhmm/homopoly_device.py``
  ``BatchHomopolyPairHMM._forward``: the 14-state forward, K17-log's warp
  over lane column stripes (``pairhmm_log_geometry`` at 14 states).

Common inputs: ``xs`` (B, M) and ``ys`` (B, N) uint8, ``xlens`` / ``ylens``
(B,) int32 (clamped into [0, M] / [0, N], by the kernels and the plain
versions alike), ``params`` a 1-D tensor of the model's transition values,
``emit`` the emissions, shared (K,) or per lane (B, K). Each wrapper runs
its plain version for tensors on the CPU and launches its kernel for CUDA
tensors; it never falls back from one to the other. The plain versions run
vectorized over the batch with a loop over the rows of x, as the JAX
engines do.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rust_bio_tpu_torch.ops._build import INT, PTR, CudaKernel, check, same_device
from rust_bio_tpu_torch.ops.sw import _ptr, _sm_count
from rust_bio_tpu_torch.utils.fastexp import fastexp_torch

# the surrogates of -inf (device.py NEG_INF, NEG_INF64): in log space, and
# K17's value for a lane whose probability underflowed (f32)
NEG_F32 = -3.0e38
NEG_F64 = -1.0e308
MED_SENT = 1 << 62  # the plain exact version's usize::MAX (exact.py MED_SENT)
HOMOPOLY_NPAR = 34  # csrc/pairhmm_homopoly.cu's parameter vector
HOMOPOLY_STATES = 14  # its states a column
# K17's launch (csrc/pairhmm_scaled.cu): K17-log's lanes, lane t over the
# columns [t * C + 1, t * C + C] of y, 32 * C >= N, a row at a time; a
# lane's three f32 values a column in registers up to SCALED_REG_BYTES (C
# then a power of two up to 16), else in a (B, 3, C, 32) device scratch; at
# most 8 warps a block
SCALED_REG_BYTES = 192
# K17-log's and K17-homopoly's launch (csrc/pairhmm_log.cu,
# pairhmm_homopoly.cu): one warp a pair, lane t over the columns
# [t * C + 1, t * C + C] of y, 32 * C >= N; a lane's state (three values a
# column, fourteen for K17-homopoly) in registers up to LOG_REG_BYTES /
# HOMOPOLY_REG_BYTES a lane (C then a power of two up to the largest the
# kernel instantiates: K17-log 16 float columns, 8 double; K17-homopoly 4
# float, 2 double), else in a (B, states, C, 32) device scratch; at most 8
# warps a block. HOMOPOLY_REG_BYTES holds double at C = 2: on the 2048
# homopoly pairs (N = 54) registers took 27.45-27.71 ms against the
# scratch's 28.29-28.47 (scripts/placement_trial.py, H100, three runs)
LOG_REG_BYTES = 192
HOMOPOLY_REG_BYTES = 224
_LOG_WARPS_MAX = 8
_REG_C_MAX = {3: 16, HOMOPOLY_STATES: 4}
# K17-exact's launch (csrc/pairhmm_exact.cu): K17-log's lanes; a lane keeps
# the oracle's two buffers of each of its columns, EXACT_SLOTS float64
# values a column (fm, fx, fy; banded EXACT_BANDED_SLOTS: fm, fx and fy
# twice, med twice), in registers up to EXACT_REG_BYTES a lane (C a power
# of two: 8 columns unbanded, 2 banded), else in a (B, slots, C, 32)
# device scratch
EXACT_REG_BYTES = 192
EXACT_SLOTS = 3
EXACT_BANDED_SLOTS = 7

PAIRHMM_FWD_SCALED = CudaKernel("pairhmm_scaled", "pairhmm_fwd_scaled", [PTR] * 6 + [INT] * 7 + [PTR] * 2)
PAIRHMM_FWD_LOG = CudaKernel("pairhmm_log", "pairhmm_fwd_log", [PTR] * 6 + [INT] * 8 + [PTR] * 2)
PAIRHMM_FWD_EXACT = CudaKernel(
    "pairhmm_exact", "pairhmm_fwd_exact", [PTR] * 6 + [INT] * 6 + [ctypes.c_longlong] + [INT] * 2 + [PTR] * 4
)
PAIRHMM_FWD_HOMOPOLY = CudaKernel(
    "pairhmm_homopoly", "pairhmm_fwd_homopoly", [PTR] * 6 + [INT] * 8 + [PTR] * 2
)


def _check_batch(xs, ys, xlens, ylens, params, emit, n_par: int, n_emit: int, dtypes):
    """(B, M, N, device, emit lane stride); raises on a wrong dtype, shape or
    device (reads nothing back from the card)."""
    dev = same_device(xs, ys, xlens, ylens, params, emit)
    if xs.dim() != 2 or ys.dim() != 2:
        raise ValueError("xs must be (B, M) and ys (B, N)")
    B, M = xs.shape
    N = ys.shape[1]
    check(xs, "xs", torch.uint8, (B, M))
    check(ys, "ys", torch.uint8, (B, N))
    check(xlens, "xlens", torch.int32, (B,))
    check(ylens, "ylens", torch.int32, (B,))
    if params.dtype not in dtypes:
        raise TypeError(f"params: expected one of {dtypes}, got {params.dtype}")
    check(params, "params", params.dtype, (n_par,))
    shared = emit.dim() == 1
    check(emit, "emit", params.dtype, (n_emit,) if shared else (B, n_emit))
    return B, M, N, dev, 0 if shared else n_emit


def _lens(lens: torch.Tensor, limit: int) -> torch.Tensor:
    return lens.clamp(0, limit).long()


def _emit_cols(emit: torch.Tensor, B: int, n: int):
    """The emission columns as (B, 1) tensors, shared or per lane."""
    e = emit.reshape(1, n).expand(B, n) if emit.dim() == 1 else emit
    return [e[:, k : k + 1] for k in range(n)]


# ---------------------------------------------------------------------------
# K17: the scaled linear-space forward (f32)
# ---------------------------------------------------------------------------


def pairhmm_fwd_scaled(xs, ys, xlens, ylens, params, emit, semiglobal: bool):
    """K17. (B,) float32 log-likelihoods; ``NEG_F32`` where the lane's
    probability underflowed f32 relative to the per-row maximum (the caller
    re-runs those in log space).

    ``params`` (7,) float32 probabilities [no_gap, no_gap_x_ext,
    no_gap_y_ext, gap_x, gap_y, gap_x_ext, gap_y_ext]; ``emit`` float32
    probabilities [p_match, p_mismatch, p_gap_emit], (3,) or (B, 3).

    On the card one warp computes a pair a row at a time over lane column
    stripes (``pairhmm_scaled_geometry``); each stripe runs the Y
    recurrence in sequence from a carry that a scan over the lanes gives,
    so only the carries round otherwise than the plain version's chain
    wherever the gap extension is not 0 (within 1e-5 of max(1, |p|) on the
    tests' inputs; every lane bit-identical on chip_smoke.py's corpora)."""
    B, M, N, dev, estride = _check_batch(xs, ys, xlens, ylens, params, emit, 7, 3, (torch.float32,))
    if dev.type == "cpu":
        return pairhmm_fwd_scaled_plain(xs, ys, xlens, ylens, params, emit, semiglobal)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B:
        C, warps, placement = pairhmm_scaled_geometry(N, B, _sm_count(dev))
        scratch = torch.empty((B, 3, C, 32), dtype=torch.float32, device=dev) if placement == "scratch" else None
        PAIRHMM_FWD_SCALED.launch(
            dev, xs.data_ptr(), ys.data_ptr(), xlens.data_ptr(), ylens.data_ptr(),
            params.data_ptr(), emit.data_ptr(), estride, B, M, N, int(bool(semiglobal)), C, warps,
            out.data_ptr(), _ptr(scratch),
        )
    return out


def pairhmm_scaled_geometry(N: int, B: int, sms: int = 132):
    """K17's launch at y width ``N`` and ``B`` pairs on a card of ``sms``
    SMs: (C columns a lane, warps (that is pairs) a block, where the state
    lives: ``"registers"`` or ``"scratch"``). Lane t owns the columns
    [t * C + 1, t * C + C]: in registers C is the least power of two with
    32 * C >= N while its three f32 values a column fit
    ``SCALED_REG_BYTES`` (16 columns, N <= 512), else the least C in the
    scratch. Warps a block as ``pairhmm_log_geometry``."""
    return _lane_stripes(N, B, sms, 3 * 4, SCALED_REG_BYTES, _REG_C_MAX[3])


_F32_TINY = torch.finfo(torch.float32).tiny


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Flush f32 subnormals to zero, as the TPU and XLA's CPU backend do to
    every f32 result (and K17, built with -ftz=true)."""
    return torch.where(t.abs() < _F32_TINY, 0.0, t)


def pairhmm_fwd_scaled_plain(xs, ys, xlens, ylens, params, emit, semiglobal: bool):
    """Plain version of K17: the Pallas kernel's arithmetic (pairhmm_pallas.py
    :48-133) on (B, N + 1) state rows, every f32 result flushed to zero
    below the smallest normal (``_ftz``), the Y state's recurrence in
    sequence over j as the kernel runs it (the Pallas kernel's log-step
    prefix sums it in another order; under flush-to-zero the two can part
    on lanes whose mass passes under the smallest normal)."""
    B, M = xs.shape
    N = ys.shape[1]
    dev = xs.device
    f32 = torch.float32
    z = _ftz
    xl = _lens(xlens, M)[:, None]
    yl = _lens(ylens, N)[:, None]
    ng, ngx, ngy, gx, gy, gxe, gye = (z(params[k]) for k in range(7))
    pm, pmm, pge = (z(c) for c in _emit_cols(emit, B, 3))
    rows = torch.arange(N + 1, device=dev)[None, :]
    is_end = rows == yl
    FM = (rows == 0).to(f32).expand(B, N + 1).clone()
    FX = torch.zeros(B, N + 1, dtype=f32, device=dev)
    FY = torch.zeros_like(FX)
    LS = torch.zeros(B, 1, dtype=f32, device=dev)
    ACC = torch.zeros_like(LS)
    zero = torch.zeros(B, 1, dtype=f32, device=dev)
    c_ext = z(pge * gxe)
    c_open = z(pge * gx)
    extend = bool((c_ext != 0).any())
    em_match = z(pmm + z(pm - pmm))  # pmm + (pm - pmm) * eq at eq = 1
    for i in range(M):
        active = i < xl
        fm = FM
        if semiglobal:
            unit = z(torch.exp(-LS))
            bound = z(2.0 * unit) if i == 0 else unit
            fm = torch.cat([torch.where(active, bound, FM[:, :1]), FM[:, 1:]], 1)
        em = torch.where(ys == xs[:, i : i + 1], em_match, pmm)
        m_in = z(z(z(ng * fm[:, :-1]) + z(ngx * FX[:, :-1])) + z(ngy * FY[:, :-1]))
        fm_new = torch.cat([zero, z(em * m_in)], 1)
        fx_new = torch.cat([zero, z(pge * z(z(gy * fm[:, 1:]) + z(gye * FX[:, 1:])))], 1)
        A = z(c_open * fm_new[:, :-1])
        if extend:
            fy_cols = [zero]
            for j in range(N):
                fy_cols.append(z(A[:, j : j + 1] + z(c_ext * fy_cols[-1])))
            fy_new = torch.cat(fy_cols, 1)
        else:  # fy[j] = A[j-1] + 0 * fy[j-1] = A[j-1]
            fy_new = torch.cat([zero, A], 1)
        if semiglobal:
            row_p = torch.where(is_end, z(z(fm_new + fx_new) + fy_new), 0.0).sum(1, keepdim=True)
            ACC = z(ACC + torch.where(active, row_p, 0.0))
        mx = torch.maximum(torch.maximum(fm_new, fx_new), fy_new).amax(1, keepdim=True)
        scale = torch.where(active, mx.clamp_min(1e-30), 1.0)
        inv = 1.0 / scale
        FM = torch.where(active, z(fm_new * inv), fm)
        FX = torch.where(active, z(fx_new * inv), FX)
        FY = torch.where(active, z(fy_new * inv), FY)
        ACC = z(ACC * inv)
        LS = LS + torch.log(scale)
    if semiglobal:
        p_lin = ACC
    else:
        p_lin = torch.where(is_end, z(z(FM + FX) + FY), 0.0).sum(1, keepdim=True)
    # max(p_lin, 1e-38) is p_lin: 1e-38 is a subnormal, flushed
    out = torch.where(
        p_lin > 0,
        torch.clamp_max(torch.log(torch.where(p_lin > 0, p_lin, 1.0)) + LS, 0.0),
        torch.full_like(p_lin, NEG_F32),
    )
    return out[:, 0]


# ---------------------------------------------------------------------------
# K17-log: the log-space forward (f32 or f64)
# ---------------------------------------------------------------------------


def _neg_clamp(dtype):
    """(surrogate of -inf, exp clamp) of device.py ``_lae`` for ``dtype``."""
    return (NEG_F32, -87.0) if dtype == torch.float32 else (NEG_F64, -700.0)


def _lae(a, b, neg: float, clamp: float):
    """logaddexp that tolerates the surrogate (device.py ``_lae``)."""
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    out = hi + torch.log1p(torch.exp(torch.clamp(lo - hi, min=clamp)))
    return torch.where(lo <= neg / 2, hi, out)


def _scan_log(A, Bc, neg: float, clamp: float):
    """f[j] = lae(A[j], Bc[j] + f[j-1]) along the last dim, f[0] = A[0]: a
    log-step scan (the JAX engines' associative scan, another tree)."""
    n = A.shape[-1]
    k = 1
    while k < n:
        As = torch.cat([torch.full_like(A[..., :k], neg), A[..., :-k]], -1)
        Bs = torch.cat([torch.zeros_like(Bc[..., :k]), Bc[..., :-k]], -1)
        A = _lae(A, Bc + As, neg, clamp)
        Bc = Bc + Bs
        k *= 2
    return A


def pairhmm_log_geometry(N: int, B: int, dtype, sms: int = 132, states: int = 3):
    """K17-log's launch (``states`` 3), or K17-homopoly's (14), at y width
    ``N`` and ``B`` pairs of ``dtype`` (float32 or float64) on a card of
    ``sms`` SMs: (C columns a lane, warps (that is pairs) a block, where the
    state lives: ``"registers"`` or ``"scratch"``). Lane t owns the columns
    [t * C + 1, t * C + C]. One warp a block while the card holds every pair
    at 32 blocks an SM (the pairs spread over the SMs), more, up to 8,
    beyond that."""
    budget = LOG_REG_BYTES if states == 3 else HOMOPOLY_REG_BYTES
    return _lane_stripes(N, B, sms, states * (8 if dtype == torch.float64 else 4), budget, _REG_C_MAX[states])


def _lane_stripes(N: int, B: int, sms: int, column_bytes: int, budget: int, c_max: Optional[int] = None):
    """(C, warps a block, placement) of the PairHMM warp kernels: in
    registers the least power of two C with 32 * C >= N while C columns of
    ``column_bytes`` fit ``budget`` (and C <= ``c_max``, the largest
    register stripe a kernel instantiates, where given), else the least C in
    the scratch; one warp a block until 32 blocks an SM hold every pair,
    up to 8 beyond that."""
    C = max(1, -(-N // 32))
    pow2 = 1 << (C - 1).bit_length()
    placement = "scratch"
    if column_bytes * pow2 <= budget and (c_max is None or pow2 <= c_max):
        C, placement = pow2, "registers"
    return C, max(1, min(_LOG_WARPS_MAX, -(-B // (32 * sms)))), placement


def pairhmm_exact_geometry(N: int, B: int, banded: bool, sms: int = 132):
    """K17-exact's launch at y width ``N`` and ``B`` pairs, ``banded`` (a
    ``max_edit_dist``) or not, on a card of ``sms`` SMs: (C columns a
    lane, warps (that is pairs) a block, where the state lives:
    ``"registers"`` or ``"scratch"``), as ``pairhmm_log_geometry`` picks
    them at ``EXACT_SLOTS`` or ``EXACT_BANDED_SLOTS`` float64 values a
    column within ``EXACT_REG_BYTES``."""
    slots = EXACT_BANDED_SLOTS if banded else EXACT_SLOTS
    return _lane_stripes(N, B, sms, slots * 8, EXACT_REG_BYTES)


def pairhmm_fwd_log(xs, ys, xlens, ylens, params, emit, semiglobal: bool):
    """K17-log. (B,) log-likelihoods in ``params.dtype`` (float32 or
    float64), at most 0, the surrogate -3e38 / -1e308 for no path.

    ``params`` (7,) log probabilities [no_gap, no_gap_x_ext, no_gap_y_ext,
    gap_x, gap_y, gap_x_ext, gap_y_ext] (a -inf extend as the f32
    surrogate, as ``BatchPairHMM.g`` holds it); ``emit`` [ln p_match,
    ln p_mismatch, ln p_gap_emit], (3,) or (B, 3)."""
    B, M, N, dev, estride = _check_batch(
        xs, ys, xlens, ylens, params, emit, 7, 3, (torch.float32, torch.float64)
    )
    if dev.type == "cpu":
        return pairhmm_fwd_log_plain(xs, ys, xlens, ylens, params, emit, semiglobal)
    out = torch.empty(B, dtype=params.dtype, device=dev)
    if B:
        C, warps, placement = pairhmm_log_geometry(N, B, params.dtype, _sm_count(dev))
        scratch = torch.empty((B, 3, C, 32), dtype=params.dtype, device=dev) if placement == "scratch" else None
        PAIRHMM_FWD_LOG.launch(
            dev, xs.data_ptr(), ys.data_ptr(), xlens.data_ptr(), ylens.data_ptr(),
            params.data_ptr(), emit.data_ptr(), estride, B, M, N, int(bool(semiglobal)),
            int(params.dtype == torch.float64), C, warps, out.data_ptr(), _ptr(scratch),
        )
    return out


def pairhmm_fwd_log_plain(xs, ys, xlens, ylens, params, emit, semiglobal: bool):
    """Plain version of K17-log (device.py ``BatchPairHMM._forward``)."""
    B, M = xs.shape
    N = ys.shape[1]
    dev = xs.device
    FT = params.dtype
    neg, clamp = _neg_clamp(FT)
    xl = _lens(xlens, M)
    yl = _lens(ylens, N)[:, None]
    ng, ngxe, ngye, gx, gy, gxe, gye = (params[k] for k in range(7))
    pm, pmm, pge = _emit_cols(emit, B, 3)
    ln2 = torch.tensor(0.6931471805599453, dtype=FT, device=dev)
    col0 = torch.full((B, 1), neg, dtype=FT, device=dev)

    def lae(a, b):
        return _lae(a, b, neg, clamp)

    fm = torch.cat([torch.zeros_like(col0), col0.expand(B, N)], 1)
    fx = torch.full((B, N + 1), neg, dtype=FT, device=dev)
    fy = fx.clone()
    acc = torch.full((B,), neg, dtype=FT, device=dev)
    Bc = (pge + gxe).expand(B, N)
    for i in range(M):
        active = i < xl
        if semiglobal:
            bound = ln2 if i == 0 else torch.zeros_like(ln2)
            fm = torch.cat([torch.where(active[:, None], bound, fm[:, :1]), fm[:, 1:]], 1)
        eq = xs[:, i : i + 1] == ys
        emit_xy = torch.where(eq, pm, pmm)
        m_in = lae(lae(ng + fm[:, :-1], ngxe + fx[:, :-1]), ngye + fy[:, :-1])
        fm_c = torch.cat([col0, emit_xy + m_in], 1)
        fx_c = torch.cat([col0, pge + lae(gy + fm[:, 1:], gye + fx[:, 1:])], 1)
        A = pge + gx + fm_c[:, :-1]
        fy_c = torch.cat([col0, _scan_log(A, Bc, neg, clamp)], 1)
        keep = active[:, None]
        if semiglobal:
            ends = [t.gather(1, yl)[:, 0] for t in (fm_c, fx_c, fy_c)]
            acc = torch.where(active, lae(acc, lae(lae(*ends[:2]), ends[2])), acc)
        fm = torch.where(keep, fm_c, fm)
        fx = torch.where(keep, fx_c, fx)
        fy = torch.where(keep, fy_c, fy)
    if semiglobal:
        p = acc
    else:
        p = lae(lae(fm.gather(1, yl)[:, 0], fx.gather(1, yl)[:, 0]), fy.gather(1, yl)[:, 0])
    return torch.clamp_max(p, 0.0)


# ---------------------------------------------------------------------------
# K17-exact: the oracle-order f64 forward
# ---------------------------------------------------------------------------


def pairhmm_fwd_exact(
    xs, ys, xlens, ylens, params, emit, semiglobal: bool,
    max_edit_dist: Optional[int] = None, skip_mask: bool = False,
):
    """K17-exact. (B,) float64 log-likelihoods equal to the host oracle's
    ``PairHMM.prob_related`` (-inf for no path); with ``skip_mask`` also a
    (B, M, N) bool mask, True at every (i, j) the ``max_edit_dist`` band
    skipped (the oracle's ``skip_trace``).

    ``params`` (7,) float64 [no_gap, no_gap_x_ext, no_gap_y_ext, gap_x,
    gap_y, gap_x_ext, gap_y_ext] as the oracle's ``_GapParamCache`` holds
    them (an extend of -inf switches that extension off); ``emit`` float64
    [ln p_match, ln p_mismatch, ln p_gap_emit], (3,) or (B, 3)."""
    B, M, N, dev, estride = _check_batch(xs, ys, xlens, ylens, params, emit, 7, 3, (torch.float64,))
    if dev.type == "cpu":
        return pairhmm_fwd_exact_plain(xs, ys, xlens, ylens, params, emit, semiglobal, max_edit_dist, skip_mask)
    banded = max_edit_dist is not None
    out = torch.empty(B, dtype=torch.float64, device=dev)
    skip = torch.zeros((B, M, N), dtype=torch.uint8, device=dev) if skip_mask else None
    if B:
        ends = torch.empty((B, 3 * M), dtype=torch.float64, device=dev) if semiglobal else None
        C, warps, placement = pairhmm_exact_geometry(N, B, banded, _sm_count(dev))
        slots = EXACT_BANDED_SLOTS if banded else EXACT_SLOTS
        scratch = torch.empty((B, slots, C, 32), dtype=torch.float64, device=dev) if placement == "scratch" else None
        PAIRHMM_FWD_EXACT.launch(
            dev, xs.data_ptr(), ys.data_ptr(), xlens.data_ptr(), ylens.data_ptr(),
            params.data_ptr(), emit.data_ptr(), estride, B, M, N, int(bool(semiglobal)),
            int(banded), int(max_edit_dist) if banded else 0, C, warps, out.data_ptr(), _ptr(ends),
            _ptr(skip), _ptr(scratch),
        )
    if skip_mask:
        return out, skip.bool()
    return out


def _lae_exact(a, b):
    """LogProb(a).ln_add_exp(b), vectorized (exact.py ``_lae``)."""
    inf = float("inf")
    p0 = torch.maximum(a, b)
    p1 = torch.minimum(a, b)
    diff = torch.where(torch.isfinite(p0), p1 - p0, 0.0)
    out = p0 + torch.log1p(fastexp_torch(diff))
    out = torch.where(p0 == inf, inf, out)
    out = torch.where(p0 == -inf, -inf, out)
    return torch.where(b == -inf, a, out)


def _ln_sum3_exp_approx(p0, p1, p2):
    """pairhmm.rs ln_sum3_exp_approx (exact.py ``_ln_sum3_exp_approx``)."""
    inf = float("inf")
    s1 = p1 < p2
    q1 = torch.where(s1, p2, p1)
    q2 = torch.where(s1, p1, p2)
    s2 = q1 > p0
    r0 = torch.where(s2, q1, p0)
    r1 = torch.where(s2, p0, q1)
    s = fastexp_torch(r1 - r0) + fastexp_torch(q2 - r0)
    out = torch.where(r0 - r1 > 10.0, r0, r0 + torch.log1p(s))
    out = torch.where(r0 == inf, inf, out)
    return torch.where(r0 == -inf, -inf, out)


def _ln_sum_exp3(a, b, c):
    """LogProb.ln_sum_exp([a, b, c]): first strict maximum, index order."""
    inf = float("inf")
    pmax = torch.maximum(a, torch.maximum(b, c))
    im2 = c > torch.maximum(a, b)
    im1 = ~im2 & (b > a)
    im0 = ~im2 & ~im1
    sa = torch.where(im0, 0.0, fastexp_torch(a - pmax))
    sb = torch.where(im1, 0.0, fastexp_torch(b - pmax))
    sc = torch.where(im2, 0.0, fastexp_torch(c - pmax))
    out = pmax + torch.log1p((sa + sb) + sc)
    out = torch.where(pmax == inf, inf, out)
    return torch.where(pmax == -inf, -inf, out)


def pairhmm_fwd_exact_plain(
    xs, ys, xlens, ylens, params, emit, semiglobal: bool,
    max_edit_dist: Optional[int] = None, skip_mask: bool = False,
):
    """Plain version of K17-exact (exact.py ``BatchPairHMMExact._forward``):
    the stale rows of the oracle's two rolling buffers carried alongside,
    the band's med row and an extended Y state as loops over j; med in
    int64 with ``MED_SENT`` for usize::MAX (values only feed min and the
    band test, so the order is kept)."""
    B, M = xs.shape
    N = ys.shape[1]
    dev = xs.device
    F = torch.float64
    inf = float("inf")
    banded = max_edit_dist is not None
    K_ed = int(max_edit_dist) if banded else 0
    xl = _lens(xlens, M)
    yl = _lens(ylens, N)[:, None]
    no_gap, ngxe, ngye, gx, gy, gxe, gye = (params[k] for k in range(7))
    do_gxe = bool(gxe != -inf)
    pm, pmm, pge = _emit_cols(emit, B, 3)
    start_gap = torch.tensor(0.0 if semiglobal else -inf, dtype=F, device=dev)
    neg_col = torch.full((B, 1), -inf, dtype=F, device=dev)

    neg = torch.full((B, N + 1), -inf, dtype=F, device=dev)
    fm_p = neg.clone()
    fm_p[:, 0] = 0.0
    fx_p, fy_p, fx_s, fy_s = neg, neg, neg, neg
    sent = torch.full((B, N + 1), MED_SENT, dtype=torch.int64, device=dev)
    med_p, med_s = sent, sent
    ends_rows = []
    skips = []
    for i in range(M):
        active = (i < xl)[:, None]
        fm_p = torch.cat([torch.where(active, _lae_exact(fm_p[:, :1], start_gap), fm_p[:, :1]), fm_p[:, 1:]], 1)
        if banded and semiglobal:
            med_p = torch.cat([torch.where(active, 0, med_p[:, :1]), med_p[:, 1:]], 1)
        eq = xs[:, i : i + 1] == ys
        if banded:
            med_top = med_s[:, 0]
            skip_cols, med_cols = [], []
            for j in range(N):
                tl, left, stale_j = med_p[:, j], med_p[:, j + 1], med_s[:, j + 1]
                skip_j = torch.minimum(torch.minimum(tl, med_top), left) > K_ed
                m = torch.where(eq[:, j], tl, tl + 1)
                new_med = torch.minimum(torch.minimum(m, left + 1), med_top + 1)
                med_top = torch.where(skip_j, stale_j, new_med)
                skip_cols.append(skip_j)
                med_cols.append(med_top)
            skip = torch.stack(skip_cols, 1)
            med_c = torch.cat([med_s[:, :1], torch.stack(med_cols, 1)], 1)
        else:
            skip = torch.zeros((B, N), dtype=torch.bool, device=dev)
            med_c = med_s
        emit_xy = torch.where(eq, pm, pmm)
        m_in = _ln_sum3_exp_approx(no_gap + fm_p[:, :-1], ngxe + fx_p[:, :-1], ngye + fy_p[:, :-1])
        fm_c = torch.cat([neg_col, torch.where(skip, -inf, emit_xy + m_in)], 1)
        fx_new = _lae_exact(pge + (gy + fm_p[:, 1:]), gye + fx_p[:, 1:])
        fx_c = torch.cat([fx_s[:, :1], torch.where(skip, fx_s[:, 1:], fx_new)], 1)
        if not do_gxe:
            fy_new = pge + (gx + fm_c[:, :-1])
            fy_c = torch.cat([fy_s[:, :1], torch.where(skip, fy_s[:, 1:], fy_new)], 1)
        else:
            fy_jm1 = fy_s[:, 0]
            cols = []
            for j in range(N):
                v = _lae_exact(pge[:, 0] + (gx + fm_c[:, j]), gxe + fy_jm1)
                fy_jm1 = torch.where(skip[:, j], fy_s[:, j + 1], v)
                cols.append(fy_jm1)
            fy_c = torch.cat([fy_s[:, :1], torch.stack(cols, 1)], 1)
        ends = torch.stack([t.gather(1, yl)[:, 0] for t in (fm_c, fx_c, fy_c)])  # (3, B)
        ends_rows.append(torch.where(active[:, 0][None, :], ends, -inf))
        skips.append(skip & active)
        fm_p, fx_p, fy_p, fx_s, fy_s, med_p, med_s = (
            torch.where(active, fm_c, fm_p),
            torch.where(active, fx_c, fx_p),
            torch.where(active, fy_c, fy_p),
            torch.where(active, fx_p, fx_s),
            torch.where(active, fy_p, fy_s),
            torch.where(active, med_c, med_p),
            torch.where(active, med_p, med_s),
        )
    if semiglobal:
        if M:
            flat = torch.cat(ends_rows, 0)  # (3M, B), row-major over (i, state)
        else:
            flat = torch.full((1, B), -inf, dtype=F, device=dev)
        pmax = flat.max(0).values
        first = (flat == pmax[None, :]).to(torch.int32).argmax(0)
        s = torch.zeros_like(pmax)
        for k in range(flat.shape[0]):
            s = s + torch.where(first == k, 0.0, fastexp_torch(flat[k] - pmax))
        p = pmax + torch.log1p(s)
        p = torch.where(pmax == inf, inf, p)
        p = torch.where(pmax == -inf, -inf, p)
    else:
        p = _ln_sum_exp3(*(t.gather(1, yl)[:, 0] for t in (fm_p, fx_p, fy_p)))
    p = torch.where(p > 0.0, 0.0, p)
    if skip_mask:
        cols = torch.arange(N, device=dev)[None, None, :]
        mask = torch.stack(skips, 1) if M else torch.zeros((B, 0, N), dtype=torch.bool, device=dev)
        return p, mask & (cols < yl[:, :, None])
    return p


# ---------------------------------------------------------------------------
# K17-homopoly: the 14-state forward (f32 or f64)
# ---------------------------------------------------------------------------


def pairhmm_fwd_homopoly(xs, ys, xlens, ylens, params, emit, semiglobal: bool):
    """K17-homopoly. (B,) log-likelihoods in ``params.dtype`` (float32 or
    float64), at most 0, the surrogate -3e38 / -1e308 for no path.

    ``params`` (34,): [match_any, pgx, pgy, pgxe, pgye, from_gx, from_gy],
    then hx, hy, hxe, hye, from_hx, from_hy (4 each, A/C/G/T), then ln 2,
    ln 0.25 and -ln 4 in that dtype (``BatchHomopolyPairHMM.p`` in this
    order); ``emit`` [ln p_match, ln p_mismatch, ln p_emit_x, ln p_emit_y],
    (4,) or (B, 4)."""
    B, M, N, dev, estride = _check_batch(
        xs, ys, xlens, ylens, params, emit, HOMOPOLY_NPAR, 4, (torch.float32, torch.float64)
    )
    if dev.type == "cpu":
        return pairhmm_fwd_homopoly_plain(xs, ys, xlens, ylens, params, emit, semiglobal)
    out = torch.empty(B, dtype=params.dtype, device=dev)
    if B:
        C, warps, placement = pairhmm_log_geometry(N, B, params.dtype, _sm_count(dev), HOMOPOLY_STATES)
        scratch = None
        if placement == "scratch":
            scratch = torch.empty((B, HOMOPOLY_STATES, C, 32), dtype=params.dtype, device=dev)
        PAIRHMM_FWD_HOMOPOLY.launch(
            dev, xs.data_ptr(), ys.data_ptr(), xlens.data_ptr(), ylens.data_ptr(),
            params.data_ptr(), emit.data_ptr(), estride, B, M, N, int(bool(semiglobal)),
            int(params.dtype == torch.float64), C, warps, out.data_ptr(), _ptr(scratch),
        )
    return out


def _lse_stack(arrs, neg, clamp):
    out = arrs[0]
    for a in arrs[1:]:
        out = _lae(out, a, neg, clamp)
    return out


def pairhmm_fwd_homopoly_plain(xs, ys, xlens, ylens, params, emit, semiglobal: bool):
    """Plain version of K17-homopoly (homopoly_device.py
    ``BatchHomopolyPairHMM._forward``): (B, 4, N + 1) match, hop-X and
    hop-Y rows, (B, N + 1) GapX and GapY rows, the in-row GapX and hop-X
    recurrences as one stacked log-step scan."""
    B, M = xs.shape
    N = ys.shape[1]
    dev = xs.device
    FT = params.dtype
    neg, clamp = _neg_clamp(FT)
    xl = _lens(xlens, M)
    yl = _lens(ylens, N)
    match_any, pgx, pgy, pgxe, pgye, from_gx, from_gy = (params[k] for k in range(7))
    hx, hy, hxe, hye, from_hx, from_hy = (params[7 + 4 * r : 11 + 4 * r] for r in range(6))
    ln2, quarter, neg_ln4 = params[31], params[32], params[33]
    p_match, p_mismatch, pe_x, pe_y = _emit_cols(emit, B, 4)

    def lae(a, b):
        return _lae(a, b, neg, clamp)

    def lse(arrs):
        return _lse_stack(arrs, neg, clamp)

    def lse4(a):  # over dim 1 of (B, 4, ...)
        return lse([a[:, k] for k in range(4)])

    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    ey_gate = ys[:, None, :] == bases[None, :, None]  # (B, 4, N)
    vm = torch.full((B, 4, N + 1), neg, dtype=FT, device=dev)
    vm[:, :, 0] = quarter
    vgx = torch.full((B, N + 1), neg, dtype=FT, device=dev)
    vgy = vgx.clone()
    vhx = torch.full((B, 4, N + 1), neg, dtype=FT, device=dev)
    vhy = vhx.clone()
    col1 = torch.full((B, 14), neg, dtype=FT, device=dev)
    col2 = col1.clone()
    acc = torch.full((B,), neg, dtype=FT, device=dev)
    neg1 = torch.full((B, 1), neg, dtype=FT, device=dev)
    neg4 = torch.full((B, 4, 1), neg, dtype=FT, device=dev)
    B_gx = (pe_y + pgye).expand(B, N)
    B_hx = hxe[None, :, None].expand(B, 4, N)
    n_stale = torch.clamp_min(yl - 1, 0).to(FT)
    ln_nstale = torch.where(n_stale > 0, torch.log(torch.clamp_min(n_stale, 1.0)), neg)
    idx1 = yl[:, None]
    idx2 = yl[:, None, None].expand(B, 4, 1)
    for i in range(M):
        active = i < xl
        xi = xs[:, i : i + 1]
        if semiglobal:
            v0 = lae(vm[:, :, 0], neg_ln4.expand(B, 4))
            vm = torch.cat([torch.where(active[:, None], v0, vm[:, :, 0])[:, :, None], vm[:, :, 1:]], 2)
        gate = (xi == bases[None, :])[:, :, None] | ey_gate
        eq = xi == ys
        ep_m = torch.where(eq, p_match, p_mismatch - ln2)
        pre = lse(
            [match_any + lse4(vm[:, :, :-1]), from_gx + vgx[:, :-1], from_gy + vgy[:, :-1]]
            + [from_hx[k] + vhx[:, k, :-1] for k in range(4)]
            + [from_hy[k] + vhy[:, k, :-1] for k in range(4)]
        )
        vm_c = torch.cat([neg4, torch.where(gate, (ep_m + pre)[:, None, :], neg)], 2)
        vgy_c = torch.cat([neg1, pe_x + lae(pgx + lse4(vm[:, :, 1:]), pgxe + vgy[:, 1:])], 1)
        vhy_c = torch.cat(
            [neg4, lae(hy[None, :, None] + vm[:, :, 1:], hye[None, :, None] + vhy[:, :, 1:])], 2
        )
        A_gx = pe_y + pgy + lse4(vm_c[:, :, :-1])
        A_hx = hx[None, :, None] + vm_c[:, :, :-1]
        As = _scan_log(
            torch.cat([A_gx[:, None, :], A_hx], 1), torch.cat([B_gx[:, None, :], B_hx], 1), neg, clamp
        )
        vgx_c = torch.cat([neg1, As[:, 0]], 1)
        vhx_c = torch.cat([neg4, As[:, 1:]], 2)
        fresh = torch.cat(
            [
                vm_c.gather(2, idx2)[:, :, 0], vgx_c.gather(1, idx1), vgy_c.gather(1, idx1),
                vhx_c.gather(2, idx2)[:, :, 0], vhy_c.gather(2, idx2)[:, :, 0],
            ],
            1,
        )  # (B, 14)
        keep1 = active[:, None]
        keep2 = active[:, None, None]
        vm = torch.where(keep2, vm_c, neg)
        vgx = torch.where(keep1, vgx_c, vgx)
        vgy = torch.where(keep1, vgy_c, vgy)
        vhx = torch.where(keep2, vhx_c, vhx)
        vhy = torch.where(keep2, vhy_c, vhy)
        if semiglobal:
            stale = torch.cat([torch.full_like(col2[:, :4], neg), col2[:, 4:]], 1)
            row_mass = lae(
                lse([stale[:, s] + ln_nstale for s in range(14)]), lse([fresh[:, s] for s in range(14)])
            )
            acc = torch.where(active, lae(acc, row_mass), acc)
        else:
            acc = torch.where(active, lse([fresh[:, s] for s in range(14)]), acc)
        col2, col1 = col1, fresh
    return torch.clamp_max(acc, 0.0)
