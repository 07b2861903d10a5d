"""Batched SMEM search over an FMD index: kernel K-SMEM, CUDA source in
``csrc/fmd_smem.cu``. K-SMEM replaces no Pallas kernel: the XLA function
``rust_bio_tpu/data_structures/fmd_device.py:143`` ``_smems_impl``, two
``lax.while_loop``s over a slot axis, the hot loop of the SMEM read
mapper's seeding (reference: ``FMDIndex::smems``, fmindex.rs:367-434).

One query is a (pattern, position i) pair. Phase 1 extends the interval of
``pats[i]`` forward to the pattern's end and appends the interval before
every step that shrinks it (``E`` slots, newest first after the phase);
phase 2 extends every slot backward from i - 1 down to the sentinel,
keeps the first slot of each new size, and emits a match (the slot's
interval, start k + 1 and length) where the first slot with no appended
slot before it dies (or k reaches -1), at most ``MC`` a query. ``mapper``
mode ranks only the queried symbol in phase 2 and carries the reverse
interval's lower bound (``lor``) from phase 1 unchanged; full mode ranks
the KE extension-order symbols at both ends and updates ``lor``
(``FMDIndex.backward_ext``). In mapper mode with E >= 4 phase 2 narrows its
slots on a fixed schedule (E, then E/2 after step 10, E/4 after step 16,
E/8 after step 22); a query with more live slots than the next width, with
a phase-1 append past E slots, or an emission past MC, is flagged ``ovf``
(its outputs are still the XLA function's).

Tables (from ``fmd_device.DeviceFMDIndex``): ``fused`` (S, nw, 2) int32 and
its row layout ``rows`` (nw, 2S) int32 (``DeviceFMIndex.ensure_row_layout``),
``less_b`` (257,) int32 by byte, ``sym_of`` (256,) int32, ``comp`` (256,)
uint8 (the DNA complement), ``ext_pos`` (256,) int32 (a byte's position in
``_EXT_ORDER``, -1 outside), ``ext_sym`` (11,) int32 (each extension-order
byte's symbol index, -1 where the index lacks it) and ``KE``. Inputs:
``pats`` (B, L) uint8, ``plens`` (B,) int32, ``iis`` (B,) int32 in [0, L)
(read clamped to it), ``l_min``, ``E`` (1-32) and ``MC`` (>= 1). Outputs:
``m_lo``, ``m_lor``, ``m_sz``, ``m_st``, ``m_ml`` (B, MC) int32, ``mcnt``
(B,) int32, ``ovf`` (B,) bool, bit for bit the XLA function's (int32
arithmetic wraps as XLA's; a rank position is clamped into the table as
XLA's gather clamps it; an extension-order position past KE reads
INT32_MIN, XLA's fill value).

``seed_pick`` is the mapper's seed chain head (``read_mapper.py:569-597``
``_seed_impl``): K-SMEM in mapper mode with MC = E, folding the pick of the
longest match (the first on ties) into its epilog: it writes the picked
row (``m_lo`` of the pick where the query found a match and did not
overflow, else 0) and the (4, B) int32 rows (start, length, found, ovf)
without writing the seven outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rust_bio_tpu_torch.ops._build import INT, PTR, CudaKernel, check, same_device
from rust_bio_tpu_torch.ops.fm import U32_MASK, _popcount32

# the extension order of FMDIndex.backward_ext (fmindex.rs:520-540)
EXT_ORDER = b"$TGCNAtgcna"
INT32_MIN = -(2**31)
MAX_SLOTS = 32  # one slot a lane of the query's warp
# csrc/fmd_smem.cu's WARPS: queries a block
SMEM_WARPS = 4
FMD_SMEMS = CudaKernel("fmd_smem", "fmd_smems", [PTR, PTR, INT, INT] + [PTR] * 5 + [INT] + [PTR] * 3 + [INT] * 13 + [PTR] * 9)


class FmdTables(NamedTuple):
    """The index tables K-SMEM reads (see the module docstring)."""

    fused: torch.Tensor
    rows: torch.Tensor
    less_b: torch.Tensor
    sym_of: torch.Tensor
    comp: torch.Tensor
    ext_pos: torch.Tensor
    ext_sym: torch.Tensor
    KE: int


def ext_tables(sym_of: np.ndarray):
    """(ext_pos (256,), ext_sym (11,), KE) of an index's ``sym_of``: KE is
    one past the last extension-order position whose byte the index holds
    (fmd_device.py ``__init__``)."""
    ext = np.frombuffer(EXT_ORDER, np.uint8)
    ext_pos = np.full(256, -1, np.int32)
    ext_pos[ext] = np.arange(len(ext), dtype=np.int32)
    ext_sym = np.asarray(sym_of, np.int32)[ext]
    present = np.nonzero(ext_sym >= 0)[0]
    KE = int(present.max()) + 1 if present.size else 1
    return ext_pos, ext_sym, KE


def schedule(E: int, mapper: bool):
    """Phase 2's stages: (step limit or None, slot width) each, as the XLA
    function narrows the slots (fmd_device.py:345-359)."""
    if mapper and E >= 4:
        return [(10, E), (16, E // 2), (22, max(E // 4, 1)), (None, max(E // 8, 1))]
    return [(None, E)]


def _check(t: FmdTables, pats, plens, iis, E: int, MC: int):
    dev = same_device(t.fused, t.rows, t.less_b, t.sym_of, t.comp, t.ext_pos, t.ext_sym, pats, plens, iis)
    if t.fused.dim() != 3 or pats.dim() != 2:
        raise ValueError("fused must be (S, nw, 2) and pats (B, L)")
    S, nw, _ = t.fused.shape
    B, L = pats.shape
    check(t.fused, "fused", torch.int32, (S, nw, 2))
    check(t.rows, "rows", torch.int32, (nw, 2 * S))
    check(t.less_b, "less_b", torch.int32, (257,))
    check(t.sym_of, "sym_of", torch.int32, (256,))
    check(t.comp, "comp", torch.uint8, (256,))
    check(t.ext_pos, "ext_pos", torch.int32, (256,))
    check(t.ext_sym, "ext_sym", torch.int32, (len(EXT_ORDER),))
    check(pats, "pats", torch.uint8, (B, L))
    check(plens, "plens", torch.int32, (B,))
    check(iis, "iis", torch.int32, (B,))
    if not 1 <= t.KE <= len(EXT_ORDER):
        raise ValueError(f"KE = {t.KE}: expected 1 to {len(EXT_ORDER)}")
    if not 1 <= E <= MAX_SLOTS:
        raise ValueError(f"E = {E}: expected 1 to {MAX_SLOTS} slots")
    if MC < 1:
        raise ValueError(f"MC = {MC}: expected at least one match slot")
    if B and L == 0:
        raise ValueError("pats has no columns")
    return dev, B


def _launch(dev, t: FmdTables, pats, plens, iis, l_min, E, MC, mapper, outs, pick_rows, pick):
    B, L = pats.shape
    S, nw, _ = t.fused.shape
    sched = schedule(E, mapper)
    lims = [lim for lim, _ in sched[:-1]] + [0] * (4 - len(sched))
    widths = [w for _, w in sched[1:]] + [0] * (4 - len(sched))
    ptr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    FMD_SMEMS.launch(
        dev, t.fused.data_ptr(), t.rows.data_ptr(), S, nw,
        t.less_b.data_ptr(), t.sym_of.data_ptr(), t.comp.data_ptr(), t.ext_pos.data_ptr(), t.ext_sym.data_ptr(), t.KE,
        pats.data_ptr(), plens.data_ptr(), iis.data_ptr(), B, L,
        int(l_min), E, MC, int(mapper), len(sched), *lims[:3], *widths[:3],
        *(ptr(o) for o in outs), ptr(pick_rows), ptr(pick),
    )


def smems(t: FmdTables, pats, plens, iis, l_min: int, E: int, MC: int, mapper: bool = False):
    """K-SMEM. Returns (m_lo, m_lor, m_sz, m_st, m_ml, mcnt, ovf)."""
    dev, B = _check(t, pats, plens, iis, E, MC)
    if dev.type == "cpu":
        return smems_plain(t, pats, plens, iis, l_min, E, MC, mapper)
    outs = [torch.empty((B, MC), dtype=torch.int32, device=dev) for _ in range(5)]
    outs += [torch.empty(B, dtype=torch.int32, device=dev), torch.empty(B, dtype=torch.bool, device=dev)]
    if B:
        _launch(dev, t, pats, plens, iis, l_min, E, MC, mapper, outs, None, None)
    return tuple(outs)


def seed_pick(t: FmdTables, pats, plens, iis, l_min: int, E: int, out: torch.Tensor):
    """K-SMEM in mapper mode (MC = E) with the pick in its epilog: returns
    the (B,) int32 picked rows and writes (start, length, found, ovf) of
    the pick into ``out``, a contiguous (4, B) int32 tensor."""
    dev, B = _check(t, pats, plens, iis, E, E)
    check(out, "out", torch.int32, (4, B))
    if dev.type == "cpu":
        rows, pick = pick_plain(*smems_plain(t, pats, plens, iis, l_min, E, E, True))
        out.copy_(pick)
        return rows
    rows = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        _launch(dev, t, pats, plens, iis, l_min, E, E, True, [None] * 7, rows, out)
    return rows


# ---------------------------------------------------------------------------
# plain PyTorch versions (queries and slots vectorized, steps in a Python
# loop with a host sync a step)
# ---------------------------------------------------------------------------


def _rank(fused: torch.Tensor, pos: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """Rank of symbol index ``sym`` (>= 0) at int32 positions ``pos``: 0
    where pos < 0, the word index clamped to the table (XLA's gather)."""
    nw = fused.shape[1]
    p = pos.clamp(min=0).long()
    pair = fused[sym.long(), (p >> 5).clamp(max=nw - 1)]
    mask = (1 << ((p & 31) + 1)) - 1
    cnt = pair[..., 1] + _popcount32((pair[..., 0].long() & U32_MASK) & mask).to(torch.int32)
    return torch.where(pos < 0, 0, cnt)


def _take(m: torch.Tensor, aidx: torch.Tensor, KE: int) -> torch.Tensor:
    """``take_along_axis(m, aidx)`` as XLA takes it: -1 wraps to KE - 1, an
    index past the columns reads INT32_MIN."""
    idx = torch.where(aidx < 0, aidx + KE, aidx)
    got = m.gather(1, idx.clamp(0, KE - 1).long()[:, None])[:, 0]
    return torch.where(idx < KE, got, INT32_MIN)


def _backward_ext(t: FmdTables, lo, lor, sz, a):
    """(lo', lor', sz') of the backward extensions by bytes ``a``, every
    extension-order symbol ranked at both ends (fmd_device.py
    ``_backward_ext``)."""
    KE = t.KE
    hi = lo + sz - 1
    syms = t.ext_sym[:KE].clamp(min=0)
    valid = (t.ext_sym[:KE] >= 0)[None, :]
    r_lo = torch.where(valid, _rank(t.fused, (lo - 1)[:, None], syms[None, :]), 0)
    r_hi = torch.where(valid, _rank(t.fused, hi[:, None], syms[None, :]), 0)
    o_all = torch.where((lo > 0)[:, None], r_lo, 0)
    s_all = r_hi - o_all
    cums = torch.cumsum(s_all, dim=1).to(torch.int32)
    aidx = t.ext_pos[a.long()]
    ssel = _take(s_all, aidx, KE)
    lor_new = lor + (_take(cums, aidx, KE) - ssel)
    lo_new = t.less_b[a.long()] + _take(o_all, aidx, KE)
    return lo_new, lor_new, ssel


def _forward_ext(t: FmdTables, lo, lor, sz, a):
    k2, l2, s2 = _backward_ext(t, lor, lo, sz, t.comp[a.long()])
    return l2, k2, s2


def _backward_ext_nolor(t: FmdTables, lo, sz, a):
    """(lo', sz') ranking only the queried symbol (fmd_device.py
    ``_backward_ext_nolor``)."""
    hi = lo + sz - 1
    sym = t.sym_of[a.long()]
    symc = sym.clamp(min=0)
    o = torch.where((lo > 0) & (sym >= 0), _rank(t.fused, lo - 1, symc), 0)
    s = torch.where(sym >= 0, _rank(t.fused, hi, symc), 0) - o
    return t.less_b[a.long()] + o, s


def smems_plain(t: FmdTables, pats, plens, iis, l_min: int, E: int, MC: int, mapper: bool = False, work=None):
    """Plain version of K-SMEM: ``_smems_impl``'s two loops over (B, E)
    slot arrays. The per-slot scan of the last size and the emission is
    closed-form: the last size before slot e is the size of the nearest
    earlier slot that can append (a slot that could but did not had that
    same size), and a slot may emit when no slot before it appended.

    ``work``, a dict, receives the steps this input needs (one host sync
    each): ``phase1_steps`` (a query's forward extensions), ``phase2_steps``
    (its backward steps) and ``slot_steps`` (valid slots extended)."""
    B, L = pats.shape
    dev = pats.device
    i32 = torch.int32
    bidx = torch.arange(B, device=dev)
    ii = iis.clamp(0, max(L - 1, 0)).long()
    plens = plens.to(i32)

    # phase 1: forward extensions from position i
    a0 = pats[bidx, ii].long()
    lo = t.less_b[a0]
    lor = t.less_b[t.comp[a0].long()]
    sz = t.less_b[a0 + 1] - lo
    mlen = (sz != 0).to(i32)
    ar = torch.arange(E, device=dev)
    s_lo, s_lor, s_sz, s_ml = (torch.zeros((B, E), dtype=i32, device=dev) for _ in range(4))
    cnt = torch.zeros(B, dtype=i32, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    step = 1
    while step <= L and bool(alive.any()):
        pos = ii + step
        in_rng = pos < plens
        a = pats[bidx, pos.clamp(max=L - 1)]
        flo, flor, fsz = _forward_ext(t, lo, lor, sz, a)
        if work is not None:
            work["phase1_steps"] = work.get("phase1_steps", 0) + int((alive & in_rng).sum())
        app = alive & in_rng & (sz != fsz)
        onehot = (ar[None, :] == cnt[:, None]) & app[:, None]
        s_lo = torch.where(onehot, lo[:, None], s_lo)
        s_lor = torch.where(onehot, lor[:, None], s_lor)
        s_sz = torch.where(onehot, sz[:, None], s_sz)
        s_ml = torch.where(onehot, mlen[:, None], s_ml)
        ovf = ovf | (app & (cnt >= E))
        cnt = cnt + app.to(i32)
        cont = alive & in_rng & (fsz != 0)
        lo, lor, sz = torch.where(cont, flo, lo), torch.where(cont, flor, lor), torch.where(cont, fsz, sz)
        mlen = mlen + cont.to(i32)
        alive = cont
        step += 1
    onehot = ar[None, :] == cnt[:, None]
    s_lo = torch.where(onehot, lo[:, None], s_lo)
    s_lor = torch.where(onehot, lor[:, None], s_lor)
    s_sz = torch.where(onehot, sz[:, None], s_sz)
    s_ml = torch.where(onehot, mlen[:, None], s_ml)
    ovf = ovf | (cnt >= E)
    cnt = cnt + 1
    ridx = (cnt[:, None] - 1 - ar[None, :]).clamp(0, E - 1).long()
    s_lo, s_lor, s_sz, s_ml = (m.gather(1, ridx) for m in (s_lo, s_lor, s_sz, s_ml))
    valid = ar[None, :] < cnt[:, None]

    # phase 2: backward sweep k = i - 1 .. -1
    m_lo, m_lor, m_sz, m_st, m_ml = (torch.zeros((B, MC), dtype=i32, device=dev) for _ in range(5))
    arm = torch.arange(MC, device=dev)
    j = plens.clone()
    mcnt = torch.zeros(B, dtype=i32, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    tau = 1
    sched = schedule(E, mapper)
    for si, (lim, ecur) in enumerate(sched):
        are = torch.arange(ecur, device=dev)
        while bool(alive.any()) and (lim is None or tau <= lim):
            k = ii.to(i32) - tau
            if work is not None:
                work["phase2_steps"] = work.get("phase2_steps", 0) + int(alive.sum())
                work["slot_steps"] = work.get("slot_steps", 0) + int((valid & alive[:, None]).sum())
            a = torch.where(k == -1, ord("$"), pats[bidx, k.clamp(min=0).long()].to(i32))
            af = a[:, None].expand(B, ecur).reshape(-1)
            if mapper:
                elo, esz = _backward_ext_nolor(t, s_lo.reshape(-1), s_sz.reshape(-1), af)
                elor = s_lor.reshape(-1)
            else:
                elo, elor, esz = _backward_ext(t, s_lo.reshape(-1), s_lor.reshape(-1), s_sz.reshape(-1), af)
            elo, elor, esz = (v.reshape(B, ecur) for v in (elo, elor, esz))
            can_app = valid & (esz != 0)
            prev = torch.cummax(torch.where(can_app, are[None, :], -1), dim=1).values
            prev = torch.cat([torch.full((B, 1), -1, dtype=prev.dtype, device=dev), prev[:, :-1]], dim=1)
            last = torch.where(prev >= 0, esz.gather(1, prev.clamp(min=0)), -1)
            appended = can_app & (esz != last)
            before = (torch.cumsum(appended.to(i32), dim=1) - appended.to(i32)) > 0
            em = (
                valid & ((esz == 0) | (k == -1)[:, None]) & ~before
                & (k < j)[:, None] & (s_ml >= l_min)
            )
            emitted = em.any(dim=1) & alive
            emit_slot = torch.argmax(em.to(i32), dim=1)[:, None]
            j = torch.where(emitted, k, j)
            onehot = (arm[None, :] == mcnt[:, None]) & emitted[:, None]
            m_lo = torch.where(onehot, s_lo.gather(1, emit_slot), m_lo)
            m_lor = torch.where(onehot, s_lor.gather(1, emit_slot), m_lor)
            m_sz = torch.where(onehot, s_sz.gather(1, emit_slot), m_sz)
            m_st = torch.where(onehot, (k + 1)[:, None], m_st)
            m_ml = torch.where(onehot, s_ml.gather(1, emit_slot), m_ml)
            ovf = ovf | (emitted & (mcnt >= MC))
            mcnt = mcnt + emitted.to(i32)
            appended = appended & alive[:, None]
            s_lo = torch.where(appended, elo, s_lo)
            s_lor = torch.where(appended, elor, s_lor)
            s_sz = torch.where(appended, esz, s_sz)
            s_ml = torch.where(appended, s_ml + 1, s_ml)
            valid = appended
            alive = alive & appended.any(dim=1) & (k > -1)
            tau += 1
        if lim is not None:
            # narrow to the next stage's width, valid slots first in order;
            # a live query with more valid slots than that retires as ovf
            ec = sched[si + 1][1]
            over = alive & (valid.sum(dim=1) > ec)
            ovf = ovf | over
            alive = alive & ~over
            order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)[:, :ec]
            s_lo, s_lor, s_sz, s_ml, valid = (m.gather(1, order) for m in (s_lo, s_lor, s_sz, s_ml, valid))
    return m_lo, m_lor, m_sz, m_st, m_ml, mcnt, ovf


def pick_plain(m_lo, m_lor, m_sz, m_st, m_ml, mcnt, ovf):
    """The seed pick of ``_seed_impl`` on K-SMEM's outputs: the first
    longest stored match. Returns (rows (B,), (4, B) int32 of start,
    length, found, ovf)."""
    B, MC = m_lo.shape
    valid = torch.arange(MC, device=m_lo.device)[None, :] < mcnt[:, None]
    best = torch.argmax(torch.where(valid, m_ml, -1), dim=1)[:, None]
    found = (mcnt > 0) & ~ovf
    rows = torch.where(found, m_lo.gather(1, best)[:, 0], 0)
    pick = torch.stack([m_st.gather(1, best)[:, 0], m_ml.gather(1, best)[:, 0], found.to(torch.int32), ovf.to(torch.int32)])
    return rows, pick
