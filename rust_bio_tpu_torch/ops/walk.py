"""Column-sweep traceback walks: kernel K2 (global mode, CUDA source
``csrc/walk_global.cu``) and kernel K6 (semiglobal family,
``csrc/walk_semiglobal.cu``). They replace ``rust_bio_tpu/ops/walk_pallas.py``
``sweep_walk_global`` and ``sweep_walk_semiglobal``.

Input: the traceback tensor of K1 or K5 (``ops.sw``), ``tb`` (N, X, B) uint16
with X = M + 1, and ``mlens``/``nlens`` (B,) int32. Output, per DP column j
(row j - 1) and pair: ``ins_cnt`` Ins ops, then one exit op ``exit_op``
(TB_MATCH / TB_SUBST / TB_DEL, in K6 also TB_YCLIP_PREFIX; 0 where the pair
is not), walking end -> start; plus ``ins0``, the Ins run in column 0. All
uint16.
"""

from __future__ import annotations

import torch

from rust_bio_tpu_torch.alignment.pairwise.tb import (
    TB_DEL,
    TB_INS,
    TB_MATCH,
    TB_START,
    TB_SUBST,
    TB_YCLIP_PREFIX,
    TB_YCLIP_SUFFIX,
)
from rust_bio_tpu_torch.ops._build import (
    INT,
    PTR,
    CudaKernel,
    check,
    check_lengths,
    same_device,
)

SWEEP_WALK_GLOBAL = CudaKernel(
    "walk_global", "sweep_walk_global", [PTR, PTR, PTR, INT, INT, INT, PTR, PTR, PTR]
)
SWEEP_WALK_SEMIGLOBAL = CudaKernel(
    "walk_semiglobal", "sweep_walk_semiglobal",
    [PTR] * 7 + [INT, INT, INT] + [PTR] * 4,
)


def sweep_walk_global(tb, mlens, nlens):
    """K2. Returns (ins_cnt (N, B), exit_op (N, B), ins0 (B,)), uint16."""
    dev = same_device(tb, mlens, nlens)
    if tb.dim() != 3:
        raise ValueError(f"tb: expected (N, X, B), got shape {tuple(tb.shape)}")
    N, X, B = tb.shape
    check(tb, "tb", torch.uint16, (N, X, B))
    check(mlens, "mlens", torch.int32, (B,))
    check(nlens, "nlens", torch.int32, (B,))
    check_lengths(mlens, "mlens", X - 1)
    check_lengths(nlens, "nlens", N)
    if dev.type == "cpu":
        return sweep_walk_global_plain(tb, mlens, nlens)
    ins_cnt = torch.empty((N, B), dtype=torch.uint16, device=dev)
    exit_op = torch.empty((N, B), dtype=torch.uint16, device=dev)
    ins0 = torch.empty(B, dtype=torch.uint16, device=dev)
    if B:
        SWEEP_WALK_GLOBAL.launch(
            dev, tb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, X, N,
            ins_cnt.data_ptr(), exit_op.data_ptr(), ins0.data_ptr(),
        )
    return ins_cnt, exit_op, ins0


def sweep_walk_global_plain(tb, mlens, nlens):
    """Plain version of K2 (walk_pallas.py ``_kernel_sweep_walk_global``)."""
    B = tb.shape[2]
    start = torch.full((B,), TB_START, dtype=torch.int32, device=tb.device)
    ones = torch.ones(B, dtype=torch.bool, device=tb.device)
    ins_cnt, exit_op, ins0, _ = _sweep_plain(tb, mlens, nlens, start, ones, ~ones, torch.zeros_like(start))
    return ins_cnt, exit_op, ins0


def _sweep_plain(tb, icur, jcur, carried, use_s, done, ystart):
    """The column sweep of K2 and K6, plain: pairs vectorized, columns
    j = N..1 in a Python loop, Ins runs from the bits 12-15 nibble plus
    the re-gather chain for runs of 15 or more. A Yclip-prefix exit (K6
    only) jumps to column 0 and keeps reading s-bits; ``ystart`` takes its
    column. Returns (ins_cnt (N, B), exit_op (N, B), ins0 (B,)) uint16 and
    ystart (B,) int32."""
    N, X, B = tb.shape
    dev = tb.device
    i32 = torch.int32
    ins_out = torch.zeros((N, B), dtype=i32, device=dev)
    exit_out = torch.zeros((N, B), dtype=i32, device=dev)

    for j in range(N, 0, -1):
        col = tb[j - 1].to(i32)  # (X, B)

        def gather(idx):
            """col[idx[b], b]; -1 where idx is outside the column."""
            inside = (idx >= 0) & (idx < X)
            got = col.gather(0, idx.clamp(0, X - 1).long()[None, :])[0]
            return torch.where(inside, got, -1)

        at = (jcur == j) & ~done
        g1 = gather(icur)
        entry = torch.where(use_s, (g1 >> 8) & 0xF, carried)
        is_ins = at & (entry == TB_INS)
        m = torch.where(is_ins, g1 >> 12, 0)
        act = is_ins & (m == 15)
        while bool(act.any()):
            nib = gather(icur - m) >> 12
            m = m + torch.where(act, nib, 0)
            act = act & (nib == 15)
        ins_cnt = torch.where(is_ins, m + 1, 0)

        ga = gather(icur - m)
        gb = gather(icur - m - 1)
        layer2 = torch.where(is_ins, ga & 0xF, entry)
        db2 = torch.where(is_ins, (gb >> 4) & 0xF, (g1 >> 4) & 0xF)
        i2 = torch.where(is_ins, icur - m - 1, icur)
        is_mm = (layer2 == TB_MATCH) | (layer2 == TB_SUBST)
        is_del = layer2 == TB_DEL
        is_ycp = layer2 == TB_YCLIP_PREFIX

        ins_out[j - 1] = ins_cnt
        exit_out[j - 1] = torch.where(at & (is_mm | is_del | is_ycp), layer2, 0)
        icur = torch.where(at & is_mm, i2 - 1, torch.where(at & (is_del | is_ycp), i2, icur))
        jcur = torch.where(at & (is_mm | is_del), j - 1, torch.where(at & is_ycp, 0, jcur))
        carried = torch.where(at & is_del, db2, carried)
        use_s = torch.where(at, is_mm | is_ycp, use_s)
        done = done | (at & (layer2 == TB_START))
        # the (at most one) Yclip-prefix exit's column
        ystart = torch.where(at & is_ycp, ystart.clamp(min=j), ystart)

    # column 0 is the analytic init column: a live pair emits icur Ins
    ins0 = torch.where(done, 0, icur)
    u16 = torch.uint16
    return ins_out.to(u16), exit_out.to(u16), ins0.to(u16), ystart


# ---------------------------------------------------------------------------
# semiglobal family (K6)
# ---------------------------------------------------------------------------


def resolve_fixed_column(tbfix, mlens, nlens):
    """The walk's steps inside the suffix-fixed final column (walk_pallas.py
    ``_resolve_fixed_column``), plain torch on the tensors' device.

    ``tbfix`` (B, X) int32: the fixed column's 12-bit cells with Ly(i) << 12.
    Returns (fix_ins, fix_exit, fix_ly, i1, j1, ca1, us1, dn1, ystart0,
    yend0), each (B,) int32: the column's Ins run and exit op (a y-clip exit
    carries its length in ``fix_ly``), the sweep's entry state (row, column,
    carried layer, use-s flag, done) and the y-coordinates it implies."""
    B, X = tbfix.shape
    i32 = torch.int32
    cols = torch.arange(X, dtype=i32, device=tbfix.device)[None, :]
    bidx = torch.arange(B, device=tbfix.device)
    ib = tbfix & 0xF
    db = (tbfix >> 4) & 0xF
    sb = (tbfix >> 8) & 0xF
    ly = tbfix >> 12
    ml = mlens.long()
    entry_sb = sb[bidx, ml]

    # vertical Ins runs of the i-bits, ending at each row
    cont = ib == TB_INS
    lz = torch.cummax(torch.where(cont, -(2**20), cols), dim=1).values
    rl = torch.where(cont, cols - lz, 0)

    is_ins = entry_sb == TB_INS
    m = torch.where(is_ins, rl[bidx, ml], 0)
    fix_ins = torch.where(is_ins, m + 1, 0)
    i2 = torch.where(is_ins, mlens - m - 1, mlens)
    layer2 = torch.where(is_ins, ib[bidx, (mlens - m).clamp(min=0).long()], entry_sb)
    i2w = (i2 % X).long()  # -1 wraps to the last row, as the JAX gather does
    db2 = db[bidx, i2w]
    ly2 = ly[bidx, i2w]

    is_mm = (layer2 == TB_MATCH) | (layer2 == TB_SUBST)
    is_del = layer2 == TB_DEL
    is_ycs = layer2 == TB_YCLIP_SUFFIX
    is_ycp = layer2 == TB_YCLIP_PREFIX
    is_start = layer2 == TB_START

    fix_exit = torch.where(is_start, 0, layer2)
    fix_ly = torch.where(is_ycs, ly2, torch.where(is_ycp, nlens, 0))
    i1 = torch.where(is_mm, i2 - 1, i2)
    j1 = torch.where(
        is_mm | is_del,
        nlens - 1,
        torch.where(is_ycs, nlens - ly2, torch.where(is_ycp, 0, nlens)),
    )
    ca1 = torch.where(is_del, db2, TB_START)
    us1 = torch.where(is_del, 0, 1)
    ystart0 = torch.where(is_ycp, nlens, 0)
    yend0 = torch.where(is_ycs, nlens - ly2, nlens)
    outs = (fix_ins, fix_exit, fix_ly, i1, j1, ca1, us1, is_start, ystart0, yend0)
    return tuple(o.to(i32) for o in outs)


def _check_semi_walk(tb, tbfix, mlens, nlens):
    dev = same_device(tb, tbfix, mlens, nlens)
    if tb.dim() != 3:
        raise ValueError(f"tb: expected (N, X, B), got shape {tuple(tb.shape)}")
    N, X, B = tb.shape
    check(tb, "tb", torch.uint16, (N, X, B))
    check(tbfix, "tbfix", torch.int32, (B, X))
    check(mlens, "mlens", torch.int32, (B,))
    check(nlens, "nlens", torch.int32, (B,))
    check_lengths(mlens, "mlens", X - 1)
    check_lengths(nlens, "nlens", N)
    return dev


def sweep_walk_semiglobal(tb, tbfix, mlens, nlens):
    """K6. Returns (ins_cnt (N, B) uint16, exit_op (N, B) uint16, ins0 (B,)
    uint16, fix_ins, fix_exit, fix_ly, ystart, yend (B,) int32).

    ``tbfix`` (B, X) int32 is the suffix-fixed final column with Ly << 12
    (``batched._semiglobal_device``). The walk enters the sweep from
    ``resolve_fixed_column``; the fixed column's own ops are ``fix_ins`` Ins
    after the exit ``fix_exit`` of length ``fix_ly``. Decode with
    ``batched._decode_semi_batch``."""
    dev = _check_semi_walk(tb, tbfix, mlens, nlens)
    if dev.type == "cpu":
        return sweep_walk_semiglobal_plain(tb, tbfix, mlens, nlens)
    fix_ins, fix_exit, fix_ly, *entry, yend0 = resolve_fixed_column(tbfix, mlens, nlens)
    ins_cnt, exit_op, ins0, ystart = sweep_walk_semiglobal_launch(tb, *entry)
    return ins_cnt, exit_op, ins0, fix_ins, fix_exit, fix_ly, ystart, yend0


def sweep_walk_semiglobal_launch(tb, i1, j1, ca1, us1, dn1, ystart0):
    """The launch of K6 alone, from the entry state of
    ``resolve_fixed_column`` (CUDA tensors, (B,) int32 each): (ins_cnt,
    exit_op, ins0, ystart)."""
    N, X, B = tb.shape
    dev = tb.device
    if dev.type != "cuda":
        raise ValueError(f"K6 launches on a CUDA device, got {dev}")
    ins_cnt = torch.empty((N, B), dtype=torch.uint16, device=dev)
    exit_op = torch.empty((N, B), dtype=torch.uint16, device=dev)
    ins0 = torch.empty(B, dtype=torch.uint16, device=dev)
    ystart = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        SWEEP_WALK_SEMIGLOBAL.launch(
            dev, tb.data_ptr(), i1.data_ptr(), j1.data_ptr(), ca1.data_ptr(),
            us1.data_ptr(), dn1.data_ptr(), ystart0.data_ptr(), B, X, N,
            ins_cnt.data_ptr(), exit_op.data_ptr(), ins0.data_ptr(), ystart.data_ptr(),
        )
    return ins_cnt, exit_op, ins0, ystart


def sweep_walk_semiglobal_plain(tb, tbfix, mlens, nlens):
    """Plain version of K6 (walk_pallas.py ``sweep_walk_semiglobal``): the
    fixed-column prolog, then K2's column sweep with Yclip-prefix exits."""
    fix_ins, fix_exit, fix_ly, icur, jcur, carried, us1, dn1, ystart0, yend0 = resolve_fixed_column(
        tbfix, mlens, nlens
    )
    ins_cnt, exit_op, ins0, ystart = _sweep_plain(tb, icur, jcur, carried, us1 == 1, dn1 == 1, ystart0)
    return ins_cnt, exit_op, ins0, fix_ins, fix_exit, fix_ly, ystart, yend0
