"""Column-sweep traceback walks: kernels K2 (global mode), K6 (semiglobal
family, with its fixed-column prolog), K10 (general clips) and K8 (local
mode), the last two with their prologs and K10 with its coordinate epilog,
CUDA source ``csrc/walk_sweep.cu``; kernel K14 (global mode on the
block-row tb of K13, ``csrc/walk_global_seg.cu``). They replace
``rust_bio_tpu/ops/walk_pallas.py`` ``sweep_walk_global``,
``_sweep_walk_global_seg``, ``sweep_walk_semiglobal`` (with
``_resolve_fixed_column``), ``sweep_walk_custom`` and ``sweep_walk_local``.
Kernel K15-walk (``walk_steps``, the per-step walk
of K15's traceback tensor, ``csrc/walk_steps.cu``) replaces the XLA walk
``rust_bio_tpu/alignment/pairwise/batched.py`` ``_walk``, and K16-walk
(``walk_banded``, the banded aligner's walk, in the same source) the XLA
walk ``banded_device.py`` ``_walk_banded``; their sections at the end of
this module say what they read and write.

Input: the traceback tensor of K1, K11, K5 or K12 (``ops.sw``), ``tb`` (N,
X, B) uint16 with X = M + 1 (K1's, K11's, K5's, K12's, K13's, K7's, K7-LUT's, K9's,
K9-LUT's, K15's and K16's are views of pair-major tensors, which K2, K6,
K14, K8, K10, K15-walk and K16-walk read in place through their strides),
and ``mlens``/``nlens`` (B,) int32. Output, per DP column j
(row j - 1) and pair: ``ins_cnt`` Ins ops, then one exit op ``exit_op``
(TB_MATCH / TB_SUBST / TB_DEL, in K6 also TB_YCLIP_PREFIX; 0 where the pair
is not), walking end -> start; plus ``ins0``, the Ins run in column 0. All
uint16. K8 and K10 walk the (N+1, X, B) tensor of K7/K9, column 0 included,
and emit (N+1, B) outputs; their module section says what.

Kernel K-merge (``merge_rle``, ``csrc/rle_merge.cu``) merges K2's or K6's
column-RLE outputs into at most R (kind, length) runs a pair and packs them
as the (5 + R, B) uint16 compact pack; it replaces the XLA functions
``rust_bio_tpu/alignment/pairwise/batched.py`` ``_merge_rle_device`` and
``_pack_rle_merged``. Its section at the end of this module says how.
"""

from __future__ import annotations

import torch

from rust_bio_tpu_torch.alignment.pairwise.tb import (
    TB_DEL,
    TB_INS,
    TB_MATCH,
    TB_REREAD,
    TB_START,
    TB_SUBST,
    TB_XCLIP_PREFIX,
    TB_XCLIP_SUFFIX,
    TB_YCLIP_PREFIX,
    TB_YCLIP_SUFFIX,
)
from rust_bio_tpu_torch.ops._build import (
    I64,
    INT,
    PTR,
    CudaKernel,
    check,
    check_lengths,
    same_device,
)

SWEEP_WALK_GLOBAL = CudaKernel(
    "walk_sweep", "sweep_walk_global", [PTR, PTR, PTR, INT, INT, INT, I64, I64, I64, PTR, PTR, PTR]
)
SWEEP_WALK_GLOBAL_SEG = CudaKernel(
    "walk_global_seg", "sweep_walk_global_seg", [PTR, PTR, PTR, INT, INT, INT, I64, I64, I64, INT, PTR, PTR, PTR]
)
# K14's launch (csrc/walk_global_seg.cu), and K15-walk's and K16-walk's (csrc/walk_steps.cu):
# one warp a pair, SEG_WARPS pairs a block; a warp's two tiles (the one it
# walks, the one fetched ahead, whose last row lies SEG_AHEAD rows above the
# row the first was fetched for where the path runs left) hold
# SEG_TILE_COLUMNS DP columns (one a lane) of SEG_TILE_ROWS rows each,
# SEG_TILE_PITCH uint16 apart in shared memory
SEG_WARPS = 2
SEG_TILE_COLUMNS = 32
SEG_TILE_ROWS = 96
SEG_TILE_PITCH = SEG_TILE_ROWS + 8
SEG_AHEAD = 16
SWEEP_WALK_SEMIGLOBAL = CudaKernel(
    "walk_sweep", "sweep_walk_semiglobal", [PTR] * 4 + [INT, INT, INT, I64, I64, I64] + [PTR] * 8
)
# K2's and K6's launch (csrc/walk_sweep.cu): one warp a pair, SWEEP_WARPS
# pairs a block, whose column outputs are staged in shared memory (4 *
# SWEEP_WARPS * N bytes) where they fit SWEEP_STAGE_MAX_BYTES
SWEEP_WARPS = 16
SWEEP_LANES = 32
SWEEP_STAGE_MAX_BYTES = 48 * 1024
SWEEP_WALK_CUSTOM = CudaKernel(
    "walk_sweep", "sweep_walk_custom", [PTR] * 6 + [INT, INT, INT, I64, I64, I64] + [PTR] * 4
)
SWEEP_WALK_LOCAL = CudaKernel(
    "walk_sweep", "sweep_walk_local", [PTR] * 6 + [INT, INT, INT, I64, I64, I64] + [PTR] * 4
)
# K8's and K10's launch (csrc/walk_sweep.cu): K2's warps and lanes; a block
# stages its pairs' column outputs (2 * outputs * SWEEP_WARPS * (N + 1)
# bytes: K8 two outputs, K10 five) where they fit CLIP_STAGE_MAX_BYTES,
# past 48 KB by opting in to the larger dynamic shared memory
CLIP_LOCAL_OUTPUTS = 2
CLIP_CUSTOM_OUTPUTS = 5
CLIP_STAGE_MAX_BYTES = 96 * 1024
WALK_STEPS = CudaKernel("walk_steps", "walk_steps", [PTR] * 5 + [INT] * 4 + [I64] * 3 + [INT] + [PTR] * 6)


def sweep_walk_global(tb, mlens, nlens):
    """K2. Returns (ins_cnt (N, B), exit_op (N, B), ins0 (B,)), uint16.
    ``tb`` is a contiguous (N, X, B) tensor or, as K1 and K11 return it, a
    pair-major view (``_walk_strides``): read in place, never copied. On
    the card one warp a pair walks a run of Match/Subst or Del columns, or
    one column's Ins run, a round, a lane a step (``sweep_walk_geometry``)."""
    return _global_walk(SWEEP_WALK_GLOBAL, sweep_walk_global_plain, tb, mlens, nlens)


def sweep_walk_global_seg(tb, mlens, nlens):
    """K14: K2's walk over K13's tb (no run nibble, ``TB_REREAD`` i-cells at
    the row-block seams); K2's outputs. ``tb`` is a contiguous (N, X, B)
    tensor or, as K13 returns it, an (N, X, B) view whose X axis has stride
    1 and whose B axis the largest stride (a pair-major tensor, permuted):
    read in place, never copied. Other layouts raise ``ValueError``. On
    the card one warp a pair walks tiles of the tb staged in shared memory
    (``seg_walk_geometry``), 8 rows a load where ``_vector_rows`` allows."""
    return _global_walk(
        SWEEP_WALK_GLOBAL_SEG, sweep_walk_global_seg_plain, tb, mlens, nlens, lambda: (int(_vector_rows(tb)),)
    )


def sweep_walk_geometry(B: int, N: int) -> dict:
    """K2's and K6's launch for B pairs of N columns, as csrc/walk_sweep.cu
    sets it: pairs (warps) a block, lanes a warp, blocks, threads a block,
    whether a block stages its pairs' column outputs in shared memory (so
    that it stores a column's outputs of its pairs in one sector each),
    and its shared bytes (the stage, else none)."""
    stage = 4 * SWEEP_WARPS * N
    staged = stage <= SWEEP_STAGE_MAX_BYTES
    return {
        "warps": SWEEP_WARPS, "lanes": SWEEP_LANES, "blocks": -(-B // SWEEP_WARPS),
        "threads": SWEEP_WARPS * SWEEP_LANES, "staged": staged, "shared_bytes": stage if staged else 0,
    }


def clip_walk_geometry(B: int, N: int, custom: bool) -> dict:
    """K8's (``custom`` False) or K10's launch for B pairs over columns
    0..N, as csrc/walk_sweep.cu sets it: K2's pairs (warps) a block, lanes,
    blocks and threads, the (N+1, B) uint16 outputs a block stages, whether
    it stages them (so that it stores a column's outputs of its pairs in one
    sector each), its shared bytes (the stage, else none) and whether they
    pass the 48 KB a block takes without opting in."""
    outputs = CLIP_CUSTOM_OUTPUTS if custom else CLIP_LOCAL_OUTPUTS
    stage = 2 * outputs * SWEEP_WARPS * (N + 1)
    staged = stage <= CLIP_STAGE_MAX_BYTES
    shared = stage if staged else 0
    return {
        "warps": SWEEP_WARPS, "lanes": SWEEP_LANES, "blocks": -(-B // SWEEP_WARPS),
        "threads": SWEEP_WARPS * SWEEP_LANES, "outputs": outputs, "staged": staged, "shared_bytes": shared,
        "opt_in": shared > 48 * 1024,
    }


def seg_walk_geometry() -> dict:
    """K14's launch, and K15-walk's and K16-walk's, as csrc/walk_global_seg.cu and
    csrc/walk_steps.cu set it: pairs (warps) a
    block, a tile's columns and rows, the rows between the bottoms of a
    tile and the one fetched ahead, the bytes between tile columns and a
    block's static shared bytes (two tiles a warp)."""
    return {
        "warps": SEG_WARPS, "tile_columns": SEG_TILE_COLUMNS, "tile_rows": SEG_TILE_ROWS, "ahead_rows": SEG_AHEAD,
        "pitch_bytes": 2 * SEG_TILE_PITCH, "shared_bytes": SEG_WARPS * 2 * SEG_TILE_COLUMNS * SEG_TILE_PITCH * 2,
    }


def _vector_rows(tb) -> bool:
    """Whether K14, K15-walk or K16-walk may read a column's rows 8 at a time with
    aligned 16-byte loads: rows of stride 1, columns (and pairs, where B > 1) 8 elements
    apart, the data 16-byte aligned, and the storage holding each column's
    rows up to X rounded up to 8 (the last group of 8 may pass row X - 1)."""
    N, X, B = tb.shape
    if tb.numel() == 0:
        return False
    sj, si, sb = _walk_strides(tb)
    if si != 1 or sj % 8 or (B > 1 and sb % 8) or tb.data_ptr() % 16:
        return False
    end = (N - 1) * sj + (B - 1) * sb + -(-X // 8) * 8
    return tb.storage_offset() + end <= tb.untyped_storage().nbytes() // tb.element_size()


def _walk_strides(tb) -> tuple:
    """(column, row, pair) element strides of an (N, X, B) tb that K2, K6,
    K8, K10, K14, K15-walk and K16-walk read: contiguous, or rows of stride
    1 inside columns inside pairs, none overlapping (the view of K11's,
    K12's, K7's, K7-LUT's, K9's, K9-LUT's, K13's, K15's or K16's pair-major
    tensor). Raises ``ValueError`` on any other layout."""
    N, X, B = tb.shape
    if tb.is_contiguous() or tb.numel() == 0:
        return X * B, B, 1
    sj, si, sb = tb.stride()
    if si == 1 and (N == 1 or sj >= X) and (B == 1 or sb >= (N - 1) * sj + X):
        return sj, si, sb
    raise ValueError(
        f"tb: strides {tuple(tb.stride())} of shape {tuple(tb.shape)} are neither contiguous (N, X, B) "
        "nor a pair-major view (rows of stride 1, pairs the largest stride)"
    )


def _check_tb(tb) -> tuple:
    """(N, X, B) of a uint16 tb in a layout ``_walk_strides`` takes;
    raises ``TypeError`` / ``ValueError`` otherwise."""
    if tb.dim() != 3:
        raise ValueError(f"tb: expected (N, X, B), got shape {tuple(tb.shape)}")
    if tb.dtype != torch.uint16:
        raise TypeError(f"tb: expected {torch.uint16}, got {tb.dtype}")
    _walk_strides(tb)
    return tuple(tb.shape)


def _global_walk(kernel, plain, tb, mlens, nlens, extra=tuple):
    """K2's or K14's wrapper; ``extra()`` gives the C arguments after the
    strides (K14: the vector-load flag)."""
    dev = same_device(tb, mlens, nlens)
    N, X, B = _check_tb(tb)
    check(mlens, "mlens", torch.int32, (B,))
    check(nlens, "nlens", torch.int32, (B,))
    check_lengths(mlens, "mlens", X - 1)
    check_lengths(nlens, "nlens", N)
    if dev.type == "cpu":
        return plain(tb, mlens, nlens)
    ins_cnt = torch.empty((N, B), dtype=torch.uint16, device=dev)
    exit_op = torch.empty((N, B), dtype=torch.uint16, device=dev)
    ins0 = torch.empty(B, dtype=torch.uint16, device=dev)
    if B:
        kernel.launch(
            dev, tb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, X, N, *_walk_strides(tb), *extra(),
            ins_cnt.data_ptr(), exit_op.data_ptr(), ins0.data_ptr(),
        )
    return ins_cnt, exit_op, ins0


def sweep_walk_global_plain(tb, mlens, nlens):
    """Plain version of K2 (walk_pallas.py ``_kernel_sweep_walk_global``)."""
    B = tb.shape[2]
    start = torch.full((B,), TB_START, dtype=torch.int32, device=tb.device)
    ones = torch.ones(B, dtype=torch.bool, device=tb.device)
    ins_cnt, exit_op, ins0, _ = _sweep_plain(tb, mlens, nlens, start, ones, ~ones, torch.zeros_like(start), False)
    return ins_cnt, exit_op, ins0


def sweep_walk_global_seg_plain(tb, mlens, nlens):
    """Plain version of K14 (walk_pallas.py ``_make_seg_walk_kernel``):
    pairs vectorized, columns j = N..1 in a Python loop, each column's rows
    at once. The resolved i-layer of a cell is its i-bits, or the s-bits of
    the cell above where they say ``TB_REREAD``; an Ins run ends at the
    last row at or above that does not continue it (a cummax of those
    rows); the exit is read at that chain-break row, with the d-bits of the
    cell above it."""
    N, X, B = tb.shape
    dev = tb.device
    i32 = torch.int32
    rows = torch.arange(X, dtype=i32, device=dev)[:, None]
    icur, jcur = mlens.clone(), nlens.clone()
    carried = torch.full((B,), TB_START, dtype=i32, device=dev)
    use_s = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    ins_out = torch.zeros((N, B), dtype=i32, device=dev)
    exit_out = torch.zeros((N, B), dtype=i32, device=dev)
    start_row = torch.full((1, B), TB_START, dtype=i32, device=dev)

    def gather(a, idx):
        return a.gather(0, idx.clamp(0, X - 1).long()[None, :])[0]

    for j in range(N, 0, -1):
        col = tb[j - 1].to(i32)  # (X, B)
        ib, db, sb = col & 0xF, (col >> 4) & 0xF, (col >> 8) & 0xF
        layer = torch.where(ib == TB_REREAD, torch.cat([start_row, sb[:-1]]), ib)
        brk_rows = torch.cummax(torch.where(layer == TB_INS, -1, rows), dim=0).values

        at = (jcur == j) & ~done
        entry = torch.where(use_s, gather(sb, icur), carried)
        is_ins = at & (entry == TB_INS)
        brk = gather(brk_rows, icur)  # icur - (the Ins run above icur)
        ins_out[j - 1] = torch.where(is_ins, icur - brk + 1, 0)
        layer2 = torch.where(is_ins, gather(layer, brk), entry)
        db2 = torch.where(is_ins, torch.where(brk > 0, gather(db, brk - 1), 0), gather(db, icur))
        i2 = torch.where(is_ins, brk - 1, icur)
        is_mm = (layer2 == TB_MATCH) | (layer2 == TB_SUBST)
        is_del = layer2 == TB_DEL

        exit_out[j - 1] = torch.where(at & (is_mm | is_del), layer2, 0)
        icur = torch.where(at & is_mm, i2 - 1, torch.where(at & is_del, i2, icur))
        jcur = torch.where(at & (is_mm | is_del), j - 1, jcur)
        carried = torch.where(at & is_del, db2, carried)
        use_s = torch.where(at, is_mm, use_s)
        done = done | (at & (layer2 == TB_START))

    # column 0 is the analytic init column: a live pair emits icur Ins
    ins0 = torch.where(done, 0, icur)
    u16 = torch.uint16
    return ins_out.to(u16), exit_out.to(u16), ins0.to(u16)


def _sweep_plain(tb, icur, jcur, carried, use_s, done, ystart, yclip=True):
    """The column sweep of K2 and K6, plain: pairs vectorized, columns
    j = N..1 in a Python loop, Ins runs from the bits 12-15 nibble plus
    the re-gather chain for runs of 15 or more. A Yclip-prefix exit (K6,
    ``yclip``; K2 stops there, as the global Pallas walk does) jumps to
    column 0 and keeps reading s-bits; ``ystart`` takes its column. Returns
    (ins_cnt (N, B), exit_op (N, B), ins0 (B,)) uint16 and ystart (B,)
    int32."""
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
        is_ycp = (layer2 == TB_YCLIP_PREFIX) & yclip

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
    ``_resolve_fixed_column``), plain torch on the tensors' device: K6's
    prolog in its plain version (on the card K6 resolves it itself).

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
    N, X, B = _check_tb(tb)
    check(tbfix, "tbfix", torch.int32, (B, X))
    check(mlens, "mlens", torch.int32, (B,))
    check(nlens, "nlens", torch.int32, (B,))
    check_lengths(mlens, "mlens", X - 1)
    check_lengths(nlens, "nlens", N)
    return dev


def sweep_walk_semiglobal(tb, tbfix, mlens, nlens):
    """K6. Returns (ins_cnt (N, B) uint16, exit_op (N, B) uint16, ins0 (B,)
    uint16, fix_ins, fix_exit, fix_ly, ystart, yend (B,) int32). ``tb`` is a
    pair-major view, as K5 and K12 return it, or a contiguous (N, X, B)
    tensor (``_walk_strides``): read in place, never copied.

    ``tbfix`` (B, X) int32 is the suffix-fixed final column with Ly << 12
    (``batched._semiglobal_device``). The walk enters the sweep from the
    fixed column (``resolve_fixed_column``, which the kernel resolves
    itself on the card); the fixed column's own ops are ``fix_ins`` Ins
    after the exit ``fix_exit`` of length ``fix_ly``. Decode with
    ``batched._decode_semi_batch``."""
    dev = _check_semi_walk(tb, tbfix, mlens, nlens)
    if dev.type == "cpu":
        return sweep_walk_semiglobal_plain(tb, tbfix, mlens, nlens)
    return sweep_walk_semiglobal_launch(tb, tbfix, mlens, nlens)


def sweep_walk_semiglobal_launch(tb, tbfix, mlens, nlens):
    """The launch of K6 alone, without the wrapper's input checks (CUDA
    tensors as ``sweep_walk_semiglobal`` takes them): its outputs."""
    N, X, B = tb.shape
    dev = tb.device
    if dev.type != "cuda":
        raise ValueError(f"K6 launches on a CUDA device, got {dev}")
    ins_cnt = torch.empty((N, B), dtype=torch.uint16, device=dev)
    exit_op = torch.empty((N, B), dtype=torch.uint16, device=dev)
    ins0 = torch.empty(B, dtype=torch.uint16, device=dev)
    per_pair = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(5)]  # fix_ins .. yend
    if B:
        SWEEP_WALK_SEMIGLOBAL.launch(
            dev, tb.data_ptr(), tbfix.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, X, N, *_walk_strides(tb),
            ins_cnt.data_ptr(), exit_op.data_ptr(), ins0.data_ptr(), *(t.data_ptr() for t in per_pair),
        )
    return (ins_cnt, exit_op, ins0, *per_pair)


def sweep_walk_semiglobal_plain(tb, tbfix, mlens, nlens):
    """Plain version of K6 (walk_pallas.py ``sweep_walk_semiglobal``): the
    fixed-column prolog, then K2's column sweep with Yclip-prefix exits."""
    fix_ins, fix_exit, fix_ly, icur, jcur, carried, us1, dn1, ystart0, yend0 = resolve_fixed_column(
        tbfix, mlens, nlens
    )
    ins_cnt, exit_op, ins0, ystart = _sweep_plain(tb, icur, jcur, carried, us1 == 1, dn1 == 1, ystart0)
    return ins_cnt, exit_op, ins0, fix_ins, fix_exit, fix_ly, ystart, yend0


# ---------------------------------------------------------------------------
# general-clip family (K10) and local mode (K8)
# ---------------------------------------------------------------------------
#
# Both walk the (N+1, X, B) traceback tensor of K9 / K7 (column 0 at index 0)
# after the fixed final column is resolved (``resolve_fixed_column_custom``,
# their plain prolog; on the card each kernel resolves it itself, K8 with
# ``local_entry``'s cell, and K10 computes ``_custom_coords`` as it stores
# its outputs). That prolog writes up to four op slots
# ``fix_codes``/``fix_lens`` (B, 4), in end -> start order: the fixed
# column's ops. K10's per-column outputs (N+1, B) uint16, in the decode's
# start -> end order ``[post][exit][Ins x ins_cnt][Xclip-suffix pre]``:
# ``pre`` an x-suffix clip length taken at the entry row, ``ins_cnt``,
# ``exit_op`` (Match, Subst, Del, Xclip-prefix, Yclip-prefix) with its
# length ``exit_len``, and ``post``, the row-0 op after an Xclip-prefix.
# K8's are ``ins_cnt`` and ``exit_op`` (Match, Subst, Del): in local mode
# the prefix clips end the path and give xstart/ystart.


def _gather_cols(a, idx):
    """a[b, idx[b]] of a (B, X) tensor with JAX's index rules: a negative
    index counts from the end, an index still outside is clamped."""
    X = a.shape[1]
    idx = torch.where(idx < 0, idx + X, idx).clamp(0, X - 1)
    return a.gather(1, idx.long()[:, None])[:, 0]


def resolve_fixed_column_custom(tbfix, lx_n, mlens, nlens):
    """The walk's steps inside the suffix-fixed final column with every clip
    layer live (walk_pallas.py ``_resolve_fixed_column_custom``), torch ops
    on the tensors' device: three unrolled steps, each an optional
    Xclip-suffix jump of ``lx_n`` rows, an Ins run and one exit.

    ``tbfix`` (B, X) int32 is the fixed column's 12-bit cells with Ly << 12,
    ``lx_n`` (B,) its x-suffix clip length. Returns (fix_codes, fix_lens
    (B, 4), i1, j1, ca1, us1, dn1, xstart0, ystart0, xend0, yend0 (B,)), all
    int32: the op slots and the sweep's entry state (row, column, carried
    layer, use-s flag, done) with the coordinates the prolog fixed."""
    B, X = tbfix.shape
    dev = tbfix.device
    i32 = torch.int32
    cols = torch.arange(X, dtype=i32, device=dev)[None, :]
    ib = tbfix & 0xF
    db = (tbfix >> 4) & 0xF
    sb = (tbfix >> 8) & 0xF
    ly = tbfix >> 12
    # vertical Ins runs of the i-bits, ending at each row
    cont = ib == TB_INS
    lz = torch.cummax(torch.where(cont, -(2**20), cols), dim=1).values
    rl = torch.where(cont, cols - lz, 0)

    slot = torch.arange(4, device=dev)[None, :]
    fix_codes = torch.zeros((B, 4), dtype=i32, device=dev)
    fix_lens = torch.zeros((B, 4), dtype=i32, device=dev)
    nslot = torch.zeros(B, dtype=i32, device=dev)

    def emit(act, code, length):
        nonlocal fix_codes, fix_lens, nslot
        oh = (slot == nslot[:, None]) & act[:, None]
        fix_codes = torch.where(oh, code[:, None], fix_codes)
        fix_lens = torch.where(oh, length[:, None], fix_lens)
        nslot = nslot + act.to(i32)

    def full(v):
        return torch.full((B,), v, dtype=i32, device=dev)

    i, j = mlens.clone(), nlens.clone()
    carried = full(TB_START)
    use_s = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    left = torch.zeros(B, dtype=torch.bool, device=dev)
    xstart, ystart, xend, yend = full(0), full(0), mlens.clone(), nlens.clone()
    zero = full(0)
    for _ in range(3):
        act = ~done & ~left
        entry = torch.where(use_s, _gather_cols(sb, i), carried)
        is_xs = act & (entry == TB_XCLIP_SUFFIX)  # row mlens only
        emit(is_xs, full(TB_XCLIP_SUFFIX), lx_n)
        i = torch.where(is_xs, i - lx_n, i)
        xend = torch.where(is_xs, i, xend)
        use_s = use_s | is_xs
        entry = torch.where(is_xs, _gather_cols(sb, i), entry)
        is_ins = act & (entry == TB_INS)
        m = torch.where(is_ins, _gather_cols(rl, i), 0)
        emit(is_ins, full(TB_INS), torch.where(is_ins, m + 1, 0))
        i2 = torch.where(is_ins, i - m - 1, i)
        layer2 = torch.where(is_ins, _gather_cols(ib, torch.clamp(i - m, min=0)), entry)
        db2 = _gather_cols(db, i2)
        ly2 = _gather_cols(ly, i2)

        is_mm = act & ((layer2 == TB_MATCH) | (layer2 == TB_SUBST))
        is_del = act & (layer2 == TB_DEL)
        is_ycs = act & (layer2 == TB_YCLIP_SUFFIX)
        is_ycp = act & (layer2 == TB_YCLIP_PREFIX)
        is_xcp = act & (layer2 == TB_XCLIP_PREFIX)
        is_start = act & (layer2 == TB_START)
        do_emit = is_mm | is_del | is_ycs | is_ycp | is_xcp
        length = torch.where(is_ycs, ly2, torch.where(is_ycp, j, torch.where(is_xcp, i2, zero)))
        emit(do_emit, torch.where(do_emit, layer2, 0), length)

        i = torch.where(is_mm, i2 - 1, torch.where(is_xcp, 0, i2))
        yend = torch.where(is_ycs, j - ly2, yend)
        ystart = torch.where(is_ycp, j, ystart)
        xstart = torch.where(is_xcp, i2, xstart)
        carried = torch.where(is_del, db2, carried)
        use_s = torch.where(is_del, False, use_s | do_emit)
        done = done | is_start
        left_now = is_mm | is_del
        j = torch.where(left_now, j - 1, torch.where(is_ycp, 0, torch.where(is_ycs, j - ly2, j)))
        left = left | left_now | is_ycp | is_ycs
    outs = (i, j, carried, use_s, done, xstart, ystart, xend, yend)
    return (fix_codes, fix_lens) + tuple(o.to(i32) for o in outs)


def _check_clip_walk(tb, tbfix, lx, lx_n, mlens, nlens):
    dev = same_device(tb, tbfix, lx, lx_n, mlens, nlens)
    Nc, X, B = _check_tb(tb)
    check(tbfix, "tbfix", torch.int32, (B, X))
    check(lx, "lx", torch.int32, (Nc, B))
    check(lx_n, "lx_n", torch.int32, (B,))
    check(mlens, "mlens", torch.int32, (B,))
    check(nlens, "nlens", torch.int32, (B,))
    check_lengths(mlens, "mlens", X - 1)
    check_lengths(nlens, "nlens", Nc - 1)
    return dev


def sweep_walk_custom(tb, tbfix, lx, lx_n, mlens, nlens):
    """K10. ``tb`` (N+1, X, B) uint16 and ``lx`` (N+1, B) int32 of K9, K7 or
    K7-LUT (a contiguous tb or a pair-major view, ``_walk_strides``: read in
    place, never copied), ``tbfix`` (B, X) int32 the fixed final column with Ly << 12, ``lx_n``
    (B,) its x-suffix clip length (``batched._custom_device``). Returns
    (pre, ins_cnt, exit_op, exit_len, post (N+1, B) uint16, fix_codes,
    fix_lens (B, 4), xstart, ystart, xend, yend (B,)) int32. On the card one
    launch: one warp a pair resolves the fixed column, walks a run of the
    column-RLE path a round, as K2 (``clip_walk_geometry``), and writes the
    coordinates."""
    if _check_clip_walk(tb, tbfix, lx, lx_n, mlens, nlens).type == "cpu":
        return sweep_walk_custom_plain(tb, tbfix, lx, lx_n, mlens, nlens)
    return sweep_walk_custom_launch(tb, tbfix, lx, lx_n, mlens, nlens)


def _custom_coords(outs, mlens, xstart0, ystart0, xend0, yend0):
    """(xstart, ystart, xend, yend) of K10's outputs (walk_pallas.py
    ``sweep_walk_custom`` epilog): the largest Xclip-prefix length, the
    column of a Yclip-prefix exit or post, the largest x-suffix clip."""
    pre, _, exit_op, elen, post = (o.to(torch.int32) for o in outs)
    jcols = torch.arange(pre.shape[0], dtype=torch.int32, device=pre.device)[:, None]
    xstart = torch.maximum(torch.where(exit_op == TB_XCLIP_PREFIX, elen, 0).amax(dim=0), xstart0)
    xs_hit = pre > 0
    xend = torch.where(xs_hit.any(dim=0), mlens - torch.where(xs_hit, pre, 0).amax(dim=0), xend0)
    ycp_hit = (exit_op == TB_YCLIP_PREFIX) | (post == TB_YCLIP_PREFIX)
    ystart = torch.maximum(torch.where(ycp_hit, jcols, 0).amax(dim=0), ystart0)
    return xstart, ystart, xend.to(torch.int32), yend0


def sweep_walk_custom_launch(tb, tbfix, lx, lx_n, mlens, nlens):
    """The launch of K10 alone, without the wrapper's input checks (CUDA
    tensors as ``sweep_walk_custom`` takes them): its outputs."""
    return _clip_launch(SWEEP_WALK_CUSTOM, CLIP_CUSTOM_OUTPUTS, tb, tbfix, lx, lx_n, mlens, nlens)


def _clip_launch(kernel, outputs, tb, tbfix, lx, lx_n, mlens, nlens):
    """K8's or K10's one launch: (the ``outputs`` (N+1, B) uint16 column
    outputs, fix_codes, fix_lens (B, 4), xstart, ystart, xend, yend (B,)),
    views of three tensors."""
    Nc, X, B = tb.shape
    dev = tb.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel.symbol} launches on a CUDA device, got {dev}")
    cols = torch.empty((outputs, Nc, B), dtype=torch.uint16, device=dev)
    fix = torch.empty((2, B, 4), dtype=torch.int32, device=dev)
    coords = torch.empty((4, B), dtype=torch.int32, device=dev)
    if B:
        kernel.launch(
            dev, tb.data_ptr(), tbfix.data_ptr(), lx.data_ptr(), lx_n.data_ptr(), mlens.data_ptr(), nlens.data_ptr(),
            B, X, Nc - 1, *_walk_strides(tb), cols.data_ptr(), fix[0].data_ptr(), fix[1].data_ptr(), coords.data_ptr(),
        )
    return (*cols.unbind(0), *fix.unbind(0), *coords.unbind(0))


def sweep_walk_custom_plain(tb, tbfix, lx, lx_n, mlens, nlens):
    """Plain version of K10 (walk_pallas.py ``sweep_walk_custom``), same
    outputs."""
    fix_codes, fix_lens, *entry, xstart0, ystart0, xend0, yend0 = resolve_fixed_column_custom(
        tbfix, lx_n, mlens, nlens
    )
    outs = _sweep_clip_plain(tb, lx, *entry, local=False)
    return outs + (fix_codes, fix_lens) + _custom_coords(outs, mlens, xstart0, ystart0, xend0, yend0)


def local_entry(tb, lx, tbfix, lx_n, mlens, nlens):
    """The prolog of K8 in its plain version (on the card K8 resolves it
    itself): ``resolve_fixed_column_custom``, then the x-suffix
    cell a lane reaches after leaving the fixed column through a y-suffix
    clip (walk_pallas.py:1054-1072): row mlens of column j1, read from
    ``tb`` and ``lx``; its clip goes into a free fix slot. Returns
    (fix_codes, fix_lens, i1, j1, ca1, us1, dn1, xstart0, ystart0, xend,
    yend0)."""
    fix_codes, fix_lens, i1, j1, ca1, us1, dn1, xs0, ys0, xend0, yend0 = resolve_fixed_column_custom(
        tbfix, lx_n, mlens, nlens
    )
    _, X, B = tb.shape
    bidx = torch.arange(B, device=tb.device)
    live = (dn1 == 0) & (us1 == 1) & (j1 < nlens) & (j1 > 0)
    jg = torch.where(live, j1, 0).long()
    # the row by JAX's index rules (``_gather_cols``); CUDA has no uint16
    # gather: read the cells as int16
    rows = torch.where(live, i1, 0)
    rows = torch.where(rows < 0, rows + X, rows).clamp(0, X - 1).long()
    cell = tb.view(torch.int16)[jg, rows, bidx].to(torch.int32) & 0xFFFF
    lxj = lx[jg, bidx]
    is_xs = live & (((cell >> 8) & 0xF) == TB_XCLIP_SUFFIX)
    i1 = torch.where(is_xs, i1 - lxj, i1)
    xend = torch.where(is_xs, i1, xend0)
    nslot = (fix_codes != 0).sum(dim=1)
    oh = (torch.arange(4, device=tb.device)[None, :] == nslot[:, None]) & is_xs[:, None]
    fix_codes = torch.where(oh, TB_XCLIP_SUFFIX, fix_codes)
    fix_lens = torch.where(oh, lxj[:, None], fix_lens)
    return fix_codes, fix_lens, i1, j1, ca1, us1, dn1, xs0, ys0, xend, yend0


def sweep_walk_local(tb, tbfix, lx, lx_n, mlens, nlens):
    """K8: the local-mode walk, for K7's (or K7-LUT's) output with gap_open + gap_extend
    < 0 (a Del run past a free x-suffix clip would tie it otherwise, which
    only K10 resolves). Inputs as ``sweep_walk_custom``. Returns (ins_cnt,
    exit_op (N+1, B) uint16, fix_codes, fix_lens (B, 4), xstart, ystart,
    xend, yend (B,)) int32. On the card one launch, as K10's, with
    ``local_entry``'s cell read in the kernel."""
    if _check_clip_walk(tb, tbfix, lx, lx_n, mlens, nlens).type == "cpu":
        return sweep_walk_local_plain(tb, tbfix, lx, lx_n, mlens, nlens)
    return sweep_walk_local_launch(tb, tbfix, lx, lx_n, mlens, nlens)


def sweep_walk_local_launch(tb, tbfix, lx, lx_n, mlens, nlens):
    """The launch of K8 alone, without the wrapper's input checks (CUDA
    tensors as ``sweep_walk_local`` takes them): its outputs."""
    return _clip_launch(SWEEP_WALK_LOCAL, CLIP_LOCAL_OUTPUTS, tb, tbfix, lx, lx_n, mlens, nlens)


def sweep_walk_local_plain(tb, tbfix, lx, lx_n, mlens, nlens):
    """Plain version of K8 (walk_pallas.py ``sweep_walk_local``), same
    outputs."""
    fix_codes, fix_lens, *entry, xend, yend0 = local_entry(tb, lx, tbfix, lx_n, mlens, nlens)
    ins_cnt, exit_op, xstart, ystart = _sweep_clip_plain(tb, lx, *entry, local=True)
    return ins_cnt, exit_op, fix_codes, fix_lens, xstart, ystart, xend, yend0


def _sweep_clip_plain(tb, lx, icur, jcur, carried, us1, dn1, xs0=None, ys0=None, local=False):
    """The column sweep of K10 (``local`` False: returns pre, ins_cnt,
    exit_op, exit_len, post) or K8 (returns ins_cnt, exit_op, xstart,
    ystart), plain: pairs vectorized, columns j = N..0 in a Python loop."""
    Nc, X, B = tb.shape
    dev = tb.device
    i32 = torch.int32
    use_s = us1 == 1
    done = dn1 == 1
    outs = torch.zeros((5, Nc, B), dtype=i32, device=dev)
    xs, ys = xs0, ys0
    for j in range(Nc - 1, -1, -1):
        col = tb[j].to(i32)  # (X, B)

        def gather(idx):
            """col[idx[b], b]; -1 where idx is outside the column."""
            inside = (idx >= 0) & (idx < X)
            got = col.gather(0, idx.clamp(0, X - 1).long()[None, :])[0]
            return torch.where(inside, got, -1)

        at = (jcur == j) & ~done
        g = gather(icur)
        entry = torch.where(use_s, (g >> 8) & 0xF, carried)
        pre = torch.zeros_like(icur)
        ip = icur
        if not local:
            is_xs = at & (entry == TB_XCLIP_SUFFIX)
            pre = torch.where(is_xs, lx[j], 0)
            ip = icur - pre
            g = torch.where(is_xs, gather(ip), g)
            entry = torch.where(is_xs, (g >> 8) & 0xF, entry)
        is_ins = at & (entry == TB_INS)
        m = torch.where(is_ins, g >> 12, 0)
        act = is_ins & (m == 15)
        while bool(act.any()):
            nib = gather(ip - m) >> 12
            m = m + torch.where(act, nib, 0)
            act = act & (nib == 15)
        ins_cnt = torch.where(is_ins, m + 1, 0)
        layer2 = torch.where(is_ins, gather(ip - m) & 0xF, entry)
        db2 = torch.where(is_ins, (gather(ip - m - 1) >> 4) & 0xF, (g >> 4) & 0xF)
        i2 = torch.where(is_ins, ip - m - 1, ip)
        is_mm = (layer2 == TB_MATCH) | (layer2 == TB_SUBST)
        is_del = layer2 == TB_DEL
        is_ycp = layer2 == TB_YCLIP_PREFIX
        is_xcp = layer2 == TB_XCLIP_PREFIX
        outs[1, j] = ins_cnt
        if local:
            finish = at & ((layer2 == TB_START) | is_xcp | is_ycp)
            outs[2, j] = torch.where(at & (is_mm | is_del), layer2, 0)
            icur = torch.where(at & is_mm, i2 - 1, torch.where(at, i2, icur))
            jcur = torch.where(at & (is_mm | is_del), j - 1, jcur)
            carried = torch.where(at & is_del, db2, carried)
            use_s = torch.where(at, is_mm, use_s)
            done = done | finish
            xs = torch.where(finish, torch.maximum(i2, xs), xs)
            ys = torch.where(finish, torch.clamp(ys, min=j), ys)
            continue
        outs[0, j] = pre
        outs[2, j] = torch.where(at & (is_mm | is_del | is_ycp | is_xcp), layer2, 0)
        outs[3, j] = torch.where(at & is_xcp, i2, torch.where(at & is_ycp, j, 0))
        sb0 = (col[0] >> 8) & 0xF
        db0 = (col[0] >> 4) & 0xF
        outs[4, j] = torch.where(at & is_xcp, sb0, 0)
        post_del = at & is_xcp & (sb0 == TB_DEL)
        post_ycp = at & is_xcp & (sb0 == TB_YCLIP_PREFIX)
        post_start = at & is_xcp & (sb0 == TB_START)
        icur = torch.where(at & is_mm, i2 - 1, torch.where(at & is_xcp, 0, torch.where(at, i2, icur)))
        jcur = torch.where(
            at & (is_mm | is_del | post_del), j - 1, torch.where(at & (is_ycp | post_ycp), 0, jcur)
        )
        carried = torch.where(at & is_del, db2, torch.where(post_del, db0, carried))
        use_s = torch.where(at, ~(is_del | post_del), use_s)
        done = done | (at & (layer2 == TB_START)) | post_start
    u16 = torch.uint16
    if local:
        return outs[1].to(u16), outs[2].to(u16), xs & 0xFFFF, ys & 0xFFFF
    return tuple(o.to(u16) for o in outs)


# ---------------------------------------------------------------------------
# the per-step walk of K15 (K15-walk)
# ---------------------------------------------------------------------------
#
# Input: K15's ``tb`` (N+1, X, B) uint16 of 12-bit cells (column 0 at index
# 0) with the suffix-fixed column written at column nlens[b], contiguous or
# the pair-major view K15 returns (``_walk_strides``), its ``lx``
# (N+1, B) int32 with the fixed column's clip length, and ``ly`` (B, X) int32,
# K15's final Ly. Output, one entry a step of T = M + N + 8, end -> start:
# ``op_codes`` (T, B) uint8, the TB_* layer of the step (0 once the lane is
# done), ``op_lens`` (T, B) uint16, a clip step's length; and xstart,
# ystart, xend, yend (B,) int32. Decode with ``batched._decode_ops``.


def _check_steps(tb, lx, ly, mlens, nlens):
    dev = same_device(tb, lx, ly, mlens, nlens)
    if tb.dim() != 3:
        raise ValueError(f"tb: expected (N+1, X, B), got shape {tuple(tb.shape)}")
    Nc, X, B = _check_tb(tb)
    check(lx, "lx", torch.int32, (Nc, B))
    check(ly, "ly", torch.int32, (B, X))
    check(mlens, "mlens", torch.int32, (B,))
    check(nlens, "nlens", torch.int32, (B,))
    check_lengths(mlens, "mlens", X - 1)
    check_lengths(nlens, "nlens", Nc - 1)
    return dev


def walk_steps(tb, lx, ly, mlens, nlens):
    """K15-walk. Returns (op_codes (T, B) uint8, op_lens (T, B) uint16,
    xstart, ystart, xend, yend (B,) int32). ``tb`` is a contiguous (N+1, X,
    B) tensor or, as K15 returns it, a pair-major view: read in place, never
    copied. On the card one warp a pair walks tiles of the tb staged in
    shared memory (K14's, ``seg_walk_geometry``), 8 rows a copy where
    ``_vector_rows`` allows, a run of Match/Subst, Ins or Del steps a
    round (a lane a step)."""
    if _check_steps(tb, lx, ly, mlens, nlens).type == "cpu":
        return walk_steps_plain(tb, lx, ly, mlens, nlens)
    Nc, X, B = tb.shape
    T = (X - 1) + (Nc - 1) + 8
    dev = tb.device
    op_codes = torch.zeros((T, B), dtype=torch.uint8, device=dev)
    op_lens = torch.zeros((T, B), dtype=torch.uint16, device=dev)
    coords = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)]
    if B:
        WALK_STEPS.launch(
            dev, tb.data_ptr(), lx.data_ptr(), ly.data_ptr(), mlens.data_ptr(), nlens.data_ptr(),
            B, X - 1, Nc - 1, T, *_walk_strides(tb), int(_vector_rows(tb)), op_codes.data_ptr(),
            op_lens.data_ptr(), *(c.data_ptr() for c in coords),
        )
    return (op_codes, op_lens, *coords)


def _storage(tb):
    """``tb``'s storage from its first element on, as flat int16 (no uint16
    indexing on CUDA): the plain walks gather a view's cells from it through
    the strides, in place."""
    off = tb.storage_offset()
    return tb.view(torch.int16).as_strided((tb.untyped_storage().nbytes() // 2 - off,), (1,), off)


def walk_steps_plain(tb, lx, ly, mlens, nlens):
    """Plain version of K15-walk (batched.py ``_walk``, three-gather form):
    pairs vectorized, steps in a Python loop with a gather each for the
    cell, lx and Ly, until every lane is done. The cell is gathered from
    ``tb``'s storage through its strides (``_walk_strides``), so that a
    pair-major view is read in place, not copied."""
    Nc, X, B = tb.shape
    T = (X - 1) + (Nc - 1) + 8
    dev = tb.device
    i32 = torch.int32
    sj, si, sb = _walk_strides(tb)
    flat = _storage(tb)
    bidx = torch.arange(B, device=dev)
    i, j = mlens.clone(), nlens.clone()
    carried = torch.full((B,), TB_START, dtype=i32, device=dev)
    use_s = torch.ones(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    xstart, ystart, xend, yend = torch.zeros_like(i), torch.zeros_like(i), mlens.clone(), nlens.clone()
    op_codes = torch.zeros((T, B), dtype=i32, device=dev)
    op_lens = torch.zeros((T, B), dtype=i32, device=dev)
    for t in range(T):
        if t % 32 == 0 and bool(done.all()):
            break
        ic, jc = i.clamp(0, X - 1).long(), j.clamp(0, Nc - 1).long()
        cell = flat[jc * sj + ic * si + bidx * sb].to(i32) & 0xFFFF
        lxj = lx[jc, bidx]
        lyi = ly[bidx, ic]
        layer = torch.where(use_s, (cell >> 8) & 0xF, carried)
        done = done | (layer == TB_START)
        live = ~done
        is_ins = layer == TB_INS
        is_del = layer == TB_DEL
        is_mm = (layer == TB_MATCH) | (layer == TB_SUBST)
        is_xp = live & (layer == TB_XCLIP_PREFIX)
        is_xs = live & (layer == TB_XCLIP_SUFFIX)
        is_yp = live & (layer == TB_YCLIP_PREFIX)
        is_ys = live & (layer == TB_YCLIP_SUFFIX)
        op_codes[t] = torch.where(live, layer, 0)
        op_lens[t] = torch.where(is_xp, i, 0) + torch.where(is_xs, lxj, 0) + torch.where(is_yp, j, 0) + torch.where(
            is_ys, lyi, 0
        )
        ni = torch.where(is_xp, 0, i - (live & (is_ins | is_mm)).to(i32) - torch.where(is_xs, lxj, 0))
        nj = torch.where(is_yp, 0, j - (live & (is_del | is_mm)).to(i32) - torch.where(is_ys, lyi, 0))
        xstart = torch.where(is_xp, i, xstart)
        xend = torch.where(is_xs, ni, xend)
        ystart = torch.where(is_yp, j, ystart)
        yend = torch.where(is_ys, nj, yend)
        carried = torch.where(is_ins, cell & 0xF, (cell >> 4) & 0xF)
        use_s = ~(is_ins | is_del)
        i, j = ni, nj
    return op_codes.to(torch.uint8), op_lens.to(torch.uint16), xstart, ystart, xend, yend


# ---------------------------------------------------------------------------
# the lockstep walk of the banded aligner (K16-walk)
# ---------------------------------------------------------------------------
#
# Input: K16's ``tb`` (N, X, B) uint16, columns 1..N, contiguous or the
# pair-major view K16 returns (``_walk_strides``); ``tb0`` (B, X) int32,
# column 0's cells (``banded_device._init_column_banded``); ``tbfix`` (B, X)
# int32, the suffix-fixed final column's 12-bit cells with Ly << 12, read in
# place of column nlens[b]; ``lx`` (B, N + 1) int32, each column's x-suffix
# clip length (the fixed one at nlens[b]); ``pens`` (gap_open, gap_extend,
# xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix). Output as
# K15-walk's, one entry a step of T = M + N + 8, end -> start: ``op_codes``
# (T, B) uint8 (0 once the lane is done), ``op_lens`` (T, B) uint16; xstart,
# ystart, xend, yend (B,) int32. The walk rewrites the s-bits of row 0 and
# column 0 as it reads them (banded.py:595-620 writes them after the DP) and
# ends a path that stops at TB_START away from the origin with two ops: Ins
# x i or an x-prefix clip, then Del x j or a y-prefix clip (banded.rs:833-856).
# Decode with ``banded_device._decode_ops_batch``.

WALK_BANDED = CudaKernel("walk_steps", "walk_banded", [PTR] * 6 + [INT] * 9 + [I64] * 3 + [INT] + [PTR] * 6)


def _check_banded_walk(tb, tb0, tbfix, lx, mlens, nlens):
    dev = same_device(tb, tb0, tbfix, lx, mlens, nlens)
    N, X, B = _check_tb(tb)
    check(tb0, "tb0", torch.int32, (B, X))
    check(tbfix, "tbfix", torch.int32, (B, X))
    check(lx, "lx", torch.int32, (B, N + 1))
    check(mlens, "mlens", torch.int32, (B,))
    check(nlens, "nlens", torch.int32, (B,))
    return dev


def walk_banded(tb, tb0, tbfix, lx, mlens, nlens, pens):
    """K16-walk (banded_device.py ``_walk_banded``). Returns (op_codes (T, B)
    uint8, op_lens (T, B) uint16, xstart, ystart, xend, yend (B,) int32).
    ``0 <= mlens <= X - 1`` and ``0 <= nlens <= N`` are the caller's to keep
    (the kernel clamps the cells it reads into the tensors). ``tb`` is a
    contiguous (N, X, B) tensor or, as K16 returns it, a pair-major view:
    read in place, never copied. On the card K15-walk's tile walk: one
    warp a pair over tiles of the tb in shared memory (``seg_walk_geometry``;
    column 0 from ``tb0``, column nlens from ``tbfix``), 8 rows a copy where
    ``_vector_rows`` allows, a run of Match/Subst, Ins or Del steps a
    round."""
    dev = _check_banded_walk(tb, tb0, tbfix, lx, mlens, nlens)
    pens = tuple(int(v) for v in pens)[:6]
    if dev.type == "cpu":
        return walk_banded_plain(tb, tb0, tbfix, lx, mlens, nlens, pens)
    N, X, B = tb.shape
    T = (X - 1) + N + 8
    op_codes = torch.zeros((T, B), dtype=torch.uint8, device=dev)
    op_lens = torch.zeros((T, B), dtype=torch.uint16, device=dev)
    coords = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)]
    if B:
        WALK_BANDED.launch(
            dev, tb.data_ptr(), tb0.data_ptr(), tbfix.data_ptr(), lx.data_ptr(), mlens.data_ptr(),
            nlens.data_ptr(), B, X - 1, N, T, *pens[:5], *_walk_strides(tb), int(_vector_rows(tb)), op_codes.data_ptr(),
            op_lens.data_ptr(), *(c.data_ptr() for c in coords),
        )
    return (op_codes, op_lens, *coords)


def walk_banded_plain(tb, tb0, tbfix, lx, mlens, nlens, pens):
    """Plain version of K16-walk: ``_walk_banded``'s step, pairs vectorized,
    steps in a Python loop until every lane is done. The cell is gathered
    from ``tb``'s storage through its strides, as ``walk_steps_plain``
    gathers it."""
    go, ge, xcp, xcs, ycp, ycs = (int(v) for v in pens[:6])
    N, X, B = tb.shape
    T = (X - 1) + N + 8
    dev = tb.device
    i32 = torch.int32
    flat, (s_col, s_row, s_pair) = _storage(tb), _walk_strides(tb)
    bidx = torch.arange(B, device=dev)
    i, j = mlens.clone(), nlens.clone()
    carried = torch.full((B,), TB_START, dtype=i32, device=dev)
    use_s = torch.ones(B, dtype=torch.bool, device=dev)
    phase1 = torch.zeros(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    xstart, ystart, xend, yend = torch.zeros_like(i), torch.zeros_like(i), mlens.clone(), nlens.clone()
    op_codes = torch.zeros((T, B), dtype=i32, device=dev)
    op_lens = torch.zeros((T, B), dtype=i32, device=dev)
    for t in range(T):
        if t % 32 == 0 and bool(done.all()):
            break
        ic, jc = i.clamp(0, X - 1).long(), j.clamp(0, N).long()
        cm = flat[(jc - 1).clamp(min=0) * s_col + ic * s_row + bidx * s_pair].to(i32) & 0xFFFF
        cm = torch.where(jc == 0, tb0[bidx, ic], cm)
        cf = tbfix[bidx, ic]
        use_fix = j == nlens
        cell = torch.where(use_fix, cf, cm) & 0xFFF
        ib, db, sb = cell & 0xF, (cell >> 4) & 0xF, (cell >> 8) & 0xF
        # the row-0 and column-0 s-bit rewrites
        rw0 = torch.where(go + ge * (j - 1) > ycp, TB_DEL, TB_YCLIP_PREFIX)
        sb = torch.where((i == 0) & (j >= 1) & ~use_fix, rw0, sb)
        c_i = go + ge * (i - 1)
        rwc = torch.where(c_i > xcp, TB_INS, TB_XCLIP_PREFIX)
        rwc = torch.where((i == mlens) & (xcs > torch.clamp(c_i, min=xcp)), TB_XCLIP_SUFFIX, rwc)
        sb = torch.where((j == 0) & (i >= 1), rwc, sb)
        ly = cf >> 12
        lxj = lx[bidx, jc]
        layer = torch.where(use_s, sb, carried)

        hit_start = (layer == TB_START) & ~done
        do_x = hit_start & ~phase1 & (i > 0)
        do_y = hit_start & (j > 0) & (phase1 | (i == 0))
        finish = hit_start & ~do_x & ~do_y
        live = ~hit_start & ~done
        is_ins = live & (layer == TB_INS)
        is_del = live & (layer == TB_DEL)
        is_mm = live & ((layer == TB_MATCH) | (layer == TB_SUBST))
        is_xp = live & (layer == TB_XCLIP_PREFIX)
        is_xs = live & (layer == TB_XCLIP_SUFFIX)
        is_yp = live & (layer == TB_YCLIP_PREFIX)
        is_ys = live & (layer == TB_YCLIP_SUFFIX)

        # the ending fixups: Ins x i / Xclip(i), then Del x j / Yclip(j)
        iw = go + ge * (i - 1) > xcp
        dw = go + ge * (j - 1) > ycp
        fix_code = torch.where(do_x, torch.where(iw, TB_INS, TB_XCLIP_PREFIX), torch.where(dw, TB_DEL, TB_YCLIP_PREFIX))
        fixing = do_x | do_y
        op_codes[t] = torch.where(done | finish, 0, torch.where(fixing, fix_code, layer))
        step_len = is_mm.to(i32) + torch.where(is_xp, i, 0) + torch.where(is_xs, lxj, 0)
        step_len = step_len + torch.where(is_yp, j, 0) + torch.where(is_ys, ly, 0)
        op_lens[t] = torch.where(fixing, torch.where(do_x, i, j), step_len)

        new_i = torch.where(do_x, 0, i - (is_ins | is_mm).to(i32) - torch.where(is_xs, lxj, 0) - torch.where(is_xp, i, 0))
        new_j = torch.where(do_y, 0, j - (is_del | is_mm).to(i32) - torch.where(is_ys, ly, 0) - torch.where(is_yp, j, 0))
        xstart = torch.where(is_xp, i, xstart)
        xstart = torch.where(do_x, torch.where(iw, 0, i), xstart)
        xend = torch.where(is_xs, new_i, xend)
        ystart = torch.where(is_yp, j, ystart)
        ystart = torch.where(do_y, torch.where(dw, 0, j), ystart)
        yend = torch.where(is_ys, new_j, yend)

        new_done = done | finish | (do_y & ~do_x)
        phase1 = phase1 | do_x
        next_carried = torch.where(is_ins, ib, db)
        carried = torch.where(do_x | new_done, TB_START, next_carried)
        use_s = ~(is_ins | is_del | do_x) | new_done
        i, j, done = new_i, new_j, new_done
    return op_codes.to(torch.uint8), op_lens.to(torch.uint16), xstart, ystart, xend, yend


# ---------------------------------------------------------------------------
# K-merge: the run merge of the compact pack
# ---------------------------------------------------------------------------
#
# A pair's stream in op order is [Ins x ins0], per column j < nlens (exit_op[j]
# x 1, Ins x ins_cnt[j]), [fix_exit x 1], [Ins x fix_ins]; entries of kind
# Ins..Match (1-4) with a positive length are kept, and a kept entry starts a
# run where its kind differs from the previous kept entry's (dropped entries
# do not break a run, as the numpy merge of ``PackedSemiglobal.cigars``). The
# pack: rows 0-4 the score's high and low 16 bits, xstart, xend and n_runs |
# ovf << 15; row 5 + r run r's kind << 12 | min(length, 4095), 0 past the
# runs. ``ovf``: more than R runs, or one of the first R longer than 4095.

RLE_MERGE = CudaKernel("rle_merge", "rle_merge", [PTR] * 9 + [INT, INT, INT, PTR])
# csrc/rle_merge.cu's launch: one warp a pair, MERGE_WARPS pairs a block
MERGE_WARPS = 8


def merge_rle(score, ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens, xstart, xend, R: int):
    """K-merge. ``score`` (B,) int32; ``ins_cnt``, ``exit_op`` (N, B) and
    ``ins0`` (B,) uint16 as K2 and K6 return them; ``fix_ins``, ``fix_exit``
    (B,) int32 or None (global mode: 0); ``nlens``, ``xend`` (B,) int32,
    ``xstart`` (B,) int32 or None (0). Returns the (5 + R, B) uint16 pack."""
    dev = same_device(score, ins_cnt, exit_op, ins0, nlens, xend)
    if ins_cnt.dim() != 2:
        raise ValueError(f"ins_cnt: expected (N, B), got shape {tuple(ins_cnt.shape)}")
    N, B = ins_cnt.shape
    if not 1 <= R < 2**15:
        raise ValueError(f"R = {R}: expected 1 <= R < 2^15")
    check(score, "score", torch.int32, (B,))
    check(ins_cnt, "ins_cnt", torch.uint16, (N, B))
    check(exit_op, "exit_op", torch.uint16, (N, B))
    check(ins0, "ins0", torch.uint16, (B,))
    check(nlens, "nlens", torch.int32, (B,))
    check(xend, "xend", torch.int32, (B,))
    for name, t in (("fix_ins", fix_ins), ("fix_exit", fix_exit), ("xstart", xstart)):
        if t is not None:
            same_device(score, t)
            check(t, name, torch.int32, (B,))
    if dev.type == "cpu":
        return merge_rle_plain(score, ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens, xstart, xend, R)
    pack = torch.empty((5 + R, B), dtype=torch.uint16, device=dev)
    if B:
        RLE_MERGE.launch(
            dev, score.data_ptr(), ins_cnt.data_ptr(), exit_op.data_ptr(), ins0.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (fix_ins, fix_exit)), nlens.data_ptr(),
            0 if xstart is None else xstart.data_ptr(), xend.data_ptr(), B, N, R, pack.data_ptr(),
        )
    return pack


def merge_rle_plain(score, ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens, xstart, xend, R: int):
    """Plain version of K-merge: batched.py ``_merge_rle_device`` (the
    stream, the forward fill of the previous kept kind, here a ``cummax``
    over the indices of kept entries, the run ids and the masked sums, here
    ``scatter_add_`` with a column for the runs past R) and
    ``_pack_rle_merged``."""
    i32 = torch.int32
    N, B = ins_cnt.shape
    dev = ins_cnt.device
    zero = torch.zeros(B, dtype=i32, device=dev)
    fix_ins = zero if fix_ins is None else fix_ins
    fix_exit = zero if fix_exit is None else fix_exit
    xstart = zero if xstart is None else xstart
    cvalid = torch.arange(N, device=dev)[None, :] < nlens[:, None]  # (B, N)
    ex = torch.where(cvalid, exit_op.T.to(i32), 0)
    cnt = torch.where(cvalid, ins_cnt.T.to(i32), 0)
    ins = torch.full((B, 1), TB_INS, dtype=i32, device=dev)
    kind = torch.cat([ins, torch.stack([ex, ins.expand(B, N)], dim=2).reshape(B, 2 * N), fix_exit[:, None], ins], 1)
    ones = torch.ones((B, 1), dtype=i32, device=dev)
    ln = torch.cat(
        [ins0.to(i32)[:, None], torch.stack([ones.expand(B, N), cnt], dim=2).reshape(B, 2 * N), ones, fix_ins[:, None]],
        1,
    )
    W = kind.shape[1]
    kept = (kind >= TB_INS) & (kind <= TB_MATCH) & (ln > 0)
    at = torch.arange(W, device=dev).expand(B, W)
    last = torch.cummax(torch.where(kept, at, -1), dim=1).values  # the last kept entry up to each
    ffi = torch.where(last >= 0, kind.gather(1, last.clamp(min=0)), 0)
    prev = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev), ffi[:, :-1]], 1)
    new = kept & (kind != prev)
    rid = torch.cumsum(new.to(i32), 1) - 1
    n_runs = rid[:, -1] + 1
    slot = torch.where(rid < R, rid, R).clamp(min=0).long()
    run_len = torch.zeros((B, R + 1), dtype=i32, device=dev).scatter_add_(1, slot, torch.where(kept, ln, 0))[:, :R]
    run_kind = torch.zeros((B, R + 1), dtype=i32, device=dev).scatter_add_(1, slot, torch.where(new, kind, 0))[:, :R]
    ovf = (n_runs > R) | (run_len.max(dim=1).values > 0xFFF)
    small = torch.stack([(score >> 16) & 0xFFFF, score & 0xFFFF, xstart, xend, n_runs | (ovf.to(i32) << 15)])
    kl = (run_kind.T << 12) | run_len.T.clamp(max=0xFFF)
    return torch.cat([small, kl], 0).to(torch.uint16)
