"""Batched pairwise alignment on the device (port of
``rust_bio_tpu.alignment.pairwise.batched``: global, semiglobal, local and
custom modes).

The substitution source is chosen once, in ``BatchAligner.__init__``:
``MatchParams`` scoring runs the kernels below with its two scores; every
other match function (a BLOSUM/PAM scorer, a (256, 256) ndarray, a
callable) becomes the dense (256, 256) int32 LUT of ``Scoring.dense_lut``,
kept on the device, and runs each kernel's LUT twin (K1 -> K11, K3 -> K18,
K5 -> K12, K7/K9 -> their LUT instantiations). The walks, fixups and packs
read only traceback cells and are the same for both.

The path of ``BatchAligner.global_``: pad the pairs to (B, M) / (B, N)
uint8; K1 (``ops.sw.scan_global``) computes the scores and the traceback
tensor; K2 (``ops.walk.sweep_walk_global``) walks it into per-column
run-length ops; ``_pack_rle`` packs those into one (10 + N, B) uint16
tensor, the only device-to-host transfer; the host decodes it into
reference-exact ``Alignment`` objects. ``scores(..., "global")`` runs K3
(``ops.sw.scores_global``) instead, at any M.

Long x (M + 1 >= ``T_ROWS``, the routing by padded M that K1 had when its
column state left shared memory there) takes the block-row path instead: K13 (``ops.sw.scan_global_rows``,
K13-LUT under a LUT) computes the DP in blocks of rows and writes
``TB_REREAD`` i-cells at the block seams, K14
(``ops.walk.sweep_walk_global_seg``) walks that tensor into K2's outputs.
From M + 1 >= 4096 on, where an Ins run no longer fits ``_pack_rle``'s 12
bits, the wide pack ``_pack_rle_wide`` (ins_cnt and exit_op in rows of
their own) replaces it; the handles and ``PackedSemiglobal`` record which
layout they hold. Its uint16 fields cap M at 65534 and N at 65535.

The path of ``BatchAligner.semiglobal`` (and of the read mapper's
extension, ``semiglobal_packed_*``): K5 (``ops.sw.scan_semiglobal``) with
the y-clip penalties 0, ``_suffix_fixups`` (plain torch) on its finals, K6
(``ops.walk.sweep_walk_semiglobal``) from the fixed final column, and the
same pack with the fix/clip fields live. ``PackedSemiglobal`` holds the
pulled result: vectorized CIGARs and per-read ``Alignment`` decode.

The compact path (``global_packed_compact_async_arrays``,
``semiglobal_packed_compact_async_arrays``, ``packed_compact_finish``,
``packed_compact_finish_many``): K1 -> K2 or K5 -> K6 as above, then K-merge
(``ops.walk.merge_rle``) merges the walk's column-RLE stream into at most R
(``max_runs``, default ``_COMPACT_RUNS`` = 32) runs a pair and packs them
as one (5 + R, B) uint16 tensor; the host formats the CIGARs
(``PackedMergedCigars``) and re-runs the lanes that overflow R runs or a
12-bit run length through the dense packed path. As in the JAX package only
MatchParams scoring on the column-RLE engines has this route: in the port
K1 below padded M + 1 = ``T_ROWS`` and K5 below M + 1 = 4096 (the routing
by padded M); elsewhere the compact calls raise ``ValueError``.

The path of ``BatchAligner.local`` and ``.custom`` (``_custom_device``):
K7 (``ops.sw.scan_local``) when all four clip penalties are 0, else K9
(``ops.sw.scan_custom``); ``_suffix_fixups`` with all four clips; then K8
(``ops.walk.sweep_walk_local``) after K7 with gap_open + gap_extend < 0,
else K10 (``ops.walk.sweep_walk_custom``); ``_pack_rle_local`` or
``_pack_rle_custom`` and the host decode. ``scores(..., "local"|"custom")``
stops after the fixups. Custom mode with the x-clips off takes this path
too (the JAX package sends it through its semiglobal subs kernel; the
results are the same).

Long x in the clip modes (M + 1 >= ``T_COLUMNS`` = 4096, where the
column-RLE packs' 12-bit Ins counts end): ``semiglobal`` (clips (MIN, MIN,
0, 0)), ``local`` and ``custom`` run the JAX package's general engine
(batched.py ``_align_batch_device``): K15 (``ops.sw.scan_columns``, K15-LUT
under a LUT) with the mode's four clips, ``_suffix_fixups``, the fixed
column written into K15's traceback tensor, K15-walk
(``ops.walk.walk_steps``, one op a step) and ``_pack_steps``; the host
decodes each pair with ``_decode_ops``. ``scores`` in those modes stops
after the fixups. ``semiglobal_packed*`` raises there (its layout holds
12-bit Ins counts). Lengths are capped as for global mode.

Results are bit-identical to the JAX package and to its scalar oracle
(at M + 1 >= 4096 to the oracle: the JAX package's global path packs Ins
runs in 12 bits there and wraps them), but for a lane with an empty y in
the clip modes, where the port follows the oracle: the JAX engines end
column 0 with I = MIN_SCORE instead of I0, so their suffix fixups may
rewrite column 0's i-bits.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from rust_bio_tpu_torch._device import resolve_device
from rust_bio_tpu_torch.alignment.pairwise.scoring import (
    MIN_SCORE,
    MatchParams,
    Scoring,
)
from rust_bio_tpu_torch.alignment.pairwise.tb import (
    TB_DEL,
    TB_INS,
    TB_MATCH,
    TB_START,
    TB_SUBST,
    TB_XCLIP_PREFIX,
    TB_XCLIP_SUFFIX,
    TB_YCLIP_PREFIX,
    TB_YCLIP_SUFFIX,
)
from rust_bio_tpu_torch.alignment.types import (
    Alignment,
    AlignmentMode,
    AlignmentOperation,
    Del,
    Ins,
    Match,
    Subst,
    Xclip,
    Yclip,
)
from rust_bio_tpu_torch.utils.text import to_bytes

_MAX_ROWS = 4096  # _pack_rle keeps ins_cnt <= M + 1 in 12 bits
# M + 1 >= T_ROWS runs K13 + K14: the routing by padded M stays where the
# first K1 (one thread a pair) had to hand over, when its column state left
# a block's shared memory, so that a batch takes the engine whose chain it
# took before where int32 wraps (K13's block-seeded chain parts from K1's
# there); and K13 is the engine of x past 605 (K1's lanes keep their state
# on chip up to M = 2,047, and at 128 pairs one block a pair fills the
# card where one warp a pair does not)
T_ROWS = 606
# M + 1 >= T_COLUMNS runs the clip modes on K15 and K15-walk (the packs of
# the column-RLE walks keep Ins counts in 12 bits)
T_COLUMNS = _MAX_ROWS
_MAX_M, _MAX_N = 65534, 65535  # the uint16 fields of the packs
_SENTINEL = -(2**31)  # int32 min: masked-out entries of the fixup maxima


def _pack_rle(
    score, ins_cnt, exit_op, ins0, fix_ins, fix_exit, fix_ly,
    xstart, ystart, xend, yend,
):
    """One (10 + N, B) uint16 tensor for the single device-to-host pull
    (batched.py ``_pack_rle`` layout): the score split in two 16-bit rows,
    eight per-pair fields, then ``exit_op << 12 | ins_cnt`` per column."""
    i32 = torch.int32
    small = _pack_head(score, ins0, fix_ins, fix_exit, fix_ly, xstart, ystart, xend, yend)
    merged = ((exit_op.to(i32) << 12) | ins_cnt.to(i32)).to(torch.uint16)
    return torch.cat([small, merged], dim=0)


def _pack_head(score, ins0, *fields):
    """The ten per-pair rows of ``_pack_rle``: the score in two 16-bit
    halves, ``ins0``, then the seven int32 fields."""
    return torch.stack([(score >> 16) & 0xFFFF, score & 0xFFFF, ins0.to(torch.int32), *fields]).to(torch.uint16)


def _unpack_rle(packed: np.ndarray):
    """Host-side inverse of ``_pack_rle``: (score (B,), dict of arrays)."""
    small = packed[:10].astype(np.int64)
    v = (small[0] << 16) | small[1]
    score = np.where(v >= 2**31, v - 2**32, v).astype(np.int64)
    merged = packed[10:]
    return score, {
        "ins0": small[2],
        "fix_ins": small[3],
        "fix_exit": small[4],
        "fix_ly": small[5],
        "xstart": small[6],
        "ystart": small[7],
        "xend": small[8],
        "yend": small[9],
        "ins_cnt": merged & 0xFFF,
        "exit_op": merged >> 12,
    }


def _unpack_rle_merged(packed: np.ndarray):
    """Host-side inverse of the compact pack (K-merge's, batched.py
    ``_pack_rle_merged``): (score (B,), dict of arrays)."""
    small = packed[:5].astype(np.int64)
    v = (small[0] << 16) | small[1]
    score = np.where(v >= 2**31, v - 2**32, v).astype(np.int64)
    kl = packed[5:]
    return score, {
        "xstart": small[2],
        "xend": small[3],
        "n_runs": small[4] & 0x7FFF,
        "ovf": (small[4] >> 15).astype(bool),
        "run_kind": kl >> 12,  # (R, B)
        "run_len": kl & 0xFFF,
    }


def _pack_rle_wide(
    score, ins_cnt, exit_op, ins0, fix_ins, fix_exit, fix_ly,
    xstart, ystart, xend, yend,
):
    """``_pack_rle`` for M + 1 >= 4096: one (10 + 2N, B) uint16 tensor, the
    ten per-pair rows, then ``ins_cnt`` and ``exit_op`` in N rows each,
    unmasked."""
    small = _pack_head(score, ins0, fix_ins, fix_exit, fix_ly, xstart, ystart, xend, yend)
    return torch.cat([small, ins_cnt.to(torch.uint16), exit_op.to(torch.uint16)], dim=0)


def _unpack_rle_wide(packed: np.ndarray):
    """Host-side inverse of ``_pack_rle_wide``: (score (B,), dict of arrays)."""
    score, up = _unpack_rle(packed[:10])
    N = (packed.shape[0] - 10) // 2
    up["ins_cnt"] = packed[10 : 10 + N]
    up["exit_op"] = packed[10 + N :]
    return score, up


def _wide(M: int) -> bool:
    """Whether a global batch padded to M packs into ``_pack_rle_wide``."""
    return M + 1 >= _MAX_ROWS


def _long(M: int) -> bool:
    """Whether a clip-mode batch padded to M takes K15 and K15-walk."""
    return M + 1 >= T_COLUMNS


def _check_limits(what: str, M: int, N: int) -> None:
    """The uint16 fields of the results cap M at 65534 and N at 65535."""
    if M > _MAX_M or N > _MAX_N:
        raise ValueError(
            f"{what} alignment of M = {M}, N = {N}: the packed result keeps "
            f"lengths in uint16 fields, so M <= {_MAX_M} and N <= {_MAX_N}"
        )


def _unpack(packed: np.ndarray, wide: bool):
    """The unpacker of the layout ``wide`` names."""
    return (_unpack_rle_wide if wide else _unpack_rle)(packed)


def _score_coords(score, xstart, ystart, xend, yend):
    """Six per-pair rows: the score in two 16-bit halves, the four
    coordinates."""
    return torch.stack([(score >> 16) & 0xFFFF, score & 0xFFFF, xstart, ystart, xend, yend])


def _small_rows(score, xstart, ystart, xend, yend, fix_codes, fix_lens):
    """The 14 per-pair rows of the clip-mode packs: ``_score_coords``, then
    the four fix slots' codes and lengths."""
    head = _score_coords(score, xstart, ystart, xend, yend)
    return torch.cat([head, fix_codes.t(), fix_lens.t()]).to(torch.uint16)


def _pack_steps(score, op_codes, op_lens, xstart, ystart, xend, yend):
    """One (6 + 2T, B) uint16 tensor of the K15-walk for the single pull:
    ``_score_coords``, then the walk's T op codes and T clip lengths."""
    head = _score_coords(score, xstart, ystart, xend, yend).to(torch.uint16)
    return torch.cat([head, op_codes.to(torch.uint16), op_lens])


def _pack_rle_custom(
    score, pre, ins_cnt, exit_op, elen, post, fix_codes, fix_lens,
    xstart, ystart, xend, yend,
):
    """One (14 + 4 Nc, B) uint16 tensor of the K10 walk (batched.py
    ``_pack_rle_custom`` layout): the 14 per-pair rows, then ``exit_op << 12
    | pre``, ``ins_cnt``, ``exit_len`` and ``post`` per column."""
    i32 = torch.int32
    pre_op = (exit_op.to(i32) << 12) | pre.to(i32)
    cols = [pre_op.to(torch.uint16), ins_cnt, elen, post]
    return torch.cat([_small_rows(score, xstart, ystart, xend, yend, fix_codes, fix_lens)] + cols)


def _pack_rle_local(score, ins_cnt, exit_op, fix_codes, fix_lens, xstart, ystart, xend, yend):
    """One (14 + Nc, B) uint16 tensor of the K8 walk (batched.py
    ``_pack_rle_local`` layout): the 14 per-pair rows, then ``exit_op << 12
    | ins_cnt`` per column."""
    i32 = torch.int32
    merged = ((exit_op.to(i32) << 12) | ins_cnt.to(i32)).to(torch.uint16)
    return torch.cat([_small_rows(score, xstart, ystart, xend, yend, fix_codes, fix_lens), merged])


def _unpack_head(packed: np.ndarray):
    """Host-side inverse of ``_score_coords``: (score (B,), dict of the
    coordinates)."""
    small = packed[:6].astype(np.int64)
    v = (small[0] << 16) | small[1]
    score = np.where(v >= 2**31, v - 2**32, v).astype(np.int64)
    return score, {"xstart": small[2], "ystart": small[3], "xend": small[4], "yend": small[5]}


def _unpack_small(packed: np.ndarray):
    score, out = _unpack_head(packed)
    small = packed[6:14].astype(np.int64)
    out.update(fix_codes=small[:4], fix_lens=small[4:])
    return score, out


def _unpack_steps(packed: np.ndarray):
    """Host-side inverse of ``_pack_steps``: (score (B,), dict of arrays)."""
    score, out = _unpack_head(packed)
    T = (packed.shape[0] - 6) // 2
    out.update(op_codes=packed[6 : 6 + T], op_lens=packed[6 + T :])
    return score, out


def _unpack_rle_local(packed: np.ndarray):
    """Host-side inverse of ``_pack_rle_local``: (score (B,), dict)."""
    score, out = _unpack_small(packed)
    merged = packed[14:]
    out["ins_cnt"] = merged & 0xFFF
    out["exit_op"] = merged >> 12
    return score, out


def _unpack_rle_custom(packed: np.ndarray):
    """Host-side inverse of ``_pack_rle_custom``: (score (B,), dict)."""
    score, out = _unpack_small(packed)
    Nc = (packed.shape[0] - 14) // 4
    pre_op, ins_cnt, elen, post = (packed[14 + t * Nc : 14 + (t + 1) * Nc] for t in range(4))
    out.update(pre=pre_op & 0xFFF, exit_op=pre_op >> 12, ins_cnt=ins_cnt, elen=elen, post=post)
    return score, out


def _geometry(B, M, mlens):
    """Row index, row >= 1, mlens as a column and the row-m mask, each
    (B, M+1) or (B, 1) on ``mlens``' device (batched.py ``_geometry``)."""
    rows = torch.arange(M + 1, dtype=torch.int32, device=mlens.device)[None, :].expand(B, M + 1)
    row_ge1 = rows >= 1
    mlens_c = mlens[:, None]
    is_row_m = (rows == mlens_c) & (mlens_c >= 1)
    return rows, row_ge1, mlens_c, is_row_m


def _suffix_fixups(
    S_f, I_f, Sn_f, tb_f,
    B, M, rows, row_ge1, mlens, mlens_c, is_row_m, pens,
):
    """Post-loop suffix fixups at j = n (batched.py ``_suffix_fixups``,
    reference pairwise/mod.rs:809-843), torch ops on the (B, M+1) finals.

    Returns (score (B,) int32, tb_col_fixed (B, M+1) uint16: the final
    column's 12-bit cells after the fixups, Lx_n (B,) int32: the x-suffix
    clip length at column n, and whether it was set (B,) bool)."""
    go, ge, xcp, xcs, ycp, ycs = pens
    i32 = torch.int32
    tb = tb_f.to(i32)
    i_bits_f = tb & 0xF
    d_bits_f = (tb >> 4) & 0xF
    s_bits_f = (tb >> 8) & 0xF
    idx_m = mlens_c.long()

    def take_m(a):
        return a.gather(1, idx_m)[:, 0]

    def first_index(vals, best):
        # argmax takes the first of equal maxima
        return torch.argmax((vals == best[:, None]).to(torch.uint8), dim=1).to(i32)

    # fixup 1: yclip-suffix improvements + xclip-suffix re-accumulation
    y_take = (Sn_f > S_f) & (rows <= mlens_c)
    S1 = torch.where(y_take, Sn_f, S_f)
    sb1 = torch.where(y_take, TB_YCLIP_SUFFIX, s_bits_f)
    S_m_base = take_m(S_f)
    # accumulate S1[i]+xcs for 0 <= i <= m-1 against acc0 = S_f[m]
    vals = torch.where(rows <= mlens_c - 1, S1 + xcs, _SENTINEL)
    A2 = vals.amax(dim=1)
    x_upd = A2 > S_m_base
    acc = torch.where(x_upd, A2, S_m_base)
    sb_m = torch.where(x_upd, TB_XCLIP_SUFFIX, take_m(sb1))
    Lx_n = torch.where(x_upd, mlens - first_index(vals, A2), 0)
    lx_n_set = x_upd
    # then row m's own yclip-suffix check
    Sn_m = take_m(Sn_f)
    y_take_m = Sn_m > acc
    acc = torch.where(y_take_m, Sn_m, acc)
    sb_m = torch.where(y_take_m, TB_YCLIP_SUFFIX, sb_m)
    col0 = rows == 0
    m0 = (mlens == 0)[:, None]
    S1 = torch.where(is_row_m | (col0 & m0), acc[:, None], S1)
    sb1 = torch.where(is_row_m | (col0 & m0), sb_m[:, None], sb1)

    # fixup 2: recompute last-column I (chained opens after clip updates)
    # S2[i] = max(S1[i], S2[i-1] + go) for i = 1..m-1 (row m handled after)
    rgo = rows * go
    S2 = torch.cummax(S1 - rgo, dim=1).values + rgo
    upd2 = S2 > S1
    sb2 = torch.where(upd2, TB_INS, sb1)
    S2m1 = torch.cat([torch.full((B, 1), MIN_SCORE, dtype=i32, device=S2.device), S2[:, :-1]], dim=1)
    i_take2 = S2m1 + go > I_f
    sb2_prev = torch.cat([torch.full((B, 1), TB_START, dtype=i32, device=S2.device), sb2[:, :-1]], dim=1)
    ib2 = torch.where(i_take2 & row_ge1, sb2_prev, i_bits_f)
    # xclip re-check for updated rows 1..m-1 against evolving S[m]
    vals3 = torch.where(row_ge1 & (rows <= mlens_c - 1) & upd2, S2 + xcs, _SENTINEL)
    A3 = vals3.amax(dim=1)
    acc_m = take_m(S1)  # fixup-1 final row-m value
    x_upd3 = A3 > acc_m
    acc3 = torch.where(x_upd3, A3, acc_m)
    sb_m3 = torch.where(x_upd3, TB_XCLIP_SUFFIX, take_m(sb2))
    Lx_n = torch.where(x_upd3, mlens - first_index(vals3, A3), Lx_n)
    lx_n_set = lx_n_set | x_upd3
    # row m second statement: S[m] = max(acc3, S2[m-1]+go)
    sm_open = take_m(S2m1) + go
    m_take = (sm_open > acc3) & (mlens >= 1)
    S_final_m = torch.where(m_take, sm_open, acc3)
    sb_final_m = torch.where(m_take, TB_INS, sb_m3)
    # row m first statement (I)
    i_take_m = (sm_open > take_m(I_f)) & (mlens >= 1)
    ib_m = torch.where(i_take_m, take_m(sb2_prev), take_m(i_bits_f))

    S_fixed = torch.where(is_row_m, S_final_m[:, None], S2)
    sb_fixed = torch.where(is_row_m, sb_final_m[:, None], sb2)
    ib_fixed = torch.where(is_row_m, ib_m[:, None], ib2)
    S_fixed = torch.where(mlens_c == 0, S1, S_fixed)
    sb_fixed = torch.where(mlens_c == 0, sb1, sb_fixed)
    ib_fixed = torch.where(mlens_c == 0, i_bits_f, ib_fixed)

    tb_col_fixed = (ib_fixed | (d_bits_f << 4) | (sb_fixed << 8)).to(torch.uint16)
    return take_m(S_fixed), tb_col_fixed, Lx_n.to(i32), lx_n_set


def _columns_fixups(scan, mlens, nlens, pens):
    """The suffix fixups on a K15 scan's finals (``pens`` = (go, ge, *clips))
    and, where the scan kept its traceback, the fixed column and its x-suffix
    clip length written into its tb and lx at column nlens[b] (batched.py
    ``_postlude``), in place: the JAX package concatenates a second tb,
    10 GB at 128 pairs of 6.4 kb. On the card the tb is K15's pair-major
    view, and the indexed write goes through it into K15's tensor, copying
    nothing. Returns the (B,) int32 scores."""
    tb, lx, S_f, I_f, Sn_f, _Ly, tbk = scan
    B, X = S_f.shape
    rows, row_ge1, mlens_c, is_row_m = _geometry(B, X - 1, mlens)
    score, tb_col_fixed, Lx_n, lx_n_set = _suffix_fixups(
        S_f, I_f, Sn_f, tbk, B, X - 1, rows, row_ge1, mlens, mlens_c, is_row_m, pens
    )
    if tb is not None:
        cols, bidx = nlens.long(), torch.arange(B, device=tb.device)
        rows_idx = torch.arange(X, device=tb.device)[None, :]
        tb.view(torch.int16)[cols[:, None], rows_idx, bidx[:, None]] = tb_col_fixed.view(torch.int16)
        lx[cols, bidx] = torch.where(lx_n_set, Lx_n, lx[cols, bidx])  # where the fixups set one
    return score


def _fixed_column(S_f, I_f, Sn_f, Ly_f, tbk, mlens, go, ge):
    """(score (B,) int32, tbfix (B, M+1) int32): the suffix fixups on the
    finals of K5 run with the semiglobal penalties (x-clips off, y-clips 0),
    and the fixed final column K6 enters from, its 12-bit cells with
    Ly << 12."""
    B, X = S_f.shape
    rows, row_ge1, mlens_c, is_row_m = _geometry(B, X - 1, mlens)
    score, tb_col_fixed, _lx, _lx_set = _suffix_fixups(
        S_f, I_f, Sn_f, tbk, B, X - 1, rows, row_ge1, mlens, mlens_c, is_row_m,
        (go, ge, MIN_SCORE, MIN_SCORE, 0, 0),
    )
    return score, (tb_col_fixed.to(torch.int32) & 0xFFF) | (Ly_f << 12)


_OP_BY_CODE = {TB_INS: Ins, TB_DEL: Del, TB_MATCH: Match, TB_SUBST: Subst}
_OP_ARR = np.empty(16, object)
for _c, _o in _OP_BY_CODE.items():
    _OP_ARR[_c] = _o


def _decode_ops(codes: np.ndarray, lens: np.ndarray) -> List[AlignmentOperation]:
    """One lane's K15-walk buffers (T,), end -> start, to the start -> end op
    list (batched.py ``_decode_ops``): entries up to the first code 0, each
    clip entry an Xclip / Yclip of its length."""
    nz = np.nonzero(codes == 0)[0]
    end = int(nz[0]) if nz.size else len(codes)
    c = codes[:end].astype(np.intp)
    ops = _OP_ARR[c].tolist()
    for k in np.nonzero(c >= TB_XCLIP_PREFIX)[0]:
        n = int(lens[k])
        ops[k] = Xclip(n) if c[k] in (TB_XCLIP_PREFIX, TB_XCLIP_SUFFIX) else Yclip(n)
    ops.reverse()
    return ops


def _decode_ops_colrle(
    ins_cnt: np.ndarray, exit_op: np.ndarray, ins0: int, nlen: int
) -> List[AlignmentOperation]:
    """Column-RLE walk output (one ``[Ins x cnt][exit]`` group per DP
    column, emitted end -> start) to the start -> end op list: ``Ins*ins0``,
    then per column j ascending its exit op and its insertion run."""
    ops: List[AlignmentOperation] = [Ins] * int(ins0)
    exits = exit_op[:nlen].tolist()
    cnts = ins_cnt[:nlen].tolist()
    for j in range(nlen):
        c = exits[j]
        if c:
            ops.append(_OP_BY_CODE[c])
        n = cnts[j]
        if n:
            ops.extend([Ins] * n)
    return ops


def _decode_ops_colrle_semi(
    ins_cnt, exit_op, ins0: int,
    fix_ins: int, fix_exit: int, fix_ly: int, nlen: int,
) -> List[AlignmentOperation]:
    """Decode the semiglobal column-RLE walk of one pair: per sweep column
    an ``[Ins x cnt][exit]`` group (the exit may be a Yclip-prefix of
    length j), then the fixed final column's group, emitted end -> start
    and rebuilt here start -> end."""
    ops: List[AlignmentOperation] = [Ins] * int(ins0)
    exits = exit_op[:nlen].tolist()
    cnts = ins_cnt[:nlen].tolist()
    for j in range(nlen):
        c = exits[j]
        if c:
            ops.append(Yclip(j + 1) if c == TB_YCLIP_PREFIX else _OP_BY_CODE[c])
        n = cnts[j]
        if n:
            ops.extend([Ins] * n)
    c = int(fix_exit)
    if c:
        if c in (TB_YCLIP_PREFIX, TB_YCLIP_SUFFIX):
            ops.append(Yclip(int(fix_ly)))
        else:
            ops.append(_OP_BY_CODE[c])
    ops.extend([Ins] * int(fix_ins))
    return ops


def _fix_slot_ops(fix_codes, fix_lens) -> List[AlignmentOperation]:
    """The fixed final column's ops, start -> end (its four slots hold them
    end -> start)."""
    ops: List[AlignmentOperation] = []
    for t in range(3, -1, -1):
        c = int(fix_codes[t])
        if not c:
            continue
        if c == TB_INS:
            ops.extend([Ins] * int(fix_lens[t]))
        elif c in (TB_XCLIP_PREFIX, TB_XCLIP_SUFFIX):
            ops.append(Xclip(int(fix_lens[t])))
        elif c in (TB_YCLIP_PREFIX, TB_YCLIP_SUFFIX):
            ops.append(Yclip(int(fix_lens[t])))
        else:
            ops.append(_OP_BY_CODE[c])
    return ops


def _decode_ops_colrle_local(
    ins_cnt, exit_op, fix_codes, fix_lens, nlen: int,
    xstart: int = 0, ystart: int = 0, keep_clips: bool = False,
) -> List[AlignmentOperation]:
    """Decode the K8 walk of one pair: per column 0..nlen ascending its exit
    op and Ins run, then the fixed column's slots. Local paths carry no
    interior clips; with ``keep_clips`` (``custom`` at clips 0, which takes
    the local path) the prefix clips that ended the path are re-emitted from
    (xstart, ystart) as ``[Yclip(ystart), Xclip(xstart)]`` unless the slots
    already hold them: with zero clips and strictly negative gaps a path
    starting at xstart > 0 enters through an Xclip-prefix, and a row-0 cell
    at ystart > 0 is a Yclip-prefix."""
    ops: List[AlignmentOperation] = []
    exits = exit_op[: nlen + 1].tolist()
    cnts = ins_cnt[: nlen + 1].tolist()
    for j in range(nlen + 1):
        e = exits[j]
        if e:
            ops.append(_OP_BY_CODE[e])
        n = cnts[j]
        if n:
            ops.extend([Ins] * n)
    codes = [int(c) for c in fix_codes]
    ops += _fix_slot_ops(fix_codes, fix_lens)
    if keep_clips:
        pre: List[AlignmentOperation] = []
        if ystart and TB_YCLIP_PREFIX not in codes:
            pre.append(Yclip(ystart))
        if xstart and TB_XCLIP_PREFIX not in codes:
            pre.append(Xclip(xstart))
        ops = pre + ops
    return ops


def _decode_ops_colrle_custom(
    pre, ins_cnt, exit_op, elen, post, fix_codes, fix_lens, nlen: int,
) -> List[AlignmentOperation]:
    """Decode the K10 walk of one pair: per column 0..nlen ascending
    ``[post][exit][Ins x cnt][Xclip-suffix pre]``, then the fixed column's
    slots."""
    ops: List[AlignmentOperation] = []
    posts = post[: nlen + 1].tolist()
    exits = exit_op[: nlen + 1].tolist()
    elens = elen[: nlen + 1].tolist()
    cnts = ins_cnt[: nlen + 1].tolist()
    pres = pre[: nlen + 1].tolist()
    for j in range(nlen + 1):
        p = posts[j]
        if p:
            ops.append(Yclip(j) if p == TB_YCLIP_PREFIX else _OP_BY_CODE[p])
        e = exits[j]
        if e:
            if e == TB_XCLIP_PREFIX:
                ops.append(Xclip(elens[j]))
            elif e == TB_YCLIP_PREFIX:
                ops.append(Yclip(elens[j]))
            else:
                ops.append(_OP_BY_CODE[e])
        n = cnts[j]
        if n:
            ops.extend([Ins] * n)
        if pres[j]:
            ops.append(Xclip(pres[j]))
    return ops + _fix_slot_ops(fix_codes, fix_lens)


def _interleave_semi(ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens):
    """Every lane's op stream as (B, 2N + 3) code and length arrays, in op
    order: ``Ins*ins0``, per column its exit and Ins run, then the fixed
    column's exit and Ins run (columns past a lane's length are empty)."""
    B = len(nlens)
    N = int(nlens.max()) if B else 0
    valid = np.arange(N)[None, :] < np.asarray(nlens)[:, None]  # (B, N)
    W = 2 * N + 3
    C = np.zeros((B, W), np.int32)
    Lm = np.zeros((B, W), np.int32)
    C[:, 0] = TB_INS
    Lm[:, 0] = ins0
    C[:, 1 : 1 + 2 * N : 2] = exit_op[:N].T.astype(np.int32) * valid
    Lm[:, 1 : 1 + 2 * N : 2] = 1
    C[:, 2 : 2 + 2 * N : 2] = TB_INS
    Lm[:, 2 : 2 + 2 * N : 2] = ins_cnt[:N].T.astype(np.int32) * valid
    C[:, 1 + 2 * N] = fix_exit
    Lm[:, 1 + 2 * N] = 1
    C[:, 2 + 2 * N] = TB_INS
    Lm[:, 2 + 2 * N] = fix_ins
    return C, Lm, N


def _decode_semi_batch(
    ins_cnt, exit_op, ins0, fix_ins, fix_exit, fix_ly, nlens,
    drop_clips: bool = False,
) -> List[List[AlignmentOperation]]:
    """Whole-batch ``_decode_ops_colrle_semi``: one object-LUT
    ``np.repeat`` over the interleaved op stream of every lane."""
    B = len(nlens)
    C, Lm, N = _interleave_semi(ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens)
    is_clip = C >= TB_XCLIP_PREFIX
    reps = np.where(C == 0, 0, np.where(is_clip, 0 if drop_clips else 1, np.maximum(Lm, 0)))
    ops_flat = np.repeat(_OP_ARR[np.where(is_clip, 0, C).ravel()], reps.ravel())
    offs = np.concatenate([[0], np.cumsum(reps.sum(axis=1))])
    within = np.cumsum(reps, axis=1) - reps
    for r, col in zip(*np.nonzero(is_clip & (reps > 0))):
        c = int(C[r, col])
        # the fixed column's clip has length fix_ly; a sweep column j's
        # Yclip-prefix exit has length j + 1
        ln = int(fix_ly[r]) if col == 1 + 2 * N else (col - 1) // 2 + 1
        ops_flat[offs[r] + within[r, col]] = (
            Xclip(ln) if c in (TB_XCLIP_PREFIX, TB_XCLIP_SUFFIX) else Yclip(ln)
        )
    return [ops_flat[offs[k] : offs[k + 1]].tolist() for k in range(B)]


def _format_cigar_strings(run_row, run_kind, run_len, B, xs_a, xe_a, m_a):
    """CIGAR strings of a flat merged-run list (row-major per lane), built
    with fixed-width digit buffers and one boolean compaction; soft clips
    for x outside [xstart, xend)."""
    if len(run_len) and run_len.max() >= 10_000_000:
        raise ValueError("CIGAR run exceeds 7 digits")
    R = len(run_len)
    opch = np.array([0, ord("I"), ord("D"), ord("X"), ord("=")], np.uint8)[run_kind]
    ndig = 1 + sum((run_len >= 10**k) for k in range(1, 7)).astype(np.int64)
    buf = np.empty((R, 8), np.uint8)
    for d in range(7):
        buf[:, d] = 48 + run_len // 10 ** (6 - d) % 10
    buf[:, 7] = opch
    keep = np.arange(8)[None, :] >= (7 - ndig)[:, None]
    flat = buf[keep].tobytes()  # row-major: run order preserved
    row_nbytes = np.bincount(run_row, weights=ndig + 1, minlength=B).astype(np.int64)
    offs = np.zeros(B + 1, np.int64)
    np.cumsum(row_nbytes, out=offs[1:])
    out = []
    for b in range(B):
        s = flat[offs[b] : offs[b + 1]].decode()
        xs_, xe, m = int(xs_a[b]), int(xe_a[b]), int(m_a[b])
        if xs_ > 0:
            s = f"{xs_}S" + s
        if m > xe:
            s = s + f"{m - xe}S"
        out.append(s)
    return out


class PackedSemiglobal:
    """Column-RLE batch result of the semiglobal (or global) path pulled to
    the host: scores and coordinates as arrays, whole-batch CIGARs, and
    per-read ``Alignment`` decode on demand. ``wide`` records whether it
    was pulled from the ``_pack_rle_wide`` layout; the unpacked arrays are
    the same for both."""

    def __init__(
        self, score, up, mlens, nlens,
        mode: AlignmentMode = AlignmentMode.Semiglobal, wide: bool = False,
    ) -> None:
        self.score = score
        self._up = up
        self.mlens = np.asarray(mlens)
        self.nlens = np.asarray(nlens)
        self.mode = mode
        self.wide = wide
        self.xstart = up["xstart"]
        self.ystart = up["ystart"]
        self.xend = up["xend"]
        self.yend = up["yend"]

    def cigars(self) -> List[str]:
        """All CIGAR strings, from the native column-RLE emitter
        (``native.cigars_colrle``, threaded over lanes); a row whose string
        overflows the emitter's buffer is formatted by the numpy merge
        (``cigars_plain``), as the JAX class formats it."""
        up = self._up
        B = len(self.mlens)
        N = int(self.nlens.max()) if B else 0
        if not (B and N):
            return self.cigars_plain()
        from rust_bio_tpu_torch import native

        got = native.cigars_colrle(
            up["exit_op"][:N].T, up["ins_cnt"][:N].T, self.nlens, self.mlens, up["ins0"],
            up["fix_exit"], up["fix_ins"], self.xstart, self.xend,
        )
        missing = [k for k, c in enumerate(got) if c is None]
        if missing:
            plain = self.cigars_plain()
            for k in missing:
                got[k] = plain[k]
        return got

    def cigars_plain(self) -> List[str]:
        """All CIGAR strings by one flat numpy run-length merge over the
        interleaved op streams (clips dropped; runs merge across them): the
        native emitter's oracle."""
        up = self._up
        B = len(self.mlens)
        C, Lm, _ = _interleave_semi(
            up["ins_cnt"], up["exit_op"], up["ins0"], up["fix_ins"], up["fix_exit"], self.nlens
        )
        keep = (C >= TB_INS) & (C <= TB_MATCH) & (Lm > 0)
        rr, cc = np.nonzero(keep)
        if len(rr) == 0:
            return [""] * B
        k = C[rr, cc]
        ln = Lm[rr, cc]
        # merge consecutive same-kind entries within each row
        new = np.empty(len(rr), bool)
        new[0] = True
        new[1:] = (rr[1:] != rr[:-1]) | (k[1:] != k[:-1])
        run_len = np.bincount(np.cumsum(new) - 1, weights=ln).astype(np.int64)
        starts = np.nonzero(new)[0]
        return _format_cigar_strings(
            rr[starts], k[starts], run_len, B,
            np.asarray(self.xstart), np.asarray(self.xend), self.mlens,
        )

    def alignment(self, k: int) -> Alignment:
        """The reference-exact ``Alignment`` of pair ``k``."""
        up = self._up
        if self.mode is AlignmentMode.Global:
            ops = _decode_ops_colrle(
                up["ins_cnt"][:, k], up["exit_op"][:, k], up["ins0"][k], int(self.nlens[k]),
            )
        else:
            ops = _decode_ops_colrle_semi(
                up["ins_cnt"][:, k], up["exit_op"][:, k], up["ins0"][k],
                up["fix_ins"][k], up["fix_exit"][k], up["fix_ly"][k], int(self.nlens[k]),
            )
        aln = Alignment(
            score=int(self.score[k]),
            xstart=int(self.xstart[k]), ystart=int(self.ystart[k]),
            xend=int(self.xend[k]), yend=int(self.yend[k]),
            xlen=int(self.mlens[k]), ylen=int(self.nlens[k]),
            operations=ops, mode=self.mode,
        )
        if self.mode is not AlignmentMode.Global:
            aln.filter_clip_operations()
        return aln


class PackedMergedCigars:
    """Compact batch result (batched.py ``PackedMergedCigars``): the walk's
    column-RLE stream merged on the card (K-merge) and pulled as (5 + R, B)
    uint16. Holds the scores and each lane's merged runs; ``cigars()`` only
    formats. ``overflow`` lanes (more than R runs, or a run past 4095)
    carry no runs: the compact finishes re-run them through the dense
    packed path and keep their CIGARs here."""

    def __init__(self, score, up, mlens, nlens) -> None:
        self.score = score
        self._up = up
        self.mlens = np.asarray(mlens)
        self.nlens = np.asarray(nlens)
        self.xstart = up["xstart"]
        self.xend = up["xend"]
        self.overflow = up["ovf"]
        self._ovf_idx = None  # set by the compact finish on overflow
        self._ovf_cigars = None

    def cigars(self) -> List[str]:
        up = self._up
        B = len(self.mlens)
        nr = up["n_runs"]  # (B,)
        R = up["run_len"].shape[0]
        mask = (np.arange(R)[None, :] < nr[:, None]) & ~up["ovf"][:, None]
        kinds = up["run_kind"].T[mask]
        lens_ = up["run_len"].T[mask]
        rows = np.nonzero(mask)[0]
        out = _format_cigar_strings(
            rows, kinds, lens_.astype(np.int64), B, up["xstart"], up["xend"], self.mlens,
        )
        if self._ovf_idx is not None:
            for i, c in zip(self._ovf_idx, self._ovf_cigars):
                out[i] = c
        return out


class BatchAligner:
    """Batched aligner: pads pairs to shared (M, N) and runs the DP on the
    device. ``device=None`` means CUDA (``RuntimeError`` without a card);
    ``device="cpu"`` runs the kernels' plain PyTorch versions."""

    def __init__(self, scoring: Scoring, device=None) -> None:
        assert scoring.gap_open <= scoring.gap_extend, (
            "batched path requires gap_open <= gap_extend; "
            "use the scalar Aligner otherwise"
        )
        self.scoring = scoring
        self.device = resolve_device(device)
        # the kernels' substitution arguments: (match, mismatch) for
        # MatchParams, else the (256, 256) int32 LUT (tabulating a callable
        # takes 65,536 Python calls: once, here)
        mp = scoring.match_fn
        if isinstance(mp, MatchParams):
            self._lut = None
            self._subst = (mp.match_score, mp.mismatch_score)
        else:
            self._lut = torch.from_numpy(scoring.dense_lut()).to(self.device)
            self._subst = (self._lut,)

    def _pad(self, xs, ys):
        xs = [to_bytes(x) for x in xs]
        ys = [to_bytes(y) for y in ys]
        B = len(xs)
        assert len(ys) == B
        M = max((len(x) for x in xs), default=1) or 1
        N = max((len(y) for y in ys), default=1) or 1
        xb = np.zeros((B, M), dtype=np.uint8)
        yb = np.zeros((B, N), dtype=np.uint8)
        for k, (x, y) in enumerate(zip(xs, ys)):
            xb[k, : len(x)] = np.frombuffer(x, dtype=np.uint8)
            yb[k, : len(y)] = np.frombuffer(y, dtype=np.uint8)
        mlens = np.array([len(x) for x in xs], dtype=np.int32)
        nlens = np.array([len(y) for y in ys], dtype=np.int32)
        return xb, yb, mlens, nlens

    def _kernel(self, name: str):
        """The ``ops.sw`` kernel ``name`` for this scoring's substitution
        source: ``name`` itself for MatchParams, else its ``_lut`` twin.
        Call it with ``(..., gap_open, gap_extend, *self._subst, ...)``."""
        from rust_bio_tpu_torch.ops import sw  # imports this package's tb/scoring

        return getattr(sw, name if self._lut is None else f"{name}_lut")

    def _tensors(self, xb, yb, mlens, nlens):
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (xb, yb, np.asarray(mlens, np.int32), np.asarray(nlens, np.int32))
        )

    def global_packed_arrays(self, xb, yb, mlens, nlens, merged_runs: int = 0) -> torch.Tensor:
        """The device part of ``global_`` on padded arrays, returning the
        packed uint16 tensor on the device: K1 (K11 under a LUT), K2 and
        ``_pack_rle``; at M + 1 >= ``T_ROWS`` K13 (K13-LUT) and K14 in
        their place, and from M + 1 >= 4096 on ``_pack_rle_wide``. With
        ``merged_runs`` R > 0 (K1 and MatchParams only): K1, K2 and K-merge,
        the (5 + R, B) compact pack."""
        from rust_bio_tpu_torch.ops import walk

        M, N = xb.shape[1], yb.shape[1]
        _check_limits("global", M, N)
        s = self.scoring
        if merged_runs:
            self._check_compact("global", M + 1 < T_ROWS, f"padded M + 1 < T_ROWS = {T_ROWS}")
        xt, yt, ml, nl = self._tensors(xb, yb, mlens, nlens)
        if M + 1 >= T_ROWS:
            score, tb = self._kernel("scan_global_rows")(xt, yt, ml, nl, s.gap_open, s.gap_extend, *self._subst)
            ins_cnt, exit_op, ins0 = walk.sweep_walk_global_seg(tb, ml, nl)
        else:
            score, tb, _tbk = self._kernel("scan_global")(xt, yt, ml, nl, s.gap_open, s.gap_extend, *self._subst)
            ins_cnt, exit_op, ins0 = walk.sweep_walk_global(tb, ml, nl)
        del tb
        if merged_runs:
            return walk.merge_rle(score, ins_cnt, exit_op, ins0, None, None, nl, None, ml, merged_runs)
        z = torch.zeros_like(ml)
        pack = _pack_rle_wide if _wide(M) else _pack_rle
        return pack(score, ins_cnt, exit_op, ins0, z, z, z, z, z, ml, nl)

    def _semiglobal_device(self, xb, yb, mlens, nlens, with_traceback: bool = True, merged_runs: int = 0):
        """The semiglobal path on padded arrays (batched.py
        ``_align_batch_device_semiglobal_mp``, sweep-walk branch): K5 (K12
        under a LUT; score only, its tb stores skipped, without traceback)
        with y-clips 0, the suffix fixups, then, with traceback, K6 and the
        pack. Returns the (10 + N, B) uint16 packed tensor, or the (B,)
        int32 scores without traceback; both stay on the device. With
        ``merged_runs`` R > 0, K-merge's (5 + R, B) compact pack in place
        of the pack."""
        go, ge = self.scoring.gap_open, self.scoring.gap_extend
        from rust_bio_tpu_torch.ops.walk import merge_rle, sweep_walk_semiglobal

        xt, yt, ml, nl = self._tensors(xb, yb, mlens, nlens)
        tb, S_f, I_f, Sn_f, Ly_f, tbk = self._kernel("scan_semiglobal")(
            xt, yt, ml, nl, go, ge, *self._subst, 0, 0, traceback=with_traceback
        )
        score, tbfix = _fixed_column(S_f, I_f, Sn_f, Ly_f, tbk, ml, go, ge)
        if not with_traceback:
            return score
        ins_cnt, exit_op, ins0, fix_ins, fix_exit, fix_ly, ystart, yend = sweep_walk_semiglobal(
            tb, tbfix, ml, nl
        )
        if merged_runs:
            return merge_rle(score, ins_cnt, exit_op, ins0, fix_ins, fix_exit, nl, None, ml, merged_runs)
        return _pack_rle(
            score, ins_cnt, exit_op, ins0, fix_ins, fix_exit, fix_ly,
            torch.zeros_like(ml), ystart, ml, yend,
        )

    def global_(self, xs, ys) -> List[Alignment]:
        xb, yb, mlens, nlens = self._pad(xs, ys)
        packed = self.global_packed_arrays(xb, yb, mlens, nlens)
        score, up = _unpack(packed.cpu().numpy(), _wide(xb.shape[1]))
        results = []
        for k in range(len(mlens)):
            ops = _decode_ops_colrle(
                up["ins_cnt"][:, k], up["exit_op"][:, k], up["ins0"][k],
                int(nlens[k]),
            )
            results.append(
                Alignment(
                    score=int(score[k]),
                    xstart=int(up["xstart"][k]),
                    ystart=int(up["ystart"][k]),
                    xend=int(up["xend"][k]),
                    yend=int(up["yend"][k]),
                    xlen=int(mlens[k]),
                    ylen=int(nlens[k]),
                    operations=ops,
                    mode=AlignmentMode.Global,
                )
            )
        return results

    def semiglobal(self, xs, ys) -> List[Alignment]:
        """Semiglobal alignments: x aligned whole, y's ends free; clip ops
        are dropped from the op lists (batched.py ``_run``)."""
        xb, yb, mlens, nlens = self._pad(xs, ys)
        if _long(xb.shape[1]):
            return self._columns_alignments(xb, yb, mlens, nlens, AlignmentMode.Semiglobal, True)
        score, up = _unpack_rle(self._semiglobal_device(xb, yb, mlens, nlens).cpu().numpy())
        ops = _decode_semi_batch(
            up["ins_cnt"], up["exit_op"], up["ins0"], up["fix_ins"], up["fix_exit"],
            up["fix_ly"], nlens, drop_clips=True,
        )
        return [
            Alignment(
                score=int(score[k]),
                xstart=int(up["xstart"][k]),
                ystart=int(up["ystart"][k]),
                xend=int(up["xend"][k]),
                yend=int(up["yend"][k]),
                xlen=int(mlens[k]),
                ylen=int(nlens[k]),
                operations=ops[k],
                mode=AlignmentMode.Semiglobal,
            )
            for k in range(len(mlens))
        ]

    def _clips(self, mode: str) -> Tuple[int, int, int, int]:
        """(xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix) of a
        clip mode: the x-clips off and the y-clips 0 for semiglobal, all 0
        for local, the scoring's for custom."""
        if mode == "semiglobal":
            return (MIN_SCORE, MIN_SCORE, 0, 0)
        if mode == "local":
            return (0, 0, 0, 0)
        s = self.scoring
        return (s.xclip_prefix, s.xclip_suffix, s.yclip_prefix, s.yclip_suffix)

    def _custom_device(self, xb, yb, mlens, nlens, clips, with_traceback: bool = True):
        """The local/custom path on padded arrays (batched.py
        ``_align_batch_device_custom_mp``, sweep-walk branch): K7 when all
        four clips are 0, else K9 (their LUT instantiations under a LUT,
        where the JAX package runs its XLA engine ``_align_batch_device``);
        the suffix fixups with the four clips;
        then, with traceback, K8 after K7 with gap_open + gap_extend < 0,
        else K10 (with go + ge == 0 a Del run past a free x-suffix clip can
        tie the clip, which only K10 resolves), and the pack. Returns
        ("local" or "custom", the packed uint16 tensor), or the (B,) int32
        scores without traceback; both stay on the device."""
        go, ge = self.scoring.gap_open, self.scoring.gap_extend
        B, M = xb.shape
        from rust_bio_tpu_torch.ops.walk import sweep_walk_custom, sweep_walk_local

        xt, yt, ml, nl = self._tensors(xb, yb, mlens, nlens)
        local = all(int(c) == 0 for c in clips)
        if local:
            scan = self._kernel("scan_local")(xt, yt, ml, nl, go, ge, *self._subst, traceback=with_traceback)
        else:
            scan = self._kernel("scan_custom")(xt, yt, ml, nl, go, ge, *self._subst, *clips, traceback=with_traceback)
        tb, lx, S_f, I_f, Sn_f, Ly_f, tbk = scan
        rows, row_ge1, mlens_c, is_row_m = _geometry(B, M, ml)
        score, tb_col_fixed, Lx_n, lx_n_set = _suffix_fixups(
            S_f, I_f, Sn_f, tbk, B, M, rows, row_ge1, ml, mlens_c, is_row_m,
            (go, ge, *(int(c) for c in clips)),
        )
        if not with_traceback:
            return score
        tbfix = (tb_col_fixed.to(torch.int32) & 0xFFF) | (Ly_f << 12)
        # the fixups' clip length where they set one, else the scan's at nlens
        lx_n = torch.where(lx_n_set, Lx_n, lx.gather(0, nl.long()[None, :])[0])
        if local and go + ge < 0:
            ins_cnt, exit_op, fix_codes, fix_lens, *coords = sweep_walk_local(tb, tbfix, lx, lx_n, ml, nl)
            return "local", _pack_rle_local(score, ins_cnt, exit_op, fix_codes, fix_lens, *coords)
        return "custom", _pack_rle_custom(score, *sweep_walk_custom(tb, tbfix, lx, lx_n, ml, nl))

    def _columns_device(self, xb, yb, mlens, nlens, clips, with_traceback: bool = True):
        """The clip-mode path of long x on padded arrays (batched.py
        ``_align_batch_device`` and ``_postlude``): K15 (K15-LUT under a LUT)
        with the four clips, the suffix fixups, then, with traceback, the
        fixed column and its x-suffix clip length written into K15's tb and
        lx at column nlens[b], K15-walk and ``_pack_steps``. Returns the
        packed uint16 tensor, or the (B,) int32 scores without traceback;
        both stay on the device."""
        B, M = xb.shape
        _check_limits("clip-mode", M, yb.shape[1])
        go, ge = self.scoring.gap_open, self.scoring.gap_extend
        from rust_bio_tpu_torch.ops.walk import walk_steps

        xt, yt, ml, nl = self._tensors(xb, yb, mlens, nlens)
        scan = self._kernel("scan_columns")(xt, yt, ml, nl, go, ge, *self._subst, *clips, traceback=with_traceback)
        score = _columns_fixups(scan, ml, nl, (go, ge, *clips))
        if not with_traceback:
            return score
        tb, lx, Ly_f = scan[0], scan[1], scan[5]
        return _pack_steps(score, *walk_steps(tb, lx, Ly_f, ml, nl))

    def _columns_alignments(self, xb, yb, mlens, nlens, mode: AlignmentMode, filter_clips: bool) -> List[Alignment]:
        """The long route's ``Alignment`` list (batched.py ``_run``): one
        pull, then ``_decode_ops`` per pair."""
        packed = self._columns_device(xb, yb, mlens, nlens, self._clips(mode.value))
        score, up = _unpack_steps(packed.cpu().numpy())
        results = []
        for k in range(len(mlens)):
            aln = Alignment(
                score=int(score[k]),
                xstart=int(up["xstart"][k]),
                ystart=int(up["ystart"][k]),
                xend=int(up["xend"][k]),
                yend=int(up["yend"][k]),
                xlen=int(mlens[k]),
                ylen=int(nlens[k]),
                operations=_decode_ops(up["op_codes"][:, k], up["op_lens"][:, k]),
                mode=mode,
            )
            if filter_clips:
                aln.filter_clip_operations()
            results.append(aln)
        return results

    def _run_clips(self, xs, ys, mode: AlignmentMode, filter_clips: bool) -> List[Alignment]:
        """Local and custom alignments (batched.py ``_run`` for the two
        clip-mode packs): one pull, then a per-pair decode."""
        xb, yb, mlens, nlens = self._pad(xs, ys)
        if _long(xb.shape[1]):
            return self._columns_alignments(xb, yb, mlens, nlens, mode, filter_clips)
        kind, packed = self._custom_device(xb, yb, mlens, nlens, self._clips(mode.value))
        packed = packed.cpu().numpy()
        score, up = (_unpack_rle_local if kind == "local" else _unpack_rle_custom)(packed)
        results = []
        for k in range(len(mlens)):
            if kind == "local":
                ops = _decode_ops_colrle_local(
                    up["ins_cnt"][:, k], up["exit_op"][:, k], up["fix_codes"][:, k],
                    up["fix_lens"][:, k], int(nlens[k]),
                    xstart=int(up["xstart"][k]), ystart=int(up["ystart"][k]),
                    keep_clips=not filter_clips,
                )
            else:
                ops = _decode_ops_colrle_custom(
                    up["pre"][:, k], up["ins_cnt"][:, k], up["exit_op"][:, k], up["elen"][:, k],
                    up["post"][:, k], up["fix_codes"][:, k], up["fix_lens"][:, k], int(nlens[k]),
                )
            aln = Alignment(
                score=int(score[k]),
                xstart=int(up["xstart"][k]),
                ystart=int(up["ystart"][k]),
                xend=int(up["xend"][k]),
                yend=int(up["yend"][k]),
                xlen=int(mlens[k]),
                ylen=int(nlens[k]),
                operations=ops,
                mode=mode,
            )
            if filter_clips:
                aln.filter_clip_operations()
            results.append(aln)
        return results

    def local(self, xs, ys) -> List[Alignment]:
        """Local (Smith-Waterman) alignments: clips (0, 0, 0, 0), clip ops
        dropped from the op lists."""
        return self._run_clips(xs, ys, AlignmentMode.Local, filter_clips=True)

    def custom(self, xs, ys) -> List[Alignment]:
        """Alignments under the scoring's four clip penalties, clip ops
        kept."""
        return self._run_clips(xs, ys, AlignmentMode.Custom, filter_clips=False)

    def scores(self, xs, ys, mode: str = "global") -> np.ndarray:
        """Score-only path, no traceback: (B,) int32. Global runs K3 (K18
        under a LUT); semiglobal runs K5 (K12) and the suffix fixups; local
        and custom run K7 or K9 (fed by the LUT) and the suffix fixups; the
        three clip modes at M + 1 >= ``T_COLUMNS`` run K15 (K15-LUT) and the
        fixups."""
        if mode not in ("global", "semiglobal", "local", "custom"):
            raise ValueError(f"unknown mode {mode!r}")
        xb, yb, mlens, nlens = self._pad(xs, ys)
        if mode != "global" and _long(xb.shape[1]):
            clips = self._clips(mode)
            return self._columns_device(xb, yb, mlens, nlens, clips, with_traceback=False).cpu().numpy()
        if mode == "semiglobal":
            return self._semiglobal_device(xb, yb, mlens, nlens, with_traceback=False).cpu().numpy()
        if mode in ("local", "custom"):
            return self._custom_device(xb, yb, mlens, nlens, self._clips(mode), with_traceback=False).cpu().numpy()
        s = self.scoring
        scores_global = self._kernel("scores_global")
        return scores_global(*self._tensors(xb, yb, mlens, nlens), s.gap_open, s.gap_extend, *self._subst).cpu().numpy()

    # --- packed results: one device-to-host pull, host decode on demand ---

    def semiglobal_packed_async(self, xs, ys):
        """Start the packed semiglobal batch on the device without waiting
        for it; pass the handle to ``semiglobal_packed_finish``."""
        return self.semiglobal_packed_async_arrays(*self._pad(xs, ys))

    def semiglobal_packed_async_arrays(self, xb, yb, mlens, nlens):
        """``semiglobal_packed_async`` on padded (B, M) / (B, N) uint8
        batches and their (B,) lengths."""
        if _wide(xb.shape[1]):
            raise ValueError(
                f"semiglobal_packed at M + 1 = {xb.shape[1] + 1} >= {_MAX_ROWS}: the packed "
                "layout holds each column's Ins count in 12 bits; semiglobal() serves this length"
            )
        mlens = np.asarray(mlens, np.int32)
        nlens = np.asarray(nlens, np.int32)
        return self._semiglobal_device(xb, yb, mlens, nlens), mlens, nlens

    @staticmethod
    def semiglobal_packed_finish(handle) -> "PackedSemiglobal":
        """Pull a ``semiglobal_packed_async`` handle (one device-to-host
        transfer) into a ``PackedSemiglobal``."""
        packed, mlens, nlens = handle
        score, up = _unpack_rle(packed.cpu().numpy())
        return PackedSemiglobal(score, up, mlens, nlens)

    def semiglobal_packed(self, xs, ys) -> "PackedSemiglobal":
        """Semiglobal batch without op-list objects: a ``PackedSemiglobal``
        with vectorized CIGARs and per-read ``Alignment`` decode."""
        return self.semiglobal_packed_finish(self.semiglobal_packed_async(xs, ys))

    def global_packed_async_arrays(self, xb, yb, mlens, nlens):
        """``semiglobal_packed_async_arrays`` for global mode (the path of
        ``global_packed_arrays``): the fix/clip fields of the packed layout
        are 0, and the handle's last entry says whether it is the wide
        layout."""
        mlens = np.asarray(mlens, np.int32)
        nlens = np.asarray(nlens, np.int32)
        return self.global_packed_arrays(xb, yb, mlens, nlens), mlens, nlens, _wide(xb.shape[1])

    @staticmethod
    def global_packed_finish(handle) -> "PackedSemiglobal":
        """Pull a ``global_packed_async_arrays`` handle into a
        ``PackedSemiglobal`` in global mode."""
        packed, mlens, nlens, wide = handle
        score, up = _unpack(packed.cpu().numpy(), wide)
        return PackedSemiglobal(score, up, mlens, nlens, mode=AlignmentMode.Global, wide=wide)

    def global_packed(self, xs, ys) -> "PackedSemiglobal":
        """Global batch without op-list objects (see ``semiglobal_packed``)."""
        return self.global_packed_finish(self.global_packed_async_arrays(*self._pad(xs, ys)))

    # --- compact delivered CIGARs: the run merge on the card (K-merge) ---

    _COMPACT_RUNS = 32  # a 150 bp read at mapper identity merges to far fewer

    def _check_compact(self, mode: str, route_ok: bool, route: str) -> None:
        """Raise ``ValueError`` outside the compact route: MatchParams
        scoring on K1 (global) or K5 (semiglobal) at this padded M."""
        if self._lut is not None:
            raise ValueError(f"compact {mode} CIGARs need MatchParams scoring (the column-RLE engines)")
        if not route_ok:
            raise ValueError(f"compact {mode} CIGARs run on the column-RLE engine only: {route}")

    def global_packed_compact_async_arrays(self, xb, yb, mlens, nlens, max_runs: int = 0):
        """Start the global batch with the run merge on the card (K1, K2,
        K-merge): the pull is (5 + R, B) uint16, R = ``max_runs`` or
        ``_COMPACT_RUNS``. Pass the handle to ``packed_compact_finish``
        (or ``packed_compact_finish_many``); lanes past R runs are re-run
        there through the dense packed path."""
        R = max_runs or self._COMPACT_RUNS
        mlens = np.asarray(mlens, np.int32)
        nlens = np.asarray(nlens, np.int32)
        packed = self.global_packed_arrays(xb, yb, mlens, nlens, merged_runs=R)
        return packed, mlens, nlens, (self, xb, yb, "global")

    def semiglobal_packed_compact_async_arrays(self, xb, yb, mlens, nlens, max_runs: int = 0):
        """``global_packed_compact_async_arrays`` for semiglobal mode (K5,
        K6, K-merge)."""
        R = max_runs or self._COMPACT_RUNS
        M = xb.shape[1]
        self._check_compact("semiglobal", not _wide(M), f"M + 1 < {_MAX_ROWS}")
        mlens = np.asarray(mlens, np.int32)
        nlens = np.asarray(nlens, np.int32)
        packed = self._semiglobal_device(xb, yb, mlens, nlens, merged_runs=R)
        return packed, mlens, nlens, (self, xb, yb, "semiglobal")

    @staticmethod
    def packed_compact_finish_many(handles) -> List["PackedMergedCigars"]:
        """Finish several compact handles with one device-to-host pull of
        the stacked (H, 5 + R, B) packs; overflow lanes re-run per handle as
        in ``packed_compact_finish``. Handles of different shapes raise
        ``ValueError``."""
        if not handles:
            return []
        shapes = {tuple(h[0].shape) for h in handles}
        if len(shapes) != 1:
            raise ValueError(f"packed_compact_finish_many: handles of different shapes {sorted(shapes)}; finish them apart")
        stacked = torch.stack([h[0] for h in handles]).cpu().numpy()
        return [
            BatchAligner._finish_compact_host(stacked[k], mlens, nlens, ctx)
            for k, (_, mlens, nlens, ctx) in enumerate(handles)
        ]

    @staticmethod
    def packed_compact_finish(handle) -> "PackedMergedCigars":
        """Pull a compact handle (one device-to-host transfer) into a
        ``PackedMergedCigars``; lanes that overflowed R runs (or a 12-bit
        run) re-run through the dense packed path, so ``cigars()`` is
        complete and exact."""
        packed, mlens, nlens, ctx = handle
        return BatchAligner._finish_compact_host(packed.cpu().numpy(), mlens, nlens, ctx)

    @staticmethod
    def _finish_compact_host(packed_np, mlens, nlens, ctx) -> "PackedMergedCigars":
        """The host half of the compact finishes: unpack, and the dense
        re-run of the overflow lanes, padded to a multiple of 8 lanes."""
        ba, xb, yb, mode = ctx
        score, up = _unpack_rle_merged(packed_np)
        res = PackedMergedCigars(score, up, mlens, nlens)
        if up["ovf"].any():
            idx = np.nonzero(up["ovf"])[0]
            sel = np.resize(idx, -(-len(idx) // 8) * 8)
            args = (np.asarray(xb)[sel], np.asarray(yb)[sel], np.asarray(mlens)[sel], np.asarray(nlens)[sel])
            if mode == "global":
                dense = BatchAligner.global_packed_finish(ba.global_packed_async_arrays(*args))
            else:
                dense = BatchAligner.semiglobal_packed_finish(ba.semiglobal_packed_async_arrays(*args))
            res._ovf_idx = idx
            res._ovf_cigars = dense.cigars()[: len(idx)]
        return res
