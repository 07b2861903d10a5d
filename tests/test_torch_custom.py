"""The port's local and custom paths against the JAX package on the CPU.

Stage by stage on one batch per case: kernel K9 (custom scan) against
``scan_custom_pallas_mp`` and K7 (local scan) against ``scan_local_pallas_mp``
and against K9 at clips 0, the suffix fixups with live x-suffix clips,
``resolve_fixed_column_custom``, K10 and K8 (the walks) on the JAX scan's
traceback tensor against JAX's ``sweep_walk_custom`` and ``sweep_walk_local``
(read from the packs of its jitted engine on the same inputs), and the
packed tensors. The Pallas kernels run in interpret mode. End to end:
``BatchAligner.local``, ``.custom`` and ``scores(..., "local" | "custom")``
against the JAX ``BatchAligner``, every ``Alignment`` field. Integers
throughout: every comparison is exact (tolerance 0). Most of the file's
time is JAX compiling its interpret-mode engines, once per engine: the
stage batches share the entry-point corpus's shape for that."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.alignment.pairwise import Aligner as JaxScalarAligner
from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.batched import _geometry as jax_geometry
from rust_bio_tpu.alignment.pairwise.batched import _align_batch_device_custom_mp
from rust_bio_tpu.alignment.pairwise.batched import _unpack_rle_custom as jax_unpack_rle_custom
from rust_bio_tpu.alignment.pairwise.batched import _unpack_rle_local as jax_unpack_rle_local
from rust_bio_tpu.alignment.pairwise.batched import _suffix_fixups as jax_suffix_fixups
from rust_bio_tpu.alignment.pairwise.scoring import MatchParams as JaxMatchParams
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu.ops.sw_pallas import scan_custom_pallas_mp, scan_local_pallas_mp
from rust_bio_tpu.ops.walk_pallas import _resolve_fixed_column_custom
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
from rust_bio_tpu_torch.alignment.pairwise.batched import (
    _geometry,
    _pack_rle_custom,
    _pack_rle_local,
    _suffix_fixups,
    _unpack_rle_custom,
    _unpack_rle_local,
)
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE, MatchParams
from rust_bio_tpu_torch.alignment.pairwise.tb import TB_INS, TB_XCLIP_SUFFIX
from rust_bio_tpu_torch.alignment.types import Ins, Xclip
from rust_bio_tpu_torch.ops.sw import scan_custom, scan_local
from rust_bio_tpu_torch.ops.walk import (
    resolve_fixed_column_custom,
    sweep_walk_custom,
    sweep_walk_local,
)

MIN = MIN_SCORE
MA, MI = 2, -2
B, M, N = 16, 40, 46  # the shape of the entry-point tests' mixed corpus
# (go, ge, (xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix)): local,
# clips from {MIN_SCORE, 0, -1, -7} as the JAX package's own tests draw them,
# BWA-MEM's soft clips, and go = ge = 0
STAGE_CASES = [
    (-5, -1, (0, 0, 0, 0)),
    (-2, -2, (0, 0, 0, 0)),
    (-5, -1, (-7, -1, 0, -7)),
    (-4, -2, (MIN, 0, -1, MIN)),
    (-3, -1, (-1, MIN, 0, -7)),
    (-6, -1, (-5, -5, 0, 0)),
    (0, 0, (0, 0, 0, 0)),
]


def _case_id(case):
    go, ge, clips = case
    return f"go{go}ge{ge}-" + "_".join("min" if c == MIN else str(c) for c in clips)


def _batch(seed):
    """Random DNA pairs of ragged lengths, with empty and one-symbol lanes,
    and lanes whose x holds a stretch of y behind random ends (clipped
    paths)."""
    rng = np.random.default_rng(seed)
    xb = rng.choice(list(b"ACGT"), size=(B, M)).astype(np.uint8)
    yb = rng.choice(list(b"ACGT"), size=(B, N)).astype(np.uint8)
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:4] = [M, 0, M, 1]
    nlens[:4] = [N, N, 0, 1]
    for b in range(8, B):
        mlens[b], nlens[b] = M - (b % 3), N - (b % 4)
        xb[b, 4:16] = yb[b, 6:18]
    return xb, yb, mlens, nlens


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]  # a writable copy


def _is_local(clips):
    return all(c == 0 for c in clips)


_JAX_SCAN = {
    local: jax.jit(functools.partial(scan_local_pallas_mp if local else scan_custom_pallas_mp, runs="ins"))
    for local in (False, True)
}


@functools.lru_cache(maxsize=None)
def _jax_stages(case):
    """One case through the JAX package's stages, as numpy arrays: the scan
    (the local kernel at clips 0, except at go = ge = 0, where it departs
    from the custom kernel; see ``test_zero_gap_penalties_match_the_reference``),
    the fixups, the walk inputs, and the walk outputs as JAX's
    ``BatchAligner`` packs them (its jitted engine at the entry-point tests'
    shape, so each variant compiles once)."""
    go, ge, clips = case
    inputs = _batch(abs(go * 13 + ge) + sum(abs(c) % 97 for c in clips))
    xb, yb, ml, nl, pen8 = (jnp.asarray(a) for a in inputs + (np.array([go, ge, *clips, MA, MI], np.int32),))
    use_local = _is_local(clips) and (go, ge) != (0, 0)
    scan = _JAX_SCAN[use_local](xb, yb, ml, nl, pen8)
    tb, lx, S_f, I_f, Sn_f, Ly_f, tbk = scan
    rows, row_ge1, mlens_c, is_row_m = jax_geometry(B, M, ml)
    fix = jax_suffix_fixups(
        S_f, I_f, Sn_f, tbk.astype(jnp.uint16), B, M, rows, row_ge1, ml, mlens_c, is_row_m,
        tuple(jnp.int32(v) for v in (go, ge, *clips)),
    )
    score, tb_fixed, Lx_n, lx_set = fix
    tbfix = (tb_fixed.astype(jnp.int32) & 0xFFF) | (Ly_f << 12)
    lx_n = jnp.where(lx_set, Lx_n, jnp.take_along_axis(lx.T, nl[:, None], axis=1)[:, 0])
    local_walk = use_local and go + ge < 0
    packed = _align_batch_device_custom_mp(
        xb, yb, ml, nl, pen8, with_traceback=True, local_engine=use_local, local_walk=local_walk
    )
    out = {
        "inputs": inputs,
        "scan": [np.asarray(v) for v in scan],
        "fixups": [np.asarray(v) for v in fix],
        "tbfix": np.asarray(tbfix),
        "lx_n": np.asarray(lx_n),
        "resolve": [np.asarray(v) for v in _resolve_fixed_column_custom(tbfix, lx_n, ml, nl)],
    }
    kind = "local" if local_walk else "custom"
    out[kind + "_pack"] = np.asarray(packed["packed_" + kind])
    return out


def _port_scan(case):
    go, ge, clips = case
    xb, yb, mlens, nlens = _jax_stages(case)["inputs"]
    if _is_local(clips):
        return scan_local(*_torch(xb, yb, mlens, nlens), go, ge, MA, MI)
    return scan_custom(*_torch(xb, yb, mlens, nlens), go, ge, MA, MI, *clips)


def column0_i(go, ge, xcp, X):
    """Column 0's insertion scores I(i, 0), as the scalar oracle's init column
    holds them: MIN_SCORE at row 0, gap_open at row 1, below it the better of
    the gap and the x-prefix clip. (X,) int32."""
    rows = np.arange(X, dtype=np.int64)
    i0 = np.maximum(go + ge * (rows - 1), xcp + go)
    i0[: min(X, 2)] = [MIN, go][: min(X, 2)]
    return i0.astype(np.int32)


def _assert_scans_equal(got, want, mlens, nlens, what, i0=None):
    """tb columns 0..nlens and rows 0..mlens, lx columns 0..nlens, the finals
    rows 0..mlens: the region a kernel defines. With ``i0`` (column 0's I)
    the final I of a lane with nlens = 0 is held to it: the port follows the
    oracle there, where the Pallas kernels leave MIN_SCORE."""
    tb, lx, *finals = (t.to(torch.int32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in got)
    for b in range(B):
        m, n = mlens[b], nlens[b]
        np.testing.assert_array_equal(tb[: n + 1, : m + 1, b], want[0][: n + 1, : m + 1, b], err_msg=f"{what} tb lane {b}")
        np.testing.assert_array_equal(lx[: n + 1, b], want[1][: n + 1, b], err_msg=f"{what} lx lane {b}")
        for k, (g, w) in enumerate(zip(finals, want[2:])):
            w = i0 if k == 1 and n == 0 and i0 is not None else w[b]
            np.testing.assert_array_equal(g[b, : m + 1], w[: m + 1], err_msg=f"{what} final {k} lane {b}")


@pytest.mark.parametrize("case", STAGE_CASES, ids=_case_id)
def test_scan_matches_jax(case):
    """K9 (K7 at clips 0) against the Pallas custom (local) scan; the final I
    of the nlens = 0 lanes against column 0's I."""
    jx = _jax_stages(case)
    got = _port_scan(case)
    go, ge, clips = case
    _, _, mlens, nlens = jx["inputs"]
    assert got[0].shape == (N + 1, M + 1, B) and got[0].dtype == torch.uint16
    assert got[1].shape == (N + 1, B) and got[1].dtype == torch.int32
    assert (nlens == 0).any()
    _assert_scans_equal(got, jx["scan"], mlens, nlens, _case_id(case), i0=column0_i(go, ge, clips[0], M + 1))


@pytest.mark.parametrize("go,ge", [(-5, -1), (-2, -2), (-1, 0), (0, 0)])
def test_local_scan_equals_custom_scan_at_zero_clips(go, ge):
    """K7 gives K9's outputs byte for byte at clips 0 (with traceback and
    score-only), over the whole tensor."""
    xb, yb, mlens, nlens = _torch(*_batch(5 + abs(go) + 3 * abs(ge)))
    for traceback in (True, False):
        got = scan_local(xb, yb, mlens, nlens, go, ge, MA, MI, traceback=traceback)
        want = scan_custom(xb, yb, mlens, nlens, go, ge, MA, MI, 0, 0, 0, 0, traceback=traceback)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)


def test_scan_score_only_keeps_the_finals():
    case = STAGE_CASES[2]
    go, ge, clips = case
    xb, yb, mlens, nlens = _torch(*_jax_stages(case)["inputs"])
    full = scan_custom(xb, yb, mlens, nlens, go, ge, MA, MI, *clips)
    only = scan_custom(xb, yb, mlens, nlens, go, ge, MA, MI, *clips, traceback=False)
    assert only[0] is None and only[1] is None
    for g, w in zip(only[2:6], full[2:6]):
        assert torch.equal(g, w)
    assert torch.equal(only[6], full[6] & 0xFFF)  # tbk without the run nibble


def _port_fixups(case):
    go, ge, clips = case
    jx = _jax_stages(case)
    _tb, _lx, S_f, I_f, Sn_f, _Ly, tbk = _torch(*jx["scan"])
    mlens = torch.from_numpy(jx["inputs"][2])
    rows, row_ge1, mlens_c, is_row_m = _geometry(B, M, mlens)
    return _suffix_fixups(S_f, I_f, Sn_f, tbk, B, M, rows, row_ge1, mlens, mlens_c, is_row_m, (go, ge, *clips))


@pytest.mark.parametrize("case", STAGE_CASES, ids=_case_id)
def test_suffix_fixups_match_jax(case):
    """The fixups with all four clips live, on the JAX scan's finals."""
    got = _port_fixups(case)
    for g, w in zip(got, _jax_stages(case)["fixups"]):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), w.astype(np.int32))


def test_suffix_fixups_set_x_suffix_clips():
    """The cases hold lanes whose fixed column ends in an x-suffix clip."""
    n_set = sum(int(_port_fixups(c)[3].sum()) for c in STAGE_CASES if c[2][1] != MIN)
    assert n_set > 0


@pytest.mark.parametrize("case", STAGE_CASES, ids=_case_id)
def test_resolve_fixed_column_custom_matches_jax(case):
    jx = _jax_stages(case)
    _, _, mlens, nlens = jx["inputs"]
    got = resolve_fixed_column_custom(*_torch(jx["tbfix"], jx["lx_n"], mlens, nlens))
    assert len(got) == len(jx["resolve"]) == 11
    for k, (g, w) in enumerate(zip(got, jx["resolve"])):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int32), err_msg=str(k))


def _walk_inputs(case):
    """The walk's inputs on the JAX scan's traceback tensor."""
    jx = _jax_stages(case)
    tb, lx = jx["scan"][0][: N + 1], jx["scan"][1][: N + 1]
    _, _, mlens, nlens = jx["inputs"]
    return _torch(tb, jx["tbfix"], lx, jx["lx_n"], mlens, nlens)


def _assert_walk_equals_pack(got, up, names):
    """The walk's per-column outputs (first N+1 columns of JAX's padded
    ones), then fix_codes, fix_lens (B, 4) and the four coordinates."""
    per_col = [up[k][: N + 1] for k in names]
    small = [up["fix_codes"].T, up["fix_lens"].T] + [up[k] for k in ("xstart", "ystart", "xend", "yend")]
    for k, (g, w) in enumerate(zip(got, per_col + small)):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), w.astype(np.int32), err_msg=str(k))


CUSTOM_WALK_CASES = [c for c in STAGE_CASES if not _is_local(c[2]) or c[0] + c[1] == 0]
LOCAL_CASES = [c for c in STAGE_CASES if _is_local(c[2]) and c[0] + c[1] < 0]


@pytest.mark.parametrize("case", CUSTOM_WALK_CASES, ids=_case_id)
def test_sweep_walk_custom_matches_jax(case):
    """K10 (plain) on the JAX scan's traceback tensor, every output, against
    JAX's K10 on the same scan."""
    got = sweep_walk_custom(*_walk_inputs(case))
    assert all(t.shape == (N + 1, B) and t.dtype == torch.uint16 for t in got[:5])
    _, up = jax_unpack_rle_custom(_jax_stages(case)["custom_pack"])
    _assert_walk_equals_pack(got, up, ("pre", "ins_cnt", "exit_op", "elen", "post"))


@pytest.mark.parametrize("case", LOCAL_CASES, ids=_case_id)
def test_sweep_walk_local_matches_jax(case):
    """K8 (plain) on the JAX local scan's traceback tensor, every output."""
    got = sweep_walk_local(*_walk_inputs(case))
    assert all(t.shape == (N + 1, B) and t.dtype == torch.uint16 for t in got[:2])
    _, up = jax_unpack_rle_local(_jax_stages(case)["local_pack"])
    _assert_walk_equals_pack(got, up, ("ins_cnt", "exit_op"))


def _assert_pack_equal(got, want, n_sections):
    """The 14 per-pair rows, then each per-column section's first N+1
    columns (JAX pads the column count)."""
    got = got.to(torch.int32).numpy()
    want = want.astype(np.int32)
    np.testing.assert_array_equal(got[:14], want[:14])
    nc_got, nc_want = (got.shape[0] - 14) // n_sections, (want.shape[0] - 14) // n_sections
    assert nc_got == N + 1
    for t in range(n_sections):
        np.testing.assert_array_equal(got[14 + t * nc_got : 14 + (t + 1) * nc_got], want[14 + t * nc_want : 14 + t * nc_want + nc_got])


@pytest.mark.parametrize("case", STAGE_CASES, ids=_case_id)
def test_packs_match_jax(case):
    score = _port_fixups(case)[0]
    inputs = _walk_inputs(case)
    jx = _jax_stages(case)
    if case in LOCAL_CASES:
        got = _pack_rle_local(score, *sweep_walk_local(*inputs))
        _assert_pack_equal(got, jx["local_pack"], 1)
        s, up = _unpack_rle_local(got.numpy())
        np.testing.assert_array_equal(up["exit_op"], jax_unpack_rle_local(jx["local_pack"])[1]["exit_op"][: N + 1])
    else:
        got = _pack_rle_custom(score, *sweep_walk_custom(*inputs))
        _assert_pack_equal(got, jx["custom_pack"], 4)
        s, up = _unpack_rle_custom(got.numpy())
        np.testing.assert_array_equal(up["pre"], jax_unpack_rle_custom(jx["custom_pack"])[1]["pre"][: N + 1])
    np.testing.assert_array_equal(s, score.numpy())


def test_resolve_fixed_column_custom_fields():
    """A hand-built fixed column: an x-suffix clip of 2 from row 5 to row 3,
    an Ins run of two above a Match exit."""
    X = 6
    match = 4
    tbfix = torch.zeros((1, X), dtype=torch.int32)
    tbfix[0, 5] = TB_XCLIP_SUFFIX << 8
    tbfix[0, 3] = TB_INS << 8 | TB_INS
    tbfix[0, 2] = TB_INS
    tbfix[0, 1] = match
    one = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    out = [o.tolist() for o in resolve_fixed_column_custom(tbfix, one(2), one(5), one(9))]
    fix_codes, fix_lens, i1, j1, ca1, us1, dn1, xs0, ys0, xend0, yend0 = out
    assert fix_codes == [[TB_XCLIP_SUFFIX, TB_INS, match, 0]] and fix_lens == [[2, 3, 0, 0]]
    assert (i1, j1, us1, dn1, xend0, yend0) == ([-1], [8], [1], [0], [3], [9])


# ---- entry points ---------------------------------------------------------


def _fields(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, list(a.operations))


def _mixed_corpus(seed=71):
    """16 pairs of one padded shape (M = 40, N = 46), so that each JAX
    engine compiles once: empty x and empty y, pairs whose path holds an Ins
    run in column 0, x much longer than y (Ins runs past the nibble's cap of
    15), reads of y with random bases at both ends (clipped paths), and
    random pairs."""
    rng = np.random.default_rng(seed)

    def dna(n):
        return rng.choice(list(b"ACGT"), size=n).astype(np.uint8)

    xs = [b"", dna(15).tobytes(), b"AAAC", b"GGGGGGA"]
    ys = [dna(20).tobytes(), b"", b"C", b"A"]
    for k in range(3):
        xs.append(dna(40 - 2 * k).tobytes())
        ys.append(dna(2 + k).tobytes())
    for _ in range(5):
        y = dna(46)
        x = y[4:40].copy()
        a, b = rng.integers(0, 8, size=2)
        x[:a] = dna(a)
        x[len(x) - b :] = dna(b)
        xs.append(x.tobytes())
        ys.append(y.tobytes())
    for _ in range(4):
        xs.append(dna(int(rng.integers(10, 41))).tobytes())
        ys.append(dna(int(rng.integers(10, 47))).tobytes())
    return xs, ys


def _jax_scoring(go, ge, ma, mi, clips):
    return JaxScoring(go, ge, JaxMatchParams(ma, mi), (ma, mi), *clips)


def _port_scoring(go, ge, ma, mi, clips):
    return Scoring(go, ge, MatchParams(ma, mi), (ma, mi), *clips)


# (go, ge, match, mismatch, clips) on the mixed corpus
ENTRY_CASES = [
    (-5, -1, 2, -2, (0, 0, 0, 0)),
    (-5, -1, 2, -2, (-7, -1, 0, -7)),
    (-4, -2, 2, -3, (MIN, 0, -1, MIN)),
    (-3, -1, 1, -1, (-1, MIN, 0, -7)),
    (-3, 0, 2, -2, (-3, 0, -2, 0)),
    # BWA-MEM's -A1 -B4 -O6 -E1 -L5 with the reference window's ends free
    (-6, -1, 1, -4, (-5, -5, 0, 0)),
    # clips above the gap cost: column 0's multi-row Ins runs
    (-5, -1, 2, -2, (-20, -20, -20, -20)),
    # match large enough that JAX's local kernel runs out of int32 headroom
    # (local_engine_headroom_ok fails) and JAX takes its custom engine
    (-5, -1, 2**23, -2, (0, 0, 0, 0)),
]


def _entry_id(case):
    go, ge, ma, mi, clips = case
    return f"go{go}ge{ge}ma{ma}-" + "_".join("min" if c == MIN else str(c) for c in clips)


def _assert_entry_points_match_jax(xs, ys, case):
    port = BatchAligner(_port_scoring(*case), device="cpu")
    jax_ba = JaxBatchAligner(_jax_scoring(*case))
    for mode in ("local", "custom"):
        got = getattr(port, mode)(xs, ys)
        want = getattr(jax_ba, mode)(xs, ys)
        assert [_fields(a) for a in got] == [_fields(a) for a in want], mode
        scores = port.scores(xs, ys, mode)
        assert scores.dtype == np.int32
        np.testing.assert_array_equal(scores, jax_ba.scores(xs, ys, mode))
        np.testing.assert_array_equal(scores, [a.score for a in got])


@pytest.mark.parametrize("case", ENTRY_CASES, ids=_entry_id)
def test_local_custom_and_scores_match_jax(case):
    _assert_entry_points_match_jax(*_mixed_corpus(), case)


def test_custom_with_clips_off_equals_global_and_semiglobal():
    """``custom`` with every clip off is global alignment, and with the
    x-clips off and the y-clips 0 semiglobal alignment plus its y-clip ops.
    JAX runs its global and semiglobal engines for these scorings; the port
    runs K9 and K10, held here to its own global and semiglobal paths (which
    tests/test_torch_aligner.py and test_torch_semiglobal.py hold to JAX)."""
    xs, ys = _mixed_corpus()
    port = BatchAligner(_port_scoring(-5, -1, 2, -2, (MIN, MIN, MIN, MIN)), device="cpu")
    got, want = port.custom(xs, ys), port.global_(xs, ys)
    assert [_fields(a)[:7] + (a.operations,) for a in got] == [_fields(a)[:7] + (a.operations,) for a in want]
    np.testing.assert_array_equal(port.scores(xs, ys, "custom"), port.scores(xs, ys, "global"))
    port = BatchAligner(_port_scoring(-5, -1, 2, -2, (MIN, MIN, 0, 0)), device="cpu")
    got, want = port.custom(xs, ys), port.semiglobal(xs, ys)
    assert any(op.kind == "Yclip" for a in got for op in a.operations)
    for a in got:
        a.filter_clip_operations()
    assert [_fields(a)[:7] + (a.operations,) for a in got] == [_fields(a)[:7] + (a.operations,) for a in want]
    np.testing.assert_array_equal(port.scores(xs, ys, "custom"), port.scores(xs, ys, "semiglobal"))


def test_one_symbol_x_matches_jax():
    """M = 1 (JAX takes its XLA engine there), with empty lanes; the scores
    against the JAX alignments' (its XLA score-only engine would add a
    compile the mixed corpus already covers for the Pallas engines)."""
    xs, ys = [b"A", b"C", b"G", b"", b"T"], [b"ACGT", b"C", b"", b"GATTACA", b"TT"]
    case = (-5, -1, 2, -2, (-7, 0, -1, -1))
    port = BatchAligner(_port_scoring(*case), device="cpu")
    jax_ba = JaxBatchAligner(_jax_scoring(*case))
    for mode in ("local", "custom"):
        want = getattr(jax_ba, mode)(xs, ys)
        assert [_fields(a) for a in getattr(port, mode)(xs, ys)] == [_fields(a) for a in want], mode
        np.testing.assert_array_equal(port.scores(xs, ys, mode), [a.score for a in want])


def test_mixed_corpus_reaches_the_cases():
    """Ins runs past 15, Ins runs in column 0 and clipped reads."""
    xs, ys = _mixed_corpus()
    custom = BatchAligner(_port_scoring(-5, -1, 2, -2, (-20, -20, -20, -20)), device="cpu").custom(xs, ys)
    ops = [[o.kind for o in a.operations] for a in custom]
    assert ops[2] == ["Ins", "Ins", "Ins", "Match"]  # the column-0 Ins run of AAAC / C
    # with the clips off, x much longer than y takes one long Ins run
    off = BatchAligner(_port_scoring(-5, -1, 2, -2, (MIN, MIN, MIN, MIN)), device="cpu").custom(xs, ys)
    runs = [max((len(list(g)) for k, g in itertools.groupby(a.operations) if k.kind == "Ins"), default=0) for a in off]
    assert min(runs[4:7]) > 15
    bwa = BatchAligner(_port_scoring(-6, -1, 1, -4, (-5, -5, 0, 0)), device="cpu").custom(xs, ys)
    assert any(op.kind == "Xclip" for a in bwa[7:12] for op in a.operations[:2])  # after Yclip(4)


def test_custom_at_zero_clips_keeps_prefix_clips():
    """``custom`` at clips 0 takes the local path (K7, K8) and re-emits the
    prefix clips the local walk resolves to coordinates: AAAC against C is
    [Xclip(3), Match] in custom mode, [Match] in local mode."""
    xs, ys = _mixed_corpus()
    case = (-5, -1, 2, -2, (0, 0, 0, 0))
    port = BatchAligner(_port_scoring(*case), device="cpu")
    got = port.custom(xs, ys)
    assert _fields(got[2]) == _fields(JaxBatchAligner(_jax_scoring(*case)).custom(xs, ys)[2])
    assert [op.kind for op in got[2].operations] == ["Xclip", "Match"]
    assert [op.kind for op in port.local(xs, ys)[2].operations] == ["Match"]


def test_zero_gap_penalties_match_the_reference():
    """go = ge = 0 at clips 0: K10 walks K7's output. The port equals the
    JAX scalar oracle (the reference) in every field, and the JAX
    ``BatchAligner``'s scores; JAX's own local kernel departs from its
    custom kernel in column 0 here (see ROADMAP Queue 3)."""
    xs, ys = _mixed_corpus(seed=74)
    oracle = JaxScalarAligner.with_scoring(_jax_scoring(0, 0, 2, -2, (0, 0, 0, 0)))
    port = BatchAligner(_port_scoring(0, 0, 2, -2, (0, 0, 0, 0)), device="cpu")
    jax_ba = JaxBatchAligner(_jax_scoring(0, 0, 2, -2, (0, 0, 0, 0)))
    for mode in ("local", "custom"):
        got = getattr(port, mode)(xs, ys)
        assert [_fields(a) for a in got] == [_fields(getattr(oracle, mode)(x, y)) for x, y in zip(xs, ys)], mode
        np.testing.assert_array_equal(port.scores(xs, ys, mode), jax_ba.scores(xs, ys, mode))


def test_empty_y_lane_follows_the_oracle():
    """The smallest input of the nlens = 0 fault (ROADMAP Queue 3): with a
    free x-prefix clip and go = ge = 0, column 0's final I must be I0, or
    the suffix fixups rewrite its i-bits and the walk takes [Ins, Ins]."""
    sc = _port_scoring(0, 0, 2, -5, (MIN, MIN, MIN, MIN)).xclip_prefix_(0)
    got = BatchAligner(sc, device="cpu").custom([b"AA", b"ACG"], [b"", b"AC"])
    oracle = JaxScalarAligner.with_scoring(_jax_scoring(0, 0, 2, -5, (MIN, MIN, MIN, MIN)).xclip_prefix_(0))
    assert (got[0].score, got[0].xstart, got[0].operations) == (0, 1, [Xclip(1), Ins])
    assert [_fields(a) for a in got] == [_fields(oracle.custom(x, y)) for x, y in ((b"AA", b""), (b"ACG", b"AC"))]


@pytest.mark.parametrize("seed", range(4))
def test_empty_y_lanes_under_random_clips_follow_the_oracle(seed):
    """Lanes with nlens = 0 beside nonempty ones, clips drawn from
    {MIN_SCORE, 0, -1, -7}: ``local``, ``custom`` and ``scores`` equal the
    scalar oracle in every field."""
    rng = np.random.default_rng(90 + seed)
    go = int(rng.integers(-6, 1))
    case = (go, int(rng.integers(go, 1)), MA, MI, tuple(int(c) for c in rng.choice([MIN, 0, -1, -7], size=4)))
    xs = [rng.choice(list(b"ACGT"), size=int(rng.integers(0, 13))).astype(np.uint8).tobytes() for _ in range(8)]
    ys = [b"" if k % 2 == 0 else rng.choice(list(b"ACGT"), size=int(rng.integers(1, 9))).astype(np.uint8).tobytes() for k in range(8)]
    port = BatchAligner(_port_scoring(*case), device="cpu")
    oracle = JaxScalarAligner.with_scoring(_jax_scoring(*case))
    for mode in ("local", "custom"):
        want = [getattr(oracle, mode)(x, y) for x, y in zip(xs, ys)]
        assert [_fields(a) for a in getattr(port, mode)(xs, ys)] == [_fields(a) for a in want], (mode, case)
        np.testing.assert_array_equal(port.scores(xs, ys, mode), [a.score for a in want])
