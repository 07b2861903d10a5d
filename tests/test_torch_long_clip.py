"""Long x in the clip modes: K15 (the clip-mode column scan), K15-LUT and
K15-walk (the per-step walk) against the JAX package on the CPU.

Stage by stage at B = 8, M = 40, N = 46 (ragged lengths, an empty y): the
plain K15 against ``scan_columns_pallas_mp`` in interpret mode (fed from
``_init_column``, the Lx nibbles decoded from tb rows 0-2), the plain
K15-LUT against the XLA engine ``_scan_columns_xla`` under BLOSUM62, and
``walk_steps_plain`` against ``_walk`` on the same ``tb_full``. End to end,
``semiglobal``, ``local``, ``custom`` and ``scores`` at M = 4,100-4,300
against the scalar oracle and the JAX ``BatchAligner`` (MatchParams and
BLOSUM62), and the long route forced below 4096 against the K5/K6 and
K9/K10 routes. Integers throughout: every comparison is exact (tolerance
0). The port follows the oracle on lanes with an empty y, where the JAX
engines end column 0 with I = MIN_SCORE.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu import scores as jax_scores
from rust_bio_tpu.alignment.pairwise import Aligner as JaxScalarAligner
from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.batched import _geometry as jax_geometry
from rust_bio_tpu.alignment.pairwise.batched import _init_column, _scan_columns_xla, _subs_einsum, _walk
from rust_bio_tpu.alignment.pairwise.batched import _suffix_fixups as jax_suffix_fixups
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu.ops.sw_pallas import scan_columns_pallas_mp
from rust_bio_tpu_torch import scores
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring, batched
from rust_bio_tpu_torch.alignment.pairwise.batched import _decode_ops, _pack_steps, _unpack_steps
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE
from rust_bio_tpu_torch.alignment.types import Del, Ins, Match, Xclip, Yclip
from rust_bio_tpu_torch.ops import sw, walk
from test_torch_custom import column0_i

MIN = MIN_SCORE
MA, MI = 2, -2
B, M, N = 8, 40, 46
AA = b"ARNDCQEGHILKMFPSTWYV"
# (go, ge, (xclip_prefix, xclip_suffix, yclip_prefix, yclip_suffix)):
# semiglobal, local, BWA-MEM's soft clips, and clips from {MIN_SCORE, 0, -1,
# -7} as the JAX package's own tests draw them
CASES = [
    (-5, -1, (MIN, MIN, 0, 0)),
    (-5, -1, (0, 0, 0, 0)),
    (-6, -1, (-5, -5, 0, 0)),
    (-4, -2, (-7, -1, 0, MIN)),
    (-3, -1, (-1, MIN, -7, 0)),
    (-2, -2, (0, -7, -1, -1)),
    (0, 0, (0, 0, 0, 0)),
]


def _case_id(case):
    go, ge, clips = case
    return f"go{go}ge{ge}-" + "_".join("min" if c == MIN else str(c) for c in clips)


def _batch(seed, alphabet=b"ACGT"):
    """B pairs of x 24-40 and y 30-46 symbols, lane 1 with an empty y and
    lane 2 with a one-symbol x; lanes 4.. hold a stretch of y in x (clipped
    paths)."""
    rng = np.random.default_rng(seed)
    syms = np.frombuffer(alphabet, np.uint8)
    xb = syms[rng.integers(0, len(syms), size=(B, M))]
    yb = syms[rng.integers(0, len(syms), size=(B, N))]
    mlens = rng.integers(24, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(30, N + 1, size=B).astype(np.int32)
    mlens[:3] = [M, 30, 1]
    nlens[:3] = [N, 0, 35]
    xb[4:, 5:20] = yb[4:, 8:23]
    return xb, yb, mlens, nlens


@functools.partial(jax.jit, static_argnames=("engine",))
def _jax_columns(xb, yb, mlens, nlens, pens8, lut, engine):
    """The JAX general engine's stages (batched.py ``_align_batch_device`` /
    ``_align_batch_device_mp`` and ``_postlude``): init column, the scan
    (the Pallas K15 or the XLA engine), and the walk on ``tb_full``."""
    Bq, Mq = xb.shape
    Nq = yb.shape[1]
    pens = tuple(pens8[k] for k in range(6))
    rows, row_ge1, mlens_c, is_row_m = jax_geometry(Bq, Mq, mlens)
    S0, D0, sb0, Sn0, Ly0, tb_col0, Lx0 = _init_column(Bq, Mq, rows, row_ge1, mlens, nlens, mlens_c, is_row_m, pens)
    if engine == "pallas":
        eq = (jnp.swapaxes(yb, 0, 1)[:, :, None] == xb[None, :, :]).astype(jnp.uint8)
        scan = scan_columns_pallas_mp(eq, S0, D0, sb0, Sn0, Ly0, tb_col0, mlens, nlens, pens8)
    else:
        yclip_row = pens[4] + pens[0] + pens[1] * (rows - 1)
        scan = _scan_columns_xla(
            xb, yb, _subs_einsum(xb, yb, lut, 32), S0, D0, sb0, Sn0, Ly0, tb_col0,
            Bq, Mq, Nq, rows, row_ge1, mlens, nlens, mlens_c, is_row_m, yclip_row, pens,
        )
    S_f, I_f, Sn_f, Ly_f, tb_f, tb_cols, Lx_cols = scan
    _, fixed, Lx_n, lx_set = jax_suffix_fixups(S_f, I_f, Sn_f, tb_f, Bq, Mq, rows, row_ge1, mlens, mlens_c, is_row_m, pens)
    # tb_full and Lx_full as _postlude builds them
    bidx = jnp.arange(Bq)
    tb_full = jnp.concatenate([tb_col0[:, :, None], jnp.moveaxis(tb_cols, 0, 2)], axis=2)
    tb_full = tb_full.at[bidx[:, None], jnp.arange(Mq + 1)[None, :], nlens[:, None]].set(fixed)
    Lx_full = jnp.concatenate([Lx0[:, None], jnp.moveaxis(Lx_cols, 0, 1)], axis=1)
    Lx_full = Lx_full.at[bidx, nlens].set(jnp.where(lx_set, Lx_n, Lx_full[bidx, nlens]))
    steps = _walk(tb_full, Lx_full, Ly_f, mlens, nlens, Bq, Mq, Nq)
    return scan, tb_col0, Lx0, tb_full, Lx_full, steps


def _mp_lut():
    """The MatchParams scoring (2, -2) as a (256, 256) table."""
    lut = np.full((256, 256), MI, np.int32)
    np.fill_diagonal(lut, MA)
    return lut


@functools.lru_cache(maxsize=None)
def _jax_case(case, engine):
    """One case through the JAX engine, as numpy arrays: DNA pairs through
    the Pallas K15, protein pairs under BLOSUM62 through the XLA engine."""
    go, ge, clips = case
    seed = abs(go * 13 + ge) + sum(abs(c) % 97 for c in clips)
    inputs = _batch(seed, b"ACGT" if engine == "pallas" else AA)
    lut = _mp_lut() if engine == "pallas" else scores.dense_matrix("blosum62")
    pens8 = np.array([go, ge, *clips, MA, MI], np.int32)
    out = _jax_columns(*(jnp.asarray(a) for a in inputs + (pens8, lut)), engine=engine)
    return inputs, lut, jax.tree.map(np.asarray, out)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_scan_matches(got, jx, case):
    """The port's (N+1, X, B) tb and (N+1, B) lx against the JAX init column
    and scanned columns (12 bits), the finals rows 0..mlens; the final I of
    the empty-y lane against column 0's I."""
    go, ge, clips = case
    (_, _, mlens, nlens), _, (scan, tb_col0, Lx0, *_) = jx
    S_f, I_f, Sn_f, Ly_f, tb_f, tb_cols, Lx_cols = scan
    tb, lx, *finals = (t.to(torch.int32).numpy() for t in got)
    want_tb = np.concatenate([tb_col0[None].astype(np.int32), tb_cols[:N].astype(np.int32) & 0xFFF])  # (N+1, B, X)
    want_lx = np.concatenate([Lx0[None], Lx_cols[:N]])
    i0 = column0_i(go, ge, clips[0], M + 1)
    for b in range(B):
        m, n = mlens[b], nlens[b]
        np.testing.assert_array_equal(tb[: n + 1, : m + 1, b], want_tb[: n + 1, b, : m + 1], err_msg=f"tb lane {b}")
        np.testing.assert_array_equal(lx[: n + 1, b], want_lx[: n + 1, b], err_msg=f"lx lane {b}")
        for k, w in enumerate((S_f, i0 if n == 0 else I_f[b], Sn_f, Ly_f, tb_f)):
            w = w if w.ndim == 1 else w[b]
            np.testing.assert_array_equal(finals[k][b, : m + 1], w[: m + 1].astype(np.int32), err_msg=f"final {k} lane {b}")
    assert not (tb[: nlens.max() + 1] >> 12).any()  # no run nibble


@pytest.mark.parametrize("subst", ["matchparams", "lut"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_scan_columns_plain_matches_pallas_k15(case, subst):
    """K15 (and K15-LUT fed the MatchParams table) against the Pallas K15."""
    go, ge, clips = case
    jx = _jax_case(case, "pallas")
    args = _torch(*jx[0])
    if subst == "matchparams":
        got = sw.scan_columns(*args, go, ge, MA, MI, *clips)
    else:
        got = sw.scan_columns_lut(*args, go, ge, torch.from_numpy(jx[1]), *clips)
    assert got[0].shape == (N + 1, M + 1, B) and got[0].dtype == torch.uint16
    _assert_scan_matches(got, jx, case)


@pytest.mark.parametrize("m", [0, 1, 150, 4095, 5588, 11621, 11622, 16383, 65534])
def test_columns_geometry_covers_every_row_once(m):
    """K15's launch (csrc/sw_columns.cu): the stripes [t * R, t * R + R) of
    T threads own each row 0..M exactly once, T is a multiple of 32 within
    the 1,024 threads of a block, R a multiple of 8, and the dynamic shared
    memory fits a
    block's 232,448 bytes; the row state leaves it above
    ``COLUMNS_SHARED_MAX_M``."""
    T, R, placement, smem = sw.columns_geometry(m)
    owned = np.zeros(m + 1, np.int64)
    for t in range(T):
        owned[t * R : t * R + R] += 1
    assert (owned == 1).all()
    # R a multiple of 8: a thread's 8-row groups are 16-byte pieces of a
    # pair-major column
    assert T % 32 == 0 and 32 <= T <= 1024 and R >= 8 and R % 8 == 0
    assert smem <= 232_448
    assert placement == ("shared" if m <= sw.COLUMNS_SHARED_MAX_M else "scratch")
    # shared: the carries, x's bytes and five int32 layers of row state
    state = 5 * R * T * 4 if placement == "shared" else 0
    assert smem == 2 * 6 * T * 4 + R * T + state


def test_columns_shared_max_m_is_the_largest_that_fits(monkeypatch):
    """At ``COLUMNS_SHARED_MAX_M`` the row state fits shared memory; one
    more row, and it would not."""
    assert sw.columns_geometry(sw.COLUMNS_SHARED_MAX_M)[2:] == ("shared", 221_184)
    limit = sw.COLUMNS_SHARED_MAX_M + 1
    monkeypatch.setattr(sw, "COLUMNS_SHARED_MAX_M", limit)
    assert sw.columns_geometry(limit)[3] > 232_448


@pytest.mark.parametrize("case", CASES[:5], ids=_case_id)
def test_scan_columns_lut_plain_matches_xla_engine(case):
    """K15-LUT under BLOSUM62 against ``_scan_columns_xla``; the score-only
    call keeps the finals."""
    go, ge, clips = case
    jx = _jax_case(case, "xla")
    args = _torch(*jx[0])
    lut = torch.from_numpy(jx[1])
    got = sw.scan_columns_lut_plain(*args, go, ge, lut, *clips)
    _assert_scan_matches(got, jx, case)
    only = sw.scan_columns_lut(*args, go, ge, lut, *clips, traceback=False)
    assert only[0] is None and only[1] is None
    for g, w in zip(only[2:], got[2:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_walk_steps_plain_matches_jax_walk(case, engine):
    """K15-walk on the JAX engine's ``tb_full`` / ``Lx_full`` / ``Ly_f``
    against ``_walk``: every op code, clip length and coordinate."""
    (_, _, mlens, nlens), _, (scan, _, _, tb_full, Lx_full, steps) = _jax_case(case, engine)
    tb = np.ascontiguousarray(np.transpose(tb_full, (2, 1, 0)))  # (N+1, X, B)
    got = walk.walk_steps(*_torch(tb, np.ascontiguousarray(Lx_full.T), scan[3], mlens, nlens))
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.uint16
    for key, g in zip(("op_codes", "op_lens", "xstart", "ystart", "xend", "yend"), got):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), steps[key].astype(np.int32), err_msg=key)
    assert (steps["op_codes"] >= 5).any()  # clip steps occur


def _pair_major_view(tb, fill=0x0ABC):
    """``tb`` (N+1, X, B) as K15 returns it on the card: the (N+1, X, B)
    view of a pair-major (B, N+1, Xp) tensor, Xp = X rounded up to 8, its
    padding rows holding ``fill`` (a cell no walk may read)."""
    Nc, X, B = tb.shape
    pm = torch.full((B, Nc, sw.pair_major_pitch(X - 1)), fill, dtype=torch.int32).to(torch.uint16)
    pm[:, :, :X] = tb.permute(2, 0, 1)
    return pm, pm[:, :, :X].permute(1, 2, 0)


# lanes whose walk starts on row 0 or column 0 or at once: (mlens, nlens)
# put in place of lanes 3, 5 and 6
EDGE_STARTS = ((0, 20), (17, 0), (0, 0))


@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_walk_steps_plain_on_pair_major_view_matches_jax_walk(case, engine):
    """K15-walk's plain version reading ``tb_full`` through a pair-major
    view (strided gathers, no copy) against ``_walk``, the cases of
    ``test_walk_steps_plain_matches_jax_walk`` with lanes 3, 5 and 6
    starting at mlens = 0, at nlens = 0 and at both (a lane that ends at
    once); the contiguous tb gives the same steps."""
    (_, _, mlens, nlens), _, (scan, _, _, tb_full, Lx_full, _) = _jax_case(case, engine)
    mlens, nlens = mlens.copy(), nlens.copy()
    for lane, (m, n) in zip((3, 5, 6), EDGE_STARTS):
        mlens[lane], nlens[lane] = m, n
    steps = _walk(jnp.asarray(tb_full), jnp.asarray(Lx_full), jnp.asarray(scan[3]), jnp.asarray(mlens),
                  jnp.asarray(nlens), B, M, N)
    tb = torch.from_numpy(np.ascontiguousarray(np.transpose(tb_full, (2, 1, 0)).astype(np.int32))).to(torch.uint16)
    pm, view = _pair_major_view(tb)
    assert view.data_ptr() == pm.data_ptr() and walk._walk_strides(view) == (pm.shape[2], 1, pm.shape[1] * pm.shape[2])
    rest = _torch(np.ascontiguousarray(Lx_full.T), scan[3], mlens, nlens)
    got = walk.walk_steps_plain(view, *rest)
    for key, g, c in zip(("op_codes", "op_lens", "xstart", "ystart", "xend", "yend"), got, walk.walk_steps(tb, *rest)):
        np.testing.assert_array_equal(g.to(torch.int32).numpy(), np.asarray(steps[key]).astype(np.int32), err_msg=key)
        assert torch.equal(g, c), key
    assert not got[0][:, 6].any()  # the lane at (0, 0) takes no step


def test_walk_cases_step_every_clip_kind():
    """Over the walk cases each of the four clip codes is stepped: the
    pair-major view's jumps are all exercised."""
    codes = set()
    for case in CASES:
        for engine in ("pallas", "xla"):
            codes |= set(np.unique(_jax_case(case, engine)[2][5]["op_codes"]).tolist())
    assert {5, 6, 7, 8} <= codes


@pytest.mark.parametrize("case", CASES[:5], ids=_case_id)
def test_columns_fixups_write_through_pair_major_view(case):
    """``_columns_fixups`` on K15's finals writes the fixed column and its
    clip length through a pair-major view of the tb into the pair-major
    tensor itself (no copy of the tb), as on a contiguous tb; the padding
    rows stay as they were."""
    go, ge, clips = case
    args = _torch(*_jax_case(case, "pallas")[0])
    tb, lx, *finals = sw.scan_columns(*args, go, ge, MA, MI, *clips)
    pm, view = _pair_major_view(tb)
    X = tb.shape[1]
    scan_c = (tb.clone(), lx.clone(), *finals)
    scan_v = (view, lx.clone(), *finals)
    score_c = batched._columns_fixups(scan_c, args[2], args[3], (go, ge, *clips))
    score_v = batched._columns_fixups(scan_v, args[2], args[3], (go, ge, *clips))
    assert torch.equal(score_c, score_v)
    assert torch.equal(pm[:, :, :X].permute(1, 2, 0), scan_c[0]) and not torch.equal(scan_c[0], tb)
    assert torch.equal(scan_v[1], scan_c[1])
    assert (pm[:, :, X:] == 0x0ABC).all()


def test_pack_steps_roundtrip_and_decode():
    """``_pack_steps`` / ``_unpack_steps`` keep every field; ``_decode_ops``
    stops at the first 0 and reverses, clips with their lengths."""
    score = torch.tensor([-(2**31) + 3, 77], dtype=torch.int32)
    codes = torch.tensor([[6, 4], [4, 2], [1, 7], [5, 0], [0, 0]], dtype=torch.uint8)
    lens = torch.tensor([[3, 0], [0, 0], [0, 65535], [2, 0], [0, 0]], dtype=torch.int32).to(torch.uint16)
    coords = [torch.tensor(v, dtype=torch.int32) for v in ([2, 0], [0, 9], [10, 1], [5, 65535])]
    s, up = _unpack_steps(_pack_steps(score, codes, lens, *coords).numpy())
    np.testing.assert_array_equal(s, score.numpy())
    for k, c in zip(("xstart", "ystart", "xend", "yend"), coords):
        np.testing.assert_array_equal(up[k], c.numpy())
    assert _decode_ops(up["op_codes"][:, 0], up["op_lens"][:, 0]) == [Xclip(2), Ins, Match, Xclip(3)]
    assert _decode_ops(up["op_codes"][:, 1], up["op_lens"][:, 1]) == [Yclip(65535), Del, Match]


# ---- end to end ----


def _fields(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, list(a.operations))


def _long_corpus(kind):
    """x of 4,100-4,300 symbols against y of 0-40: a slice of x, a slice
    with a changed end, random y, an empty y, and A + C * 4199 against A
    (one column holds an Ins run of 4,199 in semiglobal mode)."""
    rng = np.random.default_rng(61 if kind == "matchparams" else 62)
    syms = np.frombuffer(b"ACGT" if kind == "matchparams" else AA, np.uint8)
    xs = [syms[rng.integers(0, len(syms), size=int(rng.integers(4100, 4301)))].tobytes() for _ in range(4)]
    ys = [xs[0][300:340], xs[1][2000:2025] + xs[2][:10], syms[rng.integers(0, len(syms), size=17)].tobytes(), b""]
    return xs + [b"A" + b"C" * 4199], ys + [b"A"]


def _scorings(kind):
    if kind == "matchparams":
        return Scoring.from_scores(-5, -1, 2, -2).xclip(-7).yclip(-1), JaxScoring.from_scores(-5, -1, 2, -2).xclip(-7).yclip(-1)
    return (
        Scoring.new(-11, -1, scores.blosum62).xclip(-10).yclip(0),
        JaxScoring.new(-11, -1, jax_scores.blosum62).xclip(-10).yclip(0),
    )


@pytest.mark.parametrize("mode", ["semiglobal", "local", "custom"])
@pytest.mark.parametrize("kind", ["matchparams", "blosum62"])
def test_long_clip_modes_match_oracle_and_jax(kind, mode):
    """Every field against the scalar oracle; against the JAX
    ``BatchAligner`` (its XLA engine at this length) on every lane with a
    nonempty y; ``scores`` against both and the alignments."""
    xs, ys = _long_corpus(kind)
    port_sc, jax_sc = _scorings(kind)
    ba = BatchAligner(port_sc, device="cpu")
    got = getattr(ba, mode)(xs, ys)
    oracle = JaxScalarAligner.with_scoring(jax_sc)
    assert [_fields(a) for a in got] == [_fields(getattr(oracle, mode)(x, y)) for x, y in zip(xs, ys)]
    jax_ba = JaxBatchAligner(jax_sc)
    want = getattr(jax_ba, mode)(xs, ys)
    for k, y in enumerate(ys):
        if y:
            assert _fields(got[k]) == _fields(want[k]), k
    got_scores = ba.scores(xs, ys, mode)
    np.testing.assert_array_equal(got_scores, [a.score for a in got])
    np.testing.assert_array_equal(got_scores, jax_ba.scores(xs, ys, mode))
    if mode == "semiglobal":
        assert len(got[-1].operations) == 4200 and got[-1].operations.count(Ins) == 4199


@pytest.mark.parametrize("kind", ["matchparams", "blosum62"])
def test_long_route_below_4096_matches_short_routes_and_jax(monkeypatch, kind):
    """``T_COLUMNS`` forced to 64: ragged 100-300 symbol pairs take K15 and
    K15-walk, and equal the K5/K6 and K7-K10 routes and the JAX package."""
    rng = np.random.default_rng(71 if kind == "matchparams" else 72)
    syms = np.frombuffer(b"ACGT" if kind == "matchparams" else AA, np.uint8)
    xs = [syms[rng.integers(0, len(syms), size=int(rng.integers(100, 301)))].tobytes() for _ in range(5)]
    ys = [syms[rng.integers(0, len(syms), size=int(rng.integers(100, 301)))].tobytes() for _ in range(5)]
    ys[1] = xs[1][20:120] + ys[1][:30]  # a local hit with clipped ends
    ys[2] = xs[2][:60] + xs[2][150:]  # a 90-symbol insertion in x
    ys[3] = b""
    port_sc, jax_sc = _scorings(kind)
    ba = BatchAligner(port_sc, device="cpu")
    modes = ("semiglobal", "local", "custom")
    short = {mode: getattr(ba, mode)(xs, ys) for mode in modes}
    short_scores = {mode: ba.scores(xs, ys, mode) for mode in modes}
    calls = []
    steps = walk.walk_steps

    def counted(*a):
        calls.append(1)
        return steps(*a)

    monkeypatch.setattr(batched, "T_COLUMNS", 64)
    monkeypatch.setattr(walk, "walk_steps", counted)
    jax_ba = JaxBatchAligner(jax_sc)
    for mode in modes:
        got = getattr(ba, mode)(xs, ys)
        assert [_fields(a) for a in got] == [_fields(a) for a in short[mode]], mode
        want = getattr(jax_ba, mode)(xs, ys)
        assert [_fields(a) for k, a in enumerate(got) if ys[k]] == [_fields(a) for k, a in enumerate(want) if ys[k]], mode
        np.testing.assert_array_equal(ba.scores(xs, ys, mode), short_scores[mode])
    assert len(calls) == 3


def test_limits_and_packed_semiglobal_raise():
    ba = BatchAligner(Scoring.from_scores(-5, -1, 2, -2), device="cpu")
    with pytest.raises(ValueError, match="65534"):
        ba.local([b"A" * 65535], [b"A"])
    with pytest.raises(ValueError, match="65535"):
        ba.scores([b"A" * 4200], [b"A" * 65536], "semiglobal")
    with pytest.raises(ValueError, match="12 bits"):
        ba.semiglobal_packed_async([b"A" * 4095], [b"A"])
