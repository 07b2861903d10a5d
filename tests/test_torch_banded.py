"""The banded aligner (``BatchBandedAligner``, K16 and K16-walk) against the
JAX package on the CPU.

The host pieces: the port's ``sparse``, ``MaxBitTree`` and ``Band``
builders against the JAX ones; the port's native ``band_build_batch``
against its Python builders and, byte for byte, against the JAX native
builder; the port's host oracle ``banded.Aligner`` against the JAX one in
every mode and against the reference goldens. Stage by stage (B = 12, M =
40, N = 46, random bands: jittered so not monotone, empty columns, row 0 in
and out of band, bands that never reach row m): the plain K16 against
``scan_banded_pallas_mp`` in interpret mode (all seven outputs, tb over
columns 1..nlens), and ``_init_column_banded``, ``_banded_suffix_fixups``
and the plain K16-walk against their JAX twins. End to end,
``BatchBandedAligner(device="cpu")`` against the JAX ``BatchBandedAligner``
field for field. Integers throughout: every comparison is exact
(tolerance 0).
"""

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu import native as jax_native
from rust_bio_tpu import scores as jax_scores
from rust_bio_tpu.alignment import sparse as jax_sparse
from rust_bio_tpu.alignment.pairwise import banded as jax_banded
from rust_bio_tpu.alignment.pairwise import banded_device as jax_bd
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu.data_structures.bit_tree import MaxBitTree as JaxMaxBitTree
from rust_bio_tpu.ops.sw_pallas import scan_banded_pallas_mp
from rust_bio_tpu_torch import native, scores
from rust_bio_tpu_torch.alignment import sparse
from rust_bio_tpu_torch.alignment.pairwise import BatchBandedAligner, Scoring, banded
from rust_bio_tpu_torch.alignment.pairwise import banded_device as bd
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE
from rust_bio_tpu_torch.alignment.types import Del, Ins, Match, Subst, Xclip, Yclip
from rust_bio_tpu_torch.carry import banded_inputs
from rust_bio_tpu_torch.data_structures.bit_tree import MaxBitTree
from rust_bio_tpu_torch.ops import sw, walk
from test_banded_device import _gen_pair
from test_torch_cuda import BANDED_PENS, _band_batch, _banded_pairs

MIN = MIN_SCORE
B, M, N = 12, 40, 46
CLIPS = [(0, 0, 0, 0), (MIN,) * 4, (MIN, MIN, 0, 0), (-3, -7, -2, -5), (-3, -7, 0, 0)]
MODES = ["custom", "global_", "semiglobal", "local"]


def _key(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, list(a.operations))


def _assert_same(got, want, ctx=""):
    assert [_key(a) for a in got] == [_key(a) for a in want], ctx


def _dna(rng, n):
    return rng.choice(list(b"ACGT"), size=n).astype(np.uint8).tobytes()


def _read_in_target(rng, n, m, subs):
    y = _dna(rng, n)
    s = int(rng.integers(0, n - m + 1))
    x = bytearray(y[s : s + m])
    for _ in range(subs):
        x[int(rng.integers(0, m))] = int(rng.choice(list(b"ACGT")))
    return bytes(x), y


# ---- sparse, MaxBitTree, Band ----


@pytest.mark.parametrize("seed", range(4))
def test_sparse_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    x, y = _read_in_target(rng, int(rng.integers(60, 400)), 50, 3)
    for k in (5, 8):
        m = sparse.find_kmer_matches(x, y, k)
        assert m == jax_sparse.find_kmer_matches(x, y, k)
        assert sparse.find_kmer_matches(y, x, k) == jax_sparse.find_kmer_matches(y, x, k)
        assert sparse.hash_kmers(y, k) == jax_sparse.hash_kmers(y, k)
        assert sparse.find_kmer_matches_seq2_hashed(x, sparse.hash_kmers(y, k), k) == m
        for go, ge in ((-5, -1), (0, 0), (-2, -2)):
            got, want = sparse.sdpkpp(m, k, 2, go, ge), jax_sparse.sdpkpp(m, k, 2, go, ge)
            assert (got.path, got.score, got.dp_vector) == (want.path, want.score, want.dp_vector)
            py = sparse._sdpkpp_py(m, k, 2, go, ge)
            assert (py.path, py.score) == (got.path, got.score)
            assert sparse.sdpkpp_union_lcskpp_path(m, k, 2, go, ge) == jax_sparse.sdpkpp_union_lcskpp_path(
                m, k, 2, go, ge
            )
        lc, jlc = sparse.lcskpp(m, k), jax_sparse.lcskpp(m, k)
        assert (lc.path, lc.score, lc.dp_vector) == (jlc.path, jlc.score, jlc.dp_vector)
        assert sparse.expand_kmer_matches(x, y, k, m, 1) == jax_sparse.expand_kmer_matches(x, y, k, m, 1)


def test_max_bit_tree_matches_the_jax_package():
    rng = np.random.default_rng(5)
    ours, theirs = MaxBitTree(64, default=(0, 0)), JaxMaxBitTree(64, default=(0, 0))
    for _ in range(300):
        i, v = int(rng.integers(0, 64)), (int(rng.integers(0, 50)), int(rng.integers(0, 9)))
        ours.set(i, v)
        theirs.set(i, v)
        q = int(rng.integers(0, 64))
        assert ours.get(q) == theirs.get(q)
    assert len(ours) == len(theirs) == 64


@pytest.mark.parametrize("clips", CLIPS, ids=lambda c: "_".join("min" if v == MIN else str(v) for v in c))
def test_band_builders_match_the_jax_package(clips):
    """``Band.create`` (native) and the Python builders give the JAX
    package's bands; no k-mer match gives the full matrix."""
    rng = np.random.default_rng(abs(sum(c % 97 for c in clips)))
    for trial in range(4):
        x, y = _read_in_target(rng, int(rng.integers(60, 900)), int(rng.integers(20, 60)), trial)
        if trial == 3:
            x = rng.choice(list(b"AC"), size=30).astype(np.uint8).tobytes()
            y = rng.choice(list(b"GT"), size=50).astype(np.uint8).tobytes()
        k, w = int(rng.integers(5, 10)), int(rng.integers(2, 12))
        sc = Scoring.from_scores(-5, -1, 2, -2).with_clips(*clips)
        jsc = JaxScoring.from_scores(-5, -1, 2, -2).with_clips(*clips)
        want = jax_banded.Band.create(x, y, k, w, jsc)
        matches = sparse.find_kmer_matches(x, y, k)
        for got in (banded.Band.create(x, y, k, w, sc), banded.Band.create_with_matches(x, y, k, w, sc, matches)):
            np.testing.assert_array_equal(got.starts, want.starts)
            np.testing.assert_array_equal(got.ends, want.ends)
            assert got.num_cells() == want.num_cells()
        if matches:
            path = sparse.sdpkpp(matches, k, 2, -5, -1).path
            got = banded.Band.create_from_match_path(x, y, k, w, sc, path, matches)
            ref = jax_banded.Band.create_from_match_path(x, y, k, w, jsc, path, matches)
            np.testing.assert_array_equal(got.starts, ref.starts)
            np.testing.assert_array_equal(got.ends, ref.ends)


def test_band_add_entry_golden():
    band = banded.Band(10, 10)
    band.add_entry((3, 3), 3)
    assert [(int(s), int(e)) for s, e in zip(band.starts, band.ends)] == [(0, 7)] * 7 + [(11, 0)] * 4
    band.add_entry((9, 9), 2)
    assert [(int(s), int(e)) for s, e in zip(band.starts, band.ends)] == [(0, 7)] * 7 + [(7, 11)] * 4


# ---- the native band builder ----


def _python_windows(xs, ys, k, w, sc, crop, wcap):
    """``band_build_batch``'s outputs from the Python builders, windowed as
    the native builder windows them (banded_device.py's formula)."""
    Bq = len(xs)
    stw = np.empty((Bq, wcap + 1), np.int32)
    enw = np.empty((Bq, wcap + 1), np.int32)
    c0_all, nle_all, cells = np.zeros(Bq, np.int64), np.zeros(Bq, np.int64), np.zeros(Bq, np.int64)
    jwin = np.zeros((Bq, 2), np.int64)
    for i, (x, y) in enumerate(zip(xs, ys)):
        band = banded.Band.create_with_matches(x, y, k, w, sc, sparse.find_kmer_matches(x, y, k))
        n, m = len(y), len(x)
        cells[i] = band.num_cells()
        nz = np.nonzero(band.ends > band.starts)[0]
        jwin[i] = (nz[0], nz[-1]) if nz.size else (-1, -1)
        c0, nle = 0, n
        if crop and nz.size:
            c0 = max(int(nz[0]) - 1, 0)
            tail = n - int(nz[-1])
            nle = int(nz[-1]) - c0 + (0 if tail == 0 else (1 if tail % 2 == 1 else 2))
        c0_all[i] = c0
        if nle > wcap:
            nle_all[i] = -1
            continue
        nle_all[i] = nle
        win = min(nle, n - c0) + 1
        stw[i, :win] = band.starts[c0 : c0 + win]
        stw[i, win:] = m + 1
        enw[i, :win] = band.ends[c0 : c0 + win]
        enw[i, win:] = 0
    return stw, enw, c0_all, nle_all, cells, jwin


@pytest.mark.parametrize("crop", [False, True])
@pytest.mark.parametrize("clips", CLIPS[:4], ids=["local", "global", "semi", "custom"])
def test_native_band_build_batch_matches(clips, crop):
    """The port's ``band_build_batch`` equals the JAX native builder and its
    own Python builders byte for byte: c0, nle, cells and jwin of every
    pair, st_w and en_w of every pair whose window fits."""
    rng = np.random.default_rng(len(clips) + crop + sum(abs(c) % 89 for c in clips))
    pairs = [_read_in_target(rng, int(rng.integers(200, 1500)), int(rng.integers(30, 100)), t % 4) for t in range(10)]
    pairs.append((b"ACACACCAACACCA" * 3, b"GTGTTGTGGT" * 8))  # no k-mer match: the full matrix
    xs = [p[0] for p in pairs]
    ys = [p[1] for p in pairs]
    Mq, Nq = max(map(len, xs)), max(map(len, ys))
    xb = np.zeros((len(xs), Mq), np.uint8)
    yb = np.zeros((len(ys), Nq), np.uint8)
    for i, (x, y) in enumerate(pairs):
        xb[i, : len(x)] = np.frombuffer(x, np.uint8)
        yb[i, : len(y)] = np.frombuffer(y, np.uint8)
    ml, nl = np.array([len(x) for x in xs]), np.array([len(y) for y in ys])
    wcap = 1024 if crop else Nq
    args = (xb, ml, yb, nl, 8, 6, clips, 2, 5, 1, crop, wcap)
    got = native.band_build_batch(*args)
    ok = got[3] >= 0  # the window rows of an overflowing pair are not written
    for ref in (jax_native.band_build_batch(*args),
                _python_windows(xs, ys, 8, 6, Scoring.from_scores(-5, -1, 2, -2).with_clips(*clips), crop, wcap)):
        for g, w in zip(got[2:], ref[2:]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        for g, w in zip(got[:2], ref[:2]):
            assert g.dtype == w.dtype and np.array_equal(g[ok], w[ok])


def test_native_library_releases_the_gil_and_raises_on_a_bad_build(monkeypatch, tmp_path):
    """The band builder is a ``ctypes.CDLL`` (every call releases the GIL,
    which the pipelined aligner needs) and a failing compile raises with
    the compiler's message."""
    lib = native.get_lib()
    assert isinstance(lib, ctypes.CDLL) and not isinstance(lib, ctypes.PyDLL)
    bad = tmp_path / "band_build.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="band_build.cpp failed"):
        native.library_path()


# ---- the host oracle ----

_GOLDEN_CASES = [
    (b"ACGTATCATAGACCCTAGATAGGGTTGTGTAGATGATCCACAGACGTATCATAGATTAGATAGGGTTGTGTAGATGATTCCACAG",) * 2,
    (b"AGCACACGTGTGCGCTATACAGTACACGTGTCACAGTTGTACTAGCATGAC",
     b"AGCACACGTGTGCGCTATACAGTAAAAAAAACACGTGTCACAGTTGTACTAGCATGAC"),
    (b"AGCACACGTGTGCGCTATACAGTAAGTAGTAGTACACGTGTCACAGTTGTACTAGCATGAC",
     b"AGCACAAGTGTGCGCTATACAGGAAGTAGGAGTACACGTGTCACATTTGTACTAGCATGAC"),
    (b"CGCTATACAGTAAGTAGTAGTACACGTGTCACAGTTGTACTAGCATGAC",
     b"AGCACAAGTGTGAGCACAAGTGTGCGCTATACAGGAAGTAGGAGTACACGTGTCACATTTGTACTAGCATGAC"),
    (b"AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAGGGGGGGGGGGGGGGGGGGG",
     b"TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTGGGGGGGGGGGGGGGGGGGG"),
]


def _pm1(a, b):
    return 1 if a == b else -1


@pytest.mark.parametrize("case", range(len(_GOLDEN_CASES)))
def test_host_oracle_matches_the_jax_package(case):
    """``banded.Aligner`` against the JAX one: every mode and entry point,
    under a callable scoring (banded.rs's tests) and MatchParams with
    clips."""
    x, y = _GOLDEN_CASES[case]
    for sc, jsc in (
        (Scoring.new(-5, -1, _pm1), JaxScoring.new(-5, -1, _pm1)),
        (Scoring.from_scores(-5, -1, 2, -2).with_clips(-3, -7, -2, -5),
         JaxScoring.from_scores(-5, -1, 2, -2).with_clips(-3, -7, -2, -5)),
    ):
        ours, theirs = banded.Aligner(sc, 10, 10), jax_banded.Aligner(jsc, 10, 10)
        for mode in MODES:
            assert _key(getattr(ours, mode)(x, y)) == _key(getattr(theirs, mode)(x, y)), mode
        h = sparse.hash_kmers(y, 10)
        assert _key(ours.semiglobal_with_prehash(x, y, h)) == _key(theirs.semiglobal_with_prehash(x, y, h))
        m = sparse.find_kmer_matches(x, y, 10)
        assert _key(ours.custom_with_matches(x, y, m)) == _key(theirs.custom_with_matches(x, y, m))
        for allowed, union in ((1, True), (None, False)):
            assert _key(ours.custom_with_expanded_matches(x, y, m, allowed, union)) == _key(
                theirs.custom_with_expanded_matches(x, y, m, allowed, union)
            )


def test_host_oracle_goldens():
    """banded.rs's own expected alignments (tests/test_banded.py)."""
    al = banded.Aligner(Scoring.new(-5, -1, _pm1), 10, 10)
    aln = al.semiglobal(b"ACCGTGGAT", b"AAAAACCGTTGAT")
    assert (aln.ystart, aln.xstart) == (4, 0)
    assert aln.operations == [Match] * 5 + [Subst] + [Match] * 3
    aln = banded.Aligner(Scoring.new(-1, -1, lambda a, b: 1 if a == b else -5), 10, 10).semiglobal(
        b"ACCGTGGAT", b"AAAAACCGTTGAT"
    )
    assert (aln.ystart, aln.xstart) == (4, 0)
    assert aln.operations == [Match] * 4 + [Del, Match, Ins] + [Match] * 3
    aln = banded.Aligner(Scoring.new(-5, -1, lambda a, b: 1 if a == b else -3), 10, 10).global_(b"ACGAGAACA", b"ACGACA")
    assert aln.operations == [Match] * 3 + [Ins] * 3 + [Match] * 3
    aln = al.global_(b"AGATAGATAGATAGGGAGTTGTGTAGATGATCCACAGT", b"AGATAGATAGATGTAGATGATCCACAGT")
    assert aln.operations == [Match] * 11 + [Ins] * 10 + [Match] * 17
    y = b"AACGTACGATACGTGGGTTGTCACACGTGTCGCGCGGCAACACATCAGACTCTAACAGCATCATCAGCACGTGACA"
    aln = banded.Aligner(Scoring.new(-5, -1, lambda a, b: 1 if a == b else -3), 10, 10).local(b"N" * 69, y)
    assert aln.x_aln_len() == 0 and aln.y_aln_len() == 0
    aln = al.local(b"ACGTATCATAGATAGATAGGGTTGTGTAGATGATCCACAG", b"CGTATCATAGATAGATGTAGATGATCCACAGT")
    assert (aln.xstart, aln.ystart) == (1, 0)


# ---- stage by stage: K16, column 0, the fixups, K16-walk ----


@functools.lru_cache(maxsize=None)
def _stage_case(case):
    """One random-band batch through the Pallas K16 (interpret mode) and
    the plain K16, as numpy."""
    pens8 = BANDED_PENS[case]
    arrays = _band_batch(np.random.default_rng(100 + case), B, M, N)
    jx = scan_banded_pallas_mp(*(jnp.asarray(a) for a in arrays[:4]), jnp.asarray(np.array(pens8, np.int32)),
                               *(jnp.asarray(a) for a in arrays[4:]))
    st, en, p8 = banded_inputs(arrays[4], arrays[5], np.array(pens8, np.int32), device="cpu")
    got = sw.scan_banded(*(torch.from_numpy(a) for a in arrays[:4]), p8, st, en)
    return arrays, pens8, [np.asarray(a) for a in jx], [g.numpy() for g in got]


@pytest.mark.parametrize("case", range(len(BANDED_PENS)))
def test_scan_banded_plain_matches_pallas(case):
    """The plain K16 against ``scan_banded_pallas_mp``: tb over columns
    1..nlens, lx, and the finals S, I (one buffer), Sn, Ly, tbk on every
    row."""
    arrays, _, jx, got = _stage_case(case)
    nlens = arrays[3]
    tbj, tbp = jx[0][:N].astype(np.int64), got[0].astype(np.int64)
    for b in range(B):
        np.testing.assert_array_equal(tbp[: nlens[b], :, b], tbj[: nlens[b], :, b], err_msg=str(b))
    np.testing.assert_array_equal(got[1], jx[1][:N])
    for g, w in zip(got[2:], jx[2:]):
        np.testing.assert_array_equal(g, w)


def _jax_glue(case):
    """The JAX twins of column 0, the fixups and the walk on the Pallas
    scan's outputs (``_align_batch_device_banded_mp``'s steps)."""
    arrays, pens8, jx, _ = _stage_case(case)
    xb, yb, ml, nl, st, en = (jnp.asarray(a) for a in arrays)
    pens = tuple(jnp.int32(v) for v in pens8[:6])
    tb_cols, lx_cols, S_f, I_f, Sn_f, Ly_f, tbk = (jnp.asarray(a) for a in jx)
    bidx = jnp.arange(B)
    fix = jax_bd._banded_suffix_fixups(S_f, I_f, Sn_f, Ly_f, tbk, B, M, ml, nl, pens, st[bidx, nl], en[bidx, nl])
    rows = jnp.broadcast_to(jnp.arange(M + 1, dtype=jnp.int32)[None, :], (B, M + 1))
    tb_col0, Lx0 = jax_bd._init_column_banded(B, M, rows, ml, nl, pens, st[:, 0], en[:, 0])
    score, cells, ly_fixed, lx_n, lx_set = fix
    tb_xb = jnp.concatenate([jnp.transpose(tb_col0, (1, 0)).astype(jnp.uint16)[None], tb_cols[:N]], axis=0)
    tbfix = (cells & 0xFFF) | (ly_fixed << 12)
    Lx_full = jnp.concatenate([Lx0[:, None], jnp.transpose(lx_cols[:N], (1, 0))], axis=1)
    Lx_full = Lx_full.at[bidx, nl].set(jnp.where(lx_set, lx_n, Lx_full[bidx, nl]))
    out = jax_bd._walk_banded(tb_xb.reshape(-1, B), tbfix, Lx_full, ml, nl, B, M, N, pens)
    return [np.asarray(a) for a in fix], np.asarray(tb_col0), np.asarray(Lx0), np.asarray(Lx_full), np.asarray(tbfix), out


@pytest.mark.parametrize("case", range(len(BANDED_PENS)))
def test_banded_glue_and_walk_match_jax(case):
    """``_init_column_banded``, ``_banded_suffix_fixups`` and the plain
    K16-walk against their JAX twins on the same scan."""
    arrays, pens8, jx, _ = _stage_case(case)
    fix_j, tb0_j, lx0_j, lx_full_j, tbfix_j, walk_j = _jax_glue(case)
    xb, yb, ml, nl, st, en = (torch.from_numpy(a) for a in arrays)
    S_f, I_f, Sn_f, Ly_f, tbk = (torch.from_numpy(np.array(a)) for a in jx[2:])
    bidx = torch.arange(B)
    fix = bd._banded_suffix_fixups(S_f, I_f, Sn_f, Ly_f, tbk, B, M, ml, nl, pens8[:6], st[bidx, nl.long()],
                                   en[bidx, nl.long()])
    for g, w in zip(fix, fix_j):
        np.testing.assert_array_equal(g.numpy(), w)
    rows = torch.arange(M + 1, dtype=torch.int32)[None, :]
    tb0, lx0 = bd._init_column_banded(B, M, rows, ml, nl, pens8[:6], st[:, 0], en[:, 0])
    np.testing.assert_array_equal(tb0.numpy(), tb0_j)
    np.testing.assert_array_equal(lx0.numpy(), lx0_j)
    tb = torch.from_numpy(np.array(jx[0][:N]))
    tbfix, lx_full = torch.from_numpy(np.array(tbfix_j)), torch.from_numpy(np.array(lx_full_j))
    got = walk.walk_banded(tb, tb0, tbfix, lx_full, ml, nl, pens8[:6])
    T = M + N + 8
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(walk_j["op_codes"])[:T])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(walk_j["op_lens"])[:T])
    for g, name in zip(got[2:], ("xstart", "ystart", "xend", "yend")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(walk_j[name]), err_msg=name)


def test_banded_inputs_carry_the_jax_arrays():
    st = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    got = banded_inputs(st, st + 2, np.arange(8, dtype=np.int32) - 7, device="cpu")
    assert got[0].dtype == torch.int32 and np.array_equal(got[1].numpy(), st + 2)
    assert got[2] == tuple(range(-7, 1))
    with pytest.raises(ValueError):
        banded_inputs(st, st, np.arange(7), device="cpu")


# ---- end to end against the JAX BatchBandedAligner ----


def _both(sc_args, k, w, clips=None, **kw):
    sc = Scoring.from_scores(*sc_args)
    jsc = JaxScoring.from_scores(*sc_args)
    if clips is not None:
        sc, jsc = sc.with_clips(*clips), jsc.with_clips(*clips)
    return BatchBandedAligner(sc, k, w, device="cpu", **kw), jax_bd.BatchBandedAligner(jsc, k, w)


@functools.lru_cache(maxsize=None)
def _gen_batch():
    rng = np.random.default_rng(11)
    pairs = [_gen_pair(rng) for _ in range(12)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("mode", MODES)
def test_batch_banded_aligner_matches_jax(mode):
    xs, ys = _gen_batch()
    ours, theirs = _both((-5, -1, 2, -2), 5, 8, (-3, -7, -2, -5))
    _assert_same(getattr(ours, mode)(xs, ys), getattr(theirs, mode)(xs, ys), mode)


@pytest.mark.parametrize("mode", ["custom", "semiglobal", "local"])
def test_short_y_bands_that_never_reach_row_m(mode):
    """y cut to a third in every third pair: bands that end above row m
    (the final column's stale-cell regime), another (k, w)."""
    rng = np.random.default_rng(7)
    pairs = []
    for t in range(8):
        x, y = _gen_pair(rng, mmax=60, nmax=70)
        pairs.append((x, y[: max(8, len(y) // 3)] if t % 3 == 2 else y))
    xs, ys = [p[0] for p in pairs], [p[1] for p in pairs]
    ours, theirs = _both((-5, -1, 2, -2), 6, 10)
    _assert_same(getattr(ours, mode)(xs, ys), getattr(theirs, mode)(xs, ys), mode)


def test_no_match_full_matrix_and_golden_case():
    rng = np.random.default_rng(3)
    xs = [rng.choice(list(b"AC"), size=20).astype(np.uint8).tobytes() for _ in range(4)]
    ys = [rng.choice(list(b"GT"), size=25).astype(np.uint8).tobytes() for _ in range(4)]
    ours, theirs = _both((-4, -1, 1, -1), 8, 4)
    _assert_same(ours.global_(xs, ys), theirs.global_(xs, ys))
    x = b"AAAAACCCCCAAAAACCCCCAAAAACCCCCAAAAACCCCC"
    z = b"AAAAACCCCCAAAAAGCCCCAAAAACCCCCAAAAACCCCC"
    ours, theirs = _both((-5, -1, 1, -1), 8, 6)
    got = ours.semiglobal([x, x], [x, z])
    _assert_same(got, theirs.semiglobal([x, x], [x, z]))
    want = [banded.Aligner(Scoring.from_scores(-5, -1, 1, -1), 8, 6).semiglobal(x, yy) for yy in (x, z)]
    _assert_same(got, want)


@pytest.mark.parametrize("mode", ["semiglobal", "local", "custom"])
def test_crop_at_every_tail_parity_and_offset(mode):
    """Free y clips: 30-120 bp reads in 400-1,600 bp targets at offsets 0,
    1, n - m, n - m - 1 and random ones, through the column-window crop,
    against the host oracle and (semiglobal, local) the JAX package; custom
    mode keeps the clip ops, where the JAX package's patch-back departs
    from the oracle (``test_crop_keeps_one_y_suffix_clip``)."""
    xs, ys = _banded_pairs(np.random.default_rng(59), 12, long_targets=True)
    ours, theirs = _both((-5, -1, 2, -2), 8, 8, (-3, -7, 0, 0))
    got = getattr(ours, mode)(xs, ys)
    oracle = banded.Aligner(ours.scoring, 8, 8)
    _assert_same(got, [getattr(oracle, mode)(x, y) for x, y in zip(xs, ys)], mode)
    if mode != "custom":
        _assert_same(got, getattr(theirs, mode)(xs, ys), mode)
    tails = {len(y) - a.yend for a, y in zip(got, ys)}
    assert 0 in tails and len(tails) > 2


def test_crop_keeps_one_y_suffix_clip():
    """Custom mode on the crop path when the alignment ends in a y-suffix
    clip followed by an x-suffix clip: one Yclip of the tail, as the host
    oracle gives (the JAX package appends a second Yclip of the same
    length; ROADMAP Queue 3), and a lone prefix Yclip in an alignment of
    clips only stays the prefix's."""
    sc = Scoring.from_scores(-6, -1, 1, -4).with_clips(-5, -5, 0, 0)
    xs, ys = [b"TGAGCCTC", b"AC" * 10], [b"TTGAGCGTACGA", b"GT" * 20]
    got = BatchBandedAligner(sc, 4, 4, device="cpu").custom(xs, ys)
    oracle = banded.Aligner(sc, 4, 4)
    _assert_same(got, [oracle.custom(x, y) for x, y in zip(xs, ys)])
    assert got[0].operations[-2:] == [Yclip(6), Xclip(3)]
    jax_ops = jax_bd.BatchBandedAligner(JaxScoring.from_scores(-6, -1, 1, -4).with_clips(-5, -5, 0, 0), 4, 4).custom(
        xs, ys
    )[0].operations
    assert jax_ops[-3:] == [Yclip(6), Xclip(3), Yclip(6)]


def test_max_cells_exceeded(monkeypatch):
    """A band over MAX_CELLS gives the host's empty MIN_SCORE alignment
    beside pairs that run on the device."""
    for mod in (banded, bd, jax_banded, jax_bd):
        monkeypatch.setattr(mod, "MAX_CELLS", 600)
    xs, ys = _gen_batch()
    xs = xs + [b"AC" * 20]
    ys = ys + [b"GT" * 20]  # no match: the full 41 x 41 matrix
    ours, theirs = _both((-5, -1, 2, -2), 5, 8)
    got = ours.semiglobal(xs, ys)
    _assert_same(got, theirs.semiglobal(xs, ys))
    assert got[-1].score == MIN and got[-1].operations == []
    assert any(a.score != MIN for a in got)


def test_window_wider_than_wcap_runs_the_host_oracle():
    """A chain across 1,200 columns (gap_extend 0 keeps its pieces
    together) crops to a window wider than ``wcap`` (1,024): that pair runs
    the host oracle, the others the device."""
    rng = np.random.default_rng(17)
    y = _dna(rng, 1600)
    xs = [y[100:140] + y[1300:1340], y[500:560], y[900:950]]
    ys = [y, y, y]
    sc_args = (-1, 0, 2, -2)
    out = native.band_build_batch(
        np.frombuffer(xs[0], np.uint8)[None], np.array([80]), np.frombuffer(y, np.uint8)[None], np.array([1600]),
        8, 8, (MIN, MIN, 0, 0), 2, 1, 0, True, 1024,
    )
    assert out[3][0] == -1
    ours, theirs = _both(sc_args, 8, 8)
    got = ours.semiglobal(xs, ys)
    _assert_same(got, theirs.semiglobal(xs, ys))
    want = banded.Aligner(Scoring.from_scores(*sc_args).with_clips(MIN, MIN, 0, 0), 8, 8).semiglobal(xs[0], y)
    assert _key(got[0]) == _key(want)


# an empty y only in global mode: under these clips the oracle's traceback,
# and the JAX package's, never ends there (ROADMAP Queue 3)
_HOST_CASES = {
    "empty_x": ([b"", b"ACGTACGTAC"], [b"ACGT", b"ACGTTCGTAC"], MODES),
    "empty_y": ([b"ACGTACGTAC", b"ACGT"], [b"ACGTTCGTAC", b""], ["global_"]),
    "m_is_1": ([b"A", b"C"], [b"ACGTACGT", b"CCCC"], MODES),
}


@pytest.mark.parametrize("case", sorted(_HOST_CASES))
def test_host_routed_shapes(case):
    """Empty x or y and M = 1 run the host oracle per pair."""
    xs, ys, modes = _HOST_CASES[case]
    for mode in modes:
        ours, theirs = _both((-5, -1, 2, -2), 3, 4, (-3, -7, -2, -5))
        _assert_same(getattr(ours, mode)(xs, ys), getattr(theirs, mode)(xs, ys), (case, mode))


@pytest.mark.parametrize("mode", MODES)
def test_empty_pairs_leave_the_others_on_the_device(mode, monkeypatch):
    """An empty x (every mode) or an empty y (global mode) runs the host
    oracle for its own pair only: K16 gets the batch's other pairs, and the
    alignments equal the JAX package's (which sends the whole batch to its
    host pipeline) and the oracle's."""
    xs, ys = _gen_batch()
    xs, ys = [b""] + xs, [b"ACGTAC"] + ys
    if mode == "global_":
        xs, ys = xs + [b"ACGTTGCA"], ys + [b""]
    lanes = []
    real = sw.scan_banded

    def counted(xb, *a):
        lanes.append(xb.shape[0])
        return real(xb, *a)

    monkeypatch.setattr(sw, "scan_banded", counted)
    ours, theirs = _both((-5, -1, 2, -2), 5, 8, (-3, -7, -2, -5))
    got = getattr(ours, mode)(xs, ys)
    assert lanes == [len(_gen_batch()[0])]
    _assert_same(got, getattr(theirs, mode)(xs, ys), mode)
    oracle = banded.Aligner(ours.scoring, 5, 8)
    _assert_same(got[:1], [getattr(oracle, mode)(xs[0], ys[0])], mode)


# clips under which an empty y's traceback repeats a clip of length 0 at
# (m, 0) or (0, 0) forever in the reference (ROADMAP Queue 3)
_ENDLESS = {
    "custom_all_clips": ((-3, -7, -2, -5), "custom"),
    "local": ((0, 0, 0, 0), "local"),
    "x_prefix_clip_only": ((0, MIN, MIN, MIN), "custom"),
    "x_suffix_clip_only": ((MIN, 0, MIN, MIN), "custom"),
}


@pytest.mark.parametrize("case", sorted(_ENDLESS))
def test_endless_empty_y_traceback_raises(case):
    """Where the reference oracle (and the JAX package's) never returns on
    an empty y, the port's oracle raises ``ValueError``, and so does a batch
    holding such a pair; the empty-y cases that end keep the JAX oracle's
    answer."""
    clips, mode = _ENDLESS[case]
    sc = Scoring.from_scores(-5, -1, 2, -2).with_clips(*clips)
    with pytest.raises(ValueError, match="does not end"):
        getattr(banded.Aligner(sc, 3, 4), mode)(b"ACGT", b"")
    with pytest.raises(ValueError, match="does not end"):
        getattr(BatchBandedAligner(sc, 3, 4, device="cpu"), mode)([b"ACGT", b"ACGTTGCA"], [b"", b"ACGTTGCA"])
    for clips_end, mode_end in (((MIN,) * 4, "global_"), ((MIN, MIN, 0, 0), "semiglobal"), ((MIN, MIN, -2, -5), "custom")):
        args = (-5, -1, 2, -2)
        ours = banded.Aligner(Scoring.from_scores(*args).with_clips(*clips_end), 3, 4)
        theirs = jax_banded.Aligner(JaxScoring.from_scores(*args).with_clips(*clips_end), 3, 4)
        for x in (b"A", b"ACGT", b"ACGTTTGA"):
            _assert_same([getattr(ours, mode_end)(x, b"")], [getattr(theirs, mode_end)(x, b"")], (mode_end, x))


def test_host_routed_scorings():
    """gap_open > gap_extend, BLOSUM62 and a callable run the host oracle
    per pair, as the JAX package's host routes give."""
    xs, ys = _gen_batch()
    xs, ys = xs[:5], ys[:5]
    cases = [
        (Scoring.from_scores(-1, -3, 2, -2), JaxScoring.from_scores(-1, -3, 2, -2)),
        (Scoring.new(-11, -1, scores.blosum62), JaxScoring.new(-11, -1, jax_scores.blosum62)),
        (Scoring.new(-5, -1, _pm1), JaxScoring.new(-5, -1, _pm1)),
    ]
    for sc, jsc in cases:
        ours = BatchBandedAligner(sc, 5, 8, device="cpu")
        theirs = jax_bd.BatchBandedAligner(jsc, 5, 8)
        for mode in MODES:
            _assert_same(getattr(ours, mode)(xs, ys), getattr(theirs, mode)(xs, ys), mode)


@pytest.mark.parametrize("mode", MODES)
def test_sub_batches_equal_one_batch(mode, monkeypatch):
    """A tb budget of one byte runs every lane as its own sub-batch: the
    same alignments as one batch."""
    xs, ys = _gen_batch()
    sc = Scoring.from_scores(-5, -1, 2, -2).with_clips(-3, -7, -2, -5)
    one = getattr(BatchBandedAligner(sc, 5, 8, device="cpu"), mode)(xs, ys)
    monkeypatch.setattr(bd, "TB_BUDGET_MAX", 1)
    split = BatchBandedAligner(sc, 5, 8, device="cpu")
    handle = split._run_async(xs, ys, *_mode_args(split, mode))
    assert len(handle[1]) == len(xs)
    _assert_same(split._run_finish(handle), one, mode)


def _mode_args(al, mode):
    s = al.scoring
    return {
        "custom": (s, bd.AlignmentMode.Custom, False),
        "global_": (s.with_clips(*((MIN,) * 4)), bd.AlignmentMode.Global, False),
        "semiglobal": (s.with_clips(MIN, MIN, 0, 0), bd.AlignmentMode.Semiglobal, True),
        "local": (s.with_clips(0, 0, 0, 0), bd.AlignmentMode.Local, True),
    }[mode]


def test_pipelined_semiglobal_from_an_executor(monkeypatch):
    """``semiglobal_async`` on a one-thread executor, each handle finished
    while the next batch is built (the JAX bench's pipeline), equals
    ``semiglobal``; ``_run_async`` reads nothing back from the tensors it
    starts and does not check lengths on them."""
    rng = np.random.default_rng(23)
    batches = [_banded_pairs(rng, 10, long_targets=True) for _ in range(3)]
    al = BatchBandedAligner(Scoring.from_scores(-5, -1, 2, -2), 8, 8, device="cpu")
    want = [al.semiglobal(xs, ys) for xs, ys in batches]

    def no_read_back(*_a, **_k):
        raise AssertionError("_run_async read a tensor back")

    monkeypatch.setattr(sw, "check_lengths", no_read_back)
    with monkeypatch.context() as mp:
        for name in ("cpu", "item", "tolist", "numpy"):
            mp.setattr(torch.Tensor, name, no_read_back)
        handles = [al.semiglobal_async(*batches[0])]
    got = []
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(al.semiglobal_async, *batches[0])
        for nxt in range(1, len(batches)):
            h = fut.result()
            fut = pool.submit(al.semiglobal_async, *batches[nxt])
            got.append(al.semiglobal_finish(h))
        got.append(al.semiglobal_finish(fut.result()))
    for g, w in zip(got, want):
        _assert_same(g, w)
    _assert_same(al.semiglobal_finish(handles[0]), want[0])
