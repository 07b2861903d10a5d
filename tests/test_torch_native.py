"""The port's host C++ against the JAX package on the CPU: the column-RLE
CIGAR emitter (``native.cigars_colrle``, the first route of
``PackedSemiglobal.cigars``) against the port's numpy merge
(``cigars_plain``) and the JAX ``native.cigars_colrle``, with rows that
overflow the emitter's buffer; the SA-IS bindings ``sais`` and
``sais_u32`` against the JAX ``suffix_array`` and ``native.sais_u32`` and
the port's prefix doubling, on texts with several sentinels; the host
route of ``suffix_array``; and the library's build. Integers and strings
throughout: every comparison is exact (tolerance 0)."""

import ctypes

import numpy as np
import pytest
import torch

from rust_bio_tpu import native as jax_native
from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu.data_structures.suffix_array import suffix_array as jax_suffix_array
from rust_bio_tpu.data_structures.suffix_array import transform_text as jax_transform_text
from rust_bio_tpu_torch import native
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
from rust_bio_tpu_torch.alphabets import Alphabet
from rust_bio_tpu_torch.data_structures import suffix_array as sa_mod


def _mapper_pairs(rng, B=32):
    """Reads cut from random windows with a few substitutions (the read
    mapper's extension geometry, tests/test_read_mapper.py:431)."""
    xs, ys = [], []
    for _ in range(B):
        N = int(rng.integers(30, 200))
        y = rng.choice(list(b"ACGT"), size=N).astype(np.uint8).tobytes()
        M = int(rng.integers(5, min(80, N)))
        s = int(rng.integers(0, N - M))
        x = bytearray(y[s : s + M])
        for _ in range(int(rng.integers(0, 6))):
            x[int(rng.integers(0, M))] = int(rng.choice(list(b"ACGT")))
        xs.append(bytes(x))
        ys.append(y)
    return xs, ys


def _emit_args(packed):
    up = packed._up
    N = int(packed.nlens.max())
    return (
        up["exit_op"][:N].T, up["ins_cnt"][:N].T, packed.nlens, packed.mlens, up["ins0"],
        up["fix_exit"], up["fix_ins"], packed.xstart, packed.xend,
    )


@pytest.mark.parametrize("mode", ["semiglobal", "global"])
def test_cigar_emitter_matches_numpy_merge_and_jax(mode):
    """The emitter's strings equal the numpy merge's and the JAX emitter's
    on semiglobal and global batches (clips, ragged lengths), and
    ``cigars()`` returns them."""
    rng = np.random.default_rng(83)
    xs, ys = _mapper_pairs(rng)
    packed = getattr(BatchAligner(Scoring.from_scores(-5, -1, 2, -2), device="cpu"), f"{mode}_packed")(xs, ys)
    args = _emit_args(packed)
    got = native.cigars_colrle(*args)
    assert None not in got
    assert got == packed.cigars_plain() == packed.cigars()
    assert got == jax_native.cigars_colrle(*args)
    jax_packed = getattr(JaxBatchAligner(JaxScoring.from_scores(-5, -1, 2, -2)), f"{mode}_packed")(xs, ys)
    assert got == jax_packed.cigars()
    assert native.cigars_colrle(*args, nthreads=1) == got


def test_cigar_emitter_overflow_rows_take_the_numpy_merge(monkeypatch):
    """A row whose string passes the emitter's buffer comes back ``None``
    and ``cigars()`` formats it by the numpy merge; the other rows keep the
    emitter's strings (the JAX binding gives up on the whole batch)."""
    rng = np.random.default_rng(84)
    xs, ys = _mapper_pairs(rng, 16)
    xs[3] = bytes(rng.choice(list(b"ACGT"), size=len(xs[3])).astype(np.uint8))  # many runs
    packed = BatchAligner(Scoring.from_scores(-5, -1, 2, -2), device="cpu").semiglobal_packed(xs, ys)
    want = packed.cigars_plain()
    args = _emit_args(packed)
    cap = len(want[3]) - 1  # row 3's string overflows, a short row fits
    got = native.cigars_colrle(*args, cap=cap)
    assert got[3] is None
    assert all(g is None or g == w for g, w in zip(got, want))
    assert sum(g is not None for g in got) > 0
    assert jax_native.cigars_colrle(*args) == want
    real = native.cigars_colrle
    calls = []

    def small_cap(*a, **k):
        calls.append(1)
        return real(*a, cap=cap)

    monkeypatch.setattr(native, "cigars_colrle", small_cap)
    assert packed.cigars() == want and calls


def test_cigar_emitter_rejects_bad_shapes():
    ex = np.zeros((2, 3), np.uint16)
    lanes = [np.zeros(2, np.int32)] * 7
    with pytest.raises(ValueError, match="equal"):
        native.cigars_colrle(ex, np.zeros((2, 4), np.uint16), *lanes)
    with pytest.raises(ValueError, match="nlens"):
        native.cigars_colrle(ex, ex, np.array([1, 4], np.int32), *lanes[1:])


def _texts(rng, trials):
    """Texts of 2-500 symbols over ACGTN with 1-3 sentinels
    (tests/test_native.py:21)."""
    for _ in range(trials):
        n = int(rng.integers(2, 500))
        nseq = int(rng.integers(1, 4))
        parts = [rng.choice(list(b"ACGTN"), size=max(n // nseq, 1)).astype("uint8").tobytes() for _ in range(nseq)]
        yield b"$".join(parts) + b"$"


def test_sais_matches_jax_and_prefix_doubling():
    """``sais`` and ``sais_u32`` on the rank-recoded text equal the JAX
    ``suffix_array`` and ``native.sais_u32`` and the port's prefix
    doubling; ``suffix_array(..., device="cpu")`` takes the native route
    for a text that is not a tensor, the doubling for a tensor."""
    rng = np.random.default_rng(0)
    for text in _texts(rng, 25):
        arr = np.frombuffer(text, np.uint8)
        tr = sa_mod.transform_text_host(arr)
        jtr = jax_transform_text(arr, Alphabet(text), int((arr == arr[-1]).sum()))
        np.testing.assert_array_equal(tr, jtr.astype(np.int64))
        want = np.asarray(jax_suffix_array(text))
        got = native.sais(tr, int(tr.max()) + 1)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=str(text))
        u = native.sais_u32(tr, int(tr.max()) + 1)
        assert u.dtype == np.uint32
        np.testing.assert_array_equal(u, jax_native.sais_u32(jtr, int(jtr.max()) + 1))
        np.testing.assert_array_equal(u.astype(np.int64), want)
        t = torch.from_numpy(arr.copy())
        doubling = sa_mod._sa_prefix_doubling(
            sa_mod.transform_text(t, Alphabet(text), sa_mod._sentinel_count(t))
        )
        np.testing.assert_array_equal(doubling.numpy(), want)
        np.testing.assert_array_equal(sa_mod.suffix_array(text, device="cpu").numpy(), want)
        np.testing.assert_array_equal(sa_mod.suffix_array(t).numpy(), want)


def test_sais_wide_alphabets_and_golden():
    """An integer text over more than 256 symbols runs the int64 kernel;
    ``sais_u32`` refuses it; the reference's golden array."""
    rng = np.random.default_rng(5)
    t = rng.integers(1, 1000, size=300).astype(np.int64)
    t[-1] = 0
    want = jax_native.sais(t, 1000)
    np.testing.assert_array_equal(native.sais(t, 1000), want)
    with pytest.raises(ValueError, match="byte"):
        native.sais_u32(t, 1000)
    assert sa_mod.suffix_array_host(b"GCCTTAACATTATTACGCCTA$").tolist() == [
        21, 20, 5, 6, 14, 11, 8, 7, 17, 1, 15, 18, 2, 16, 0, 19, 4, 13, 10, 3, 12, 9,
    ]
    with pytest.raises(ValueError, match="sentinel"):
        sa_mod.suffix_array_host(b"ACGT$A")


def test_host_library_builds_every_source(monkeypatch, tmp_path):
    """The SAIS and CIGAR entry points live in the band builder's library
    (one ``c++`` build of both sources); a failing extra source raises with
    the compiler's message."""
    lib = native.get_lib()
    for name in ("sais_u8_i32", "sais_u8_u32", "sais_u8_i64", "sais_i64", "cigars_colrle", "band_build_batch"):
        assert isinstance(getattr(lib, name), ctypes._CFuncPtr)
    bad = tmp_path / "host_index.cpp"
    bad.write_text("not C++ either\n")
    monkeypatch.setattr(native, "EXTRA_SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.library_path()
