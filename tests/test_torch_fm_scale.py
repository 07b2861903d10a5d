"""The port's genome-scale FM index against the JAX package on the CPU: the
uint32 index (``force_u32``: K4 and K4-locate's uint32 instantiations,
plain here), the q-mer table (``build_kmer_lut``), K4-LUT
(``_search_kernel_lut``, ``search_batch_lut``) with its miss mask, ``occ``,
``_rank_all``, ``ensure_row_layout`` and ``bwt_host``, the chunked
bit-plane build, the host suffix-array route of ``from_text``, and index
files with a table or uint32 arrays loaded through ``carry``. Integers
throughout: every comparison is exact (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.alphabets import dna as jax_dna
from rust_bio_tpu.data_structures.bwt import bwt as jax_bwt
from rust_bio_tpu.data_structures.fm_device import DeviceFMIndex as JaxDeviceFMIndex
from rust_bio_tpu.data_structures.fm_device import _pack_bitplanes as jax_pack_bitplanes
from rust_bio_tpu.data_structures.serialize import save_fm_index
from rust_bio_tpu.data_structures.suffix_array import suffix_array as jax_suffix_array
from rust_bio_tpu_torch.alphabets import dna
from rust_bio_tpu_torch.carry import load_fm_index
from rust_bio_tpu_torch.data_structures import fm_device
from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
from rust_bio_tpu_torch.ops import fm as fm_ops

Q = 5  # the table's q at these text sizes (the JAX tests' q)


def _text(rng, n, alphabet=b"ACGT"):
    return rng.choice(list(alphabet), size=n).astype(np.uint8).tobytes() + b"$"


def _indexes(text, force_u32, s=8):
    """(JAX index, port index) over ``text`` with the same suffix array."""
    sa = np.asarray(jax_suffix_array(text))
    b = jax_bwt(text, sa)
    jax_idx = JaxDeviceFMIndex(b, jax_dna.n_alphabet(), sa=sa, sampling_rate=s, force_u32=force_u32)
    port = DeviceFMIndex(np.asarray(b), dna.n_alphabet(), sa=sa, sampling_rate=s, device="cpu", force_u32=force_u32)
    return jax_idx, port


def _patterns(rng, text, B, L, q=Q):
    """Complete, partial (one base written), absent and shorter-than-q
    lanes, a few with a byte outside A, C, G, T."""
    tarr = np.frombuffer(text, np.uint8)
    n = len(tarr) - 1
    pats = np.zeros((B, L), np.uint8)
    plens = np.zeros(B, np.int32)
    for b in range(B):
        kind = b % 4
        ln = int(rng.integers(1, q)) if kind == 3 else int(rng.integers(q, L + 1))
        if kind == 0:
            s = int(rng.integers(0, n - ln))
            p = tarr[s : s + ln].copy()
        elif kind == 1:
            s = int(rng.integers(0, n - ln))
            p = tarr[s : s + ln].copy()
            p[int(rng.integers(0, ln))] = rng.choice(list(b"ACGT"))
        else:
            p = rng.choice(list(b"ACGT"), size=ln).astype(np.uint8)
        if b % 16 == 5:
            p[-1 - int(rng.integers(0, min(ln, q)))] = ord("N")
        pats[b, :ln] = p
        plens[b] = ln
    return pats, plens


def _np(outs):
    return [np.asarray(o).astype(np.int64) for o in outs]


@pytest.mark.parametrize("trial", range(4))
def test_force_u32_search_and_locate_match_jax(trial):
    """The uint32 index (test_fmindex.py:399's texts: 200-2500 bp, s = 8)
    answers as the JAX ``force_u32`` index and as the port's int32 index."""
    rng = np.random.default_rng(500 + trial)
    text = _text(rng, int(rng.integers(200, 2500)))
    jax_u, port_u = _indexes(text, True)
    _, port_i = _indexes(text, False)
    assert port_u._big and not port_i._big
    np.testing.assert_array_equal(fm_ops.u32(port_u.less).numpy(), np.asarray(jax_u.less).astype(np.int64))
    pats, plens = _patterns(rng, text, 48, 14)
    want = _np(jax_u._search_kernel(jnp.asarray(pats), jnp.asarray(plens)))
    got_u = port_u.search_arrays(torch.from_numpy(pats), torch.from_numpy(plens))
    assert got_u[1].dtype == torch.int64 and got_u[0].dtype == torch.int32
    got_i = port_i.search_arrays(torch.from_numpy(pats), torch.from_numpy(plens))
    for w, gu, gi in zip(want, _np(got_u), _np(got_i)):
        np.testing.assert_array_equal(gu, w)
        np.testing.assert_array_equal(gi, w)
    rows = np.arange(port_u.n)
    want_pos = np.asarray(jax_u.locate_batch(rows.astype(np.uint32))).astype(np.int64)
    np.testing.assert_array_equal(port_u.locate_batch(rows), want_pos)
    np.testing.assert_array_equal(port_i.locate_batch(rows).astype(np.int64), want_pos)
    np.testing.assert_array_equal(port_u.locate_rows(torch.from_numpy(rows)).numpy(), want_pos)


def test_u32_wrappers_take_rows_past_int32():
    """The uint32 wrappers on rows and values past 2^31: a row outside
    [0, n) gives 0xFFFFFFFF (the uint32 -1), and positions come back as
    int64 uint32 values."""
    rng = np.random.default_rng(7)
    text = _text(rng, 600)
    _, port = _indexes(text, True, s=4)
    tables = (port._fused, port.bwt_sym, port.less_sym, port.sa_sample, port.sent_rows, port.sent_vals)
    rows = torch.tensor([0, 5, port.n, 2**31 + 3, 2**32 - 1], dtype=torch.int64)
    got = fm_ops.locate(*tables, (rows & fm_ops.U32_MASK).to(torch.int32), port.s, big=True)
    sa = np.asarray(jax_suffix_array(text))
    assert got.dtype == torch.int64
    assert got.tolist() == [sa[0], sa[5], 2**32 - 1, 2**32 - 1, 2**32 - 1]


@pytest.mark.parametrize("force_u32", [False, True])
def test_kmer_lut_matches_jax(force_u32):
    """``build_kmer_lut(q=5)`` on the fused table equals JAX's host build
    over its (n, 4) cumulative counts, in both index modes, and a text
    without some DNA bytes."""
    rng = np.random.default_rng(31 + force_u32)
    for text in (_text(rng, 3000), _text(rng, 500, b"ACG")):
        jax_idx, port = _indexes(text, force_u32)
        jax_idx.build_kmer_lut(q=Q)
        port.build_kmer_lut(q=Q)
        assert port._lut.shape == (4**Q, 2) and port._lut.dtype == torch.int32
        lut = fm_ops.u32(port._lut) if force_u32 else port._lut.long()
        np.testing.assert_array_equal(lut.numpy(), np.asarray(jax_idx._lut).astype(np.int64))
        np.testing.assert_array_equal(port._lut_rank.numpy(), jax_idx._lut_rank)


@pytest.mark.parametrize("force_u32", [False, True])
def test_search_lut_matches_jax(force_u32):
    """``search_batch_lut`` equals JAX's and K4's on complete, partial,
    absent and shorter-than-q lanes (test_fmindex.py:357); the plain K4-LUT's
    miss mask equals the JAX ``_search_kernel_lut``'s, and on the lanes that
    hit, its outputs equal JAX's."""
    rng = np.random.default_rng(91 + force_u32)
    text = _text(rng, 3000)
    jax_idx, port = _indexes(text, force_u32)
    jax_idx.build_kmer_lut(q=Q)
    port.build_kmer_lut(q=Q)
    pats, plens = _patterns(rng, text, 96, 12)
    want = _np(jax_idx.search_batch_lut(pats, plens))
    got = _np(port.search_batch_lut(pats, plens))
    k4 = _np(port.search_arrays(torch.from_numpy(pats), torch.from_numpy(plens)))
    for name, g, w, k in zip(("status", "lower", "upper", "mlen"), got, want, k4):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(k, w, err_msg=name)
    jax_out = jax_idx._search_kernel_lut(jnp.asarray(pats), jnp.asarray(plens))
    jax_miss = np.asarray(jax_out[4])
    port_out = port._search_kernel_lut(torch.from_numpy(pats), torch.from_numpy(plens))
    np.testing.assert_array_equal(port_out[4].numpy(), jax_miss)
    assert jax_miss.any() and not jax_miss.all()
    for g, w in zip(_np(port_out[:4]), _np(jax_out[:4])):
        np.testing.assert_array_equal(g[~jax_miss], w[~jax_miss])
    assert set(got[0].tolist()) == {fm_ops.ABSENT, fm_ops.PARTIAL, fm_ops.COMPLETE}


def test_search_lut_wrapper_contract():
    """K4-LUT's wrapper: the table must be built, its shape match q, and q
    lie in [1, 15]."""
    rng = np.random.default_rng(3)
    _, port = _indexes(_text(rng, 400), False)
    pats = torch.zeros((2, 6), dtype=torch.uint8)
    plens = torch.tensor([6, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="build_kmer_lut"):
        port.search_arrays_lut(pats, plens)
    port.build_kmer_lut(q=3)
    with pytest.raises(ValueError, match="lut"):
        fm_ops.search_lut(port._fused, port._less256, port.sym_of, port._lut_rank, port._lut, 4, pats, plens, port.n)
    with pytest.raises(ValueError, match="q = 16"):
        port.build_kmer_lut(q=16)


@pytest.mark.parametrize("force_u32", [False, True])
def test_occ_rank_all_and_row_layout_match_jax(force_u32):
    """``occ`` at every position and -1 (test_fmindex.py:135), ``_rank_all``
    over ``ensure_row_layout``'s table, and ``bwt_host``, against JAX."""
    rng = np.random.default_rng(4)
    text = _text(rng, 300)
    jax_idx, port = _indexes(text, force_u32)
    rs = np.arange(-1, port.n, dtype=np.int64)
    for a in b"ACGT$N":
        want = np.asarray(jax_idx.occ(jnp.asarray(rs.astype(np.uint32 if force_u32 else np.int32)), jnp.full(rs.shape, a)))
        got = port.occ(torch.from_numpy(rs), torch.full(rs.shape, a))
        np.testing.assert_array_equal(got.numpy(), want)
    rows = port.ensure_row_layout()
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jax_idx.ensure_row_layout()))
    assert port.ensure_row_layout() is rows
    r = rng.integers(-1, port.n, size=200).astype(np.int32)
    want = np.asarray(jax_idx._rank_all(jnp.asarray(r), jax_idx.ensure_row_layout()))
    np.testing.assert_array_equal(port._rank_all(torch.from_numpy(r), rows).numpy(), want)
    np.testing.assert_array_equal(port.bwt_host(), jax_idx.bwt_host())


def test_chunked_bitplanes_match_jax(monkeypatch):
    """The bit-plane build a chunk at a time (here 64 symbols, so the
    checkpoints carry over chunk seams) equals JAX's whole-array build."""
    monkeypatch.setattr(fm_device, "_CHUNK", 64)
    rng = np.random.default_rng(12)
    text = _text(rng, 1000)
    b = np.asarray(jax_bwt(text, jax_suffix_array(text)))
    symbols = sorted(set(jax_dna.n_alphabet().symbols()) | set(np.unique(b).tolist()))
    jbits, jckpt = jax_pack_bitplanes(b, symbols)
    bits, ckpt = fm_device._pack_bitplanes(torch.from_numpy(b), symbols)
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), jbits)
    np.testing.assert_array_equal(ckpt.numpy(), jckpt)
    port = DeviceFMIndex(b, dna.n_alphabet(), device="cpu")
    assert int(port.bwt_sym.numel()) == len(b)
    np.testing.assert_array_equal(port.bwt_sym.numpy(), port.sym_of.numpy()[b])


def test_from_text_host_route_matches_device_route():
    """``from_text(host=True)`` (native SA-IS, BWT on the host) builds the
    same tables as the device route (prefix doubling), on a text with
    several sentinels."""
    rng = np.random.default_rng(21)
    text = _text(rng, 700)[:-1] + b"$" + _text(rng, 300)
    a = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=4, device="cpu", host=True)
    b = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=4, device="cpu", host=False)
    for name in ("_fused", "less", "sym_of", "bwt_bytes", "sa_sample", "sent_rows", "sent_vals"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    rows = np.arange(a.n)
    np.testing.assert_array_equal(a.locate_batch(rows), np.asarray(jax_suffix_array(text)))


@pytest.mark.parametrize("force_u32", [False, True])
def test_index_files_with_lut_load_through_carry(tmp_path, force_u32):
    """An index file saved by the JAX ``save_fm_index`` with a q-mer table
    (and, with ``force_u32``, the uint32 arrays) loads through
    ``carry.load_fm_index`` and answers as the JAX index does: search, the
    table's search and locate."""
    rng = np.random.default_rng(40 + force_u32)
    text = _text(rng, 1500)
    jax_idx, _ = _indexes(text, force_u32)
    jax_idx.build_kmer_lut(q=Q)
    path = tmp_path / "idx.npz"
    save_fm_index(path, jax_idx)
    port = load_fm_index(path, device="cpu")
    assert port._big == force_u32 and port._lut_q == Q
    pats, plens = _patterns(rng, text, 64, 12)
    want = _np(jax_idx.search_batch_lut(pats, plens))
    for g, w in zip(_np(port.search_batch_lut(pats, plens)), want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(_np(port.search_arrays(torch.from_numpy(pats), torch.from_numpy(plens))), want):
        np.testing.assert_array_equal(g, w)
    rows = np.arange(port.n)
    jrows = rows.astype(np.uint32 if force_u32 else np.int32)
    np.testing.assert_array_equal(
        port.locate_batch(rows).astype(np.int64), np.asarray(jax_idx.locate_batch(jrows)).astype(np.int64)
    )


def test_jax_lut_search_is_jax_k4():
    """The oracle's own premise at these sizes: JAX's ``search_batch_lut``
    equals its exact scan, so the port's equality to one is equality to
    both."""
    rng = np.random.default_rng(9)
    text = _text(rng, 2000)
    jax_idx, _ = _indexes(text, False)
    jax_idx.build_kmer_lut(q=Q)
    pats, plens = _patterns(rng, text, 32, 10)
    got = _np(jax_idx.search_batch_lut(pats, plens))
    want = _np(jax.tree.map(np.asarray, jax_idx._search_kernel(jnp.asarray(pats), jnp.asarray(plens))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
