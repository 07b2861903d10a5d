"""The port's FMD index and SMEM search against the JAX package: the host
``FMDIndex`` oracle on the reference's doctest cases, the plain K-SMEM
(``ops.fmd.smems_plain``) against the XLA ``_smems_impl`` output for output
in both modes at E = 2, 4, 16 and 32 (with queries that overflow in phase 1,
at phase 2's stage compactions and past MC, and bytes outside the
alphabet), ``DeviceFMDIndex.smems_batch`` / ``all_smems_batch`` against the
JAX class and the host oracle, the seed pick, and the suffix array of a
two-sentinel FMD text. Exact comparison (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.alphabets import Alphabet as JaxAlphabet
from rust_bio_tpu.alphabets import dna as jax_dna
from rust_bio_tpu.data_structures.bwt import Occ as JaxOcc
from rust_bio_tpu.data_structures.bwt import bwt as jax_bwt
from rust_bio_tpu.data_structures.bwt import less as jax_less
from rust_bio_tpu.data_structures.fm_device import DeviceFMIndex as JaxDeviceFMIndex
from rust_bio_tpu.data_structures.fmd_device import DeviceFMDIndex as JaxDeviceFMDIndex
from rust_bio_tpu.data_structures.fmindex import FMDIndex as JaxFMDIndex
from rust_bio_tpu.data_structures.fmindex import FMIndex as JaxFMIndex
from rust_bio_tpu.data_structures.suffix_array import suffix_array as jax_suffix_array
from rust_bio_tpu_torch.alphabets import Alphabet, dna
from rust_bio_tpu_torch.data_structures.bwt import Occ, less
from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
from rust_bio_tpu_torch.data_structures.fmd_device import DeviceFMDIndex
from rust_bio_tpu_torch.data_structures.fmindex import FMDIndex, FMIndex
from rust_bio_tpu_torch.data_structures.suffix_array import suffix_array, suffix_array_host
from rust_bio_tpu_torch.ops import fmd


def _fmd_text(seq: bytes) -> bytes:
    return seq + b"$" + jax_dna.revcomp(seq) + b"$"


def _alpha():
    """The FMD alphabet (``n_alphabet`` and the sentinel) of both packages."""
    a = dna.n_alphabet()
    a.insert(ord("$"))
    ja = jax_dna.n_alphabet()
    ja.insert(ord("$"))
    return a, ja


def _pair(seq: bytes, symbols=None):
    """(port DeviceFMDIndex on the CPU, JAX DeviceFMDIndex, JAX host
    oracle) over one FMD text."""
    text = _fmd_text(seq)
    sa = jax_suffix_array(text)
    b = jax_bwt(text, sa)
    palpha, jalpha = _alpha() if symbols is None else (Alphabet(symbols), JaxAlphabet(symbols))
    port = DeviceFMDIndex(DeviceFMIndex(b, palpha, sa=sa, device="cpu"))
    jdev = JaxDeviceFMDIndex(JaxDeviceFMIndex(b, jalpha, sa=sa))
    alphabet = jax_dna.n_alphabet()
    oracle = JaxFMDIndex(JaxFMIndex(b, jax_less(b, alphabet), JaxOcc(b, 3, alphabet)))
    return port, jdev, oracle


@pytest.fixture(scope="module")
def repeat_seq():
    """800 bp of random DNA with a 20-copy 7 bp tandem repeat inside and an
    N run at its end: the repeat makes backward extensions shed one
    occurrence a step (many slots), the Ns a symbol of the text."""
    rng = np.random.default_rng(3)
    unit = rng.choice(list(b"ACGT"), size=7).astype("uint8").tobytes()
    seq = rng.choice(list(b"ACGT"), size=800).astype("uint8").tobytes()
    return seq[:300] + unit * 20 + seq[300:] + b"NNACGTN"


@pytest.fixture(scope="module")
def indexes(repeat_seq):
    return _pair(repeat_seq)


def _queries(text: bytes, seed: int, B: int = 48, L: int = 70):
    """(pats, plens, iis) numpy: substrings of the text (sentinels written
    as A) with up to 3 bytes rewritten to A/C/G/T/N or X (outside the
    alphabet), every seventh with a lowercase byte, one empty pattern."""
    rng = np.random.default_rng(seed)
    pats = np.zeros((B, L), np.uint8)
    plens = np.zeros(B, np.int32)
    for i in range(1, B):
        ln = int(rng.integers(1, L + 1))
        s = int(rng.integers(0, len(text) - ln - 1))
        p = bytearray(text[s : s + ln].replace(b"$", b"A"))
        for _ in range(int(rng.integers(0, 4))):
            p[int(rng.integers(0, ln))] = int(rng.choice(list(b"ACGTNX")))
        if i % 7 == 0:
            p[int(rng.integers(0, ln))] = ord("a")
        pats[i, :ln] = np.frombuffer(bytes(p), np.uint8)
        plens[i] = ln
    iis = np.array([int(rng.integers(0, max(pl, 1))) for pl in plens], np.int32)
    return pats, plens, iis


def _phase1_appends(oracle, pat: bytes, i: int) -> int:
    """Slots phase 1 fills for (pat, i): the host oracle's forward loop."""
    interval = oracle.init_interval_with(pat[i])
    n = 0
    for a in pat[i + 1 :]:
        fwd = oracle.forward_ext(interval, a)
        if interval.size != fwd.size:
            n += 1
        if fwd.size == 0:
            break
        interval = fwd
    return n + 1


def _key(smems):
    """A list of SMEMs as plain tuples (the two packages' BiIntervals are
    different classes)."""
    return [(i.lower, i.lower_rev, i.size, i.match_size, s, n) for i, s, n in smems]


def _keys(lanes):
    return [_key(lane) for lane in lanes]


def _port_out(port, pats, plens, iis, l, E, MC, mapper):
    t = torch.from_numpy
    return [o.numpy() for o in fmd.smems_plain(port.tables, t(pats), t(plens), t(iis), l, E, MC, mapper)]


def _jax_out(jdev, pats, plens, iis, l, E, MC, mapper):
    outs = jdev._smems_kernel(jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(iis), E, MC, jnp.int32(l), mapper)
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("mapper", [False, True], ids=["full", "mapper"])
@pytest.mark.parametrize("E", [2, 4, 16, 32])
def test_plain_smems_equals_xla(indexes, repeat_seq, mapper, E):
    port, jdev, oracle = indexes
    text = _fmd_text(repeat_seq)
    pats, plens, iis = _queries(text, 11)
    for l, MC in ((0, E), (12, 3)):
        got = _port_out(port, pats, plens, iis, l, E, MC, mapper)
        want = _jax_out(jdev, pats, plens, iis, l, E, MC, mapper)
        for name, g, w in zip(("m_lo", "m_lor", "m_sz", "m_st", "m_ml", "mcnt", "ovf"), got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), (name, l, MC)
    ovf = want[6]
    phase1 = np.array([_phase1_appends(oracle, bytes(pats[b, : plens[b]]), int(iis[b])) > E if plens[b] else False
                       for b in range(len(plens))])
    if E <= 4:
        assert phase1.any(), "no query overflows phase 1's slots"
    assert not (phase1 & ~ovf).any()


def test_overflow_at_the_compactions(indexes, repeat_seq):
    """Mapper mode narrows phase 2's slots after steps 10, 16 and 22: a
    query with more live slots than the next width retires with ovf. Reads
    entering the repeat, with the position deep in it, keep many slots
    through the backward sweep; at every E some overflow at a compaction
    (ovf without a phase-1 overflow or one past MC), and the plain version
    equals the XLA function there."""
    port, jdev, oracle = indexes
    pairs = [(s, p) for s in range(230, 270, 4) for p in (62, 74, 86)]
    pats = np.stack([np.frombuffer(repeat_seq[s : s + 90], np.uint8) for s, _ in pairs])
    plens = np.full(len(pairs), 90, np.int32)
    iis = np.array([p for _, p in pairs], np.int32)
    for E in (4, 8, 16, 32):
        got = _port_out(port, pats, plens, iis, 0, E, E, True)
        want = _jax_out(jdev, pats, plens, iis, 0, E, E, True)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), E
        phase1 = np.array([_phase1_appends(oracle, bytes(pats[b]), int(iis[b])) > E for b in range(len(plens))])
        assert (want[6] & ~phase1 & (want[5] <= E)).any(), E


def test_small_alphabet_fill(repeat_seq):
    """An index without lowercase symbols (KE = 6): a lowercase byte's
    extension-order column lies past KE and reads XLA's fill value; the
    plain K-SMEM follows it."""
    port, jdev, _ = _pair(repeat_seq, b"$ACGTN")
    assert port.KE == jdev.KE == 6
    pats, plens, iis = _queries(_fmd_text(repeat_seq), 13, B=24)
    for mapper in (False, True):
        got = _port_out(port, pats, plens, iis, 0, 16, 8, mapper)
        want = _jax_out(jdev, pats, plens, iis, 0, 16, 8, mapper)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), mapper


def test_device_tables_equal_jax(indexes):
    port, jdev, _ = indexes
    assert port.KE == jdev.KE == 11
    assert np.array_equal(port.ext_syms.numpy(), np.asarray(jdev.ext_syms))
    assert np.array_equal(port.ext_valid.numpy(), np.asarray(jdev.ext_valid))
    assert np.array_equal(port.ext_pos.numpy(), np.asarray(jdev.ext_pos))
    assert np.array_equal(port.comp.numpy(), np.asarray(jdev.comp))
    assert np.array_equal(port.less_b.numpy(), np.asarray(jdev.less_b))
    assert np.array_equal(port.tables.rows.numpy(), np.asarray(jdev.fm.ensure_row_layout()))


def test_extensions_equal_jax(indexes):
    """The batched backward / forward extensions on random bi-intervals."""
    port, jdev, _ = indexes
    rng = np.random.default_rng(5)
    n = port.fm.n
    lo = rng.integers(0, n, size=64).astype(np.int32)
    lor = rng.integers(0, n, size=64).astype(np.int32)
    sz = np.minimum(rng.integers(0, 40, size=64), n - np.maximum(lo, lor)).astype(np.int32)
    a = np.frombuffer(b"ACGTN$XaT" * 8, np.uint8)[:64].copy()
    t = torch.from_numpy
    for name in ("_backward_ext", "_forward_ext"):
        got = getattr(port, name)(t(lo), t(lor), t(sz), t(a))
        want = getattr(jdev, name)(jnp.asarray(lo), jnp.asarray(lor), jnp.asarray(sz), jnp.asarray(a), None, jdev.fm.ensure_row_layout())
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want)), name
    got = port._backward_ext_nolor(t(lo), t(sz), t(a))
    want = jdev._backward_ext_nolor(jnp.asarray(lo), jnp.asarray(sz), jnp.asarray(a))
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))


def test_seed_pick_plain(indexes, repeat_seq):
    """The pick on K-SMEM's outputs (first longest stored match; row 0 and
    slot 0's start and length where nothing was found), and ``seed_pick``
    on the CPU, equal ``_seed_impl``'s pick."""
    port, jdev, _ = indexes
    pats, plens, iis = _queries(_fmd_text(repeat_seq), 17)
    outs = fmd.smems_plain(port.tables, *map(torch.from_numpy, (pats, plens, iis)), 19, 4, 4, True)
    rows, pick = fmd.pick_plain(*outs)
    m_lo, _, _, m_st, m_ml, mcnt, ovf = (o.numpy() for o in outs)
    valid = np.arange(4)[None, :] < mcnt[:, None]
    best = np.argmax(np.where(valid, m_ml, -1), axis=1)
    found = (mcnt > 0) & ~ovf
    b = np.arange(len(mcnt))
    assert np.array_equal(rows.numpy(), np.where(found, m_lo[b, best], 0))
    assert np.array_equal(pick.numpy(), np.stack([m_st[b, best], m_ml[b, best], found, ovf]).astype(np.int32))
    out = torch.empty((4, len(mcnt)), dtype=torch.int32)
    rows2 = fmd.seed_pick(port.tables, *map(torch.from_numpy, (pats, plens, iis)), 19, 4, out)
    assert torch.equal(rows2, rows) and torch.equal(out, pick)


def test_smems_batch_equals_jax_and_oracle():
    rng = np.random.default_rng(77)
    seq = rng.choice(list(b"ACGT"), size=500).astype("uint8").tobytes()
    port, jdev, oracle = _pair(seq)
    pats, poss = [], []
    for _ in range(16):
        ln = int(rng.integers(5, 30))
        if rng.random() < 0.7:
            s = int(rng.integers(0, len(seq) - ln))
            p = bytearray(seq[s : s + ln])
            if rng.random() < 0.5:
                p[ln // 2] = int(rng.choice(list(b"ACGT")))
            p = bytes(p)
        else:
            p = rng.choice(list(b"ACGT"), size=ln).astype("uint8").tobytes()
        pats.append(p)
        poss.append(int(rng.integers(0, ln)))
    for l in (0, 5):
        got = _keys(port.smems_batch(pats, poss, l, host_oracle=oracle))
        assert got == _keys(jdev.smems_batch(pats, poss, l, host_oracle=oracle))
        assert got == _keys(oracle.smems(p, i, l) for p, i in zip(pats, poss))
        mapped = _keys(port.smems_batch(pats, poss, l, mapper_mode=True, host_oracle=oracle))
        assert [[k[:1] + k[2:] for k in lane] for lane in mapped] == [[k[:1] + k[2:] for k in lane] for lane in got]
    # a tiny slot budget overflows: the oracle answers those queries, and
    # without one smems_collect raises
    got = port.smems_batch(pats, poss, 0, max_slots=1, host_oracle=oracle)
    assert _keys(got) == _keys(oracle.smems(p, i, 0) for p, i in zip(pats, poss))
    with pytest.raises(RuntimeError, match="host_oracle"):
        port.smems_batch(pats, poss, 0, max_slots=1)
    with pytest.raises(ValueError, match="outside"):
        port.smems_batch([b"ACGT"], [4], 0)


def test_all_smems_batch_equals_jax_and_oracle():
    rng = np.random.default_rng(79)
    seq = rng.choice(list(b"ACGT"), size=400).astype("uint8").tobytes()
    port, jdev, oracle = _pair(seq)
    pats = []
    for _ in range(10):
        ln = int(rng.integers(8, 40))
        s = int(rng.integers(0, len(seq) - ln))
        p = bytearray(seq[s : s + ln])
        for _ in range(int(rng.integers(0, 3))):
            p[int(rng.integers(0, ln))] = int(rng.choice(list(b"ACGT")))
        pats.append(bytes(p))
    pats.append(b"")
    got = _keys(port.all_smems_batch(pats, 5, host_oracle=oracle))
    assert got == _keys(jdev.all_smems_batch(pats, 5, host_oracle=oracle))
    assert got == _keys(oracle.all_smems(p, 5) for p in pats)


def _host_pair(text: bytes, k: int = 3):
    """(port FMDIndex, JAX FMDIndex) over a text."""
    sa = jax_suffix_array(text)
    b = jax_bwt(text, sa)
    ja = jax_dna.n_alphabet()
    pa = dna.n_alphabet()
    jax_fmd = JaxFMDIndex(JaxFMIndex(b, jax_less(b, ja), JaxOcc(b, k, ja)))
    port_fmd = FMDIndex(FMIndex(b, less(b, pa), Occ(b, k, pa)))
    return port_fmd, jax_fmd, sa


def test_host_fmd_doctests():
    """The reference doctests (fmindex.rs), as tests/test_fmindex.py holds
    them, through the port's host oracle and the JAX one."""
    port_fmd, jax_fmd, sa = _host_pair(b"ATTC$GAAT$")
    got = port_fmd.smems(b"ATT", 2, 0)
    assert _key(got) == _key(jax_fmd.smems(b"ATT", 2, 0))
    assert got[0][0].forward().occ(sa) == [0] and got[0][0].revcomp().occ(sa) == [6]
    assert (got[0][1], got[0][2]) == (0, 3)
    port_fmd, jax_fmd, sa = _host_pair(b"ATTCGGGG$CCCCGAAT$")
    got = port_fmd.all_smems(b"ATTGGGG", 0)
    assert _key(got) == _key(jax_fmd.all_smems(b"ATTGGGG", 0))
    sols = [[bi.forward().occ(sa)[0], bi.revcomp().occ(sa)[0], p, ln] for bi, p, ln in got]
    assert sols == [[0, 14, 0, 3], [4, 9, 3, 4]]
    iv, jiv = port_fmd.init_interval_with(ord("A")), jax_fmd.init_interval_with(ord("A"))
    assert _key([(iv, 0, 0)]) == _key([(jiv, 0, 0)])
    for a in b"ACGTN":
        assert _key([(port_fmd.backward_ext(iv, a), 0, 0)]) == _key([(jax_fmd.backward_ext(jiv, a), 0, 0)])
        assert _key([(port_fmd.forward_ext(iv, a), 0, 0)]) == _key([(jax_fmd.forward_ext(jiv, a), 0, 0)])
    for pat in (b"GAAT", b"TTCG", b"NNN", b"CCCCGA"):
        pr, jr = port_fmd.backward_search(pat), jax_fmd.backward_search(pat)
        assert (pr.kind.value, pr.matched_len) == (jr.kind.value, jr.matched_len)


@pytest.mark.parametrize("k", [1, 3, 64, 128, 200])
def test_occ_and_less_equal_jax(k):
    rng = np.random.default_rng(k)
    seq = rng.choice(list(b"ACGTN"), size=700).astype("uint8").tobytes()
    text = _fmd_text(seq)
    b = jax_bwt(text, jax_suffix_array(text))
    pa, ja = dna.n_alphabet(), jax_dna.n_alphabet()
    assert np.array_equal(less(b, pa), jax_less(b, ja))
    occ, jocc = Occ(b, k, pa), JaxOcc(b, k, ja)
    assert np.array_equal(occ.occ, jocc.occ)
    for r in rng.integers(0, len(b), size=40).tolist():
        for a in b"$ACGTN":
            assert occ.get(b, r, a) == jocc.get(b, r, a)


def test_fmd_text_suffix_array_native_equals_jax():
    """The two-sentinel text ``T$revcomp(T)$`` (later sentinels rank
    smaller) by the native SA-IS route and by prefix doubling equals the
    JAX suffix array; both sentinel rows locate exactly."""
    rng = np.random.default_rng(21)
    seq = rng.choice(list(b"ACGTN"), size=3000).astype("uint8").tobytes()
    text = _fmd_text(seq)
    want = np.asarray(jax_suffix_array(text))
    assert np.array_equal(suffix_array_host(text).astype(np.int64), want)
    assert np.array_equal(suffix_array(text, device="cpu").numpy(), want)
    assert np.array_equal(suffix_array(torch.from_numpy(np.frombuffer(text, np.uint8).copy())).numpy(), want)
    arr = np.frombuffer(text, np.uint8)
    b = arr[want - 1]
    alpha, _ = _alpha()
    idx = DeviceFMIndex(b, alpha, sa=want, sampling_rate=8, device="cpu")
    sent = idx.sent_rows.numpy()
    assert len(sent) == 2
    assert np.array_equal(idx.locate_batch(sent), want[sent])
    rows = np.arange(0, len(text), 7)
    assert np.array_equal(idx.locate_batch(rows), want[rows])


def test_uint32_index_refused():
    b = np.frombuffer(b"GC$AT", np.uint8)
    idx = DeviceFMIndex(b, Alphabet(b"$ACGT"), device="cpu", force_u32=True)
    with pytest.raises(ValueError, match="int32"):
        DeviceFMDIndex(idx)


def test_wrapper_checks(indexes):
    port, _, _ = indexes
    pats = torch.zeros((2, 5), dtype=torch.uint8)
    lens = torch.full((2,), 5, dtype=torch.int32)
    iis = torch.zeros(2, dtype=torch.int32)
    for E, MC in ((0, 4), (33, 4), (4, 0)):
        with pytest.raises(ValueError):
            fmd.smems(port.tables, pats, lens, iis, 0, E, MC)
    with pytest.raises(TypeError):
        fmd.smems(port.tables, pats.to(torch.int32), lens, iis, 0, 4, 4)
    assert fmd.schedule(16, True) == [(10, 16), (16, 8), (22, 4), (None, 2)]
    assert fmd.schedule(32, True) == [(10, 32), (16, 16), (22, 8), (None, 4)]
    assert fmd.schedule(2, True) == [(None, 2)]
    assert fmd.schedule(16, False) == [(None, 16)]
