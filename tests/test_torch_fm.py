"""The port's suffix array, BWT and ``DeviceFMIndex`` (kernel K4 and the
locate walk) against the JAX package: its host ``FMIndex`` oracle, its
``DeviceFMIndex`` and its fused Pallas search kernel (interpret mode on the
CPU). Exact comparison (tolerance 0)."""

import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.alphabets import dna as jax_dna
from rust_bio_tpu.data_structures.bwt import Occ, less
from rust_bio_tpu.data_structures.bwt import bwt as jax_bwt
from rust_bio_tpu.data_structures.fm_device import DeviceFMIndex as JaxDeviceFMIndex
from rust_bio_tpu.data_structures.fmindex import FMIndex
from rust_bio_tpu.data_structures.serialize import save_fm_index
from rust_bio_tpu.data_structures.suffix_array import suffix_array as jax_suffix_array
from rust_bio_tpu_torch.alphabets import dna
from rust_bio_tpu_torch.carry import fm_index_from_arrays, load_fm_index
from rust_bio_tpu_torch.data_structures.bwt import bwt
from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
from rust_bio_tpu_torch.data_structures.fmindex import Interval
from rust_bio_tpu_torch.data_structures.suffix_array import suffix_array
from rust_bio_tpu_torch.ops import fm as fm_ops
from rust_bio_tpu_torch.ops.fm import backward_search


def _random_text(rng, n, nl=False):
    alpha = b"ACGTN" if nl else b"ACGT"
    return rng.choice(list(alpha), size=n).astype("uint8").tobytes() + b"$"


def _patterns(rng, text, count, max_len=20):
    """Substrings of the text, random DNA, bytes outside the alphabet and
    empty patterns."""
    pats = [b""]
    for _ in range(count):
        ln = int(rng.integers(1, max_len))
        kind = rng.random()
        if kind < 0.45:
            start = int(rng.integers(0, len(text) - ln - 1))
            pats.append(text[start : start + ln])
        elif kind < 0.85:
            pats.append(rng.choice(list(b"ACGT"), size=ln).astype("uint8").tobytes())
        else:
            pats.append(rng.choice(list(b"ACGTNX$"), size=ln).astype("uint8").tobytes())
    return pats


def _key(res):
    iv = None if res.interval is None else (res.interval.lower, res.interval.upper)
    return res.kind.value, iv, res.matched_len


def _jax_index(text, sampling_rate):
    sa = jax_suffix_array(text)
    b = jax_bwt(text, sa)
    host = FMIndex(b, less(b, jax_dna.n_alphabet()), Occ(b, 32, jax_dna.n_alphabet()))
    return sa, b, host, JaxDeviceFMIndex(b, jax_dna.n_alphabet(), sa=sa, sampling_rate=sampling_rate)


@pytest.mark.parametrize(
    "text",
    [b"GCCTTAACATTATTACGCCTA$", b"ATTCGGGG$CCCCGAAT$", b"$", b"AAAAAAAA$"]
    + [_random_text(np.random.default_rng(s), 300 + 50 * s, nl=s % 2 == 1) for s in range(3)],
)
def test_suffix_array_and_bwt_match_jax(text):
    sa = suffix_array(text, device="cpu")
    want = jax_suffix_array(text)
    np.testing.assert_array_equal(sa.numpy(), want)
    np.testing.assert_array_equal(bwt(text, sa).numpy(), jax_bwt(text, want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_and_locate_match_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    text = _random_text(rng, 500, nl=seed == 1)
    sa, b, host, jdev = _jax_index(text, sampling_rate=4)
    port = DeviceFMIndex(b, dna.n_alphabet(), sa=sa, sampling_rate=4, device="cpu")
    built = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=4, device="cpu")
    pats = _patterns(rng, text, 64)
    got = [_key(r) for r in port.backward_search_batch(pats)]
    assert got == [_key(r) for r in built.backward_search_batch(pats)]
    assert got == [_key(r) for r in jdev.backward_search_batch(pats)]
    assert got == [_key(host.backward_search(p)) for p in pats]
    kinds = {k for k, _, _ in got}
    assert kinds == {"complete", "partial", "absent"}
    rows = np.arange(len(sa), dtype=np.int32)
    np.testing.assert_array_equal(port.locate_batch(rows), sa)
    np.testing.assert_array_equal(built.locate_batch(rows), sa)
    np.testing.assert_array_equal(port.locate_batch(rows), jdev.locate_batch(rows))
    for (kind, iv, _), res in zip(got, port.backward_search_batch(pats)):
        if kind == "complete":
            np.testing.assert_array_equal(port.locate_interval(res.interval), sa[iv[0] : iv[1]])


def test_locate_multi_sentinel_text():
    """Sentinel BWT rows stop the LF-walk at their exact stored value."""
    text = b"ATTCGGGG$CCCCGAAT$"
    sa = jax_suffix_array(text)
    b = jax_bwt(text, sa)
    alpha = dna.n_alphabet()
    alpha.insert(ord("$"))
    port = DeviceFMIndex(b, alpha, sa=sa, sampling_rate=5, device="cpu")
    np.testing.assert_array_equal(port.locate_batch(np.arange(len(sa))), sa)


def test_k4_plain_matches_fused_pallas_kernel():
    """K4's plain version against the JAX fused search kernel (forced on the
    CPU, several query tiles with padding), on ragged patterns with absent
    bytes, partial matches and empty patterns."""
    rng = np.random.default_rng(9)
    text = _random_text(rng, 700)
    b = jax_bwt(text, jax_suffix_array(text))
    jdev = JaxDeviceFMIndex(b, jax_dna.n_alphabet())
    jdev._build_fused_search(np.asarray(jdev.bits), np.asarray(jdev.ckpt), force=True)
    assert jdev._fs_cfg is not None
    jdev._fs_cfg = dict(jdev._fs_cfg, qtb=128)
    B, L = 160, 12
    pats = np.zeros((B, L), np.uint8)
    plens = np.zeros(B, np.int32)
    for i, p in enumerate(_patterns(rng, text, B - 1, max_len=L + 1)):
        pats[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    want = [np.asarray(v) for v in jdev._search_kernel(jnp.asarray(pats), jnp.asarray(plens))]
    port = DeviceFMIndex(b, dna.n_alphabet(), device="cpu")
    got = backward_search(
        port._fused, port._less256, port.sym_of,
        torch.from_numpy(pats), torch.from_numpy(plens), port.n,
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    assert set(got[0].tolist()) == {0, 1, 2}


def test_index_tables_match_jax():
    rng = np.random.default_rng(6)
    text = _random_text(rng, 1000, nl=True)
    sa, b, _, jdev = _jax_index(text, sampling_rate=8)
    port = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=8, device="cpu")
    np.testing.assert_array_equal(port.bits.numpy().view(np.uint32), np.asarray(jdev.bits))
    np.testing.assert_array_equal(port.ckpt.numpy(), np.asarray(jdev.ckpt))
    np.testing.assert_array_equal(port.less.numpy(), np.asarray(jdev.less))
    np.testing.assert_array_equal(port.sym_of.numpy(), np.asarray(jdev.sym_of))
    np.testing.assert_array_equal(port.sa_sample.numpy(), np.asarray(jdev.sa_sample))
    np.testing.assert_array_equal(port.sent_rows.numpy(), np.asarray(jdev.sent_rows))
    assert port.symbols == jdev.symbols and port.sentinel == jdev.sentinel


def test_carry_loads_jax_index_file(tmp_path):
    rng = np.random.default_rng(9)
    text = _random_text(rng, 300)
    sa, b, _, jdev = _jax_index(text, sampling_rate=4)
    path = tmp_path / "genome.fmidx.npz"
    save_fm_index(path, jdev)
    port = load_fm_index(path, device="cpu")
    pats = [text[10:25], text[100:140], b"ACGTACGTAC", b"NNA"]
    assert [_key(r) for r in port.backward_search_batch(pats)] == [
        _key(r) for r in jdev.backward_search_batch(pats)
    ]
    rows = np.arange(len(sa), dtype=np.int32)
    np.testing.assert_array_equal(port.locate_batch(rows), jdev.locate_batch(rows))
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    again = fm_index_from_arrays(arrays, meta, device="cpu")
    np.testing.assert_array_equal(again.locate_batch(rows), sa)


def test_carry_detects_corruption(tmp_path):
    rng = np.random.default_rng(10)
    text = _random_text(rng, 100)
    sa, b, _, jdev = _jax_index(text, sampling_rate=4)
    path = tmp_path / "idx.npz"
    save_fm_index(path, jdev)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["less"] = arrays["less"].copy()
    arrays["less"][65] += 1
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="corrupted"):
        load_fm_index(path, device="cpu")


def test_bad_inputs_raise():
    port = DeviceFMIndex(b"ACGT$", dna.n_alphabet(), device="cpu")
    with pytest.raises(ValueError, match="2\\^32 - 1"):
        port._set_tables({}, 2**32 - 1, 32, 0, [], torch.device("cpu"))
    pats = torch.zeros((2, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="plens"):
        port.search_arrays(pats, torch.tensor([1, 4], dtype=torch.int32))
    with pytest.raises(TypeError):
        port.search_arrays(pats, torch.tensor([1, 2]))


def _locate_tables(port):
    return (port._fused, port.bwt_sym, port.less_sym, port.sa_sample, port.sent_rows, port.sent_vals)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("s", [1, 4, 5, 32, 64])
def test_locate_plain_matches_jax_and_suffix_array(s, seed):
    """K4-locate's plain version on every row against the JAX XLA walk
    ``_locate_impl`` and the suffix array, at sampling rates that stop the
    walk at once (1), below, at and above a word (32)."""
    rng = np.random.default_rng(20 + seed)
    text = _random_text(rng, 400 + 97 * seed, nl=seed == 1)
    sa, b, _, jdev = _jax_index(text, sampling_rate=s)
    port = DeviceFMIndex(b, dna.n_alphabet(), sa=sa, sampling_rate=s, device="cpu")
    rows = np.arange(len(sa), dtype=np.int32)
    got = fm_ops.locate_plain(*_locate_tables(port), torch.from_numpy(rows), s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), sa)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdev._locate_kernel(jnp.asarray(rows))))
    np.testing.assert_array_equal(fm_ops.locate(*_locate_tables(port), torch.from_numpy(rows), s).numpy(), sa)


def _multi_sentinel_text():
    rng = np.random.default_rng(31)
    parts = [rng.choice(list(b"ACGT"), size=k).astype("uint8").tobytes() for k in (90, 1, 57, 120)]
    return b"$".join(parts) + b"$"


@pytest.mark.parametrize("s", [5, 32])
@pytest.mark.parametrize("text", [b"ATTCGGGG$CCCCGAAT$", _multi_sentinel_text()], ids=["short", "random"])
def test_locate_plain_multi_sentinel_matches_jax(text, s):
    """Sentinel rows stop the walk at their exact stored value (binary
    search of sent_rows), as in the JAX walk."""
    sa = jax_suffix_array(text)
    b = jax_bwt(text, sa)
    jalpha = jax_dna.n_alphabet()
    jalpha.insert(ord("$"))
    jdev = JaxDeviceFMIndex(b, jalpha, sa=sa, sampling_rate=s)
    alpha = dna.n_alphabet()
    alpha.insert(ord("$"))
    port = DeviceFMIndex(b, alpha, sa=sa, sampling_rate=s, device="cpu")
    assert port.sent_rows.numel() == text.count(b"$")
    rows = np.arange(len(sa), dtype=np.int32)
    got = fm_ops.locate_plain(*_locate_tables(port), torch.from_numpy(rows), s).numpy()
    np.testing.assert_array_equal(got, sa)
    np.testing.assert_array_equal(got, np.asarray(jdev._locate_kernel(jnp.asarray(rows))))


def test_locate_batch_async_matches_locate_batch_and_jax():
    rng = np.random.default_rng(33)
    text = _random_text(rng, 600, nl=True)
    sa, b, _, jdev = _jax_index(text, sampling_rate=8)
    port = DeviceFMIndex(b, dna.n_alphabet(), sa=sa, sampling_rate=8, device="cpu")
    rows = rng.integers(0, len(sa), size=37).astype(np.int32)
    handle, nb = port.locate_batch_async(rows)
    assert nb == 37 and isinstance(handle, torch.Tensor) and handle.dtype == torch.int32
    got = handle.cpu().numpy()[:nb]
    np.testing.assert_array_equal(got, port.locate_batch(rows))
    jhandle, jnb = jdev.locate_batch_async(rows)
    assert jnb == nb
    np.testing.assert_array_equal(got, np.asarray(jhandle)[:jnb])
    np.testing.assert_array_equal(got, sa[rows])
    assert port.locate_batch_async(np.zeros(0, np.int32)) == (None, 0) == jdev.locate_batch_async(np.zeros(0, np.int32))
    assert port.locate_batch([]).size == 0


@pytest.mark.parametrize("bad", [[-1], [0, 3, 601], [5, 2**32 + 3]], ids=["negative", "n", "wraps"])
def test_locate_rows_out_of_range_raise(bad):
    rng = np.random.default_rng(34)
    text = _random_text(rng, 600)
    port = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=4, device="cpu")
    assert port.n == 601
    with pytest.raises(ValueError, match="rows must lie"):
        port.locate_batch(bad)
    with pytest.raises(ValueError, match="rows must lie"):
        port.locate_batch_async(bad)
    with pytest.raises(ValueError, match="rows must lie"):
        port.locate_rows(torch.tensor(bad, dtype=torch.int64))
    with pytest.raises(ValueError, match="rows must lie"):
        port.locate_interval(Interval(598, 603))


def test_locate_wrapper_contract():
    """Rows outside [0, n) give -1 from the wrapper (the callers check them);
    its input checks raise."""
    rng = np.random.default_rng(35)
    text = _random_text(rng, 300)
    sa = jax_suffix_array(text)
    port = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=4, device="cpu")
    tables = _locate_tables(port)
    rows = torch.tensor([-1, 0, port.n, 3, -7], dtype=torch.int32)
    assert fm_ops.locate(*tables, rows, 4).tolist() == [-1, sa[0], -1, sa[3], -1]
    assert fm_ops.locate(*tables, rows[:0], 4).shape == (0,)
    with pytest.raises(TypeError):
        fm_ops.locate(*tables, rows.long(), 4)
    with pytest.raises(ValueError, match="sampling rate"):
        fm_ops.locate(*tables, rows, 0)
    with pytest.raises(ValueError, match="sa_sample"):
        fm_ops.locate(*tables, rows, 8)
    bare = DeviceFMIndex(port.bwt_bytes, dna.n_alphabet(), device="cpu")
    with pytest.raises(ValueError, match="suffix array"):
        bare.locate_batch([0])


def test_fm_constants_mirror_the_source():
    """``ops.fm.FM_THREADS`` is csrc/fm_search.cu's ``THREADS``."""
    src = (Path(fm_ops.__file__).parent / "csrc" / "fm_search.cu").read_text()
    assert int(re.search(r"constexpr int THREADS = (\d+);", src).group(1)) == fm_ops.FM_THREADS
