"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and skip without one. They import nothing of
JAX, so they run on a machine that has only the port's requirements:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets JAX up). Integer outputs are
compared exactly.
"""

import functools
import itertools
import math

import numpy as np
import pytest
import torch

from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
from rust_bio_tpu_torch.alignment.pairwise.batched import _fixed_column
from rust_bio_tpu_torch.alphabets import dna
from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
from rust_bio_tpu_torch.ops import fm, sw, walk
from rust_bio_tpu_torch.ops import pairhmm as pairhmm_ops
from rust_bio_tpu_torch.pipelines import ReadMapper

pytestmark = pytest.mark.cuda

PENS = [(-5, -1), (-2, -2), (-1, -1)]
MIN = -858_993_459  # MIN_SCORE: a clip switched off


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _pairs(rng, B, M, N, device):
    xb = rng.choice(list(b"ACGT"), size=(B, M)).astype(np.uint8)
    yb = rng.choice(list(b"ACGT"), size=(B, N)).astype(np.uint8)
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:4] = [M, 0, M, 1]
    nlens[:4] = [N, N, 0, 1]
    return [torch.from_numpy(a).to(device) for a in (xb, yb, mlens, nlens)], mlens, nlens


@pytest.mark.parametrize("go,ge", PENS)
def test_scan_and_scores_match_plain(cuda_device, go, ge):
    args, mlens, nlens = _pairs(np.random.default_rng(7), 300, 150, 150, cuda_device)
    score, tb, tbk = sw.scan_global(*args, go, ge, 2, -2)
    torch.cuda.synchronize()
    ps, ptb, ptbk = sw.scan_global_plain(*args, go, ge, 2, -2)
    assert torch.equal(score, ps)
    assert torch.equal(sw.scores_global(*args, go, ge, 2, -2), sw.scores_global_plain(*args, go, ge, 2, -2))
    tb, ptb, tbk, ptbk = (t.cpu().numpy() for t in (tb, ptb, tbk, ptbk))
    for b in range(len(mlens)):
        m, n = mlens[b], nlens[b]
        np.testing.assert_array_equal(tb[:n, : m + 1, b], ptb[:n, : m + 1, b])
        np.testing.assert_array_equal(tbk[b, : m + 1], ptbk[b, : m + 1])


def test_scan_with_device_scratch_matches_plain(cuda_device, monkeypatch):
    """K1 with its row state in the device scratch (the warp budget set to
    0), and K3 at M = 700."""
    monkeypatch.setattr(sw, "WARP_SHARED_MAX", 0)
    assert sw.warp_geometry(700, sw.GLOBAL_WARP_LAYERS)[1] == "scratch"
    args, _, _ = _pairs(np.random.default_rng(3), 40, 700, 30, cuda_device)
    assert torch.equal(sw.scan_global(*args, -5, -1, 2, -2)[0], sw.scan_global_plain(*args, -5, -1, 2, -2)[0])
    assert torch.equal(sw.scores_global(*args, -5, -1, 2, -2), sw.scores_global_plain(*args, -5, -1, 2, -2))


def test_walk_matches_plain(cuda_device):
    args, _, _ = _pairs(np.random.default_rng(8), 300, 150, 90, cuda_device)
    _, tb, _ = sw.scan_global(*args, -5, -1, 2, -2)
    got = walk.sweep_walk_global(tb, args[2], args[3])
    torch.cuda.synchronize()
    for g, w in zip(got, walk.sweep_walk_global_plain(tb, args[2], args[3])):
        assert torch.equal(g, w)


@pytest.mark.parametrize("placement", ["shared", "scratch"])
@pytest.mark.parametrize("M", [1, 7, 8, 150, 255, 256, 600, 605])
def test_k1_warp_scan_and_walk_match_plain(cuda_device, monkeypatch, M, placement):
    """K1 (``scan_global_warp_kernel``'s MatchParams instantiation, one warp
    a pair over row stripes) against its plain version bit for bit: score,
    tb over the defined cells, tbk; mlens on a stripe's first and last rows
    and lane 31's, lanes with nlens = 0 and mlens = 0, long diagonals; the
    row state in shared memory and in the device scratch. Then K2 on its
    pair-major view and on a contiguous copy against the plain K2."""
    _warp_cases(M, placement, monkeypatch, sw.GLOBAL_WARP_LAYERS)
    rng = np.random.default_rng(80 + M)
    args, mlens, nlens = _warp_pairs(rng, 48, M, 160, cuda_device, b"ACGT")
    ml, nl = args[2], args[3]
    for go, ge in PENS:
        score, tb, tbk = sw.scan_global(*args, go, ge, 2, -2)
        torch.cuda.synchronize()
        ps, ptb, ptbk = sw.scan_global_plain(*args, go, ge, 2, -2)
        assert torch.equal(score, ps)
        assert tb.shape == ptb.shape and tb.stride() == (sw.pair_major_pitch(M), 1, 160 * sw.pair_major_pitch(M))
        assert torch.equal(_masked(tb, mlens, nlens), _masked(ptb, mlens, nlens))
        assert torch.equal(_masked(tbk, mlens), _masked(ptbk, mlens))
        _walks_on_both_layouts(tb, [(walk.sweep_walk_global, walk.sweep_walk_global_plain, (ml, nl))])


def test_aligner_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    xb = rng.choice(list(b"ACGT"), size=(64, 150)).astype(np.uint8)
    yb = xb.copy()
    mut = rng.random(size=xb.shape) < 0.02
    yb[mut] = rng.choice(list(b"ACGT"), size=int(mut.sum())).astype(np.uint8)
    xs, ys = [bytes(r) for r in xb], [bytes(r) for r in yb]
    sc = Scoring.from_scores(-5, -1, 2, -2)
    on_card = BatchAligner(sc, device=cuda_device)
    on_cpu = BatchAligner(sc, device="cpu")
    key = lambda a: (a.score, a.xstart, a.xend, a.ystart, a.yend, a.operations)  # noqa: E731
    assert [key(a) for a in on_card.global_(xs, ys)] == [key(a) for a in on_cpu.global_(xs, ys)]
    np.testing.assert_array_equal(on_card.scores(xs, ys), on_cpu.scores(xs, ys))


def test_fm_index_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(12)
    text = rng.choice(list(b"ACGTN"), size=5000).astype(np.uint8).tobytes() + b"$"
    on_card = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=8, device=cuda_device)
    on_cpu = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=8, device="cpu")
    B, L = 500, 24
    pats = rng.choice(list(b"ACGTNX$"), size=(B, L)).astype(np.uint8)
    starts = rng.integers(0, len(text) - L, size=B // 2)
    pats[: B // 2] = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(L)]
    plens = rng.integers(0, L + 1, size=B).astype(np.int32)
    got = on_card.search_arrays(torch.from_numpy(pats).to(cuda_device), torch.from_numpy(plens).to(cuda_device))
    torch.cuda.synchronize()
    want = fm.backward_search_plain(
        on_card._fused, on_card._less256, on_card.sym_of,
        torch.from_numpy(pats).to(cuda_device), torch.from_numpy(plens).to(cuda_device), on_card.n,
    )
    for g, w, c in zip(got, want, on_cpu.search_arrays(torch.from_numpy(pats), torch.from_numpy(plens))):
        assert torch.equal(g, w) and torch.equal(g.cpu(), c)
    rows = np.arange(len(text), dtype=np.int32)
    np.testing.assert_array_equal(on_card.locate_batch(rows), on_cpu.locate_batch(rows))


def _fm_text(rng, n, alphabet=b"ACGT"):
    return rng.choice(list(alphabet), size=n).astype(np.uint8).tobytes() + b"$"


def _k4_patterns(rng, text, L):
    """(B, L) patterns and lengths that reach each branch of K4: every length
    0..L, the sentinel, bytes of the alphabet absent from the text (N, a:
    occ_r == 0 at the first step), bytes outside it (X, 0x80-0xFF), PARTIAL
    at the last step, text substrings and random DNA."""
    t = np.frombuffer(text, np.uint8)
    n = len(text)
    pats = [text[st : st + ln] for ln, st in zip(range(L + 1), rng.integers(0, n - L - 1, size=L + 1))]
    pats += [b"$", text[-6:], text[-1:], b"N", b"ACGN", b"a", b"NACG", b"ACaG", b"X", bytes([0x80]), bytes([0xFF, 65]),
             b"AC" + bytes([200]) + b"GT", bytes(range(0x80, 0x80 + L))]
    partial = 0
    for st in rng.integers(0, n - L - 1, size=400):
        tail = text[st + 1 : st + L]
        first = [c for c in b"ACGT" if bytes([c]) + tail not in text]
        if first and b"$" not in tail:
            pats.append(bytes([first[0]]) + tail)
            partial += 1
    assert partial >= 20
    for st in rng.integers(0, n - L - 1, size=300):
        pats.append(t[st : st + int(rng.integers(1, L + 1))].tobytes())
    pats += [rng.choice(list(b"ACGT"), size=int(rng.integers(1, L + 1))).astype(np.uint8).tobytes() for _ in range(300)]
    pb = np.zeros((len(pats), L), np.uint8)
    plens = np.zeros(len(pats), np.int32)
    for i, p in enumerate(pats):
        pb[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p)
    return pb, plens


@pytest.mark.parametrize("n,L", [(5000, 24), (5000, 80), (2**23 + 1000, 24)], ids=["5k", "5k-long", "above-2^23"])
def test_k4_matches_plain_on_every_branch(cuda_device, n, L):
    """K4 against its plain version on the card: n + 1 not a multiple of 32,
    patterns of up to 80 bytes, and a text past the
    TPU kernel's 2^23 limit."""
    rng = np.random.default_rng(40 + L)
    text = _fm_text(rng, n)
    assert len(text) % 32 != 0
    index = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=32, device=cuda_device)
    pats, plens = _k4_patterns(rng, text, L)
    pats_d, plens_d = torch.from_numpy(pats).to(cuda_device), torch.from_numpy(plens).to(cuda_device)
    before = fm.FM_BACKWARD_SEARCH.launches
    got = index.search_arrays(pats_d, plens_d)
    torch.cuda.synchronize()
    assert fm.FM_BACKWARD_SEARCH.launches == before + 1
    want = fm.backward_search_plain(index._fused, index._less256, index.sym_of, pats_d, plens_d, index.n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    status, _, _, mlen = (t.cpu().numpy() for t in got)
    assert set(status.tolist()) == {fm.ABSENT, fm.PARTIAL, fm.COMPLETE}
    assert ((status == fm.PARTIAL) & (mlen == plens - 1) & (plens == L)).sum() >= 20
    last = pats[np.arange(len(plens)), np.maximum(plens - 1, 0)]
    assert ((status == fm.ABSENT) & (plens > 0) & np.isin(last, list(b"Na"))).sum() >= 3
    assert ((status == fm.COMPLETE) & (plens > 32)).any() == (L > 32)


def _locate_check(index, rows):
    """K4-locate on ``rows`` (a device tensor) against its plain version on
    the card, through ``locate_rows``: one launch, no plain walk."""
    tables = (index._fused, index.bwt_sym, index.less_sym, index.sa_sample, index.sent_rows, index.sent_vals)
    before = fm.FM_LOCATE.launches
    got = index.locate_rows(rows)
    torch.cuda.synchronize()
    assert fm.FM_LOCATE.launches == before + 1
    want = fm.locate_plain(*tables, rows, index.s)
    assert torch.equal(got, want)
    return got.cpu().numpy()


@pytest.mark.parametrize("s", [1, 5, 32, 64])
def test_locate_matches_plain_on_every_row(cuda_device, monkeypatch, s):
    rng = np.random.default_rng(50 + s)
    text = _fm_text(rng, 5000, b"ACGTN")
    index = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=s, device=cuda_device)
    sa = index.to("cpu").locate_batch(np.arange(len(text)))
    got = _locate_check(index, torch.arange(len(text), dtype=torch.int32, device=cuda_device))
    np.testing.assert_array_equal(got, sa)
    np.testing.assert_array_equal(np.sort(got), np.arange(len(text)))
    # the card path runs the kernel alone
    monkeypatch.setattr(fm, "locate_walk_plain", None)
    np.testing.assert_array_equal(index.locate_batch(np.arange(len(text))[::-1]), sa[::-1])
    handle, nb = index.locate_batch_async(np.arange(7, 400))
    assert handle.device.type == "cuda" and nb == 393
    np.testing.assert_array_equal(handle.cpu().numpy(), sa[7:400])


@pytest.mark.parametrize("s", [5, 32])
@pytest.mark.parametrize("kind", ["short", "random", "protein"])
def test_locate_sentinels_and_wide_alphabets_match_plain(cuda_device, s, kind):
    """Several sentinels (rows stopped by the binary search of sent_rows),
    and a protein text (21 symbols)."""
    from rust_bio_tpu_torch.data_structures.suffix_array import suffix_array

    rng = np.random.default_rng(60 + s)
    alpha = dna.n_alphabet()
    alpha.insert(ord("$"))
    if kind == "short":
        text = b"ATTCGGGG$CCCCGAAT$"
    elif kind == "random":
        text = b"$".join(_fm_text(rng, k)[:-1] for k in (900, 1, 570, 1200, 33)) + b"$"
    else:
        text, alpha = _fm_text(rng, 4000, b"ARNDCQEGHILKMFPSTWYV"), None
    index = DeviceFMIndex.from_text(text, alpha, sampling_rate=s, device=cuda_device)
    assert index.sent_rows.numel() == text.count(b"$")
    got = _locate_check(index, torch.arange(len(text), dtype=torch.int32, device=cuda_device))
    np.testing.assert_array_equal(got, suffix_array(text, device="cpu").numpy())


def test_locate_rows_outside_the_text(cuda_device):
    rng = np.random.default_rng(70)
    text = _fm_text(rng, 777)
    index = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=4, device=cuda_device)
    tables = (index._fused, index.bwt_sym, index.less_sym, index.sa_sample, index.sent_rows, index.sent_vals)
    rows = torch.tensor([-1, 0, len(text), 5, -2**31, 2**31 - 1], dtype=torch.int32, device=cuda_device)
    got = fm.locate(*tables, rows, 4)
    torch.cuda.synchronize()
    assert torch.equal(got, fm.locate_plain(*tables, rows, 4))
    assert got.cpu().tolist()[::2] == [-1, -1, -1]
    with pytest.raises(ValueError, match="rows must lie"):
        index.locate_rows(rows)
    with pytest.raises(ValueError, match="rows must lie"):
        index.locate_batch(rows.cpu().numpy())


def _masked(t, mlens, nlens=None):
    """``t`` with the entries outside the defined region zeroed: rows above
    mlens[b] of (B, X) finals, or of (N, X, B) cells also columns past
    nlens[b] (the kernels leave those unwritten)."""
    t = t.to(torch.int64).cpu()
    ml = torch.as_tensor(mlens, dtype=torch.int64)
    if t.dim() == 2:
        return torch.where(torch.arange(t.shape[1])[None, :] <= ml[:, None], t, 0)
    nl = torch.as_tensor(nlens, dtype=torch.int64)
    keep = (torch.arange(t.shape[0])[:, None, None] < nl[None, None, :]) & (
        torch.arange(t.shape[1])[None, :, None] <= ml[None, None, :]
    )
    return torch.where(keep, t, 0)


def _semi_finals_match(got, want, mlens, nlens):
    assert torch.equal(_masked(got[0], mlens, nlens), _masked(want[0], mlens, nlens))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(_masked(g, mlens), _masked(w, mlens))


@pytest.mark.parametrize("go,ge", PENS)
def test_semiglobal_scan_and_walk_match_plain(cuda_device, go, ge):
    """K5 and K6 at the mapper's shapes (M = 150, N = 166)."""
    args, mlens, nlens = _pairs(np.random.default_rng(21), 300, 150, 166, cuda_device)
    got = sw.scan_semiglobal(*args, go, ge, 2, -2, 0, 0)
    torch.cuda.synchronize()
    want = sw.scan_semiglobal_plain(*args, go, ge, 2, -2, 0, 0)
    _semi_finals_match(got, want, mlens, nlens)
    # K6 on the plain path's traceback tensor and fixed column
    tb = want[0]
    _, tbfix = _fixed_column(*want[1:], args[2], go, ge)
    wgot = walk.sweep_walk_semiglobal(tb, tbfix, args[2], args[3])
    torch.cuda.synchronize()
    for g, w in zip(wgot, walk.sweep_walk_semiglobal_plain(tb, tbfix, args[2], args[3])):
        assert torch.equal(g, w)


def test_semiglobal_scan_with_clip_penalties_and_scratch_match_plain(cuda_device, monkeypatch):
    """Nonzero y-clip penalties at M = 700, the five row layers in the
    warp's shared memory (the geometry's placement) and in the device
    scratch (the warp budget set to 0)."""
    args, mlens, nlens = _pairs(np.random.default_rng(22), 40, 700, 30, cuda_device)
    for budget, placement in ((sw.WARP_SHARED_MAX, "shared"), (0, "scratch")):
        monkeypatch.setattr(sw, "WARP_SHARED_MAX", budget)
        assert sw.warp_geometry(700, sw.LOCAL_WARP_LAYERS)[1] == placement
        for ycp, ycs in ((0, 0), (-3, -4)):
            got = sw.scan_semiglobal(*args, -5, -1, 2, -2, ycp, ycs)
            torch.cuda.synchronize()
            _semi_finals_match(got, sw.scan_semiglobal_plain(*args, -5, -1, 2, -2, ycp, ycs), mlens, nlens)


def test_semiglobal_aligner_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(5)
    xs, ys = [], []
    for _ in range(64):
        y = rng.choice(list(b"ACGT"), size=int(rng.integers(30, 170))).astype(np.uint8).tobytes()
        m = int(rng.integers(1, min(150, len(y))))
        s = int(rng.integers(0, len(y) - m + 1))
        x = bytearray(y[s : s + m])
        for _ in range(int(rng.integers(0, 5))):
            x[int(rng.integers(0, m))] = int(rng.choice(list(b"ACGT")))
        xs.append(bytes(x))
        ys.append(y)
    sc = Scoring.from_scores(-5, -1, 2, -2)
    on_card = BatchAligner(sc, device=cuda_device)
    on_cpu = BatchAligner(sc, device="cpu")
    key = lambda a: (a.score, a.xstart, a.xend, a.ystart, a.yend, a.operations)  # noqa: E731
    assert [key(a) for a in on_card.semiglobal(xs, ys)] == [key(a) for a in on_cpu.semiglobal(xs, ys)]
    np.testing.assert_array_equal(on_card.scores(xs, ys, "semiglobal"), on_cpu.scores(xs, ys, "semiglobal"))
    assert on_card.semiglobal_packed(xs, ys).cigars() == on_cpu.semiglobal_packed(xs, ys).cigars()


def test_read_mapper_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(1234)
    genome = rng.choice(list(b"ACGT"), size=5000).astype(np.uint8).tobytes()
    reads = []
    for k in range(48):
        s = int(rng.integers(0, len(genome) - 100))
        r = bytearray(genome[s : s + 100])
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, 100))] = int(rng.choice(list(b"ACGT")))
        r = bytes(r)
        if k % 3 == 1:
            r = dna.revcomp(r)
        if k % 7 == 3:
            r = rng.choice(list(b"ACGT"), size=100).astype(np.uint8).tobytes()
        reads.append(r)
    on_card = ReadMapper(genome, device=cuda_device)
    on_cpu = ReadMapper(genome, device="cpu")
    key = lambda m: (m.read_id, m.pos, m.strand, m.score, m.cigar)  # noqa: E731
    got = on_card.map_batch(reads)
    assert [key(m) for m in got] == [key(m) for m in on_cpu.map_batch(reads)]
    assert sum(m.pos >= 0 for m in got) > 30
    assert [key(m) for m in on_card.to("cpu").map_batch(reads)] == [key(m) for m in got]


# ---- local and custom: K7, K9 (scans), K8, K10 (walks) ----



def _clip_pens(rng):
    """(go, ge, clips) cases: local, go = ge = 0 at clips 0, and three
    random clip choices of {MIN_SCORE, 0, -1, -7}."""
    cases = [(-5, -1, (0, 0, 0, 0)), (0, 0, (0, 0, 0, 0)), (-6, -1, (-5, -5, 0, 0))]
    for _ in range(3):
        go = int(rng.integers(-9, 0))
        cases.append((go, int(rng.integers(go, 1)), tuple(int(c) for c in rng.choice([MIN, 0, -1, -7], size=4))))
    return cases


def _clip_scan(args, go, ge, clips, plain=False, traceback=True):
    if all(c == 0 for c in clips):
        fn = sw.scan_local_plain if plain else sw.scan_local
        return fn(*args, go, ge, 2, -2, traceback=traceback)
    fn = sw.scan_custom_plain if plain else sw.scan_custom
    return fn(*args, go, ge, 2, -2, *clips, traceback=traceback)


def _clip_scans_match(got, want, mlens, nlens):
    """tb (N+1, X, B) over columns 0..nlens, lx over columns 0..nlens, the
    finals over rows 0..mlens."""
    assert torch.equal(_masked(got[0], mlens, nlens + 1), _masked(want[0], mlens, nlens + 1))
    keep = torch.arange(got[1].shape[0])[:, None] <= torch.as_tensor(nlens, dtype=torch.int64)[None, :]
    assert torch.equal(torch.where(keep, got[1].cpu(), 0), torch.where(keep, want[1].cpu(), 0))
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(_masked(g, mlens), _masked(w, mlens))


def test_clip_scans_and_walks_match_plain(cuda_device):
    """K7 and K9 (with traceback and score-only), then K8 and K10 on the
    plain scan's tensors, at B = 64."""
    from rust_bio_tpu_torch.alignment.pairwise.batched import _geometry, _suffix_fixups

    rng = np.random.default_rng(31)
    for go, ge, clips in _clip_pens(rng):
        args, mlens, nlens = _pairs(rng, 64, 150, 166, cuda_device)
        got = _clip_scan(args, go, ge, clips)
        torch.cuda.synchronize()
        want = _clip_scan(args, go, ge, clips, plain=True)
        _clip_scans_match(got, want, mlens, nlens)
        if all(c == 0 for c in clips):  # K7 gives K9's outputs at clips 0
            _clip_scans_match(got, sw.scan_custom(*args, go, ge, 2, -2, 0, 0, 0, 0), mlens, nlens)
        # score-only: no traceback, the same finals
        only = _clip_scan(args, go, ge, clips, traceback=False)
        assert only[0] is None and only[1] is None
        for g, w in zip(only[2:6], got[2:6]):
            assert torch.equal(_masked(g, mlens), _masked(w, mlens))
        # tbk without the run nibble, which only a traceback run computes
        assert torch.equal(_masked(only[6], mlens), _masked(got[6] & 0xFFF, mlens))
        tb, lx, S_f, I_f, Sn_f, Ly_f, tbk = want
        B, X = S_f.shape
        ml, nl = args[2], args[3]
        rows, row_ge1, mlens_c, is_row_m = _geometry(B, X - 1, ml)
        score, tb_fixed, Lx_n, lx_set = _suffix_fixups(
            S_f, I_f, Sn_f, tbk, B, X - 1, rows, row_ge1, ml, mlens_c, is_row_m, (go, ge, *clips)
        )
        _, _, oS, oI, oSn, _, otbk = only
        o_score = _suffix_fixups(oS, oI, oSn, otbk, B, X - 1, rows, row_ge1, ml, mlens_c, is_row_m, (go, ge, *clips))[0]
        assert torch.equal(o_score, score)
        tbfix = (tb_fixed.to(torch.int32) & 0xFFF) | (Ly_f << 12)
        lx_n = torch.where(lx_set, Lx_n, lx.gather(0, nl.long()[None, :])[0])
        walks = [(walk.sweep_walk_custom, walk.sweep_walk_custom_plain)]
        if all(c == 0 for c in clips) and go + ge < 0:
            walks.append((walk.sweep_walk_local, walk.sweep_walk_local_plain))
        for fn, plain in walks:
            wgot = fn(tb, tbfix, lx, lx_n, ml, nl)
            torch.cuda.synchronize()
            for g, w in zip(wgot, plain(tb, tbfix, lx, lx_n, ml, nl)):
                assert torch.equal(g, w)


def test_custom_scan_with_device_scratch_matches_plain(cuda_device):
    """M = 400 (K9's lanes keep their five row layers in shared memory) and
    M = 11,700 (past a warp's budget: the device scratch)."""
    rng = np.random.default_rng(32)
    for M in (400, 11_700):
        args, mlens, nlens = _pairs(rng, 40, M, 30, cuda_device)
        for clips in ((0, 0, 0, 0), (-3, -7, -2, -5)):
            got = _clip_scan(args, -5, -1, clips)
            torch.cuda.synchronize()
            _clip_scans_match(got, _clip_scan(args, -5, -1, clips, plain=True), mlens, nlens)


def test_local_and_custom_aligners_on_card_match_cpu(cuda_device):
    rng = np.random.default_rng(6)
    xs, ys = [], []
    for _ in range(64):
        y = rng.choice(list(b"ACGT"), size=int(rng.integers(1, 170))).astype(np.uint8).tobytes()
        x = bytearray(rng.choice(list(b"ACGT"), size=int(rng.integers(1, 150))).astype(np.uint8).tobytes())
        s = int(rng.integers(0, len(y)))
        x[5 : 5 + 40] = y[s : s + 40]
        xs.append(bytes(x))
        ys.append(y)
    key = lambda a: (a.score, a.xstart, a.xend, a.ystart, a.yend, a.operations)  # noqa: E731
    for sc in (Scoring.from_scores(-5, -1, 2, -2), Scoring.from_scores(-6, -1, 1, -4).xclip(-5).yclip(0)):
        on_card = BatchAligner(sc, device=cuda_device)
        on_cpu = BatchAligner(sc, device="cpu")
        for mode in ("local", "custom"):
            assert [key(a) for a in getattr(on_card, mode)(xs, ys)] == [key(a) for a in getattr(on_cpu, mode)(xs, ys)]
            np.testing.assert_array_equal(on_card.scores(xs, ys, mode), on_cpu.scores(xs, ys, mode))


# ---- substitution LUTs: K11, K18, K12 and K7/K9 fed by the LUT ----


def _protein_pairs(rng, B, M, N, device, alphabet=b"ARNDCQEGHILKMFPSTWYV"):
    """Random pairs over ``alphabet`` with the ragged and edge lengths of
    ``_pairs``."""
    syms = np.frombuffer(alphabet, np.uint8)
    xb = syms[rng.integers(0, len(syms), size=(B, M))]
    yb = syms[rng.integers(0, len(syms), size=(B, N))]
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:4] = [M, 0, M, 1]
    nlens[:4] = [N, N, 0, 1]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (xb, yb, mlens, nlens)], mlens, nlens


def _lut(name, device):
    from rust_bio_tpu_torch.scores import dense_matrix

    return torch.from_numpy(dense_matrix(name)).to(device)


def _lut_scans_match_plain(args, mlens, nlens, lut, go, ge):
    """K11, K18, K12 (y-clips 0 and (-5, -3)), K7 and K9 fed by ``lut``
    against their plain versions on the streams of the same inputs."""
    subs2 = sw.subs2_stream_plain(args[0], args[1], lut)
    ml, nl = args[2], args[3]
    score, tb, tbk = sw.scan_global_lut(*args, go, ge, lut)
    torch.cuda.synchronize()
    ps, ptb, ptbk = sw.scan_global_lut_plain(subs2, ml, nl, go, ge)
    assert torch.equal(score, ps)
    assert torch.equal(_masked(tb, mlens, nlens), _masked(ptb, mlens, nlens))
    assert torch.equal(_masked(tbk, mlens), _masked(ptbk, mlens))
    k18 = sw.scores_global_lut(*args, go, ge, lut)
    assert torch.equal(k18, sw.scores_global_lut_plain(sw.subs_tensor_plain(args[0], args[1], lut), ml, nl, go, ge))
    assert torch.equal(k18, score)
    for ycp, ycs in ((0, 0), (-5, -3)):
        got = sw.scan_semiglobal_lut(*args, go, ge, lut, ycp, ycs)
        torch.cuda.synchronize()
        _semi_finals_match(got, sw.scan_semiglobal_lut_plain(subs2, ml, nl, go, ge, ycp, ycs), mlens, nlens)
    got = sw.scan_local_lut(*args, go, ge, lut)
    torch.cuda.synchronize()
    _clip_scans_match(got, sw.scan_local_lut_plain(subs2, ml, nl, go, ge), mlens, nlens)
    for clips in ((-7, -1, 0, -7), (0, 0, 0, 0)):
        got = sw.scan_custom_lut(*args, go, ge, lut, *clips)
        torch.cuda.synchronize()
        _clip_scans_match(got, sw.scan_custom_lut_plain(subs2, ml, nl, go, ge, *clips), mlens, nlens)


@pytest.mark.parametrize("go,ge", [(-11, -1), (-2, -2)])
def test_lut_scans_match_plain(cuda_device, go, ge):
    """BLOSUM62 protein pairs at B = 96, M = 150, N = 166."""
    args, mlens, nlens = _protein_pairs(np.random.default_rng(41), 96, 150, 166, cuda_device)
    _lut_scans_match_plain(args, mlens, nlens, _lut("blosum62", cuda_device), go, ge)


def test_lut_scans_on_all_bytes_match_plain(cuda_device):
    """256 distinct bytes in the batch (byte 0 and lowercase included), under
    BLOSUM62's dense LUT (out-of-alphabet bytes score as 'A')."""
    rng = np.random.default_rng(42)
    args, mlens, nlens = _protein_pairs(rng, 64, 60, 70, cuda_device, alphabet=bytes(range(256)))
    assert len(torch.unique(torch.cat([args[0].ravel(), args[1].ravel()]))) == 256
    _lut_scans_match_plain(args, mlens, nlens, _lut("blosum62", cuda_device), -11, -1)


def test_lut_kernels_equal_matchparams_kernels(cuda_device):
    """Under the MatchParams table K11 equals K1, K18 equals K3, K12 equals
    K5 and K9 fed by the LUT equals K9."""
    args, mlens, nlens = _pairs(np.random.default_rng(43), 96, 150, 166, cuda_device)
    lut = torch.full((256, 256), -2, dtype=torch.int32, device=cuda_device)
    lut.fill_diagonal_(2)
    score, tb, tbk = sw.scan_global_lut(*args, -5, -1, lut)
    torch.cuda.synchronize()
    ws, wtb, wtbk = sw.scan_global(*args, -5, -1, 2, -2)
    assert torch.equal(score, ws)
    assert torch.equal(_masked(tb, mlens, nlens), _masked(wtb, mlens, nlens))
    assert torch.equal(_masked(tbk, mlens), _masked(wtbk, mlens))
    assert torch.equal(sw.scores_global_lut(*args, -5, -1, lut), sw.scores_global(*args, -5, -1, 2, -2))
    _semi_finals_match(sw.scan_semiglobal_lut(*args, -5, -1, lut, -5, -3), sw.scan_semiglobal(*args, -5, -1, 2, -2, -5, -3), mlens, nlens)
    clips = (-7, -1, 0, -7)
    _clip_scans_match(sw.scan_custom_lut(*args, -5, -1, lut, *clips), sw.scan_custom(*args, -5, -1, 2, -2, *clips), mlens, nlens)
    _clip_scans_match(sw.scan_local_lut(*args, -5, -1, lut), sw.scan_local(*args, -5, -1, 2, -2), mlens, nlens)


def test_lut_semiglobal_and_local_scans_with_device_scratch_match_plain(cuda_device):
    """M = 400: the five column layers of K12 leave shared memory for the
    device scratch; K7 fed by the LUT keeps 29 pairs' layers there."""
    args, mlens, nlens = _protein_pairs(np.random.default_rng(44), 40, 400, 30, cuda_device)
    lut = _lut("pam250", cuda_device)
    subs2 = sw.subs2_stream_plain(args[0], args[1], lut)
    got = sw.scan_semiglobal_lut(*args, -11, -1, lut, -5, -3)
    torch.cuda.synchronize()
    _semi_finals_match(got, sw.scan_semiglobal_lut_plain(subs2, args[2], args[3], -11, -1, -5, -3), mlens, nlens)
    got = sw.scan_local_lut(*args, -11, -1, lut)
    torch.cuda.synchronize()
    _clip_scans_match(got, sw.scan_local_lut_plain(subs2, args[2], args[3], -11, -1), mlens, nlens)


@pytest.mark.parametrize("placement", ["geometry", "scratch"])
@pytest.mark.parametrize("M,N,B", [(1, 40, 8), (150, 166, 48), (450, 457, 24), (4978, 300, 6)])
def test_k18_on_large_tables_matches_plain(cuda_device, monkeypatch, M, N, B, placement):
    """K18 (one warp a pair, ``warp_geometry(M, 2, SCORE_WARP_SHARED_MAX)``)
    on a random table inside +-2^23 and BLOSUM62, gap costs that wrap int32
    among them, with mlens = 0 and nlens = 0 lanes: in the geometry's
    placement (shared memory, 46,080 bytes a warp at M = 4,978) and with
    the scratch forced (``SCORE_WARP_SHARED_MAX`` 0)."""
    if placement == "scratch":
        monkeypatch.setattr(sw, "SCORE_WARP_SHARED_MAX", 0)
    geometry = sw.warp_geometry(M, sw.SCORE_WARP_LAYERS, sw.SCORE_WARP_SHARED_MAX)
    assert geometry[1] == ("scratch" if placement == "scratch" else "shared")
    args, _, _ = _protein_pairs(np.random.default_rng(M + 7), B, M, N, cuda_device, alphabet=bytes(range(256)))
    big = np.random.default_rng(9).integers(-(2**23), 2**23, size=(256, 256)).astype(np.int32)
    for lut in (torch.from_numpy(big).to(cuda_device), _lut("blosum62", cuda_device)):
        for go, ge in ((-11, -1), (0, 0), (-(2**22), -(2**21))):
            got = sw.scores_global_lut(*args, go, ge, lut)
            torch.cuda.synchronize()
            assert torch.equal(got, sw.scores_global_lut_plain(sw.subs_tensor_plain(args[0], args[1], lut), args[2], args[3], go, ge))


K3_MS = [1, 2, 7, 8, 31, 32, 150, 255, 256, 300, 604, 605, 606, 700]


@pytest.mark.parametrize("placement", ["geometry", "scratch"])
@pytest.mark.parametrize("route", ["warp", "rows"])
def test_k3_routes_match_plain(cuda_device, monkeypatch, route, placement):
    """K3's two launches, ``scores_global_warp`` (K18's lanes) and
    ``scores_global_rows`` (one block a pair), against
    ``scores_global_plain`` at M = 1-700 and the three gap costs, with
    related lanes (long diagonals), mlens = 0 and nlens = 0 lanes: in each
    route's own placement and with its state forced into the device
    scratch (``SCORE_WARP_SHARED_MAX`` 0, ``SCORES_ROWS_SHARED_MAX_M``
    -1)."""
    if placement == "scratch":
        monkeypatch.setattr(sw, "SCORE_WARP_SHARED_MAX", 0)
        monkeypatch.setattr(sw, "SCORES_ROWS_SHARED_MAX_M", -1)
    call = sw.scores_global_warp if route == "warp" else sw.scores_global_rows
    rng = np.random.default_rng(61)
    for M in K3_MS:
        where = (sw.warp_geometry(M, sw.SCORE_WARP_LAYERS, sw.SCORE_WARP_SHARED_MAX)[1] if route == "warp"
                 else sw.rows_geometry(M, score_only=True)[2])
        assert where == ("scratch" if placement == "scratch" else "shared")
        args, ml, nl = _pairs(rng, 24, M, M + 9, cuda_device)
        for k in range(4, 24, 2):
            n = int(min(ml[k], nl[k]))
            args[0][k, :n] = args[1][k, :n]
        for go, ge in PENS:
            got = call(*args, go, ge, 2, -2)
            torch.cuda.synchronize()
            assert torch.equal(got, sw.scores_global_plain(*args, go, ge, 2, -2)), (M, go, ge)


@pytest.mark.parametrize("limit", [2, 151, 10_000])
def test_k3_dispatch_across_route_limit(cuda_device, monkeypatch, limit):
    """``scores_global`` on 40 pairs at M = 149-151 and 605-607 with the
    route limit ``SCORES_ROWS_MIN`` forced low, into that range and high:
    each call launches the route ``scores_route`` names, once, and equals
    the plain version."""
    monkeypatch.setattr(sw, "SCORES_ROWS_MIN", limit)
    rng = np.random.default_rng(62)
    for M in (149, 150, 151, 605, 606, 607):
        args, _, _ = _pairs(rng, 40, M, 160, cuda_device)
        route = sw.scores_route(M, 40)
        assert route == ("rows" if M + 1 >= limit else "warp")
        before = sw.SCORES_GLOBAL_WARP.launches, sw.SCORES_GLOBAL_ROWS.launches
        got = sw.scores_global(*args, -5, -1, 2, -2)
        torch.cuda.synchronize()
        after = sw.SCORES_GLOBAL_WARP.launches, sw.SCORES_GLOBAL_ROWS.launches
        assert (after[0] - before[0], after[1] - before[1]) == ((0, 1) if route == "rows" else (1, 0))
        assert torch.equal(got, sw.scores_global_plain(*args, -5, -1, 2, -2))


def _pair_major(tb):
    """An (N, X, B) tb as the (N, X, B) view of a zero-padded pair-major
    (B, N, Xp) copy, Xp = X rounded up to 8 (K13's layout)."""
    N, X, B = tb.shape
    pm = torch.zeros((B, N, -(-X // 8) * 8), dtype=torch.uint16, device=tb.device)
    pm[:, :, :X] = tb.permute(2, 0, 1)
    return pm.permute(1, 2, 0)[:, :X, :]


def _seg_walk_matches_plain(tb, ml, nl):
    """K14 on ``tb`` against its plain version; returns ins_cnt."""
    got = walk.sweep_walk_global_seg(tb, ml, nl)
    torch.cuda.synchronize()
    for g, w in zip(got, walk.sweep_walk_global_seg_plain(tb, ml, nl)):
        assert torch.equal(g.to(torch.int32), w.to(torch.int32))
    return got[0]


@pytest.mark.parametrize("layout", ["pair-major", "contiguous"])
@pytest.mark.parametrize("rb", [16, 128])
def test_seg_walk_tiles_match_plain(cuda_device, layout, rb):
    """K14 (one warp a pair over tb tiles in shared memory, Ins runs past a
    tile followed 256 rows a load) against its plain version on K13's tb:
    its pair-major view (16-byte row loads) and a contiguous (N, X, B)
    copy (a cell a load), at seams every 16 and 128 rows; x carrying
    insertions of 255 to 4,100 rows into 30-120 bp y, related pairs (paths
    near the diagonal), random pairs, and lanes with mlens = 0 or
    nlens = 0."""
    rng = np.random.default_rng(63 + rb)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    inserts = [255, 256, 257, 300, 700, 1500, 2900, 4100]
    xs, ys = [], []
    for ins in inserts:
        y = acgt[rng.integers(0, 4, size=int(rng.integers(30, 121)))]
        at = int(rng.integers(0, y.size + 1))
        xs.append(np.concatenate([y[:at], acgt[rng.integers(0, 4, size=ins)], y[at:]]))
        ys.append(y)
    for _ in range(6):
        y = acgt[rng.integers(0, 4, size=int(rng.integers(100, 400)))]
        x = y.copy()
        x[rng.random(x.size) < 0.05] = acgt[rng.integers(0, 4)]
        xs.append(np.delete(x, rng.integers(0, x.size, size=3)))
        ys.append(y)
    xs += [acgt[rng.integers(0, 4, size=200)], acgt[:0], acgt[rng.integers(0, 4, size=50)]]
    ys += [acgt[rng.integers(0, 4, size=90)], acgt[rng.integers(0, 4, size=40)], acgt[:0]]
    M, N = max(map(len, xs)), max(map(len, ys))
    xb, yb = np.zeros((len(xs), M), np.uint8), np.zeros((len(xs), N), np.uint8)
    for b, (x, y) in enumerate(zip(xs, ys)):
        xb[b, : x.size], yb[b, : y.size] = x, y
    ml = np.array([len(x) for x in xs], np.int32)
    nl = np.array([len(y) for y in ys], np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (xb, yb, ml, nl)]
    for go, ge in PENS:
        _, tb = sw.scan_global_rows(*args, go, ge, 2, -2, rb=rb)
        torch.cuda.synchronize()
        if layout == "contiguous":
            tb = tb.contiguous()
        assert walk._vector_rows(tb) == (layout == "pair-major")
        ins = _seg_walk_matches_plain(tb, args[2], args[3])
        if (go, ge) == (-5, -1):
            assert int(ins[:, 7].to(torch.int32).max()) >= 4100


def test_seg_walk_single_pairs_match_plain(cuda_device):
    """K14 at B = 1 (a contiguous tb whose rows have stride 1: 16-byte
    loads where X is a multiple of 8), mlens = 0, nlens = 0 and both, on
    the plain K13's tb and its pair-major copy."""
    rng = np.random.default_rng(64)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for ml, nl in [(0, 5), (7, 0), (0, 0), (7, 5), (15, 9), (700, 60)]:
        M = max(ml, 15)
        args = [torch.from_numpy(a).to(cuda_device) for a in (
            acgt[rng.integers(0, 4, size=(1, M))], acgt[rng.integers(0, 4, size=(1, max(nl, 9)))],
            np.array([ml], np.int32), np.array([nl], np.int32),
        )]
        _, tb = sw.scan_global_rows_plain(*args, -5, -1, 2, -2, rb=4)
        for t in (tb, _pair_major(tb)):
            assert walk._vector_rows(t) == (t.shape[1] % 8 == 0 or t is not tb)
            _seg_walk_matches_plain(t, args[2], args[3])


# ---- the insertion chain where int32 wraps: every DP scan ----

W24 = 2**24  # at 150 rows, 150 * W24 passes 2^31
# MatchParams kernels: (go, ge, match, mismatch) whose sums pass 2^31 at
# M = 150, and clip sets whose sums with the gap costs wrap
WRAP_MP = [(-W24, -W24, 2 * W24, -2 * W24), (-(2**30), -(2**29), 2**30, -(2**30))]
WRAP_CLIPS = [(MIN, MIN, 0, 0), (-4 * W24, -W24, -2 * W24, -8 * W24), (-(2**30) - 2**28, -(2**29), MIN, -(2**30))]
# LUT kernels: K18's large-table inputs (a random table inside +-2^23 and
# BLOSUM62 at gap costs (-11, -1), (0, 0), (-2^22, -2^21)) and BLOSUM62 at
# (-2^26, -2^25)
WRAP_LUT_GAPS = [(-11, -1), (0, 0), (-(2**22), -(2**21))]


def _wrap_cases(kernel, dev):
    """(call, plain call, kind) triples of one kernel at inputs where int32
    wraps, with mlens = 0 and nlens = 0 lanes (``_pairs`` / ``_protein_pairs``
    lanes 1 and 2)."""
    P = functools.partial
    rng = np.random.default_rng(91)
    cases = []
    if kernel in ("K1", "K3", "K3-rows", "K5", "K7", "K9", "K13", "K15"):
        args, ml, nl = _pairs(rng, 48, 150, 166, dev)
        for k in range(4, 48, 2):  # long diagonals: S grows by the match score
            n = int(min(ml[k], nl[k]))
            args[0][k, :n] = args[1][k, :n]
        for go, ge, ma, mi in WRAP_MP:
            pens = (*args, go, ge, ma, mi)
            if kernel == "K1":
                cases.append((P(sw.scan_global, *pens), P(sw.scan_global_plain, *pens), "global"))
            elif kernel == "K3":
                cases.append((P(sw.scores_global, *pens), P(sw.scores_global_plain, *pens), "score"))
            elif kernel == "K3-rows":
                cases.append((P(sw.scores_global_rows, *pens), P(sw.scores_global_plain, *pens), "score"))
            elif kernel == "K5":
                for yc in ((0, 0), (-W24, -3 * W24)):
                    cases.append((P(sw.scan_semiglobal, *pens, *yc), P(sw.scan_semiglobal_plain, *pens, *yc), "semi"))
            elif kernel == "K7":
                cases.append((P(sw.scan_local, *pens), P(sw.scan_local_plain, *pens), "clip"))
            elif kernel == "K13":
                cases.append((P(sw.scan_global_rows, *pens, rb=32), P(sw.scan_global_rows_plain, *pens, rb=32), "rows"))
            else:
                scan, plain = (sw.scan_custom, sw.scan_custom_plain) if kernel == "K9" else (sw.scan_columns, sw.scan_columns_plain)
                for clips in WRAP_CLIPS:
                    cases.append((P(scan, *pens, *clips), P(plain, *pens, *clips), "clip"))
        return cases, ml, nl
    args, ml, nl = _protein_pairs(rng, 24, 300, 310, dev, alphabet=bytes(range(256)))
    big = torch.from_numpy(np.random.default_rng(9).integers(-(2**23), 2**23, size=(256, 256)).astype(np.int32)).to(dev)
    blosum = _lut("blosum62", dev)
    for lut, (go, ge) in [(big, g) for g in WRAP_LUT_GAPS] + [(blosum, g) for g in WRAP_LUT_GAPS + [(-(2**26), -(2**25))]]:
        subs2 = sw.subs2_stream_plain(args[0], args[1], lut)
        on_card, on_stream = (*args, go, ge, lut), (subs2, args[2], args[3], go, ge)
        if kernel == "K11":
            cases.append((P(sw.scan_global_lut, *on_card), P(sw.scan_global_lut_plain, *on_stream), "global"))
        elif kernel == "K12":
            yc = (-(2**22), -(2**23))
            cases.append((P(sw.scan_semiglobal_lut, *on_card, *yc), P(sw.scan_semiglobal_lut_plain, *on_stream, *yc), "semi"))
        elif kernel == "K7-LUT":
            cases.append((P(sw.scan_local_lut, *on_card), P(sw.scan_local_lut_plain, *on_stream), "clip"))
        elif kernel == "K13-LUT":
            cases.append((P(sw.scan_global_rows_lut, *on_card, rb=32), P(sw.scan_global_rows_lut_plain, *on_card, rb=32), "rows"))
        elif kernel == "K9-LUT":
            for clips in WRAP_CLIPS:
                cases.append((P(sw.scan_custom_lut, *on_card, *clips), P(sw.scan_custom_lut_plain, *on_stream, *clips), "clip"))
        else:
            for clips in WRAP_CLIPS:
                cases.append((P(sw.scan_columns_lut, *on_card, *clips), P(sw.scan_columns_lut_plain, *on_card, *clips), "clip"))
    return cases, ml, nl


WRAP_KERNELS = ["K1", "K3", "K3-rows", "K5", "K7", "K9", "K11", "K7-LUT", "K9-LUT", "K12", "K13", "K13-LUT", "K15", "K15-LUT"]


@pytest.mark.parametrize("placement", ["geometry", "scratch"])
@pytest.mark.parametrize("kernel", WRAP_KERNELS)
def test_scans_match_plain_where_int32_wraps(cuda_device, monkeypatch, kernel, placement):
    """Each of the 13 DP scans (K3 in both its launches: the dispatch at M
    = 150 takes K18's lanes, ``scores_global_rows`` is its long-x launch)
    against its plain version bit for bit at gap costs, scores, tables and
    clips whose sums pass 2^31 (K13 with seams every 32 rows): the kernels
    carry the insertion chain as the JAX kernels' prefix maximum of T - i
    * ge, K13 block by block from its seams, where the recurrence max(I +
    ge, T) they carried before parts from it; in the kernel's own
    placement and with its state forced into the device scratch."""
    if placement == "scratch":
        for name, value in (
            ("WARP_SHARED_MAX", 0), ("SCORE_WARP_SHARED_MAX", 0), ("ROWS_SHARED_MAX_M", -1),
            ("SCORES_ROWS_SHARED_MAX_M", -1), ("COLUMNS_SHARED_MAX_M", -1),
        ):
            monkeypatch.setattr(sw, name, value)
    cases, ml, nl = _wrap_cases(kernel, cuda_device)
    assert cases
    for call, plain, kind in cases:
        got = call()
        torch.cuda.synchronize()
        want = plain()
        if kind == "score":
            assert torch.equal(got, want)
        elif kind in ("global", "rows"):
            assert torch.equal(got[0], want[0])
            assert torch.equal(_masked(got[1], ml, nl), _masked(want[1], ml, nl))
            if kind == "global":
                assert torch.equal(_masked(got[2], ml), _masked(want[2], ml))
        elif kind == "semi":
            _semi_finals_match(got, want, ml, nl)
        else:
            _clip_scans_match(got, want, ml, nl)


def test_lut_aligner_on_card_matches_cpu(cuda_device):
    """``BatchAligner`` under BLOSUM62 and a callable scorer, every mode and
    ``scores``, on the card and on the CPU."""
    from rust_bio_tpu_torch.scores import blosum62

    rng = np.random.default_rng(45)
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    ys = [aa[rng.integers(0, 20, size=int(rng.integers(1, 200)))].tobytes() for _ in range(64)]
    xs = []
    for y in ys:
        s = int(rng.integers(0, len(y)))
        x = bytearray(y[s : s + int(rng.integers(1, 120))])
        for _ in range(len(x) // 5):
            x[int(rng.integers(0, len(x)))] = int(aa[rng.integers(0, 20)])
        xs.append(bytes(x))
    key = lambda a: (a.score, a.xstart, a.xend, a.ystart, a.yend, a.operations)  # noqa: E731
    for sc in (Scoring.new(-11, -1, blosum62), Scoring.new(-5, -2, lambda a, b: 3 if a == b else -1).yclip(-4)):
        on_card = BatchAligner(sc, device=cuda_device)
        on_cpu = BatchAligner(sc, device="cpu")
        for mode in ("global", "semiglobal", "local", "custom"):
            fn = "global_" if mode == "global" else mode
            assert [key(a) for a in getattr(on_card, fn)(xs, ys)] == [key(a) for a in getattr(on_cpu, fn)(xs, ys)], mode
            np.testing.assert_array_equal(on_card.scores(xs, ys, mode), on_cpu.scores(xs, ys, mode))
        assert on_card.global_packed(xs, ys).cigars() == on_cpu.global_packed(xs, ys).cigars()
        assert on_card.semiglobal_packed(xs, ys).cigars() == on_cpu.semiglobal_packed(xs, ys).cigars()


# ---- K11 and K7-LUT (one warp a pair, a pair-major tb) and the walks on it ----

WARP_PENS = [(0, 0), (-11, -1), (-5, -3)]


def _warp_pairs(rng, B, M, N, device, alphabet):
    """``_protein_pairs``' batch over ``alphabet`` with row mlens on a
    stripe's first and last rows, lane 31's rows and a homolog lane (y a
    copy of x: long diagonals); lanes with nlens = 0 every fifth."""
    xb, yb, mlens, nlens = (a.numpy().copy() for a in _protein_pairs(rng, B, M, N, "cpu", alphabet=alphabet)[0])
    R = sw.warp_geometry(M, sw.GLOBAL_WARP_LAYERS)[0]
    for k, v in enumerate((R - 1, R, 2 * R - 1, 31 * R, M - 1)):
        mlens[4 + k] = max(0, min(M, v))
    nlens[9::5] = 0
    n = min(M, N)
    xb[10, :n], mlens[10], nlens[10] = yb[10, :n], n, n
    return [torch.from_numpy(a).to(device) for a in (xb, yb, mlens, nlens)], mlens, nlens


def _warp_luts(device):
    """(LUT, gap costs) cases: BLOSUM62's dense LUT at each of
    ``WARP_PENS``; a LUT near +-2^30, whose sums of a few entries wrap
    int32, at gap extension 0 (``test_scans_match_plain_where_int32_wraps``
    holds the chain where i * ge wraps too)."""
    rng = np.random.default_rng(61)
    vals = rng.integers(2**30 - 2**20, 2**30, size=(256, 256)) * rng.choice([-1, 1], size=(256, 256))
    wrap = torch.from_numpy(vals.astype(np.int32)).to(device)
    blosum = _lut("blosum62", device)
    return [(blosum, pens) for pens in WARP_PENS] + [(wrap, (0, 0)), (wrap, (-11, 0))]


def _warp_cases(M, placement, monkeypatch, layers):
    if placement == "scratch":
        monkeypatch.setattr(sw, "WARP_SHARED_MAX", 0)
    assert sw.warp_geometry(M, layers)[1] == placement


def _walks_on_both_layouts(tb, fns):
    """Each walk on ``tb`` (the pair-major view) and on its contiguous copy
    against its plain version, and the two equal."""
    for fn, plain, inputs in fns:
        for t in (tb, tb.contiguous()):
            got = fn(t, *inputs)
            torch.cuda.synchronize()
            for g, w in zip(got, plain(t, *inputs)):
                assert torch.equal(g, w), fn.__name__


@pytest.mark.parametrize("placement", ["shared", "scratch"])
@pytest.mark.parametrize("M", [1, 7, 31, 32, 33, 255, 256, 450, 511, 604])
def test_warp_global_lut_scan_and_walk_match_plain(cuda_device, monkeypatch, M, placement):
    """K11 with traceback and score-only against its plain version bit for
    bit: all 256 bytes under ``_warp_luts``' LUTs and gap costs, the row
    state in shared memory and in the device scratch; then K2 on its
    pair-major view and on a contiguous copy against the plain K2."""
    _warp_cases(M, placement, monkeypatch, sw.GLOBAL_WARP_LAYERS)
    rng = np.random.default_rng(60 + M)
    args, mlens, nlens = _warp_pairs(rng, 40, M, 48, cuda_device, bytes(range(256)))
    ml, nl = args[2], args[3]
    for lut, (go, ge) in _warp_luts(cuda_device):
        score, tb, tbk = sw.scan_global_lut(*args, go, ge, lut)
        torch.cuda.synchronize()
        ps, ptb, ptbk = sw.scan_global_lut_plain(sw.subs2_stream_plain(args[0], args[1], lut), ml, nl, go, ge)
        assert torch.equal(score, ps)
        assert tb.shape == ptb.shape and tb.stride()[1] == 1  # the pair-major view
        assert torch.equal(_masked(tb, mlens, nlens), _masked(ptb, mlens, nlens))
        assert torch.equal(_masked(tbk, mlens), _masked(ptbk, mlens))
        only, none, otbk = sw.scan_global_lut(*args, go, ge, lut, traceback=False)
        assert none is None and torch.equal(only, ps) and torch.equal(_masked(otbk, mlens), _masked(ptbk, mlens))
        _walks_on_both_layouts(tb, [(walk.sweep_walk_global, walk.sweep_walk_global_plain, (ml, nl))])


def _local_walk_inputs(scan, ml, nl, go, ge, clips=(0, 0, 0, 0)):
    from rust_bio_tpu_torch.alignment.pairwise.batched import _geometry, _suffix_fixups

    tb, lx, S_f, I_f, Sn_f, Ly_f, tbk = scan
    B, X = S_f.shape
    rows, row_ge1, mlens_c, is_row_m = _geometry(B, X - 1, ml)
    _, tb_fixed, Lx_n, lx_set = _suffix_fixups(
        S_f, I_f, Sn_f, tbk, B, X - 1, rows, row_ge1, ml, mlens_c, is_row_m, (go, ge, *clips)
    )
    tbfix = (tb_fixed.to(torch.int32) & 0xFFF) | (Ly_f << 12)
    return tbfix, lx, torch.where(lx_set, Lx_n, lx.gather(0, nl.long()[None, :])[0])


@pytest.mark.parametrize(
    "M,placement",
    [(m, p) for m in (1, 7, 31, 32, 33, 255, 256, 450, 511, 604, 1000) for p in ("shared", "scratch")] + [(4094, "scratch")],
)
def test_warp_local_lut_scan_and_walks_match_plain(cuda_device, monkeypatch, M, placement):
    """K7-LUT with traceback and score-only against its plain version bit
    for bit, as the K11 test holds K11 (M up to 4,094, where its state
    leaves shared memory; lx and the finals too); then K8 (where go + ge <
    0) and K10, and
    ``local_entry``, on its pair-major view and on a contiguous copy against
    their plain versions."""
    _warp_cases(M, placement, monkeypatch, sw.LOCAL_WARP_LAYERS)
    rng = np.random.default_rng(70 + M)
    B, N = (40, 48) if M <= 604 else (12, 24)
    args, mlens, nlens = _warp_pairs(rng, B, M, N, cuda_device, bytes(range(256)))
    ml, nl = args[2], args[3]
    for lut, (go, ge) in _warp_luts(cuda_device):
        got = sw.scan_local_lut(*args, go, ge, lut)
        torch.cuda.synchronize()
        want = sw.scan_local_lut_plain(sw.subs2_stream_plain(args[0], args[1], lut), ml, nl, go, ge)
        assert got[0].shape == want[0].shape and got[0].stride()[1] == 1  # the pair-major view
        _clip_scans_match(got, want, mlens, nlens)
        only = sw.scan_local_lut(*args, go, ge, lut, traceback=False)
        assert only[0] is None and only[1] is None
        for g, w in zip(only[2:6], got[2:6]):
            assert torch.equal(_masked(g, mlens), _masked(w, mlens))
        assert torch.equal(_masked(only[6], mlens), _masked(got[6] & 0xFFF, mlens))
        tbfix, lx, lx_n = _local_walk_inputs(got, ml, nl, go, ge)
        inputs = (tbfix, lx, lx_n, ml, nl)
        fns = [(walk.sweep_walk_custom, walk.sweep_walk_custom_plain, inputs)]
        if go + ge < 0:
            fns.append((walk.sweep_walk_local, walk.sweep_walk_local_plain, inputs))
        _walks_on_both_layouts(got[0], fns)
        for g, w in zip(walk.local_entry(got[0], lx, tbfix, lx_n, ml, nl),
                        walk.local_entry(got[0].contiguous(), lx, tbfix, lx_n, ml, nl)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("placement", ["shared", "scratch"])
def test_warp_local_scan_and_walks_match_plain(cuda_device, monkeypatch, placement):
    """K7 (csrc/sw_warp.cu: K7-LUT's lanes under match / mismatch scores)
    with traceback and score-only against ``scan_local_plain`` bit for bit
    at M = 1-700 (``K3_MS``) and four gap costs, related lanes (long
    diagonals), mlens = 0 and nlens = 0 lanes, the row state in shared
    memory and in the device scratch; then K8 (where go + ge < 0) and K10
    on its pair-major view and on a contiguous copy against their plain
    versions."""
    rng = np.random.default_rng(75)
    for M in K3_MS:
        _warp_cases(M, placement, monkeypatch, sw.LOCAL_WARP_LAYERS)
        args, mlens, nlens = _pairs(rng, 24, M, M + 9, cuda_device)
        for k in range(4, 24, 2):
            n = int(min(mlens[k], nlens[k]))
            args[0][k, :n] = args[1][k, :n]
        ml, nl = args[2], args[3]
        for go, ge in PENS + [(0, 0)]:
            got = sw.scan_local(*args, go, ge, 2, -2)
            torch.cuda.synchronize()
            want = sw.scan_local_plain(*args, go, ge, 2, -2)
            assert got[0].shape == want[0].shape and got[0].stride()[1] == 1, M  # the pair-major view
            _clip_scans_match(got, want, mlens, nlens)
            only = sw.scan_local(*args, go, ge, 2, -2, traceback=False)
            assert only[0] is None and only[1] is None
            for g, w in zip(only[2:6], got[2:6]):
                assert torch.equal(_masked(g, mlens), _masked(w, mlens))
            assert torch.equal(_masked(only[6], mlens), _masked(got[6] & 0xFFF, mlens))
            tbfix, lx, lx_n = _local_walk_inputs(got, ml, nl, go, ge)
            inputs = (tbfix, lx, lx_n, ml, nl)
            fns = [(walk.sweep_walk_custom, walk.sweep_walk_custom_plain, inputs)]
            if go + ge < 0:
                fns.append((walk.sweep_walk_local, walk.sweep_walk_local_plain, inputs))
            _walks_on_both_layouts(got[0], fns)


CLIP_CHOICES = (MIN, 0, -7)


@pytest.mark.parametrize("placement", ["shared", "scratch"])
def test_warp_custom_scan_and_walk_match_plain(cuda_device, monkeypatch, placement):
    """K9 (csrc/sw_warp.cu: K9-LUT's lanes under match / mismatch scores)
    with traceback and score-only against ``scan_custom_plain`` bit for bit
    at M = 1-700 (``K3_MS``), four clip sets of {MIN_SCORE, 0, -7} an M and
    the gap costs of ``PENS`` and (0, 0) in turn, related lanes (long
    diagonals), mlens = 0 and nlens = 0 lanes, the row state in shared
    memory and in the device scratch; then, on the first clip set of each
    M, K10 on its pair-major view and on a contiguous copy against the
    plain K10."""
    rng = np.random.default_rng(76)
    clip_sets = list(itertools.product(CLIP_CHOICES, repeat=4))
    gaps = PENS + [(0, 0)]
    for n, M in enumerate(K3_MS):
        _warp_cases(M, placement, monkeypatch, sw.LOCAL_WARP_LAYERS)
        args, mlens, nlens = _pairs(rng, 24, M, M + 9, cuda_device)
        for k in range(4, 24, 2):
            m = int(min(mlens[k], nlens[k]))
            args[0][k, :m] = args[1][k, :m]
        ml, nl = args[2], args[3]
        for c in range(4):
            clips = clip_sets[(7 * n + 13 * c) % len(clip_sets)]
            go, ge = gaps[c % len(gaps)]
            got = sw.scan_custom(*args, go, ge, 2, -2, *clips)
            torch.cuda.synchronize()
            want = sw.scan_custom_plain(*args, go, ge, 2, -2, *clips)
            assert got[0].shape == want[0].shape and got[0].stride()[1] == 1, M  # the pair-major view
            _clip_scans_match(got, want, mlens, nlens)
            only = sw.scan_custom(*args, go, ge, 2, -2, *clips, traceback=False)
            assert only[0] is None and only[1] is None
            for g, w in zip(only[2:6], got[2:6]):
                assert torch.equal(_masked(g, mlens), _masked(w, mlens))
            assert torch.equal(_masked(only[6], mlens), _masked(got[6] & 0xFFF, mlens))
            if c == 0:
                inputs = _local_walk_inputs(got, ml, nl, go, ge, clips) + (ml, nl)
                _walks_on_both_layouts(got[0], [(walk.sweep_walk_custom, walk.sweep_walk_custom_plain, inputs)])


@pytest.mark.parametrize(
    "M,placement",
    [(m, p) for m in (1, 7, 31, 32, 33, 255, 256, 450, 511, 604, 1000) for p in ("shared", "scratch")] + [(4094, "scratch")],
)
def test_custom_warp_lut_scan_and_walk_match_plain(cuda_device, monkeypatch, M, placement):
    """K9-LUT with traceback and score-only against its plain version bit
    for bit, as the K7-LUT test holds K7-LUT: every combination of the four
    clips over {MIN_SCORE, 0, -7}, the LUTs and gap costs of ``_warp_luts``
    in turn, M up to 4,094, both placements, mlens = 0 and nlens = 0 lanes;
    then K10 on its pair-major view and on a contiguous copy against the
    plain K10."""
    from rust_bio_tpu_torch.alignment.pairwise.batched import _geometry, _suffix_fixups

    _warp_cases(M, placement, monkeypatch, sw.LOCAL_WARP_LAYERS)
    rng = np.random.default_rng(90 + M)
    B, N = (40, 48) if M <= 604 else (12, 24)
    args, mlens, nlens = _warp_pairs(rng, B, M, N, cuda_device, bytes(range(256)))
    ml, nl = args[2], args[3]
    luts = _warp_luts(cuda_device)
    for k, clips in enumerate(itertools.product(CLIP_CHOICES, repeat=4)):
        lut, (go, ge) = luts[k % len(luts)]
        got = sw.scan_custom_lut(*args, go, ge, lut, *clips)
        torch.cuda.synchronize()
        want = sw.scan_custom_lut_plain(sw.subs2_stream_plain(args[0], args[1], lut), ml, nl, go, ge, *clips)
        assert got[0].shape == want[0].shape and got[0].stride()[1] == 1  # the pair-major view
        _clip_scans_match(got, want, mlens, nlens)
        only = sw.scan_custom_lut(*args, go, ge, lut, *clips, traceback=False)
        assert only[0] is None and only[1] is None
        for g, w in zip(only[2:6], got[2:6]):
            assert torch.equal(_masked(g, mlens), _masked(w, mlens))
        assert torch.equal(_masked(only[6], mlens), _masked(got[6] & 0xFFF, mlens))
        if k % 9 == 0:
            tb, lx, S_f, I_f, Sn_f, Ly_f, tbk = got
            Bq, X = S_f.shape
            rows, row_ge1, mlens_c, is_row_m = _geometry(Bq, X - 1, ml)
            _, tb_fixed, Lx_n, lx_set = _suffix_fixups(
                S_f, I_f, Sn_f, tbk, Bq, X - 1, rows, row_ge1, ml, mlens_c, is_row_m, (go, ge, *clips)
            )
            tbfix = (tb_fixed.to(torch.int32) & 0xFFF) | (Ly_f << 12)
            lx_n = torch.where(lx_set, Lx_n, lx.gather(0, nl.long()[None, :])[0])
            _walks_on_both_layouts(tb, [(walk.sweep_walk_custom, walk.sweep_walk_custom_plain, (tbfix, lx, lx_n, ml, nl))])


@pytest.mark.parametrize(
    "M,placement",
    [(m, p) for m in (1, 7, 31, 32, 33, 255, 256, 450, 511, 604, 1000) for p in ("shared", "scratch")] + [(4094, "scratch")],
)
def test_warp_semiglobal_lut_scan_and_walk_match_plain(cuda_device, monkeypatch, M, placement):
    """K12 with traceback and score-only against its plain version bit for
    bit, as the K11 test holds K11 (M up to 4,094, both placements, y-clips
    0/0 and (-5, -3)); then K6 on its pair-major view and on a contiguous
    copy against the plain K6."""
    _warp_cases(M, placement, monkeypatch, sw.LOCAL_WARP_LAYERS)
    rng = np.random.default_rng(80 + M)
    B, N = (40, 48) if M <= 604 else (12, 24)
    args, mlens, nlens = _warp_pairs(rng, B, M, N, cuda_device, bytes(range(256)))
    ml, nl = args[2], args[3]
    for lut, (go, ge) in _warp_luts(cuda_device):
        for ycp, ycs in ((0, 0), (-5, -3)):
            got = sw.scan_semiglobal_lut(*args, go, ge, lut, ycp, ycs)
            torch.cuda.synchronize()
            want = sw.scan_semiglobal_lut_plain(sw.subs2_stream_plain(args[0], args[1], lut), ml, nl, go, ge, ycp, ycs)
            assert got[0].shape == want[0].shape and got[0].stride()[1] == 1  # the pair-major view
            _semi_finals_match(got, want, mlens, nlens)
            only = sw.scan_semiglobal_lut(*args, go, ge, lut, ycp, ycs, traceback=False)
            assert only[0] is None
            for g, w in zip(only[1:], got[1:]):
                assert torch.equal(_masked(g, mlens), _masked(w, mlens))
            _, tbfix = _fixed_column(*got[1:], ml, go, ge)
            _walks_on_both_layouts(
                got[0], [(walk.sweep_walk_semiglobal, walk.sweep_walk_semiglobal_plain, (tbfix, ml, nl))]
            )


@pytest.mark.parametrize(
    "M,placement",
    [(m, p) for m in (1, 7, 31, 32, 33, 150, 255, 256, 450, 604) for p in ("shared", "scratch")] + [(4095, "scratch")],
)
def test_warp_semiglobal_scan_and_walk_match_plain(cuda_device, monkeypatch, M, placement):
    """K5 (``scan_semiglobal_warp_kernel``'s MatchParams instantiation, K12's
    lanes) with traceback and score-only against its plain version bit for
    bit: tb over the defined cells, the finals; mlens on a stripe's first
    and last rows and lane 31's, lanes with nlens = 0 and mlens = 0, long
    diagonals, y-clips 0/0 and (-5, -3); the row state in shared memory and
    in the device scratch (M = 4,095: R = 128, the geometry's scratch).
    Then K6 on its pair-major view and on a contiguous copy against the
    plain K6."""
    _warp_cases(M, placement, monkeypatch, sw.LOCAL_WARP_LAYERS)
    rng = np.random.default_rng(90 + M)
    B, N = (48, 166) if M <= 604 else (12, 24)
    args, mlens, nlens = _warp_pairs(rng, B, M, N, cuda_device, b"ACGT")
    ml, nl = args[2], args[3]
    for go, ge in PENS:
        for ycp, ycs in ((0, 0), (-5, -3)):
            got = sw.scan_semiglobal(*args, go, ge, 2, -2, ycp, ycs)
            torch.cuda.synchronize()
            want = sw.scan_semiglobal_plain(*args, go, ge, 2, -2, ycp, ycs)
            assert got[0].shape == want[0].shape
            assert got[0].stride() == (sw.pair_major_pitch(M), 1, N * sw.pair_major_pitch(M))  # the pair-major view
            _semi_finals_match(got, want, mlens, nlens)
            only = sw.scan_semiglobal(*args, go, ge, 2, -2, ycp, ycs, traceback=False)
            assert only[0] is None
            for g, w in zip(only[1:], got[1:]):
                assert torch.equal(_masked(g, mlens), _masked(w, mlens))
            if (ycp, ycs) == (0, 0):
                _, tbfix = _fixed_column(*got[1:], ml, go, ge)
                _walks_on_both_layouts(
                    got[0], [(walk.sweep_walk_semiglobal, walk.sweep_walk_semiglobal_plain, (tbfix, ml, nl))]
                )


def _sweep_cells(rng, N, X, B):
    """Synthetic K2 / K6 traceback cells, numpy (N, X, B) uint16: the i-,
    d- and s-bits drawn by lane kind (b % 4: long Match/Subst diagonals
    that cross 32-column edges; Ins s-bits over stretches of 15 to 150 Ins
    i-bits down a column, across 32- and 96-row edges; Del runs along a
    row; every code 0..15 alike) and the run nibble (bits 12-15) the capped
    run of Ins i-bits ending at each row, as the scans write it."""
    cells = np.zeros((N, X, B), np.int64)
    other = [0, 1, 2, 3, 4, 7, 9]
    for b in range(B):
        kind = b % 4
        shape = (N, X)
        if kind == 3:
            i_bits, d_bits, s_bits = (rng.integers(0, 16, size=shape) for _ in range(3))
        else:
            favour = [[3, 4], [1, 3, 4], [2]][kind]
            p = [0.97, 0.5, 0.45][kind]
            s_bits = np.where(rng.random(shape) < p, rng.choice(favour, size=shape), rng.choice(other, size=shape))
            i_bits = np.where(rng.random(shape) < (0.985 if kind == 1 else 0.3), 1, rng.choice(other, size=shape))
            if kind == 1:
                for j in range(N):
                    lo = int(rng.integers(0, X))
                    i_bits[j, lo : lo + int(rng.integers(15, 151))] = 1
            d_bits = np.where(rng.random(shape) < (0.95 if kind == 2 else 0.3), 2, rng.choice(other, size=shape))
        cells[:, :, b] = i_bits | d_bits << 4 | s_bits << 8
    run = np.zeros((N, B), np.int64)
    for r in range(X):
        run = np.where((cells[:, r] & 0xF) == 1, run + 1, 0)
        cells[:, r] |= np.minimum(run, 15) << 12
    return cells.astype(np.uint16)


def _fixed_cells(rng, X, B, mlens, nlens):
    """Synthetic K6 fixed columns, numpy (B, X) int32: 12-bit cells with
    Ly << 12 (Ly in -2..nlens + 2), the cell at row mlens by lane kind (b %
    6): Ins s-bits over Ins i-bits up to row 1 (the exit row's neighbour
    -1 wraps to row X - 1), up to row 0 (the prolog's 2^20 sentinel run),
    a Yclip-prefix exit, a Yclip-suffix exit, an Ins run of 20-60 rows
    that exits Match, Subst or Del into the sweep, or mostly such an exit
    at once."""
    cells = rng.integers(0, 1 << 12, size=(B, X))
    ly = rng.integers(-2, int(max(nlens.max(), 0)) + 3, size=(B, X))
    for b in range(B):
        m, kind = int(mlens[b]), b % 6
        if kind in (0, 1, 4):
            lo = {0: 1, 1: 0, 4: max(m - int(rng.integers(20, 61)), 0)}[kind]
            cells[b, lo : m + 1] = (cells[b, lo : m + 1] & ~0xF) | 1
            if lo:
                cells[b, lo - 1] = (cells[b, lo - 1] & ~0xF) | int(rng.choice([2, 3, 4]))
            cells[b, m] = (cells[b, m] & ~0xF00) | 1 << 8
        elif kind in (2, 3):
            cells[b, m] = (cells[b, m] & ~0xF00) | (7 if kind == 2 else 8) << 8
        elif rng.random() < 0.8:
            cells[b, m] = (cells[b, m] & ~0xF00) | int(rng.choice([2, 3, 4])) << 8
    return (cells | ly << 12).astype(np.int32)


def _sweep_inputs(rng, N, X, B, device):
    """(tb, tbfix, mlens, nlens) on ``device``: ``_sweep_cells``,
    ``_fixed_cells``, mlens on rows 0, X - 1 and at random, nlens 0, N and
    at random."""
    mlens = rng.integers(0, X, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:4], nlens[:4] = [X - 1, 0, X - 1, 0], [N, N, 0, 0]
    mlens[4 : B // 2], nlens[4 : B // 2] = X - 1, N
    tb = torch.from_numpy(_sweep_cells(rng, N, X, B).astype(np.int32)).to(torch.uint16)
    tbfix = torch.from_numpy(_fixed_cells(rng, X, B, mlens, nlens))
    return [t.to(device) for t in (tb, tbfix, torch.from_numpy(mlens), torch.from_numpy(nlens))]


def _clip_cells(rng, Nc, X, B, mlens):
    """Synthetic K8 / K10 traceback cells, numpy (Nc, X, B) uint16 (column 0
    at index 0), by lane kind (b % 5): long Match/Subst diagonals across
    32-column edges; Ins runs of 15 to 150 rows down a column, past 32
    rows and the nibble's cap, exiting through any layer; Del rows across
    32-column edges; clips (Xclip-suffix s-bits at row mlens, Xclip-prefix
    and Yclip-prefix exits, row 0's s-bits a Del, Yclip-prefix or Start
    post); every code 0..15 alike. Bits 12-15: the capped run of Ins
    i-bits ending at each row, as the scans write it."""
    cells = np.zeros((Nc, X, B), np.int64)
    other = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]
    for b in range(B):
        kind = b % 5
        shape = (Nc, X)
        if kind == 4:
            i_bits, d_bits, s_bits = (rng.integers(0, 16, size=shape) for _ in range(3))
        else:
            favour = [[3, 4], [1, 3, 4], [2], [5, 6, 7, 0, 3, 4, 1]][kind]
            p = [0.97, 0.5, 0.45, 0.6][kind]
            s_bits = np.where(rng.random(shape) < p, rng.choice(favour, size=shape), rng.choice(other, size=shape))
            exits = [5, 7, 3, 4, 2, 0, 5] if kind == 1 else other  # an Ins run's exit: Xclip-prefix often
            i_bits = np.where(rng.random(shape) < (0.985 if kind == 1 else 0.3), 1, rng.choice(exits, size=shape))
            if kind == 1:
                for j in range(Nc):
                    lo = int(rng.integers(0, X))
                    i_bits[j, lo : lo + int(rng.integers(15, 151))] = 1
            d_bits = np.where(rng.random(shape) < (0.985 if kind == 2 else 0.3), 2, rng.choice(other, size=shape))
        if kind == 3:
            s_bits[rng.random(Nc) < 0.7, mlens[b]] = 6
        if kind != 4:  # row 0's s-bits: an Xclip-prefix's post, Del, Yclip-prefix and Start by turns
            s_bits[:, 0] = np.array([2, 7, 0])[(np.arange(Nc) + b) % 3]
        cells[:, :, b] = i_bits | d_bits << 4 | s_bits << 8
    run = np.zeros((Nc, B), np.int64)
    for r in range(X):
        run = np.where((cells[:, r] & 0xF) == 1, run + 1, 0)
        cells[:, r] |= np.minimum(run, 15) << 12
    return cells.astype(np.uint16)


def _clip_fixed_cells(rng, X, B, mlens, nlens, lx_n):
    """Synthetic K8 / K10 fixed columns, numpy (B, X) int32: 12-bit cells
    with Ly << 12 (Ly in 0..nlens + 2: a y-suffix clip length, never
    negative in a scan), the cell at row mlens by lane kind (b // 5 % 8, so
    that each kind meets each of ``_clip_cells``' lane kinds): an Ins run
    up to row 1, up to row 0 (the prolog's 2^20 sentinel run), a
    Yclip-prefix exit, a Yclip-suffix exit, an Ins run of 20-60 rows exiting
    Match, Subst, Del or Xclip-prefix, an Xclip-suffix jump of ``lx_n`` rows
    (to a negative row where lx_n > mlens) onto an Ins run with an
    Xclip-prefix exit, then row 0 an Xclip-suffix again (more than four
    emits), an Xclip-prefix exit with row 0's post, or mostly a Match,
    Subst or Del exit into the sweep."""
    cells = rng.integers(0, 1 << 12, size=(B, X))
    ly = rng.integers(0, int(max(nlens.max(), 0)) + 3, size=(B, X))

    def put(b, row, s=None, i=None):
        row %= X
        if s is not None:
            cells[b, row] = (cells[b, row] & ~0xF00) | s << 8
        if i is not None:
            cells[b, row] = (cells[b, row] & ~0xF) | i

    for b in range(B):
        m, kind = int(mlens[b]), b // 5 % 8
        if kind in (0, 1, 4):
            lo = {0: 1, 1: 0, 4: max(m - int(rng.integers(20, 61)), 0)}[kind]
            cells[b, lo : m + 1] = (cells[b, lo : m + 1] & ~0xF) | 1
            if lo:
                put(b, lo - 1, i=int(rng.choice([2, 3, 4, 5])))
            if kind == 0:  # a Del exit at row 0 carries row -1's d-bits: row X - 1's, as JAX wraps it
                put(b, 0, i=2)
                cells[b, 0] = (cells[b, 0] & ~0xF0) | 2 << 4
                cells[b, X - 1] = (cells[b, X - 1] & ~0xF0) | int(rng.choice([3, 4])) << 4
            put(b, m, s=1)
        elif kind in (2, 3):
            put(b, m, s=7 if kind == 2 else 8)
        elif kind == 5:
            put(b, m, s=6)
            top = m - int(lx_n[b])
            put(b, top, s=1, i=1)
            put(b, top - 1, i=1)
            put(b, top - 2, i=5)
            put(b, 0, s=6)
        elif kind == 6:
            put(b, m, s=5)
            put(b, 0, s=int(rng.choice([2, 7, 0, 6, 3])))
        elif rng.random() < 0.9:
            put(b, m, s=int(rng.choice([2, 3, 4])))
    return (cells | ly << 12).astype(np.int32)


def _clip_inputs(rng, N, X, B, device):
    """(tb (N+1, X, B), tbfix, lx, lx_n, mlens, nlens) on ``device`` for K8
    and K10: ``_clip_cells``, ``_clip_fixed_cells``; lx mostly within the
    rows above mlens, else up to X + 2 (a jump to a negative row); mlens
    on rows 0, X - 1 and at random, nlens 0, N and at random."""
    mlens = rng.integers(0, X, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:4], nlens[:4] = [X - 1, 0, X - 1, 0], [N, N, 0, 0]
    mlens[4 : B // 2], nlens[4 : B // 2] = X - 1, N
    near = rng.random(size=(N + 1, B)) < 0.85
    lx = np.where(near, rng.integers(0, mlens + 1, size=(N + 1, B)), rng.integers(0, X + 3, size=(N + 1, B)))
    lx_n = np.where(rng.random(B) < 0.8, rng.integers(0, mlens + 1), rng.integers(0, X + 3, size=B)).astype(np.int32)
    tb = torch.from_numpy(_clip_cells(rng, N + 1, X, B, mlens).astype(np.int32)).to(torch.uint16)
    tbfix = torch.from_numpy(_clip_fixed_cells(rng, X, B, mlens, nlens, lx_n))
    arrays = (tbfix, lx.astype(np.int32), lx_n, mlens, nlens)
    return [tb.to(device)] + [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


@pytest.mark.parametrize("N,X,B", [(70, 203, 29), (150, 151, 300), (33, 97, 5), (24, 4095, 12), (1, 1, 5), (800, 40, 21)])
def test_sweep_walks_on_synthetic_cells_match_plain(cuda_device, N, X, B):
    """K2 and K6 (with its fused prolog) against their plain versions bit
    for bit on ``_sweep_cells`` / ``_fixed_cells``: Ins runs past 32 and 96
    rows and the nibble's cap, diagonals past 32 columns, Del runs, every
    layer code, the fixed column's edge cases, X not a multiple of 8, B not
    a multiple of the warps a block, X = 4,095 (K5's limit), N = 800 (past
    the outputs' stage: direct stores); on a contiguous tb and on a
    pair-major view with poisoned padding rows."""
    tb, tbfix, ml, nl = _sweep_inputs(np.random.default_rng(N + X + B), N, X, B, cuda_device)
    for t in (tb, _poisoned_view(tb)):
        for fn, plain, inputs in (
            (walk.sweep_walk_global, walk.sweep_walk_global_plain, (ml, nl)),
            (walk.sweep_walk_semiglobal, walk.sweep_walk_semiglobal_plain, (tbfix, ml, nl)),
        ):
            got = fn(t, *inputs)
            torch.cuda.synchronize()
            for k, (g, w) in enumerate(zip(got, plain(t, *inputs))):
                assert torch.equal(g, w), (fn.__name__, k)


def test_fused_prolog_fields_match_resolve_fixed_column(cuda_device):
    """K6's prolog, resolved in the kernel, field by field against
    ``resolve_fixed_column`` on ``_fixed_cells``' edge cases (Ins runs to
    row 1 and to row 0, Yclip-prefix and Yclip-suffix exits, long Ins runs,
    mlens = 0 lanes, fixed columns past 32 rows, X = 4,095): fix_ins, fix_exit, fix_ly
    and yend equal the prolog's, ystart the prolog's unless the sweep took
    a Yclip-prefix exit further right."""
    rng = np.random.default_rng(31)
    for N, X, B in ((40, 9, 24), (40, 203, 48), (12, 4095, 24)):
        tb, tbfix, ml, nl = _sweep_inputs(rng, N, X, B, cuda_device)
        got = walk.sweep_walk_semiglobal(tb, tbfix, ml, nl)
        torch.cuda.synchronize()
        fix_ins, fix_exit, fix_ly, *_, ystart0, yend0 = walk.resolve_fixed_column(tbfix, ml, nl)
        for k, want in ((3, fix_ins), (4, fix_exit), (5, fix_ly), (7, yend0)):
            assert torch.equal(got[k], want), k
        swept = torch.where(got[1].to(torch.int32) == YCLIP_PREFIX, torch.arange(1, N + 1, device=cuda_device)[:, None], 0)
        assert torch.equal(got[6], torch.maximum(ystart0, swept.amax(dim=0).to(torch.int32)))
        kinds = torch.arange(B, device=cuda_device) % 6
        assert bool((fix_ins[kinds == 1] > 2**20).all()) and bool((fix_exit[kinds == 2] == YCLIP_PREFIX).all())


def _homologs(rng, B, M, N, device):
    """Protein pairs as chip_smoke.py's homolog corpus makes them: x of up
    to M residues, y x at 30% substitutions and 3% single-residue indels,
    at most N long."""
    syms = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    xb = np.zeros((B, M), np.uint8)
    yb = np.zeros((B, N), np.uint8)
    mlens = np.zeros(B, np.int32)
    nlens = np.zeros(B, np.int32)
    for b in range(B):
        x = syms[rng.integers(0, 20, size=int(rng.integers(M // 2, M + 1)))]
        y = []
        for c in x:
            r = rng.random()
            if r < 0.015:
                continue
            y.append(syms[rng.integers(0, 20)] if r < 0.3 else c)
            if rng.random() < 0.015:
                y.append(syms[rng.integers(0, 20)])
        y = np.array(y[:N], np.uint8)
        xb[b, : len(x)], yb[b, : len(y)], mlens[b], nlens[b] = x, y, len(x), len(y)
    return [torch.from_numpy(a).to(device) for a in (xb, yb, mlens, nlens)]


def test_sweep_walks_on_protein_views_match_plain(cuda_device):
    """K2 on K11's pair-major view of 450 x 457 homologs and K6 on K12's
    view of 200 x 450 domain-shaped pairs under BLOSUM62 (-11, -1), on the
    views and on contiguous copies, against their plain versions."""
    rng = np.random.default_rng(32)
    lut = _lut("blosum62", cuda_device)
    hom = _homologs(rng, 64, 450, 457, cuda_device)
    tb = sw.scan_global_lut(*hom, -11, -1, lut)[1]
    _walks_on_both_layouts(tb, [(walk.sweep_walk_global, walk.sweep_walk_global_plain, (hom[2], hom[3]))])
    dom = _homologs(rng, 64, 200, 450, cuda_device)
    got = sw.scan_semiglobal_lut(*dom, -11, -1, lut, 0, 0)
    _, tbfix = _fixed_column(*got[1:], dom[2], -11, -1)
    _walks_on_both_layouts(got[0], [(walk.sweep_walk_semiglobal, walk.sweep_walk_semiglobal_plain, (tbfix, dom[2], dom[3]))])


CLIP_WALKS = [
    (walk.sweep_walk_custom, walk.sweep_walk_custom_plain, walk.SWEEP_WALK_CUSTOM),
    (walk.sweep_walk_local, walk.sweep_walk_local_plain, walk.SWEEP_WALK_LOCAL),
]


@pytest.mark.parametrize(
    "N,X,B", [(70, 203, 80), (150, 151, 300), (33, 97, 5), (24, 4095, 12), (1, 1, 5), (0, 9, 8), (800, 40, 40), (1600, 9, 20)]
)
def test_clip_walks_on_synthetic_cells_match_plain(cuda_device, N, X, B):
    """K10 and K8, each one launch with its prolog (and K10's coordinate
    epilog), against their plain versions bit for bit on ``_clip_inputs``:
    every layer code, Xclip-suffix jumps (to negative rows too),
    Xclip-prefix exits and their posts, Yclip-prefix exits, Ins runs past
    32 rows and the nibble's cap, diagonals and Del rows past 32 columns,
    the fixed column's edge cases, X not a multiple of 8, B not a multiple
    of the warps a block, X = 4,095, N = 800 (K8's stage past 48 KB, opted
    in; K10's past the limit: direct stores) and N = 1,600 (K8's direct
    stores); on a contiguous tb and on a pair-major view with poisoned
    padding rows."""
    inputs = _clip_inputs(np.random.default_rng(N + X + B), N, X, B, cuda_device)
    for t in (inputs[0], _poisoned_view(inputs[0])):
        for fn, plain, kernel in CLIP_WALKS:
            got = fn(t, *inputs[1:])
            torch.cuda.synchronize()
            want = plain(t, *inputs[1:])
            assert len(got) == len(want)
            for k, (g, w) in enumerate(zip(got, want)):
                assert g.dtype == w.dtype and torch.equal(g, w), (fn.__name__, k)
    for custom in (False, True):
        assert walk.clip_walk_geometry(B, N, custom)["staged"] == (N < (800 if custom else 1600))


def test_clip_walks_fold_their_torch_prolog_and_epilog(cuda_device, monkeypatch):
    """On the card K8 and K10 make one launch after their input checks: with
    ``resolve_fixed_column_custom``, ``local_entry``, ``_sweep_clip_plain``
    and ``_custom_coords`` patched to raise, each wrapper still runs, its
    kernel's count goes up by one, and its outputs equal those of the plain
    versions (run before the patch)."""
    inputs = _clip_inputs(np.random.default_rng(5), 60, 130, 48, cuda_device)
    wants = [plain(*inputs) for _, plain, _ in CLIP_WALKS]

    def boom(*args, **kwargs):
        raise AssertionError("a plain torch stage ran on the card path")

    for name in ("resolve_fixed_column_custom", "local_entry", "_sweep_clip_plain", "_custom_coords"):
        monkeypatch.setattr(walk, name, boom)
    for (fn, _, kernel), want in zip(CLIP_WALKS, wants):
        before = kernel.launches
        got = fn(*inputs)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), fn.__name__


def test_clip_fused_prolog_fields_match_plain_stages(cuda_device):
    """The prologs and K10's epilog, resolved in the kernels, field by field
    against their plain stages on ``_clip_inputs``: K10's fix_codes,
    fix_lens and yend against ``resolve_fixed_column_custom``, its four
    coordinates against ``_custom_coords`` of its own column outputs; K8's
    fix_codes, fix_lens, xend and yend against ``local_entry``."""
    rng = np.random.default_rng(33)
    for N, X, B in ((40, 9, 48), (40, 203, 96), (12, 4095, 48)):
        tb, tbfix, lx, lx_n, ml, nl = _clip_inputs(rng, N, X, B, cuda_device)
        got = walk.sweep_walk_custom(tb, tbfix, lx, lx_n, ml, nl)
        torch.cuda.synchronize()
        fix_codes, fix_lens, *_, xstart0, ystart0, xend0, yend0 = walk.resolve_fixed_column_custom(tbfix, lx_n, ml, nl)
        assert torch.equal(got[5], fix_codes) and torch.equal(got[6], fix_lens) and torch.equal(got[10], yend0)
        coords = walk._custom_coords(got[:5], ml, xstart0, ystart0, xend0, yend0)
        for k, want in enumerate(coords):
            assert torch.equal(got[7 + k], want), k
        got = walk.sweep_walk_local(tb, tbfix, lx, lx_n, ml, nl)
        torch.cuda.synchronize()
        entry = walk.local_entry(tb, lx, tbfix, lx_n, ml, nl)
        for k, want in ((2, entry[0]), (3, entry[1]), (6, entry[9]), (7, entry[10])):
            assert torch.equal(got[k], want), k
        assert bool((fix_codes != 0).all(dim=1).any())  # a lane filling all four slots


def test_clip_walks_on_protein_views_match_plain(cuda_device):
    """K8 and K10 on K7-LUT's pair-major view of 450 x 457 homologs (N =
    457: K10's stage opted in past 48 KB) and K10 on K9-LUT's view of 200 x
    450 domain-shaped pairs under BLOSUM62 (-11, -1) with the domain
    corpus's clips, on the views and on contiguous copies, against their
    plain versions."""
    rng = np.random.default_rng(34)
    lut = _lut("blosum62", cuda_device)
    hom = _homologs(rng, 64, 450, 457, cuda_device)
    scan = sw.scan_local_lut(*hom, -11, -1, lut)
    tbfix, lx, lx_n = _local_walk_inputs(scan, hom[2], hom[3], -11, -1)
    inputs = (tbfix, lx, lx_n, hom[2], hom[3])
    assert walk.clip_walk_geometry(64, 457, True)["opt_in"]
    _walks_on_both_layouts(scan[0], [(fn, plain, inputs) for fn, plain, _ in CLIP_WALKS])
    dom = _homologs(rng, 64, 200, 450, cuda_device)
    clips = (-10, -10, -5, -5)
    scan = sw.scan_custom_lut(*dom, -11, -1, lut, *clips)
    inputs = _local_walk_inputs(scan, dom[2], dom[3], -11, -1, clips) + (dom[2], dom[3])
    _walks_on_both_layouts(scan[0], [(walk.sweep_walk_custom, walk.sweep_walk_custom_plain, inputs)])


def test_semiglobal_walk_on_k5_tb_matches_plain(cuda_device):
    """K6 on K5's pair-major view (the mapper's layout) and on a contiguous
    copy against the plain K6, beside K12's pair-major view of the same
    scores."""
    args, mlens, nlens = _pairs(np.random.default_rng(23), 300, 150, 166, cuda_device)
    ml, nl = args[2], args[3]
    got = sw.scan_semiglobal(*args, -5, -1, 2, -2, 0, 0)
    torch.cuda.synchronize()
    assert got[0].stride()[1] == 1 and not got[0].is_contiguous()
    _, tbfix = _fixed_column(*got[1:], ml, -5, -1)
    want = walk.sweep_walk_semiglobal_plain(got[0], tbfix, ml, nl)
    for t in (got[0], got[0].contiguous()):
        for g, w in zip(walk.sweep_walk_semiglobal(t, tbfix, ml, nl), want):
            assert torch.equal(g, w)
    lut = torch.full((256, 256), -2, dtype=torch.int32, device=cuda_device)
    lut.fill_diagonal_(2)
    view = sw.scan_semiglobal_lut(*args, -5, -1, lut, 0, 0)[0]
    for g, w in zip(walk.sweep_walk_semiglobal(view, tbfix, ml, nl), want):
        assert torch.equal(g, w)


def test_warp_protein_aligners_on_card_match_cpu(cuda_device):
    """``global_``, ``local`` and ``scores`` under BLOSUM62 on homologs of
    250-450 residues (chip_smoke.py's corpus, 48 pairs) at gap costs
    (-11, -1) and (0, 0) (local mode then walks K7-LUT's tb with K10), on
    the card and on the CPU."""
    from rust_bio_tpu_torch.scores import blosum62

    rng = np.random.default_rng(62)
    aa = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    xs, ys = [], []
    for _ in range(48):
        x = aa[rng.integers(0, 20, size=int(rng.integers(250, 451)))]
        y = x.copy()
        mut = rng.random(y.size) < 0.3
        y[mut] = aa[rng.integers(0, 20, size=int(mut.sum()))]
        y = y[rng.random(y.size) >= 0.03]
        xs.append(x.tobytes())
        ys.append(y.tobytes())
    key = lambda a: (a.score, a.xstart, a.xend, a.ystart, a.yend, a.operations)  # noqa: E731
    for go, ge in ((-11, -1), (0, 0)):
        sc = Scoring.new(go, ge, blosum62)
        on_card = BatchAligner(sc, device=cuda_device)
        on_cpu = BatchAligner(sc, device="cpu")
        for fn, mode in (("global_", "global"), ("local", "local")):
            assert [key(a) for a in getattr(on_card, fn)(xs, ys)] == [key(a) for a in getattr(on_cpu, fn)(xs, ys)], mode
            np.testing.assert_array_equal(on_card.scores(xs, ys, mode), on_cpu.scores(xs, ys, mode))


# ---- long x: K13 (the block-row scan, and fed by the LUT), K14 ----


def _rows_edges(mlens, nlens, M, R, T, rb):
    """Row mlens on a stripe's first, last and middle rows and on a seam
    row, after ``_pairs``' lanes (M, N), (0, N), (M, 0), (1, 1); in a batch
    of 4, lanes 1-3, lane 1 with nlens = 0."""
    rows = [min(M, v) for v in (R * 2, R * 3 - 1, R * 2 + R // 2, rb * 3, R * (T // 2) - 1)]
    if len(mlens) > 9:
        mlens[4:9] = rows
        nlens[5::4] = 0
    else:
        mlens[1 : len(mlens)] = [rows[0], rows[1], rows[3]][: len(mlens) - 1]
        nlens[1] = 0


def _insertion_pairs(rng, xb, yb, mlens, nlens, lanes):
    """Lanes whose x carries a 4.2-4.8 kb insertion into a 600-800 bp y (as
    chip_smoke.py's insertion corpus): their Ins runs cross many stripes and
    seams."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for b in lanes:
        y = acgt[rng.integers(0, 4, size=int(rng.integers(600, 801)))]
        insert = acgt[rng.integers(0, 4, size=int(rng.integers(4200, 4801)))]
        at = int(rng.integers(1, y.size))
        x = np.concatenate([y[:at], insert, y[at:]])
        xb[b, : x.size], yb[b, : y.size] = x, y
        mlens[b], nlens[b] = x.size, y.size


def _rows_match_plain(args, mlens, nlens, go, ge, subst, rb):
    """K13 (or K13-LUT) with traceback and score-only, then K14 on its
    pair-major view, against their plain versions."""
    lut = isinstance(subst, torch.Tensor)
    scan = sw.scan_global_rows_lut if lut else sw.scan_global_rows
    plain = sw.scan_global_rows_lut_plain if lut else sw.scan_global_rows_plain
    pens = (subst,) if lut else subst
    score, tb = scan(*args, go, ge, *pens, rb=rb)
    torch.cuda.synchronize()
    ps, ptb = plain(*args, go, ge, *pens, rb=rb)
    assert torch.equal(score, ps)
    assert tb.shape == ptb.shape and tb.stride()[1] == 1  # the pair-major view
    assert torch.equal(_masked(tb, mlens, nlens), _masked(ptb, mlens, nlens))
    only, none = scan(*args, go, ge, *pens, rb=rb, traceback=False)
    assert none is None and torch.equal(only, ps)
    got = walk.sweep_walk_global_seg(tb, args[2], args[3])
    torch.cuda.synchronize()
    for g, w in zip(got, walk.sweep_walk_global_seg_plain(tb, args[2], args[3])):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize(
    "M,N,B,placement",
    [(1000, 60, 70, "shared"), (1000, 60, 70, "scratch"), (5600, 800, 12, "shared"), (11_700, 30, 4, "shared"),
     (11_700, 30, 4, "scratch")],
)
def test_rows_scan_and_seg_walk_match_plain(cuda_device, monkeypatch, M, N, B, placement):
    """K13 with traceback and score-only, and K14 on its pair-major view,
    against their plain versions at seam periods 16 and ``ROWS_RB``: the
    row state in shared memory and in the device scratch
    (``ROWS_SHARED_MAX_M`` set below M forces it), R = 8 (M = 1,000), 24
    (5,600) and 48 (11,700); row mlens at a stripe's first, last and middle
    rows and on a seam row, mlens 0 and 1, lanes with nlens = 0; at M =
    5,600 two lanes from the insertion corpus (Ins runs of 4.2-4.8 kb)."""
    if placement == "scratch":
        monkeypatch.setattr(sw, "ROWS_SHARED_MAX_M", min(sw.ROWS_SHARED_MAX_M, M - 1))
    T, R, where, _ = sw.rows_geometry(M)
    assert where == placement
    rng = np.random.default_rng(51 + M)
    for rb in (16, sw.ROWS_RB):
        xb, yb, mlens, nlens = _protein_pairs(rng, B, M, N, "cpu", alphabet=b"ACGT")[0]
        xb, yb, mlens, nlens = (a.numpy().copy() for a in (xb, yb, mlens, nlens))
        _rows_edges(mlens, nlens, M, R, T, rb)
        if N >= 800:
            _insertion_pairs(rng, xb, yb, mlens, nlens, (9, 10))
        args = [torch.from_numpy(a).to(cuda_device) for a in (xb, yb, mlens, nlens)]
        for go, ge in PENS:
            ins_cnt = _rows_match_plain(args, mlens, nlens, go, ge, (2, -2), rb)[0]
            if N >= 800 and (go, ge) == (-5, -1):
                assert int(ins_cnt[:, 9:11].to(torch.int32).max()) >= 4096


@pytest.mark.parametrize("M,N,B,placement", [(700, 50, 64, "shared"), (700, 50, 64, "scratch"), (11_700, 30, 4, "scratch")])
def test_rows_scan_lut_matches_plain(cuda_device, monkeypatch, M, N, B, placement):
    """K13 fed by BLOSUM62 on protein pairs, in both placements, with the
    edge lengths of ``test_rows_scan_and_seg_walk_match_plain``."""
    if placement == "scratch":
        monkeypatch.setattr(sw, "ROWS_SHARED_MAX_M", min(sw.ROWS_SHARED_MAX_M, M - 1))
    T, R, where, _ = sw.rows_geometry(M)
    assert where == placement
    rng = np.random.default_rng(52 + M)
    lut = _lut("blosum62", cuda_device)
    for rb in (16, sw.ROWS_RB):
        xb, yb, mlens, nlens = (a.numpy().copy() for a in _protein_pairs(rng, B, M, N, "cpu")[0])
        _rows_edges(mlens, nlens, M, R, T, rb)
        args = [torch.from_numpy(a).to(cuda_device) for a in (xb, yb, mlens, nlens)]
        _rows_match_plain(args, mlens, nlens, -11, -1, lut, rb)


def test_rows_scan_at_one_block_equals_k1(cuda_device):
    """With every row in one block K13 writes K1's cells without the run
    nibble, and K1's score."""
    args, mlens, nlens = _pairs(np.random.default_rng(53), 96, 150, 166, cuda_device)
    ks, ktb, _ = sw.scan_global(*args, -5, -1, 2, -2)
    score, tb = sw.scan_global_rows(*args, -5, -1, 2, -2, rb=151)
    torch.cuda.synchronize()
    assert torch.equal(score, ks)
    assert torch.equal(_masked(tb, mlens, nlens), _masked(ktb.to(torch.int32) & 0xFFF, mlens, nlens))


def test_long_aligner_on_card_matches_cpu(cuda_device):
    """``global_``, ``global_packed`` and ``scores`` at M = 4,100-4,300 (the
    wide pack; a 4,199-base insertion included) on the card through K13 and
    K14, and on the CPU, under MatchParams and BLOSUM62."""
    from rust_bio_tpu_torch.scores import blosum62

    rng = np.random.default_rng(54)
    key = lambda a: (a.score, a.xstart, a.xend, a.ystart, a.yend, a.operations)  # noqa: E731
    for sc, alphabet in ((Scoring.from_scores(-5, -1, 2, -2), b"ACGT"), (Scoring.new(-11, -1, blosum62), b"ARNDCQEGHILKMFPSTWYV")):
        syms = np.frombuffer(alphabet, np.uint8)
        xs = [syms[rng.integers(0, len(syms), size=int(rng.integers(4100, 4301)))].tobytes() for _ in range(6)]
        ys = [syms[rng.integers(0, len(syms), size=int(rng.integers(1, 41)))].tobytes() for _ in range(6)]
        xs.append(b"A" + b"C" * 4199)
        ys.append(b"A")
        on_card = BatchAligner(sc, device=cuda_device)
        on_cpu = BatchAligner(sc, device="cpu")
        before = (sw.SCAN_GLOBAL_ROWS.launches + sw.SCAN_GLOBAL_ROWS_LUT.launches, walk.SWEEP_WALK_GLOBAL_SEG.launches)
        got = on_card.global_(xs, ys)
        assert (sw.SCAN_GLOBAL_ROWS.launches + sw.SCAN_GLOBAL_ROWS_LUT.launches, walk.SWEEP_WALK_GLOBAL_SEG.launches) == (
            before[0] + 1, before[1] + 1
        )
        assert [key(a) for a in got] == [key(a) for a in on_cpu.global_(xs, ys)]
        assert len(got[-1].operations) == 4200
        np.testing.assert_array_equal(on_card.scores(xs, ys), on_cpu.scores(xs, ys))
        assert on_card.global_packed(xs, ys).cigars() == on_cpu.global_packed(xs, ys).cigars()


# ---- the final I of nlens = 0 lanes (K7, K9) ----


def test_clip_scans_seed_final_i_of_empty_y_lanes(cuda_device):
    """K9 and K7 on lanes with nlens = 0 against their plain versions: the
    final I is column 0's I0; and the smallest input that showed it, held to
    the scalar oracle's [Xclip(1), Ins], xstart 1."""
    rng = np.random.default_rng(33)
    args, mlens, nlens = _pairs(rng, 64, 150, 166, cuda_device)
    args[3][::3] = 0
    nlens[::3] = 0
    for go, ge, clips in ((-5, -1, (0, 0, 0, 0)), (0, 0, (0, 0, 0, 0)), (-4, -2, (-7, -1, 0, MIN)), (-2, -1, (MIN, -7, -1, 0))):
        got = _clip_scan(args, go, ge, clips)
        torch.cuda.synchronize()
        _clip_scans_match(got, _clip_scan(args, go, ge, clips, plain=True), mlens, nlens)
        i_f = got[3].cpu()
        assert (i_f[torch.from_numpy((nlens == 0) & (mlens >= 1)), 1] == go).all()
    sc = Scoring.from_scores(0, 0, 2, -5).xclip_prefix_(0)
    got = BatchAligner(sc, device=cuda_device).custom([b"AA", b"ACG"], [b"", b"AC"])[0]
    assert (got.score, got.xstart, [str(op) for op in got.operations]) == (0, 1, ["Xclip(1)", "Ins"])


# ---- long x in the clip modes: K15, K15-LUT, K15-walk ----


def _columns_scan(args, go, ge, clips, lut=None, plain=False, traceback=True):
    if lut is None:
        fn = sw.scan_columns_plain if plain else sw.scan_columns
        return fn(*args, go, ge, 2, -2, *clips, traceback=traceback)
    fn = sw.scan_columns_lut_plain if plain else sw.scan_columns_lut
    return fn(*args, go, ge, lut, *clips, traceback=traceback)


@pytest.mark.parametrize(
    "M,N,B,placement",
    [(150, 166, 40, "shared"), (150, 166, 40, "scratch"), (1300, 60, 40, "shared"), (1300, 60, 40, "scratch"),
     (11_700, 40, 4, "scratch")],
)
def test_columns_scans_match_plain(cuda_device, monkeypatch, M, N, B, placement):
    """K15 and K15-LUT (BLOSUM62) with traceback and score-only against
    their plain versions, in four clip settings, with the row state in
    shared memory and in the device scratch (``COLUMNS_SHARED_MAX_M`` set
    below M forces it), one row a thread (M = 150), three (M = 1,300) and
    23 (M = 11,700, past where the state fits shared memory); row mlens at
    the first, the last and a middle row of a stripe, mlens 0 and 1, lanes
    with nlens = 0 (their final I is column 0's I0); K15 equals K9 without
    the run nibble. The tb is the view of a pair-major tensor (16-byte
    stores of a thread's 8-row groups; the holder of row mlens closes its
    last group early)."""
    if placement == "scratch":
        monkeypatch.setattr(sw, "COLUMNS_SHARED_MAX_M", min(sw.COLUMNS_SHARED_MAX_M, M - 1))
    T, R, where, _ = sw.columns_geometry(M)
    assert where == placement
    rng = np.random.default_rng(34 + M)
    lut = _lut("blosum62", cuda_device)
    for go, ge, clips in ((-5, -1, (MIN, MIN, 0, 0)), (-5, -1, (0, 0, 0, 0)), (-6, -1, (-5, -5, 0, 0)), (-3, -3, (-1, MIN, -7, 0))):
        args, mlens, nlens = _protein_pairs(rng, B, M, N, cuda_device, alphabet=b"ACGT")
        # row mlens at a stripe's first, last and middle rows: lanes 4-7
        # beside _protein_pairs' (M, N), (0, N), (M, 0), (1, 1), or lanes
        # 1-3 of a small batch, lane 1 with nlens = 0
        stripe_rows = [R * 2, R * 3 - 1, R * 2 + R // 2, R * (T // 2) - 1]
        if B > 8:
            mlens[4:8] = stripe_rows
            nlens[5::4] = 0
        else:
            mlens[1:B] = stripe_rows[: B - 1]
            nlens[1] = 0
        args[2].copy_(torch.from_numpy(mlens))
        args[3].copy_(torch.from_numpy(nlens))
        for table in (lut, None):
            got = _columns_scan(args, go, ge, clips, table)
            torch.cuda.synchronize()
            assert got[0].stride()[1] == 1  # the pair-major view
            _clip_scans_match(got, _columns_scan(args, go, ge, clips, table, plain=True), mlens, nlens)
            i_f = got[3].cpu()
            assert (i_f[torch.from_numpy((nlens == 0) & (mlens >= 1)), 1] == go).all()
            only = _columns_scan(args, go, ge, clips, table, traceback=False)
            assert only[0] is None and only[1] is None
            for g, w in zip(only[2:], got[2:]):
                assert torch.equal(_masked(g, mlens), _masked(w, mlens))
        k9 = sw.scan_custom(*args, go, ge, 2, -2, *clips)  # got: K15's, the last table
        assert torch.equal(_masked(got[0], mlens, nlens + 1), _masked(k9[0].to(torch.int32) & 0xFFF, mlens, nlens + 1))


def _walk_inputs(args, scan, go, ge, clips):
    """K15-walk's inputs from a K15 scan: the fixed column and its clip
    length written into its tb and lx (``BatchAligner._columns_device``)."""
    from rust_bio_tpu_torch.alignment.pairwise.batched import _columns_fixups

    _columns_fixups(scan, args[2], args[3], (go, ge, *clips))
    return scan[0], scan[1], scan[5], args[2], args[3]


def test_walk_steps_matches_plain(cuda_device):
    """K15-walk against its plain version on the plain K15 path's tensors,
    in every clip mode, lanes with empty x or y included."""
    rng = np.random.default_rng(35)
    for go, ge, clips in ((-5, -1, (MIN, MIN, 0, 0)), (-5, -1, (0, 0, 0, 0)), (-6, -1, (-5, -5, 0, 0)), (-2, -2, (-7, -1, -1, -7))):
        args, mlens, nlens = _pairs(rng, 96, 300, 200, cuda_device)
        inputs = _walk_inputs(args, _columns_scan(args, go, ge, clips, plain=True), go, ge, clips)
        got = walk.walk_steps(*inputs)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.uint8 and got[1].dtype == torch.uint16 and got[0].shape == (300 + 200 + 8, 96)
        for g, w in zip(got, walk.walk_steps_plain(*inputs)):
            assert torch.equal(g.to(torch.int32), w.to(torch.int32))


@pytest.mark.parametrize("layout", ["pair-major", "contiguous"])
def test_walk_steps_tiles_match_plain(cuda_device, layout):
    """K15-walk (one warp a pair over tb tiles in shared memory) against its
    plain version on K15's pair-major view (16-byte copies) and on a
    contiguous copy (a cell a load), at M = 5,600, N = 800 in four clip
    settings: lanes whose x carries a 4.2-4.8 kb insertion (in semiglobal
    mode an Ins run past dozens of tiles), lanes whose y is a stretch of x
    and whose x is a stretch of y (each of the four clip codes is stepped
    somewhere), random lanes, and lanes that end at once (mlens = 0,
    nlens = 0, both)."""
    rng = np.random.default_rng(36)
    B, M, N = 24, 5600, 800
    args, mlens, nlens = _pairs(rng, B, M, N, "cpu")
    xb, yb = args[0].numpy(), args[1].numpy()
    _insertion_pairs(rng, xb, yb, mlens, nlens, range(4, 8))
    for k in range(8, 16):
        n = int(rng.integers(200, 700))
        a = int(rng.integers(0, M - n))
        if k < 12:  # y a stretch of x, with substitutions
            yb[k, :n] = xb[k, a : a + n]
            yb[k, :n][rng.random(n) < 0.03] = ord("A")
            mlens[k], nlens[k] = M, n
        else:  # x a stretch of y
            a = int(rng.integers(0, N - n))
            xb[k, :n] = yb[k, a : a + n]
            mlens[k], nlens[k] = n, N
    mlens[16:19] = [0, 0, 30]
    nlens[16:19] = [0, 40, 0]
    args = [torch.from_numpy(a).to(cuda_device) for a in (xb, yb, mlens, nlens)]
    codes, ins_max = set(), 0
    for go, ge, clips in ((-5, -1, (MIN, MIN, 0, 0)), (-5, -1, (0, 0, 0, 0)), (-6, -1, (-5, -5, 0, 0)), (-2, -2, (-7, -1, -1, -7))):
        inputs = list(_walk_inputs(args, _columns_scan(args, go, ge, clips), go, ge, clips))
        if layout == "contiguous":
            inputs[0] = inputs[0].contiguous()
        assert walk._vector_rows(inputs[0]) == (layout == "pair-major")
        got = walk.walk_steps(*inputs)
        torch.cuda.synchronize()
        for g, w in zip(got, walk.walk_steps_plain(*inputs)):
            assert torch.equal(g.to(torch.int32), w.to(torch.int32))
        ops = got[0].cpu()
        codes |= set(ops.unique().tolist())
        ins_max = max(ins_max, int((ops == 1).sum(0).max()))
        assert (ops[:, 16] == 0).all()  # a lane that ends at once emits nothing
    assert {5, 6, 7, 8} <= codes and ins_max >= 4200


def test_long_clip_aligner_on_card_matches_cpu(cuda_device):
    """``semiglobal``, ``local``, ``custom`` and ``scores`` in those modes at
    M = 4,100-4,300 on the card (K15, K15-walk) and on the CPU, under
    MatchParams with BWA-MEM's clips and under BLOSUM62; an empty y and a
    4,199-base insertion included."""
    from rust_bio_tpu_torch.scores import blosum62

    rng = np.random.default_rng(55)
    key = lambda a: (a.score, a.xstart, a.xend, a.ystart, a.yend, a.operations)  # noqa: E731
    for sc, alphabet in (
        (Scoring.from_scores(-6, -1, 1, -4).xclip(-5).yclip(0), b"ACGT"),
        (Scoring.new(-11, -1, blosum62).xclip(-10), b"ARNDCQEGHILKMFPSTWYV"),
    ):
        syms = np.frombuffer(alphabet, np.uint8)
        xs = [syms[rng.integers(0, len(syms), size=int(rng.integers(4100, 4301)))].tobytes() for _ in range(5)]
        ys = [xs[0][200:240], xs[1][1000:1030] + b"A" * 5, b""]
        ys += [syms[rng.integers(0, len(syms), size=int(rng.integers(1, 41)))].tobytes() for _ in range(2)]
        xs.append(b"A" + b"C" * 4199)
        ys.append(b"A")
        on_card = BatchAligner(sc, device=cuda_device)
        on_cpu = BatchAligner(sc, device="cpu")
        for mode in ("semiglobal", "local", "custom"):
            before = (sw.SCAN_COLUMNS.launches + sw.SCAN_COLUMNS_LUT.launches, walk.WALK_STEPS.launches)
            got = getattr(on_card, mode)(xs, ys)
            after = (sw.SCAN_COLUMNS.launches + sw.SCAN_COLUMNS_LUT.launches, walk.WALK_STEPS.launches)
            assert after == (before[0] + 1, before[1] + 1), mode
            assert [key(a) for a in got] == [key(a) for a in getattr(on_cpu, mode)(xs, ys)], mode
            np.testing.assert_array_equal(on_card.scores(xs, ys, mode), on_cpu.scores(xs, ys, mode))


# ---- the banded aligner: K16, K16-walk ----

BANDED_PENS = [
    (-5, -1, MIN, MIN, 0, 0, 2, -2),
    (-5, -1, 0, 0, 0, 0, 2, -2),
    (-2, -2, -3, -7, -2, -5, 2, -2),
    (-4, -2, MIN, MIN, MIN, MIN, 1, -1),
    (-3, -1, -1, MIN, -7, 0, 2, -2),
]


def _band_batch(rng, B, M, N, alphabet=b"ACGT", width=(1, 8)):
    """B pairs with per-column bands [starts, ends) of the kinds the
    banded aligner meets and some it does not: a jittered diagonal (so not
    monotone) of half-width drawn from ``width``, empty columns, row 0 in
    and out of band, lanes whose band never reaches row m, a full-matrix
    lane, short-y lanes. Numpy (xb, yb, mlens, nlens, starts, ends); starts,
    ends <= mlens + 1."""
    syms = np.frombuffer(alphabet, np.uint8)
    xb = syms[rng.integers(0, len(syms), size=(B, M))]
    yb = syms[rng.integers(0, len(syms), size=(B, N))]
    mlens = rng.integers(2, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(1, N + 1, size=B).astype(np.int32)
    mlens[:3] = [M, M, 2]
    nlens[:3] = [N, max(1, N // 4), N]
    xb[4:, 5:20] = yb[4:, 8:23]
    starts = np.zeros((B, N + 1), np.int32)
    ends = np.zeros((B, N + 1), np.int32)
    for b in range(B):
        m, n = int(mlens[b]), int(nlens[b])
        if b == 1:  # the full matrix
            ends[b] = m + 1
            continue
        for j in range(N + 1):
            if rng.random() < 0.1:
                starts[b, j], ends[b, j] = m + 1, 0
                continue
            c = j * m // max(n, 1)
            w = int(rng.integers(*width))
            starts[b, j] = min(max(0, c - w + int(rng.integers(-3, 4))), m + 1)
            ends[b, j] = max(0, min(m + 1, c + w + int(rng.integers(-3, 4))))
        if b % 3 == 0:
            starts[b, 0] = 0
        if b % 4 == 3:  # never reaches row m
            ends[b] = np.minimum(ends[b], m - 1)
    return xb, yb, mlens, nlens, starts, ends


def _banded_scans_match(got, want, nlens):
    """K16's outputs against the plain version's: tb over columns 1..nlens
    (the kernel leaves later columns 0), lx and the finals whole."""
    tb, ptb = got[0].cpu().to(torch.int32), want[0].cpu().to(torch.int32)
    for b, n in enumerate(nlens):
        assert torch.equal(tb[:n, :, b], ptb[:n, :, b]), b
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("pens8", BANDED_PENS)
def test_banded_scan_matches_plain(cuda_device, pens8):
    """K16 against its plain version on random bands: non-monotone, row 0
    in and out of band, row m out of band, empty columns, short-y lanes."""
    rng = np.random.default_rng(61 + pens8[0])
    arrays = _band_batch(rng, 64, 80, 90)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    got = sw.scan_banded(*args[:4], pens8, *args[4:])
    torch.cuda.synchronize()
    _banded_scans_match(got, sw.scan_banded_plain(*args[:4], pens8, *args[4:]), arrays[3])


@pytest.mark.parametrize("M", [5600, 7300])
def test_banded_scan_long_x_matches_plain(cuda_device, M):
    """K16 at M = 5,600 (one pair's state a block in shared memory) and M =
    7,300 (the device scratch route)."""
    rng = np.random.default_rng(M)
    arrays = _band_batch(rng, 4, M, 40)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    for pens8 in BANDED_PENS[:3]:
        got = sw.scan_banded(*args[:4], pens8, *args[4:])
        torch.cuda.synchronize()
        _banded_scans_match(got, sw.scan_banded_plain(*args[:4], pens8, *args[4:]), arrays[3])


@pytest.mark.parametrize("pens8", BANDED_PENS)
def test_banded_scan_wide_bands_match_plain(cuda_device, monkeypatch, pens8):
    """K16 on bands of 20-240 rows (up to 8 chunks of 32 a column, the
    insertion chain carried from chunk to chunk) with empty columns, and
    two pairs a block (the SM count lowered so that 64 pairs fill a card at
    one warp a block)."""
    rng = np.random.default_rng(64 - pens8[0])
    arrays = _band_batch(rng, 64, 300, 60, width=(10, 120))
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    monkeypatch.setattr(sw, "_sm_count", lambda dev: 1)
    assert sw.banded_geometry(300, 64, 1)[0] == 2
    got = sw.scan_banded(*args[:4], pens8, *args[4:])
    torch.cuda.synchronize()
    _banded_scans_match(got, sw.scan_banded_plain(*args[:4], pens8, *args[4:]), arrays[3])


@pytest.mark.parametrize("pens8", BANDED_PENS)
def test_banded_scan_band_edges_match_plain(cuda_device, pens8):
    """K16 with the band starting at row 0 over a pair's first columns, row
    m in band over its last columns (the x-suffix clip and row m's own
    candidates in the band's last lane) and out of band elsewhere, the last
    column's band far below row 1 (its insertion chain opens from Sn over
    every row above the band), and columns with st >= en."""
    rng = np.random.default_rng(65 - pens8[0])
    xb, yb, ml, nl, st, en = _band_batch(rng, 48, 120, 70, width=(3, 40))
    for b in range(48):
        m, n = int(ml[b]), int(nl[b])
        k = int(rng.integers(1, 6))
        st[b, :k] = 0
        if b % 2:
            en[b, n - k : n + 1] = m + 1
        if b % 5 == 4:
            st[b, n] = min(m + 1, 40 + b)
            en[b, n] = m + 1
        if b % 7 == 6:
            st[b, 1 : n : 3], en[b, 1 : n : 3] = en[b, 1 : n : 3], st[b, 1 : n : 3]
    arrays = (xb, yb, ml, nl, st, en)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    got = sw.scan_banded(*args[:4], pens8, *args[4:])
    torch.cuda.synchronize()
    _banded_scans_match(got, sw.scan_banded_plain(*args[:4], pens8, *args[4:]), arrays[3])


@pytest.mark.parametrize("M", [600, 5600])
def test_banded_scan_in_scratch_matches_plain(cuda_device, monkeypatch, M):
    """K16 with its state forced into the (B, 8, M + 1) device scratch."""
    monkeypatch.setattr(sw, "BANDED_SHARED_MAX_M", 0)
    assert sw.banded_geometry(M, 4)[1] == "scratch"
    rng = np.random.default_rng(M + 1)
    arrays = _band_batch(rng, 6, M, 40, width=(1, 40))
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    for pens8 in BANDED_PENS[:3]:
        got = sw.scan_banded(*args[:4], pens8, *args[4:])
        torch.cuda.synchronize()
        _banded_scans_match(got, sw.scan_banded_plain(*args[:4], pens8, *args[4:]), arrays[3])


def test_banded_scan_clamps_lengths(cuda_device):
    """K16 reads no lengths back: lengths outside [0, M] / [0, N] are
    clamped in the kernel (no fault), and the other lanes are unchanged."""
    rng = np.random.default_rng(63)
    arrays = _band_batch(rng, 40, 80, 90)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    want = sw.scan_banded_plain(*args[:4], BANDED_PENS[2], *args[4:])
    bad_m, bad_n = arrays[2].copy(), arrays[3].copy()
    bad_m[:2], bad_n[:2] = [200, -5], [500, -5]
    got = sw.scan_banded(args[0], args[1], *(torch.from_numpy(a).to(cuda_device) for a in (bad_m, bad_n)),
                         BANDED_PENS[2], *args[4:])
    torch.cuda.synchronize()

    def lanes(out):  # lanes 2.. of (tb, lx, the five finals)
        return [out[0][..., 2:], out[1][:, 2:], *(f[2:] for f in out[2:])]

    _banded_scans_match(lanes(got), lanes(want), arrays[3][2:])


# TB_* codes (alignment/pairwise/tb.py)
START, INS, DEL, SUBST, MATCH, XCLIP_PREFIX, XCLIP_SUFFIX, YCLIP_PREFIX, YCLIP_SUFFIX = range(9)


def _walk_cells(rng, B, M, N):
    """Synthetic K16-walk inputs that step every op code: numpy (tb (N, M+1,
    B) uint16, columns 1..N with random run nibbles; tb0 (B, M+1), tbfix
    (B, M+1) with Ly << 12, lx (B, N+1), mlens, nlens (B,)) int32. Lanes
    start at (M, N), (0, N), (M, 0), (0, 0) and at random; lane kinds by b %
    4 favour long Match/Subst runs, Ins runs (down column nlens too), Del
    runs (along row 0 too) or none. The cells keep a path inside the
    tensors, as K16's do: an x-suffix clip only at row mlens (lengths 1..m),
    a y-suffix clip only in the fixed column (Ly 1..n), no Ins into row 0
    from row 1 and no Del into column 0, (0, 0) TB_START."""
    X = M + 1
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    mlens[:4], nlens[:4] = [M, 0, M, 0], [N, N, 0, 0]
    mlens[4:8], nlens[4:8] = M, N
    moving = [START, INS, DEL, SUBST, MATCH, XCLIP_PREFIX, YCLIP_PREFIX]

    def draw(shape, favour, p):
        other = rng.choice(moving, size=shape)
        return np.where(rng.random(shape) < p, rng.choice(favour, size=shape), other)

    tb = np.zeros((B, N, X), np.int64)
    tb0 = np.zeros((B, X), np.int64)
    tbfix = np.zeros((B, X), np.int64)
    lx = np.zeros((B, N + 1), np.int64)
    for b in range(B):
        m, n, kind = int(mlens[b]), int(nlens[b]), b % 4
        shape = (N + 1, X)  # column 0 and the fixed column drawn with the others
        p = 0.99 if b < 16 else 0.9
        s_bits = draw(shape, [[MATCH, SUBST], [INS], [DEL], moving][kind], p if kind < 3 else 0.0)
        i_bits = draw(shape, [INS], p if kind == 1 else 0.3)
        d_bits = draw(shape, [DEL], p if kind == 2 else 0.3)
        s_bits[:, m] = np.where(rng.random(N + 1) < 0.3, XCLIP_SUFFIX, s_bits[:, m]) if m else s_bits[:, m]
        d_bits[1:, m] = np.where(rng.random(N) < 0.1, XCLIP_SUFFIX, d_bits[1:, m]) if m else d_bits[1:, m]
        # row 0 as K16 leaves it: no Ins into it, a Del run along it
        i_bits[:, 0] = START
        d_bits[:, 0] = np.where(rng.random(N + 1) < 0.8, DEL, YCLIP_PREFIX)
        d_bits[1, 0] = START
        # row 1 sends no Ins (nor Match) into row 0; column 1 no Del (nor
        # Match) into column 0
        i_bits[:, 1 : min(2, X)] = rng.choice([START, DEL, YCLIP_PREFIX, XCLIP_PREFIX], size=(N + 1, min(1, M)))
        if N >= 1:
            d_bits[1, 1:] = np.where(s_bits[1, 1:] == XCLIP_SUFFIX, XCLIP_SUFFIX,
                                     rng.choice([START, INS, XCLIP_PREFIX], size=M))
        # column 0 as the init column: Ins from row 2 down, the s-bits rewritten
        i_bits[0, :2] = START
        i_bits[0, 2:] = np.where(rng.random(max(M - 1, 0)) < 0.85, INS, rng.choice([START, XCLIP_PREFIX], size=max(M - 1, 0)))
        d_bits[0] = START
        cells = i_bits | d_bits << 4 | s_bits << 8
        cells[0, 0] = START
        tb0[b] = cells[0] & 0xFFF
        tb[b] = cells[1:] | rng.integers(0, 16, size=(N, X)) << 12
        # the fixed column: its own s-bits (a y-suffix clip among them), Ly
        fix = cells[n].copy()
        fs = (fix >> 8) & 0xF
        fs = np.where(rng.random(X) < 0.2, YCLIP_SUFFIX, fs) if n else fs
        fs[0] = rng.choice([DEL, YCLIP_PREFIX, YCLIP_SUFFIX, START]) if n else START
        if kind == 1 and m:
            fs[m] = INS
        fi = fix & 0xF
        if n:
            fi[2:] = np.where(rng.random(max(M - 1, 0)) < 0.05, YCLIP_SUFFIX, fi[2:])
        fix = fi | (fix & 0xF0) | fs << 8
        ly = rng.integers(1, n + 1, size=X) if n else np.zeros(X, np.int64)
        tbfix[b] = fix | ly << 12
        lx[b] = rng.integers(1, m + 1, size=N + 1) if m else 0
    i32 = np.int32
    return (tb.transpose(1, 2, 0).astype(np.uint16), tb0.astype(i32), tbfix.astype(i32), lx.astype(i32), mlens, nlens)


def _walk_path(codes, lens, m, n):
    """(i, j, code, len) of each step of one lane's K16-walk output, end ->
    start, replayed from (m, n)."""
    i, j, steps = int(m), int(n), []
    for c, k in zip(codes, lens):
        c, k = int(c), int(k)
        if c == 0:
            break
        steps.append((i, j, c, k))
        if c in (MATCH, SUBST):
            i, j = i - 1, j - 1
        elif c == INS:
            i = 0 if k else i - 1
        elif c == DEL:
            j = 0 if k else j - 1
        elif c == XCLIP_PREFIX:
            i = 0
        elif c == XCLIP_SUFFIX:
            i -= k
        elif c == YCLIP_PREFIX:
            j = 0
        else:
            j -= k
    return steps


def _poisoned_view(tb, fill=0x0ABC):
    """``tb`` (N, X, B) as the (N, X, B) view of a pair-major (B, N, Xp)
    tensor, Xp = X rounded up to 8, its padding rows holding ``fill`` (a cell
    no walk may read)."""
    N, X, B = tb.shape
    pm = torch.full((B, N, sw.pair_major_pitch(X - 1)), fill, dtype=torch.int32, device=tb.device).to(torch.uint16)
    pm[:, :, :X] = tb.permute(2, 0, 1)
    return pm[:, :, :X].permute(1, 2, 0)


def test_banded_walk_matches_plain(cuda_device):
    """K16-walk against its plain version on the plain path's tensors (the
    plain K16, the fixups, column 0's twin)."""
    from rust_bio_tpu_torch.alignment.pairwise import banded_device as bd

    rng = np.random.default_rng(67)
    for pens8 in BANDED_PENS:
        arrays = _band_batch(rng, 96, 60, 70)
        xb, yb, ml, nl, st, en = (torch.from_numpy(a).to(cuda_device) for a in arrays)
        B, M = xb.shape
        _, inputs = bd._walk_inputs(sw.scan_banded_plain(xb, yb, ml, nl, pens8, st, en), ml, nl, pens8, st, en)
        got = walk.walk_banded(*inputs)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.uint8 and got[0].shape == (M + 70 + 8, B)
        for g, w in zip(got, walk.walk_banded_plain(*inputs)):
            assert torch.equal(g.to(torch.int32), w.to(torch.int32))


def test_banded_walk_on_kernel_view_matches_plain(cuda_device):
    """K16-walk on K16's pair-major view (read in place) and on a contiguous
    copy of it against the plain walk, over every penalty set."""
    from rust_bio_tpu_torch.alignment.pairwise import banded_device as bd

    rng = np.random.default_rng(68)
    for pens8 in BANDED_PENS:
        arrays = _band_batch(rng, 96, 60, 70)
        xb, yb, ml, nl, st, en = (torch.from_numpy(a).to(cuda_device) for a in arrays)
        scan = sw.scan_banded(xb, yb, ml, nl, pens8, st, en)
        assert scan[0].stride()[1] == 1  # the pair-major view
        _, inputs = bd._walk_inputs(scan, ml, nl, pens8, st, en)
        want = walk.walk_banded_plain(*inputs)
        for tb in (inputs[0], inputs[0].contiguous()):
            got = walk.walk_banded(tb, *inputs[1:])
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.to(torch.int32), w.to(torch.int32))


@pytest.mark.parametrize("M,N", [(40, 46), (300, 420), (700, 150)])
def test_banded_walk_tiles_on_synthetic_cells_match_plain(cuda_device, M, N):
    """K16-walk's tile walk against its plain version on ``_walk_cells``
    (every op code, both ending fixups, runs past a tile's 32 columns and 96
    rows, Ins runs down column 0 and column nlens, Del runs along row 0)
    under every penalty set, on a pair-major view whose padding rows hold
    0x0ABC (16-byte copies) and on a contiguous tb (a cell a load)."""
    rng = np.random.default_rng(M + N)
    t = [torch.from_numpy(a).to(cuda_device) for a in _walk_cells(rng, 64, M, N)]
    longest = 0
    for pens8 in BANDED_PENS:
        want = walk.walk_banded_plain(*t, pens8[:6])
        for tb in (_poisoned_view(t[0]), t[0]):
            assert walk._vector_rows(tb) == (tb is not t[0])
            got = walk.walk_banded(tb, *t[1:], pens8[:6])
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.to(torch.int32), w.to(torch.int32))
        longest = max(longest, _longest_run(want[0].cpu().numpy()))
    assert longest > (32 if M > 100 else 8)


def _longest_run(codes):
    """The longest run of one op code down a lane of (T, B) op codes."""
    best = 0
    for lane in codes.T:
        run = 1
        for a, b in zip(lane[:-1], lane[1:]):
            run = run + 1 if a == b and a > 0 else 1
            best = max(best, run)
    return best


def _banded_corpora(rng):
    """Small copies of phase 3f's five banded corpora as (mode, scoring,
    xs, ys): 150 bp reads in 2 kb targets (4 substitutions) semiglobal, 1
    kb reads in 3 kb targets (20) semiglobal, STR-like pairs of 0.8-1.2 kb
    (y at 5% substitutions and 1-3 bp indels) global, the 150 bp reads
    local, and reads with 0-30 random bases at each end against their 166
    bp windows in custom mode under BWA-MEM's soft clips."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    sc = Scoring.from_scores(-5, -1, 2, -2)

    def reads(n, m, target, subs):
        xs, ys = [], []
        for _ in range(n):
            y = acgt[rng.integers(0, 4, size=target)]
            at = int(rng.integers(0, target - m))
            x = y[at : at + m].copy()
            x[rng.integers(0, m, size=subs)] = acgt[rng.integers(0, 4, size=subs)]
            xs.append(x.tobytes())
            ys.append(y.tobytes())
        return xs, ys

    def str_pair():
        x = acgt[rng.integers(0, 4, size=int(rng.integers(800, 1200)))]
        motif = acgt[rng.integers(0, 4, size=4)]
        for at in rng.integers(0, len(x) - 100, size=3):
            x[at : at + 100] = np.tile(motif, 25)
        y = x.copy()
        sub = rng.random(len(y)) < 0.05
        y[sub] = acgt[rng.integers(0, 4, size=int(sub.sum()))]
        for at in sorted(rng.integers(0, len(y) - 10, size=5), reverse=True):
            k = int(rng.integers(1, 4))
            y = np.delete(y, np.arange(at, at + k)) if rng.random() < 0.5 else np.insert(y, at, acgt[rng.integers(0, 4, size=k)])
        return x.tobytes(), y.tobytes()

    short = reads(16, 150, 2000, 4)
    pairs = [str_pair() for _ in range(6)]
    clipped_x, windows = [], []
    for _ in range(16):
        w = acgt[rng.integers(0, 4, size=166)]
        x = w[8:158].copy()
        for end in (slice(0, int(rng.integers(0, 31))), slice(150 - int(rng.integers(0, 31)), 150)):
            x[end] = acgt[rng.integers(0, 4, size=len(x[end]))]
        clipped_x.append(x.tobytes())
        windows.append(w.tobytes())
    return [
        ("semiglobal", sc.with_clips(MIN, MIN, 0, 0), *short),
        ("semiglobal", sc.with_clips(MIN, MIN, 0, 0), *reads(6, 1000, 3000, 20)),
        ("global", sc.with_clips(MIN, MIN, MIN, MIN), [x for x, _ in pairs], [y for _, y in pairs]),
        ("local", sc.with_clips(0, 0, 0, 0), *short),
        ("custom", Scoring.from_scores(-6, -1, 1, -4).with_clips(-5, -5, 0, 0), clipped_x, windows),
    ]


def test_banded_walk_on_the_banded_corpora_matches_plain(cuda_device):
    """K16-walk against its plain version on K16's outputs for small copies
    of the five banded corpora (``_banded_corpora``), on K16's pair-major
    view (16-byte copies) and on a contiguous copy (a cell a load)."""
    from rust_bio_tpu_torch.alignment.pairwise import BatchBandedAligner, banded_device as bd
    from rust_bio_tpu_torch.alignment.types import AlignmentMode

    for mode, sc, xs, ys in _banded_corpora(np.random.default_rng(74)):
        al = BatchBandedAligner(sc, 8, 8, device=cuda_device)
        _, run_idx, _, _, arrays = al._band_batch(xs, ys, sc, AlignmentMode.Custom, False)
        assert len(run_idx) == len(xs), mode
        *host, pens8 = arrays
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in host]
        scan = sw.scan_banded(*t[:4], pens8, *t[4:])
        _, inputs = bd._walk_inputs(scan, t[2], t[3], pens8, t[4], t[5])
        assert walk._vector_rows(inputs[0])
        want = walk.walk_banded_plain(*inputs)
        for tb in (inputs[0], inputs[0].contiguous()):
            got = walk.walk_banded(tb, *inputs[1:])
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.to(torch.int32), w.to(torch.int32)), mode


def _banded_pairs(rng, B, long_targets=False):
    """Reads cut from targets with a few substitutions (some pairs without
    a shared k-mer); with ``long_targets`` 30-120 bp reads in 400-1,600 bp
    targets at every offset (the crop path)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    xs, ys = [], []
    for t in range(B):
        if long_targets:
            n = int(rng.integers(400, 1600))
            m = int(rng.integers(30, 120))
        else:
            n = int(rng.integers(20, 90))
            m = int(rng.integers(10, min(n, 70)))
        y = acgt[rng.integers(0, 4, size=n)]
        s = [0, 1, n - m, n - m - 1][t % 4] if t < 4 else int(rng.integers(0, n - m + 1))
        x = y[s : s + m].copy()
        sub = rng.random(m) < 0.05
        x[sub] = acgt[rng.integers(0, 4, size=int(sub.sum()))]
        if t % 7 == 6:
            x = acgt[rng.integers(0, 2, size=m)]
            y = acgt[2 + rng.integers(0, 2, size=n)]
        xs.append(x.tobytes())
        ys.append(y.tobytes())
    return xs, ys


def test_banded_aligner_on_card_matches_cpu(cuda_device, monkeypatch):
    """``BatchBandedAligner`` on the card (K16, K16-walk) equals its CPU
    path in all four modes, on the crop path, and with the lanes split into
    sub-batches of one lane."""
    from rust_bio_tpu_torch.alignment.pairwise import BatchBandedAligner, banded_device

    rng = np.random.default_rng(71)
    key = lambda a: (a.score, a.xstart, a.xend, a.ystart, a.yend, a.operations)  # noqa: E731
    sc = Scoring.from_scores(-5, -1, 2, -2).with_clips(-3, -7, -2, -5)
    for long_targets in (False, True):
        xs, ys = _banded_pairs(rng, 40, long_targets)
        for mode in ("custom", "global_", "semiglobal", "local"):
            before = (sw.SCAN_BANDED.launches, walk.WALK_BANDED.launches)
            got = getattr(BatchBandedAligner(sc, 8, 6, device=cuda_device), mode)(xs, ys)
            assert (sw.SCAN_BANDED.launches, walk.WALK_BANDED.launches) == (before[0] + 1, before[1] + 1), mode
            want = getattr(BatchBandedAligner(sc, 8, 6, device="cpu"), mode)(xs, ys)
            assert [key(a) for a in got] == [key(a) for a in want], (mode, long_targets)
            with monkeypatch.context() as mp:
                mp.setattr(banded_device, "TB_BUDGET_MAX", 1)
                split = getattr(BatchBandedAligner(sc, 8, 6, device=cuda_device), mode)(xs, ys)
            assert [key(a) for a in split] == [key(a) for a in want], (mode, long_targets, "split")


def test_banded_aligner_keeps_pairs_beside_empty_ones_on_card(cuda_device):
    """An empty x or y runs the host oracle for its own pair; the others
    take one K16 launch, and the batch equals the CPU path."""
    from rust_bio_tpu_torch.alignment.pairwise import BatchBandedAligner

    rng = np.random.default_rng(73)
    key = lambda a: (a.score, a.xstart, a.xend, a.ystart, a.yend, a.operations)  # noqa: E731
    xs, ys = _banded_pairs(rng, 20)
    xs, ys = [b""] + xs + [b"ACGTTGCA"], [b"ACGTAC"] + ys + [b""]
    sc = Scoring.from_scores(-5, -1, 2, -2)
    before = sw.SCAN_BANDED.launches
    got = BatchBandedAligner(sc, 8, 6, device=cuda_device).global_(xs, ys)
    assert sw.SCAN_BANDED.launches == before + 1
    assert [key(a) for a in got] == [key(a) for a in BatchBandedAligner(sc, 8, 6, device="cpu").global_(xs, ys)]


# ---------------------------------------------------------------------------
# the PairHMM family: K17, K17-log, K17-exact, K17-homopoly
# ---------------------------------------------------------------------------
# Tolerances: K17, K17-log f32 and K17-homopoly f32 within 1e-5 * max(1, |p|)
# of their plain versions (the same -3e38 lanes); the f64 log-space and
# homopoly kernels within 1e-12 relative; K17-exact within 1e-14 relative
# and its skip mask bit for bit.

HMM_GAPS = {
    "bench": (math.log(2.8e-6), math.log(5.1e-6), float("-inf"), float("-inf")),
    "extend": (math.log(2.8e-6), math.log(5.1e-6), math.log(0.3), math.log(0.2)),
}
HMM_EMIT = np.array([math.log(1 - 0.0021), math.log(0.0021 / 3), math.log(1 - 0.0021)])
HOPS = (math.log(1e-4), math.log(1e-4), math.log(0.5), math.log(0.5))


def _hmm_pairs(rng, B, M, N, ymax=None):
    """x a haplotype, y a substring with 2 errors; ragged lengths (ylen up to
    ``ymax``, N by default) with xlen 0 and ylen 0 lanes; per-lane
    emissions from a mean base quality."""
    xs = rng.choice(list(b"ACGT"), size=(B, M)).astype(np.uint8)
    ys = np.zeros((B, N), np.uint8)
    for i in range(B):
        s = int(rng.integers(0, max(1, M - N)))
        seg = xs[i, s : s + N]
        ys[i, : len(seg)] = seg
        ys[i, rng.integers(0, N, size=2)] = rng.choice(list(b"ACGT"), size=2)
    xl = rng.integers(0, M + 1, size=B).astype(np.int32)
    ymax = N if ymax is None else ymax
    yl = rng.integers(0, ymax + 1, size=B).astype(np.int32)
    xl[:4] = [M, 0, M, 1]
    yl[:4] = [ymax, ymax, 0, 1]
    q = 10.0 ** (-rng.uniform(15, 40, size=B) / 10.0)
    ep = np.stack([np.log1p(-q), np.log(q / 3), np.log1p(-q)], 1)
    return xs, ys, xl, yl, ep


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _f32_close(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    fell = want <= pairhmm_ops.NEG_F32 / 2
    assert torch.equal(got <= pairhmm_ops.NEG_F32 / 2, fell)
    err = (got - want).abs()[~fell]
    assert bool((err <= 1e-5 * want.abs()[~fell].clamp_min(1.0)).all()), float(err.max())


def _rel_close(got, want, rel):
    got, want = got.double().cpu(), want.double().cpu()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], want[~fin])
    assert bool(((got - want).abs()[fin] <= rel * want.abs()[fin].clamp_min(1.0)).all())


@pytest.mark.parametrize("N", [54, 150, 19_400])
def test_pairhmm_scaled_matches_plain(cuda_device, N):
    """K17 with its lane stripes in registers (N 54, 150: C = 2, 8) and in
    the device scratch (N 19,400: C = 607 columns a lane)."""
    from rust_bio_tpu_torch.stats.pairhmm import BatchPairHMMLinear

    B, M = (300, 207) if N < 1000 else (6, 12)
    xs, ys, xl, yl, ep = _hmm_pairs(np.random.default_rng(N), B, M, N)
    for gaps in HMM_GAPS:
        hmm = BatchPairHMMLinear(*HMM_GAPS[gaps], device=cuda_device)
        args = _on(cuda_device, xs, ys, xl, yl)
        for emit in (HMM_EMIT, ep):
            e = torch.from_numpy(np.exp(emit).astype(np.float32)).to(cuda_device)
            for semi in (False, True):
                got = pairhmm_ops.pairhmm_fwd_scaled(*args, hmm._lin_params, e, semi)
                torch.cuda.synchronize()
                _f32_close(got, pairhmm_ops.pairhmm_fwd_scaled_plain(*args, hmm._lin_params, e, semi))


@pytest.mark.parametrize("placement", ["geometry", "scratch"])
@pytest.mark.parametrize("N", [1, 33, 54, 150, 500, 700])
def test_pairhmm_scaled_warp_placements_match_plain(cuda_device, monkeypatch, N, placement):
    """K17's lane stripes, a row at a time, at ylen 0, 1, 31, 32, 33 and N
    and xlen 0 and 1, semiglobal and global, shared and per-lane emissions,
    without gap extension (``bench``: c_ext = 0, the lanes' scan skipped)
    and with it (``extend``): in the geometry's placement (registers up to
    N = 512, the device scratch above) and in the scratch at every N (the
    register budget lowered to 0). The same lanes underflow to -3e38."""
    from rust_bio_tpu_torch.stats.pairhmm import BatchPairHMMLinear

    if placement == "scratch":
        monkeypatch.setattr(pairhmm_ops, "SCALED_REG_BYTES", 0)
    B, M = 40, 60
    want_placement = "registers" if placement == "geometry" and N <= 512 else "scratch"
    assert pairhmm_ops.pairhmm_scaled_geometry(N, B, sw._sm_count(cuda_device))[2] == want_placement
    xs, ys, xl, yl, ep = _hmm_pairs(np.random.default_rng(N + 9), B, M, N)
    yl[4:10] = np.minimum([0, 1, 31, 32, 33, N], N)
    xl[10:12] = [0, 1]
    args = _on(cuda_device, xs, ys, xl, yl)
    for gaps in HMM_GAPS:
        hmm = BatchPairHMMLinear(*HMM_GAPS[gaps], device=cuda_device)
        for emit in (HMM_EMIT, ep):
            e = torch.from_numpy(np.exp(emit).astype(np.float32)).to(cuda_device)
            for semi in (False, True):
                got = pairhmm_ops.pairhmm_fwd_scaled(*args, hmm._lin_params, e, semi)
                torch.cuda.synchronize()
                _f32_close(got, pairhmm_ops.pairhmm_fwd_scaled_plain(*args, hmm._lin_params, e, semi))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [54, 20_000])
def test_pairhmm_log_matches_plain(cuda_device, N, dtype):
    """K17-log with its state in registers (N 54: two columns a lane) and
    in the device scratch (N 20,000: 625 columns a lane, over
    ``pairhmm.LOG_REG_BYTES``)."""
    from rust_bio_tpu_torch.stats.pairhmm import BatchPairHMM

    # the long rows hold lanes of up to 60 columns: a sum over 20,000
    # columns in f32 parts the sequential and log-step orders past 1e-5
    B, M = (300, 207) if N < 1000 else (6, 10)
    xs, ys, xl, yl, ep = _hmm_pairs(np.random.default_rng(N + 1), B, M, N, None if N < 1000 else 60)
    for gaps in HMM_GAPS:
        hmm = BatchPairHMM(*HMM_GAPS[gaps], dtype=dtype, device=cuda_device)
        args = _on(cuda_device, xs, ys, xl, yl)
        for emit in (HMM_EMIT, ep):
            e = torch.from_numpy(emit).to(dtype).to(cuda_device)
            for semi in (False, True):
                got = pairhmm_ops.pairhmm_fwd_log(*args, hmm._log_params, e, semi)
                torch.cuda.synchronize()
                want = pairhmm_ops.pairhmm_fwd_log_plain(*args, hmm._log_params, e, semi)
                if dtype == torch.float32:
                    _f32_close(got, want)
                else:
                    _rel_close(got, want, 1e-12)


@pytest.mark.parametrize("placement", ["geometry", "scratch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [54, 150, 500, 700])
def test_pairhmm_log_warp_placements_match_plain(cuda_device, monkeypatch, N, dtype, placement):
    """K17-log's lane stripes at ylen 0, 1, 31, 32, 33 and N and xlen 0 and
    1, semiglobal and global, shared and per-lane emissions: in the
    geometry's placement (registers up to N = 512 in f32 and 256 in f64,
    the device scratch above) and in the scratch at every N (the register
    budget lowered to 0)."""
    from rust_bio_tpu_torch.stats.pairhmm import BatchPairHMM

    if placement == "scratch":
        monkeypatch.setattr(pairhmm_ops, "LOG_REG_BYTES", 0)
    B, M = 40, 60
    in_registers = placement == "geometry" and N <= (512 if dtype == torch.float32 else 256)
    want_placement = "registers" if in_registers else "scratch"
    assert pairhmm_ops.pairhmm_log_geometry(N, B, dtype, sw._sm_count(cuda_device))[2] == want_placement
    xs, ys, xl, yl, ep = _hmm_pairs(np.random.default_rng(N + 5), B, M, N)
    yl[4:10] = [0, 1, 31, 32, 33, N]
    xl[10:12] = [0, 1]
    hmm = BatchPairHMM(*HMM_GAPS["extend"], dtype=dtype, device=cuda_device)
    args = _on(cuda_device, xs, ys, xl, yl)
    for emit in (HMM_EMIT, ep):
        e = torch.from_numpy(emit).to(dtype).to(cuda_device)
        for semi in (False, True):
            got = pairhmm_ops.pairhmm_fwd_log(*args, hmm._log_params, e, semi)
            torch.cuda.synchronize()
            want = pairhmm_ops.pairhmm_fwd_log_plain(*args, hmm._log_params, e, semi)
            if dtype == torch.float32:
                _f32_close(got, want)
            else:
                _rel_close(got, want, 1e-12)


@pytest.mark.parametrize("placement", ["geometry", "scratch"])
@pytest.mark.parametrize("N", [54, 5_000])
def test_pairhmm_exact_matches_plain(cuda_device, monkeypatch, N, placement):
    """K17-exact, one warp a pair, with its skip mask, bit for bit: in the
    geometry's placement (registers at N 54, two columns a lane; the device
    scratch at N 5,000, 157 columns a lane) and in the scratch at both N
    (the register budget lowered to 0)."""
    from rust_bio_tpu_torch.stats.pairhmm import BatchPairHMMExact

    if placement == "scratch":
        monkeypatch.setattr(pairhmm_ops, "EXACT_REG_BYTES", 0)
    small = N < 1000
    B, M = (64, 60) if small else (4, 3)
    for banded in (False, True):
        want_placement = "registers" if placement == "geometry" and small else "scratch"
        assert pairhmm_ops.pairhmm_exact_geometry(N, B, banded, sw._sm_count(cuda_device))[2] == want_placement
    xs, ys, xl, yl, ep = _hmm_pairs(np.random.default_rng(N + 2), B, M, N)
    if small:  # ylen at both places of a two-column stripe, on lanes 0, 15, 16 and 26
        yl[4:10] = [1, 2, 31, 32, 33, 53]
    # the plain version loops over j for a band or an extended Y state:
    # the long rows take the bench gaps, unbanded and at 4
    for gaps in HMM_GAPS if small else ("bench",):
        hmm = BatchPairHMMExact(*HMM_GAPS[gaps], device=cuda_device)
        args = _on(cuda_device, xs, ys, xl, yl, ep if gaps == "extend" else HMM_EMIT)
        for semi in (False, True):
            for med in (None, 2, 4) if small else (None, 4):
                got, skip = hmm._forward(*args, semi, med, True)
                torch.cuda.synchronize()
                want, wskip = pairhmm_ops.pairhmm_fwd_exact_plain(*args[:4], hmm._params, args[4], semi, med, True)
                _rel_close(got, want, 1e-14)
                assert torch.equal(skip, wskip)
                assert torch.equal(got.view(torch.int64), want.view(torch.int64)), (gaps, semi, med)


@pytest.mark.parametrize("placement", ["geometry", "scratch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [54, 4_200])
def test_pairhmm_homopoly_matches_plain(cuda_device, monkeypatch, N, dtype, placement):
    """K17-homopoly (one warp a pair, ``pairhmm_log_geometry`` at 14 states),
    f32 and f64, global and semiglobal, shared and per-lane emissions: in
    the geometry's placement (registers at N = 54, C = 2; the scratch at
    N = 4,200, C = 132) and with the scratch forced (``HOMOPOLY_REG_BYTES``
    0)."""
    from rust_bio_tpu_torch.stats.pairhmm import BatchHomopolyPairHMM

    if placement == "scratch":
        monkeypatch.setattr(pairhmm_ops, "HOMOPOLY_REG_BYTES", 0)
    where = pairhmm_ops.pairhmm_log_geometry(N, 128, dtype, 132, pairhmm_ops.HOMOPOLY_STATES)[2]
    assert where == ("registers" if (N, placement) == (54, "geometry") else "scratch")

    B, M = (128, 207) if N < 1000 else (4, 6)
    xs, ys, xl, yl, ep = _hmm_pairs(np.random.default_rng(N + 3), B, M, N, None if N < 1000 else 60)
    ep4 = np.concatenate([ep, ep[:, 2:]], 1)
    hmm = BatchHomopolyPairHMM(*HMM_GAPS["extend"], *HOPS, dtype=dtype, device=cuda_device)
    args = _on(cuda_device, xs, ys, xl, yl)
    for emit in (np.append(HMM_EMIT, HMM_EMIT[2]), ep4):
        e = torch.from_numpy(emit).to(dtype).to(cuda_device)
        for semi in (False, True):
            got = pairhmm_ops.pairhmm_fwd_homopoly(*args, hmm._params, e, semi)
            torch.cuda.synchronize()
            want = pairhmm_ops.pairhmm_fwd_homopoly_plain(*args, hmm._params, e, semi)
            if dtype == torch.float32:
                _f32_close(got, want)
            else:
                _rel_close(got, want, 1e-12)


def test_pairhmm_classes_on_card_match_cpu(cuda_device):
    from rust_bio_tpu_torch.stats.pairhmm import (
        BatchHomopolyPairHMM,
        BatchPairHMM,
        BatchPairHMMExact,
        BatchPairHMMLinear,
    )

    rng = np.random.default_rng(81)
    xs, ys, xl, yl, ep = _hmm_pairs(rng, 200, 120, 40)
    for semi in (False, True):
        for emit in (HMM_EMIT, ep):
            for cls, kw in ((BatchPairHMMLinear, {}), (BatchPairHMM, {}), (BatchPairHMM, {"dtype": torch.float64})):
                before = (pairhmm_ops.PAIRHMM_FWD_SCALED.launches, pairhmm_ops.PAIRHMM_FWD_LOG.launches)
                got = cls(*HMM_GAPS["extend"], **kw, device=cuda_device).prob_related_batch(xs, ys, emit, semi, xl, yl)
                after = (pairhmm_ops.PAIRHMM_FWD_SCALED.launches, pairhmm_ops.PAIRHMM_FWD_LOG.launches)
                assert after != before
                want = cls(*HMM_GAPS["extend"], **kw, device="cpu").prob_related_batch(xs, ys, emit, semi, xl, yl)
                if kw:
                    _rel_close(torch.from_numpy(got), torch.from_numpy(want), 1e-12)
                else:
                    _f32_close(torch.from_numpy(got), torch.from_numpy(want))
            got = BatchPairHMMExact(*HMM_GAPS["extend"], device=cuda_device).prob_related_batch(xs, ys, emit, semi, 4, xl, yl)
            want = BatchPairHMMExact(*HMM_GAPS["extend"], device="cpu").prob_related_batch(xs, ys, emit, semi, 4, xl, yl)
            _rel_close(torch.from_numpy(got), torch.from_numpy(want), 1e-14)
        ep4 = np.concatenate([ep, ep[:, 2:]], 1)
        hmm = BatchHomopolyPairHMM(*HMM_GAPS["bench"], *HOPS, device=cuda_device)
        got = hmm.prob_related_batch(xs[:64], ys[:64], ep4[:64], semi, xl[:64], yl[:64])
        want = BatchHomopolyPairHMM(*HMM_GAPS["bench"], *HOPS, device="cpu").prob_related_batch(
            xs[:64], ys[:64], ep4[:64], semi, xl[:64], yl[:64]
        )
        _f32_close(torch.from_numpy(got), torch.from_numpy(want))


def test_pairhmm_linear_fallback_on_card(cuda_device):
    """x = y[10:64] against y of 64 and 207 bp, semiglobal, gap extends of
    0.5: the two 207 bp lanes underflow K17 and take K17-log, each with its
    own emission row."""
    from rust_bio_tpu_torch.stats.pairhmm import BatchPairHMM, BatchPairHMMLinear

    rng = np.random.default_rng(82)
    y = rng.choice(list(b"ACGT"), size=207).astype(np.uint8)
    xs, ys = np.tile(y[10:64], (4, 1)), np.tile(y, (4, 1))
    xl, yl = np.full(4, 54, np.int32), np.array([64, 64, 207, 207], np.int32)
    gaps = (math.log(2.8e-6), math.log(5.1e-6), math.log(0.5), math.log(0.5))
    q = 10.0 ** (-np.array([20.0, 30.0, 25.0, 35.0]) / 10.0)
    ep = np.stack([np.log1p(-q), np.log(q / 3), np.log1p(-q)], 1)
    hmm = BatchPairHMMLinear(*gaps, device=cuda_device)
    before = pairhmm_ops.PAIRHMM_FWD_LOG.launches
    got = hmm.prob_related_batch(xs, ys, ep, True, xl, yl)
    assert pairhmm_ops.PAIRHMM_FWD_LOG.launches == before + 1
    want = BatchPairHMMLinear(*gaps, device="cpu").prob_related_batch(xs, ys, ep, True, xl, yl)
    _f32_close(torch.from_numpy(got), torch.from_numpy(want))
    f64 = BatchPairHMM(*gaps, dtype=torch.float64, device=cuda_device).prob_related_batch(xs, ys, ep, True, xl, yl)
    _f32_close(torch.from_numpy(got), torch.from_numpy(f64))


# ---- K-merge, K4-LUT and the uint32 K4 / K4-locate ----


def _merge_stream(rng, N, B):
    """A synthetic walk stream with dropped codes among the exits, Ins runs
    past 4095 and ragged lengths (tests/test_torch_compact.py's, without
    JAX)."""
    ins_cnt = rng.choice([0, 0, 0, 0, 0, 1, 2, 5, 4095, 4096], size=(N, B)).astype(np.uint16)
    exit_op = rng.choice([0, 2, 3, 4, 4, 4, 4, 4, 4, 7], size=(N, B)).astype(np.uint16)
    ins0 = rng.choice([0, 0, 3, 5000], size=B).astype(np.uint16)
    fix_ins = rng.integers(0, 3, size=B).astype(np.int32)
    fix_exit = rng.choice([0, 1, 3, 4, 7], size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    nlens[:2] = [0, N]
    score = rng.integers(-(2**31), 2**31, size=B).astype(np.int32)
    xstart = rng.integers(0, 3, size=B).astype(np.int32)
    xend = rng.integers(0, 200, size=B).astype(np.int32)
    return ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens, score, xstart, xend


@pytest.mark.parametrize("N,R", [(40, 1), (150, 8), (150, 32), (800, 32), (150, 100)])
def test_merge_matches_plain(cuda_device, N, R):
    """K-merge against its plain version on the card, bit for bit: rounds
    whose runs cross the 32-entry round seams, R small enough to overflow,
    runs past 4095, R past a warp's lanes, global mode's absent fix fields."""
    rng = np.random.default_rng(80 + N + R)
    ins_cnt, exit_op, ins0, fix_ins, fix_exit, nlens, score, xstart, xend = (
        torch.from_numpy(a).to(cuda_device) for a in _merge_stream(rng, N, 3000)
    )
    for fixes in ((fix_ins, fix_exit, xstart), (None, None, None)):
        before = walk.RLE_MERGE.launches
        got = walk.merge_rle(score, ins_cnt, exit_op, ins0, fixes[0], fixes[1], nlens, fixes[2], xend, R)
        torch.cuda.synchronize()
        assert walk.RLE_MERGE.launches == before + 1
        want = walk.merge_rle_plain(score, ins_cnt, exit_op, ins0, fixes[0], fixes[1], nlens, fixes[2], xend, R)
        assert got.dtype == torch.uint16 and torch.equal(got, want)
        ovf = got[4].cpu().numpy().astype(np.int64) >> 15
        assert ovf.any() and not ovf.all()


@pytest.mark.parametrize("mode", ["global", "semiglobal"])
def test_compact_on_card_matches_cpu(cuda_device, mode):
    """The compact path on the card (K1/K5, K2/K6, K-merge) against the CPU
    path and the dense CIGARs: 2% divergence (no overflow) and random pairs
    (the dense re-run), finished alone and together."""
    rng = np.random.default_rng(90)
    B, M = 512, 150
    xb = rng.choice(list(b"ACGT"), size=(B, M)).astype(np.uint8)
    ys = [xb.copy(), rng.choice(list(b"ACGT"), size=(B, M)).astype(np.uint8)]
    mut = rng.random(size=(B, M)) < 0.02
    ys[0][mut] = rng.choice(list(b"ACGT"), size=int(mut.sum()))
    ml = np.full(B, M, np.int32)
    sc = Scoring.from_scores(-5, -1, 2, -2)
    on_card, on_cpu = BatchAligner(sc, device=cuda_device), BatchAligner(sc, device="cpu")
    start = getattr(on_card, f"{mode}_packed_compact_async_arrays")
    before = walk.RLE_MERGE.launches
    handles = [start(xb, yb, ml, ml) for yb in ys]
    assert walk.RLE_MERGE.launches == before + 2
    many = BatchAligner.packed_compact_finish_many(handles)
    for yb, h, m in zip(ys, handles, many):
        cpu_handle = getattr(on_cpu, f"{mode}_packed_compact_async_arrays")(xb, yb, ml, ml)
        assert torch.equal(h[0].cpu(), cpu_handle[0])
        want = BatchAligner.packed_compact_finish(cpu_handle)
        np.testing.assert_array_equal(m.score, want.score)
        np.testing.assert_array_equal(m.overflow, want.overflow)
        dense = getattr(BatchAligner, f"{mode}_packed_finish")(getattr(on_card, f"{mode}_packed_async_arrays")(xb, yb, ml, ml))
        assert m.cigars() == want.cigars() == dense.cigars()
    assert not many[0].overflow.any() and many[1].overflow.any()


def _lut_patterns(rng, text, B, L, q):
    """Complete, partial, absent, shorter-than-q and non-DNA lanes."""
    t = np.frombuffer(text, np.uint8)
    pats = rng.choice(list(b"ACGT"), size=(B, L)).astype(np.uint8)
    starts = rng.integers(0, len(t) - L - 1, size=B)
    sub = t[starts[:, None] + np.arange(L)]
    pats[: B // 2] = sub[: B // 2]
    part = np.arange(B // 4, B // 2)
    pats[part, rng.integers(0, L, size=part.size)] = rng.choice(list(b"ACGT"), size=part.size)
    plens = np.full(B, L, np.int32)
    plens[::7] = rng.integers(0, q, size=plens[::7].size)
    pats[3::11, rng.integers(0, L)] = ord("N")
    return pats, plens


@pytest.mark.parametrize("force_u32", [False, True], ids=["int32", "uint32"])
@pytest.mark.parametrize("n,q", [(5000, 5), (200_000, 12)], ids=["5k-q5", "200k-q12"])
def test_k4_lut_matches_plain_and_k4(cuda_device, force_u32, n, q):
    """K4-LUT against its plain version on the card and against K4, bit for
    bit, in both index modes: the table built on the card equals the one
    built on the CPU, every lane (miss lanes included) equals K4's, and
    the miss mask equals the plain version's."""
    rng = np.random.default_rng(100 + q)
    text = _fm_text(rng, n)
    index = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=16, device=cuda_device, force_u32=force_u32)
    index.build_kmer_lut(q=q)
    on_cpu = index.to("cpu")
    on_cpu.build_kmer_lut(q=q)
    assert torch.equal(index._lut.cpu(), on_cpu._lut)
    pats, plens = _lut_patterns(rng, text, 4096, 20, q)
    pats_d, plens_d = torch.from_numpy(pats).to(cuda_device), torch.from_numpy(plens).to(cuda_device)
    kernel = fm.FM_SEARCH_LUT_U32 if force_u32 else fm.FM_SEARCH_LUT
    before = kernel.launches
    got = index._search_kernel_lut(pats_d, plens_d)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = fm.search_lut_plain(
        index._fused, index._less256, index.sym_of, index._lut_rank, index._lut, q, pats_d, plens_d, index.n, force_u32
    )
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for g, k in zip(got[:4], index.search_arrays(pats_d, plens_d)):
        assert torch.equal(g, k)
    miss = got[4].cpu().numpy()
    assert miss.any() and not miss.all()
    status = got[0].cpu().numpy()
    assert set(status.tolist()) == {fm.ABSENT, fm.PARTIAL, fm.COMPLETE}
    for g, w in zip(index.search_batch_lut(pats, plens), on_cpu.search_batch_lut(pats, plens)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("s", [1, 8, 32])
def test_u32_k4_and_locate_match_plain(cuda_device, s):
    """The uint32 instantiations of K4 and K4-locate (``force_u32``) against
    their plain versions on the card and against the int32 index: every
    branch of K4's patterns, every row, several sentinels, and rows past
    2^31 and 0xFFFFFFFF, which give 0xFFFFFFFF."""
    rng = np.random.default_rng(110 + s)
    text = b"$".join(_fm_text(rng, k)[:-1] for k in (3000, 1, 1700)) + b"$"
    alpha = dna.n_alphabet()
    alpha.insert(ord("$"))
    big = DeviceFMIndex.from_text(text, alpha, sampling_rate=s, device=cuda_device, force_u32=True)
    small = DeviceFMIndex.from_text(text, alpha, sampling_rate=s, device=cuda_device)
    pats, plens = _k4_patterns(rng, _fm_text(rng, 3000), 24)
    pats_d, plens_d = torch.from_numpy(pats).to(cuda_device), torch.from_numpy(plens).to(cuda_device)
    before = fm.FM_BACKWARD_SEARCH_U32.launches
    got = big.search_arrays(pats_d, plens_d)
    torch.cuda.synchronize()
    assert fm.FM_BACKWARD_SEARCH_U32.launches == before + 1
    want = fm.backward_search_plain(big._fused, big._less256, big.sym_of, pats_d, plens_d, big.n, True)
    for g, w, i in zip(got, want, small.search_arrays(pats_d, plens_d)):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, i.to(g.dtype))
    tables = (big._fused, big.bwt_sym, big.less_sym, big.sa_sample, big.sent_rows, big.sent_vals)
    rows = torch.arange(len(text), device=cuda_device)
    before = fm.FM_LOCATE_U32.launches
    pos = big.locate_rows(rows)
    torch.cuda.synchronize()
    assert fm.FM_LOCATE_U32.launches == before + 1
    assert pos.dtype == torch.int64
    assert torch.equal(pos, fm.locate_plain(*tables, big._row_tensor(rows), s, True))
    assert torch.equal(pos, small.locate_rows(rows.to(torch.int32)).long())
    odd = torch.tensor([0, len(text), 2**31 + 5, 2**32 - 1], dtype=torch.int64, device=cuda_device)
    got = fm.locate(*tables, big._row_tensor(odd), s, big=True)
    assert torch.equal(got, fm.locate_plain(*tables, big._row_tensor(odd), s, True))
    assert got.cpu().tolist()[1:] == [2**32 - 1] * 3


def _fmd_index(seq: bytes, device):
    """A DeviceFMDIndex of ``seq``'s FMD text on ``device`` (the native
    SA-IS on the host, the tables on the device)."""
    from rust_bio_tpu_torch.data_structures.fmd_device import DeviceFMDIndex
    from rust_bio_tpu_torch.data_structures.suffix_array import suffix_array_host

    text = np.frombuffer(seq + b"$" + dna.revcomp(seq) + b"$", np.uint8)
    sa = suffix_array_host(text)
    alpha = dna.n_alphabet()
    alpha.insert(ord("$"))
    return DeviceFMDIndex(DeviceFMIndex(text[sa - 1], alpha, sa=sa, device=device))


def _smem_queries(rng, seq: bytes, B: int, L: int):
    """Substrings of ``seq`` and of its reverse complement with up to 4
    bytes rewritten (A/C/G/T, N, X outside the alphabet, a lowercase a),
    ragged, one empty; positions anywhere in each."""
    both = seq + dna.revcomp(seq)
    pats = np.zeros((B, L), np.uint8)
    plens = np.zeros(B, np.int32)
    for i in range(1, B):
        ln = int(rng.integers(1, L + 1))
        s = int(rng.integers(0, len(both) - ln))
        p = bytearray(both[s : s + ln])
        for _ in range(int(rng.integers(0, 5))):
            p[int(rng.integers(0, ln))] = int(rng.choice(list(b"ACGTNXa")))
        pats[i, :ln] = np.frombuffer(bytes(p), np.uint8)
        plens[i] = ln
    iis = np.array([int(rng.integers(0, max(n, 1))) for n in plens], np.int32)
    return pats, plens, iis


@pytest.fixture(scope="module")
def repeat_fmd():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(3)
    unit = rng.choice(list(b"ACGT"), size=7).astype("uint8").tobytes()
    seq = rng.choice(list(b"ACGT"), size=20_000).astype("uint8").tobytes()
    seq = seq[:3000] + unit * 40 + seq[3000:] + b"NNACGTN"
    return seq, _fmd_index(seq, torch.device("cuda"))


@pytest.mark.parametrize("mapper", [False, True], ids=["full", "mapper"])
@pytest.mark.parametrize("E", [2, 4, 16, 32])
def test_k_smem_matches_plain(repeat_fmd, mapper, E):
    """K-SMEM against its plain version, all seven outputs bit for bit, at
    every width of the mapper's budgets, on a tandem repeat (phase-1 and
    compaction overflows) with N, X and lowercase bytes in the reads."""
    from rust_bio_tpu_torch.ops import fmd

    seq, index = repeat_fmd
    dev = torch.device("cuda")
    pats, plens, iis = _smem_queries(np.random.default_rng(E), seq, 600, 150)
    # reads entering the repeat with the position deep in it
    starts = np.arange(2900, 3100, 5)
    deep = np.stack([np.frombuffer(seq[s : s + 150], np.uint8) for s in starts])
    pats = np.concatenate([pats, deep])
    plens = np.concatenate([plens, np.full(len(starts), 150, np.int32)])
    iis = np.concatenate([iis, np.full(len(starts), 120, np.int32)])
    args = [torch.from_numpy(a).to(dev) for a in (pats, plens, iis)]
    for l, MC in ((0, E), (19, 4)):
        got = fmd.smems(index.tables, *args, l, E, MC, mapper)
        torch.cuda.synchronize()
        want = fmd.smems_plain(index.tables, *args, l, E, MC, mapper)
        for name, g, w in zip(("m_lo", "m_lor", "m_sz", "m_st", "m_ml", "mcnt", "ovf"), got, want):
            assert torch.equal(g, w), (name, l, MC)
    if E <= 4:
        assert bool(want[6].any())
    if mapper:
        out = torch.empty((4, len(plens)), dtype=torch.int32, device=dev)
        rows = fmd.seed_pick(index.tables, *args, 19, E, out)
        torch.cuda.synchronize()
        wrows, wpick = fmd.pick_plain(*fmd.smems_plain(index.tables, *args, 19, E, E, True))
        assert torch.equal(rows, wrows) and torch.equal(out, wpick)


def test_k_smem_matches_host_oracle(repeat_fmd):
    """K-SMEM's results through ``smems_batch`` (both modes) against the
    port's host ``FMDIndex``."""
    from rust_bio_tpu_torch.data_structures.bwt import Occ, less
    from rust_bio_tpu_torch.data_structures.fmindex import FMDIndex, FMIndex

    seq, index = repeat_fmd
    b = index.fm.bwt_host()
    alpha = dna.n_alphabet()
    oracle = FMDIndex(FMIndex(b, less(b, alpha), Occ(b, 64, alpha)))
    pats, plens, iis = _smem_queries(np.random.default_rng(31), seq.replace(b"N", b"A"), 128, 100)
    keep = plens > 0
    reads = [bytes(p[:n]).replace(b"X", b"A").replace(b"a", b"A") for p, n in zip(pats[keep], plens[keep])]
    poss = iis[keep].tolist()
    key = lambda lanes: [[(i.lower, i.lower_rev, i.size, i.match_size, s, n) for i, s, n in lane] for lane in lanes]  # noqa: E731
    got = index.smems_batch(reads, poss, 10, host_oracle=oracle)
    want = [oracle.smems(r, i, 10) for r, i in zip(reads, poss)]
    assert key(got) == key(want)
    mapped = index.smems_batch(reads, poss, 10, mapper_mode=True, host_oracle=oracle)
    drop = lambda lanes: [[k[:1] + k[2:] for k in lane] for lane in key(lanes)]  # noqa: E731
    assert drop(mapped) == drop(want)


def _mapper_reads(rng, genome: bytes, n: int, length: int = 100):
    """Reads with two mixed errors each (70% substitutions, 15% and 15%
    1-2 bp insertions and deletions), half reverse-complemented."""
    reads = []
    for k in range(n):
        s = int(rng.integers(0, len(genome) - length))
        r = bytearray(genome[s : s + length])
        for _ in range(2):
            at = int(rng.integers(5, len(r) - 5))
            u = rng.random()
            if u < 0.7:
                r[at] = b"ACGT"[(b"ACGT".index(r[at]) + int(rng.integers(1, 4))) % 4]
            elif u < 0.85:
                r[at:at] = rng.choice(list(b"ACGT"), size=int(rng.integers(1, 3))).astype("uint8").tobytes()
            else:
                del r[at : at + int(rng.integers(1, 3))]
        reads.append(dna.revcomp(bytes(r)) if k % 2 else bytes(r))
    return reads


def test_seed_chain_matches_plain(repeat_fmd):
    """The mapper's seed chain on the card (K-SMEM with its pick, then
    K4-locate) gives the packed (B, 5) of the plain chain on the card."""
    from rust_bio_tpu_torch.pipelines import SmemReadMapper
    from rust_bio_tpu_torch.data_structures.fmd_device import pad_batch

    seq, _ = repeat_fmd
    genome = seq.replace(b"N", b"A")
    mapper = SmemReadMapper(genome, device="cuda")
    reads = _mapper_reads(np.random.default_rng(5), genome, 512)
    pb, plens, _ = pad_batch(reads)
    iis = np.maximum(plens // 2 - 1, 0).astype(np.int32)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (pb, plens, iis)]
    for E in (16, 32):
        got = mapper._seed_kernel(*args, E=E)
        torch.cuda.synchronize()
        from rust_bio_tpu_torch.ops import fm, fmd

        rows, pick = fmd.pick_plain(*fmd.smems_plain(mapper.fmd.tables, *args, mapper.min_seed_len, E, E, True))
        idx = mapper.index
        pos = fm.locate_plain(idx._fused, idx.bwt_sym, idx.less_sym, idx.sa_sample, idx.sent_rows, idx.sent_vals, rows, idx.s)
        assert torch.equal(got, torch.cat([pos[None, :], pick])), E


def test_smem_mapper_card_matches_cpu(repeat_fmd):
    """``SmemReadMapper`` with the kernels on the card equals the plain
    versions on the CPU, read for read, at the full budget and with a
    shrunken one (the wide retry and the host oracle)."""
    from rust_bio_tpu_torch.pipelines import SmemReadMapper

    seq, _ = repeat_fmd
    genome = seq.replace(b"N", b"A")
    card = SmemReadMapper(genome, device="cuda")
    cpu = card.to("cpu")
    rng = np.random.default_rng(9)
    reads = _mapper_reads(rng, genome, 256) + [genome[2950:3050], b"", rng.choice(list(b"ACGT"), size=100).astype("uint8").tobytes()]
    key = lambda ms: [(m.pos, m.strand, m.score, m.cigar) for m in ms]  # noqa: E731
    assert key(card.map_batch(reads)) == key(cpu.map_batch(reads))
    card._E0 = cpu._E0 = 2
    got = card.map_batch(reads)
    assert card.seed_stats["wide_lanes"] > 0 and card.seed_stats["oracle_lanes"] > 0
    assert key(got) == key(cpu.map_batch(reads))
    assert [key(b) for b in card.map_stream([reads[:100], reads[100:]])] == [key(cpu.map_batch(reads[:100])), key(cpu.map_batch(reads[100:]))]


# ---- K-HMM-vit, K-HMM-fwd, K-HMM-bwd (ops/csrc/hmm.cu) ----


def _hmm_inputs(device, S, gauss, B, T, seed, ties=False, ln0=False, V=6):
    """One model and B ragged sequences (lengths 1..T, the first T and 1):
    ``ties`` makes A and the emissions uniform; ``ln0`` puts ln 0 (the
    -3e38 surrogate) in a row and a column of A, a start and an end."""
    from rust_bio_tpu_torch.ops import hmm as hmm_ops

    rng = np.random.default_rng(seed)
    A = np.log(rng.dirichlet(np.ones(S), size=S))
    pi = np.log(rng.dirichlet(np.ones(S)))
    end = np.log(rng.dirichlet(np.ones(S)))
    if ties:
        A[:] = np.log(1.0 / S)
    if ln0:
        A[0, :] = hmm_ops.NEG
        A[:, min(1, S - 1)] = hmm_ops.NEG
        pi[0] = hmm_ops.NEG
        end[S - 1] = hmm_ops.NEG
    lens = rng.integers(1, T + 1, size=B)
    lens[: min(B, 2)] = [T, 1][: min(B, 2)]
    if gauss:
        emit = np.stack([rng.normal(0, 2, S), rng.normal(-1, 0.5, S), rng.uniform(0.1, 2, S)])
        obs = rng.normal(0, 2, size=(B, T)).astype(np.float32)
    else:
        emit = np.log(rng.dirichlet(np.ones(V), size=S))
        if ties:
            emit[:] = np.log(1.0 / V)
        obs = rng.integers(0, V, size=(B, T)).astype(np.int32)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(device)  # noqa: E731
    return t(A), t(emit), t(pi), t(end), torch.from_numpy(obs).to(device), t(lens, torch.int32)


def _hmm_close(got, want, tol=1e-4):
    """Within tol of max(1, |want|), the infinite entries equal."""
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    if fin.any():
        err = ((got - want).abs()[fin] / want.abs()[fin].clamp(min=1)).max().item()
        assert err <= tol, err


@pytest.mark.parametrize("case", ["plain", "ties", "ln0"])
@pytest.mark.parametrize("gauss", [False, True], ids=["discrete", "gaussian"])
@pytest.mark.parametrize("S", [2, 5, 33, 128, 256])
def test_hmm_kernels_match_plain(cuda_device, S, gauss, case):
    """K-HMM-vit (paths and probs bit for bit, the discrete ones; the
    Gaussian probs within 1e-6 relative), K-HMM-fwd and K-HMM-bwd (within
    1e-4 of max(1, |x|)) against their plain versions: both layouts, ties,
    ln-0 rows, ragged lengths with T = 1 lanes."""
    from rust_bio_tpu_torch.ops import hmm as hmm_ops

    B, T = (64, 300) if S <= 33 else (16, 120)
    args = _hmm_inputs(cuda_device, S, gauss, B, T, S + 7 * gauss, ties=case == "ties", ln0=case == "ln0")
    paths, prob = hmm_ops.viterbi(*args)
    torch.cuda.synchronize()
    wpaths, wprob = hmm_ops.viterbi_plain(*args)
    assert torch.equal(paths, wpaths)
    if gauss:
        _hmm_close(prob, wprob, 1e-6)
    else:
        assert torch.equal(prob, wprob)
    for fn, plain in ((hmm_ops.forward, hmm_ops.forward_plain), (hmm_ops.backward, hmm_ops.backward_plain)):
        vals, tot = fn(*args)
        torch.cuda.synchronize()
        wvals, wtot = plain(*args)
        _hmm_close(vals, wvals)
        _hmm_close(tot, wtot)


@pytest.mark.parametrize("S", [157, 200])
def test_hmm_kernels_without_shared_matrix(cuda_device, S):
    """The block layout with A read from device memory (S * S * 4 bytes
    past SHARED_M_MAX), and T = 1."""
    from rust_bio_tpu_torch.ops import hmm as hmm_ops

    assert not hmm_ops.geometry(S)["shared_m"]
    for T in (1, 70):
        args = _hmm_inputs(cuda_device, S, False, 9, T, S + T)
        assert all(torch.equal(a, b) for a, b in zip(hmm_ops.viterbi(*args), hmm_ops.viterbi_plain(*args)))
        for fn, plain in ((hmm_ops.forward, hmm_ops.forward_plain), (hmm_ops.backward, hmm_ops.backward_plain)):
            for got, want in zip(fn(*args), plain(*args)):
                _hmm_close(got, want)


def test_hmm_classes_on_card_match_cpu(cuda_device):
    """The batched classes and baum_welch_batch on the card against
    device="cpu" (the plain versions): Viterbi equal, the rest within 1e-4
    of max(1, |x|), Baum-Welch within 1e-5."""
    from rust_bio_tpu_torch.stats.hmm import device as hmm_device

    rng = np.random.default_rng(25)
    A = np.log([[0.95, 0.05], [0.1, 0.9]])
    Bm = np.log([[1 / 6.0] * 6, [0.1, 0.1, 0.1, 0.1, 0.1, 0.5]])
    pi = np.log([0.5, 0.5])
    seqs = [rng.integers(0, 6, size=int(n)) for n in rng.integers(1, 400, size=48)]
    card = hmm_device.BatchDiscreteHMM(A, Bm, pi, device=cuda_device)
    cpu = hmm_device.BatchDiscreteHMM(A, Bm, pi, device="cpu")
    for name in ("viterbi_batch", "forward_batch", "backward_batch"):
        for got, want in zip(getattr(card, name)(seqs), getattr(cpu, name)(seqs)):
            if name == "viterbi_batch":
                np.testing.assert_array_equal(got, want)
            else:
                _hmm_close(torch.from_numpy(got), torch.from_numpy(want))
    m_card, ll_card = hmm_device.baum_welch_batch(card, seqs, n_iter=2)
    m_cpu, ll_cpu = hmm_device.baum_welch_batch(cpu, seqs, n_iter=2)
    assert m_card.device.type == "cuda"
    np.testing.assert_allclose(ll_card, ll_cpu, rtol=1e-5)
    for name in ("A", "Bm", "pi"):
        np.testing.assert_allclose(getattr(m_card, name).cpu().numpy(), getattr(m_cpu, name).numpy(), atol=1e-5)
    params = [(0.05, 0.1), (0.5, 0.15), (1.0, 0.2)]
    gA = np.log([[0.98, 0.01, 0.01], [0.01, 0.98, 0.01], [0.01, 0.01, 0.98]])
    xs = [rng.normal(1.0, 0.5, size=int(n)) for n in (300, 1, 57)]
    gcard = hmm_device.BatchGaussianHMM(gA, params, np.log(np.full(3, 1 / 3)), device=cuda_device)
    gcpu = hmm_device.BatchGaussianHMM(gA, params, np.log(np.full(3, 1 / 3)), device="cpu")
    np.testing.assert_array_equal(gcard.viterbi_batch(xs)[0], gcpu.viterbi_batch(xs)[0])
    for name in ("forward_batch", "backward_batch"):
        for got, want in zip(getattr(gcard, name)(xs), getattr(gcpu, name)(xs)):
            _hmm_close(torch.from_numpy(got), torch.from_numpy(want))
