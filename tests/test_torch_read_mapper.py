"""The port's ``ReadMapper`` (``device="cpu"``: the kernels' plain PyTorch
versions) against the JAX package's ``ReadMapper`` on the 5,000 bp genome
of ``tests/test_read_mapper.py``: every field of every ``MappedRead``,
including the decoded ``Alignment``, must be equal, through the packed
extension and through ``semiglobal`` (long reads). Also the port's own
copies of the DNA and alignment-type helpers the mapper uses."""

import re

import numpy as np
import pytest

from rust_bio_tpu.alignment.types import Alignment as JaxAlignment
from rust_bio_tpu.alignment.types import AlignmentMode as JaxAlignmentMode
from rust_bio_tpu.alignment.types import Ins as JaxIns
from rust_bio_tpu.alignment.types import Yclip as JaxYclip
from rust_bio_tpu.alignment.pairwise.batched import BatchAligner as JaxBatchAligner
from rust_bio_tpu.alignment.pairwise.scoring import Scoring as JaxScoring
from rust_bio_tpu.alphabets import dna as jax_dna
from rust_bio_tpu.pipelines import ReadMapper as JaxReadMapper
from rust_bio_tpu_torch.alignment.pairwise import batched
from rust_bio_tpu_torch.alignment.types import Alignment, AlignmentMode, Del, Ins, Match, Subst, Xclip, Yclip
from rust_bio_tpu_torch.alphabets import dna
from rust_bio_tpu_torch.pipelines import MappedRead, ReadMapper


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(1234)
    return rng.choice(list(b"ACGT"), size=5000).astype("uint8").tobytes()


@pytest.fixture(scope="module")
def mappers(genome):
    return ReadMapper(genome, seed_len=20, flank=8, device="cpu"), JaxReadMapper(genome, seed_len=20, flank=8)


def _mutate(r: bytearray, pos: int) -> None:
    r[pos] = b"ACGT"[(b"ACGT".index(bytes([r[pos]])) + 1) % 4]


def _reads(kind, genome):
    """The read classes of tests/test_read_mapper.py, plus reads at both
    ends of the genome."""
    if kind == "forward":
        rng = np.random.default_rng(7)
        return [genome[s : s + 100] for s in rng.integers(0, len(genome) - 100, size=16)]
    if kind == "reverse":
        rng = np.random.default_rng(8)
        return [dna.revcomp(genome[s : s + 100]) for s in rng.integers(0, len(genome) - 100, size=8)]
    if kind == "mismatch":
        rng = np.random.default_rng(9)
        reads = []
        for s in rng.integers(0, len(genome) - 100, size=8):
            r = bytearray(genome[s : s + 100])
            _mutate(r, 30)  # outside every seed window (0, 40, 80)
            reads.append(bytes(r))
        return reads
    if kind == "deletion":
        return [genome[1000:1050] + genome[1053:1103], genome[4000:4055] + genome[4057:4102]]
    if kind == "unmapped":
        rng = np.random.default_rng(10)
        return [rng.choice(list(b"ACGT"), size=100).astype("uint8").tobytes() for _ in range(3)]
    if kind == "mixed":
        rng = np.random.default_rng(11)
        junk = rng.choice(list(b"ACGT"), size=100).astype("uint8").tobytes()
        return [genome[200:300], junk, dna.revcomp(genome[400:500])]
    if kind == "ends":
        return [genome[:100], genome[-100:], dna.revcomp(genome[-90:]), genome[3:60]]
    if kind == "short":  # shorter than a seed, empty, an N run before the seeds
        return [genome[100:110], b"", genome[200:221], b"N" * 30 + genome[500:600]]
    raise ValueError(kind)


KINDS = ["forward", "reverse", "mismatch", "deletion", "unmapped", "mixed", "ends", "short"]


def _aln_fields(a):
    if a is None:
        return None
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, a.xlen, a.ylen, a.mode.value, list(a.operations))


def _fields(m):
    return (m.read_id, m.pos, m.strand, m.score, m.cigar, _aln_fields(m.alignment))


@pytest.mark.parametrize("kind", KINDS)
def test_map_batch_matches_jax(kind, genome, mappers):
    port, jax_mapper = mappers
    reads = _reads(kind, genome)
    ids = [f"{kind}{k}" for k in range(len(reads))]
    got = port.map_batch(reads, ids=ids)
    assert all(isinstance(m, MappedRead) for m in got)
    assert [_fields(m) for m in got] == [_fields(m) for m in jax_mapper.map_batch(reads, ids=ids)]
    # the reference tests' own expectations
    if kind in ("forward", "reverse"):
        assert all(m.cigar == "100=" and m.score == 200 for m in got)
        assert {m.strand for m in got} == {"+" if kind == "forward" else "-"}
    if kind == "mismatch":
        assert all(m.cigar == "30=1X69=" and m.score == 196 for m in got)
    if kind == "deletion":
        assert (got[0].pos, got[1].pos) == (1000, 4000)
        assert all(re.fullmatch(r"(\d+)=(2|3)D(\d+)=", m.cigar) for m in got)
    if kind == "unmapped":
        assert all(m.pos == -1 and m.alignment is None for m in got)
    if kind == "mixed":
        assert [(m.pos, m.strand) for m in got] == [(200, "+"), (-1, "+"), (400, "-")]
    if kind == "short":
        assert [m.cigar for m in got] == ["10=", "", "21=", "30I100="]


def test_empty_batch(mappers):
    assert mappers[0].map_batch([]) == []
    assert [list(part) for part in mappers[0].map_stream([[], []])] == [[], []]


def _stream_reads(genome, n_batches=3, per_batch=6):
    rng = np.random.default_rng(41)
    batches = []
    for _ in range(n_batches):
        reads = []
        for k in range(per_batch):
            r = bytearray(genome[(s := int(rng.integers(0, len(genome) - 80))) : s + 80])
            if k % 2:
                _mutate(r, 35)
            reads.append(dna.revcomp(bytes(r)) if k % 3 == 2 else bytes(r))
        batches.append(reads)
    return batches


def test_map_stream_matches_map_batch(genome, mappers):
    port, _ = mappers
    batches = _stream_reads(genome)
    streamed = list(port.map_stream(batches))
    assert len(streamed) == len(batches)
    for part, reads in zip(streamed, batches):
        assert [_fields(m) for m in part] == [_fields(m) for m in port.map_batch(reads)]


def test_chunked_map_batch_matches_direct(genome, mappers):
    """Batches of at least twice ``_PIPE_CHUNK`` go through ``map_stream``
    in chunks (here 4 chunks with a ragged tail); results are equal and in
    order."""
    port, _ = mappers
    rng = np.random.default_rng(31)
    reads = [genome[s : s + 90] for s in rng.integers(0, len(genome) - 90, size=13)]
    reads[3] = dna.revcomp(reads[3])
    reads[7] = rng.choice(list(b"ACGT"), size=90).astype("uint8").tobytes()
    ids = [f"r{k}" for k in range(len(reads))]
    direct = port.map_batch(reads, ids=ids)
    chunked_mapper = port.to("cpu")
    chunked_mapper._PIPE_CHUNK = 4
    assert [_fields(m) for m in chunked_mapper.map_batch(reads, ids=ids)] == [_fields(m) for m in direct]
    assert port._PIPE_CHUNK == 8192


def test_rc_pb_matches_revcomp(mappers):
    port, _ = mappers
    rng = np.random.default_rng(2)
    seqs = [rng.choice(list(b"ACGTN"), size=int(n)).astype(np.uint8).tobytes() for n in (5, 9, 0, 9, 1)]
    pb = np.zeros((len(seqs), 9), np.uint8)
    for i, s in enumerate(seqs):
        pb[i, : len(s)] = np.frombuffer(s, np.uint8)
    rc = port._rc_pb(pb, np.array([len(s) for s in seqs], np.int32))
    for i, s in enumerate(seqs):
        assert rc[i, : len(s)].tobytes() == dna.revcomp(s)
        assert not rc[i, len(s) :].any()


def test_dna_helpers_match_jax():
    np.testing.assert_array_equal(dna.COMPLEMENT, jax_dna.COMPLEMENT)
    text = b"ACGTNacgtnRYKM"
    assert dna.revcomp(text) == jax_dna.revcomp(text)
    np.testing.assert_array_equal(dna.revcomp_array(text), jax_dna.revcomp_array(text))
    arr = np.frombuffer(text, np.uint8)
    np.testing.assert_array_equal(dna.complement(arr), jax_dna.complement(arr))
    assert dna.complement(ord("A")) == jax_dna.complement(ord("A")) == ord("T")


def test_alignment_cigar_and_clip_ops_match_jax():
    ops = [Yclip(3), Match, Match, Subst, Ins, Ins, Del, Match, Xclip(2)]
    assert Yclip(5) == JaxYclip(5) and Ins == JaxIns
    port = Alignment(score=1, xstart=1, xend=7, ystart=3, yend=9, xlen=9, ylen=12, operations=list(ops),
                     mode=AlignmentMode.Semiglobal)
    ref = JaxAlignment(score=1, xstart=1, xend=7, ystart=3, yend=9, xlen=9, ylen=12, operations=list(ops),
                       mode=JaxAlignmentMode.Semiglobal)
    assert port.cigar() == ref.cigar() == "1S2=1X2I1D1=2S"
    assert port.cigar(hard_clip=True) == ref.cigar(hard_clip=True)
    assert (port.x_aln_len(), port.y_aln_len()) == (ref.x_aln_len(), ref.y_aln_len()) == (6, 6)
    port.filter_clip_operations()
    ref.filter_clip_operations()
    assert port.operations == ref.operations == ops[1:-1]
    with pytest.raises(ValueError):
        Alignment(score=0, mode=AlignmentMode.Global).cigar()


def _reads_150(genome):
    """150 bp reads: forward, reverse-complemented, with a substitution past
    the first seed window, plus a random read."""
    rng = np.random.default_rng(17)
    reads = []
    for k, s in enumerate(rng.integers(0, len(genome) - 150, size=9)):
        r = bytearray(genome[s : s + 150])
        if k % 3 == 1:
            _mutate(r, 40)
        reads.append(dna.revcomp(bytes(r)) if k % 3 == 2 else bytes(r))
    return reads + [rng.choice(list(b"ACGT"), size=150).astype("uint8").tobytes()]


def test_long_route_matches_jax(monkeypatch, genome, mappers):
    """``T_COLUMNS`` forced to 64: the port's mapper extends 150 bp reads
    through ``semiglobal`` (K15, K15-walk), from the padded batch and from
    byte strings, and equals the JAX mapper read for read."""
    port, jax_mapper = mappers
    reads = _reads_150(genome)
    want = [_fields(m) for m in jax_mapper.map_batch(reads)]
    seqs = [genome[1000:1150], dna.revcomp(genome[2000:2150])]
    picks = {0: ("+", 992, 1158), 1: ("-", 1992, 2158)}
    by_bytes = [_fields(m) for m in port._extend(seqs, [dna.revcomp(s) for s in seqs], ["a", "b"], picks)]
    calls = []
    semiglobal = port.aligner.semiglobal
    monkeypatch.setattr(batched, "T_COLUMNS", 64)
    monkeypatch.setattr(port.aligner, "semiglobal", lambda xs, ys: calls.append(len(xs)) or semiglobal(xs, ys))
    assert [_fields(m) for m in port.map_batch(reads)] == want
    assert [_fields(m) for m in port._extend(seqs, [dna.revcomp(s) for s in seqs], ["a", "b"], picks)] == by_bytes
    assert calls == [sum(w[1] >= 0 for w in want), 2]


def test_long_read_maps_as_jax_semiglobal_on_its_window():
    """A 4,100 bp read (substitutions outside its first seed window) of a
    6,000 bp genome maps through ``semiglobal`` at its own length, equal to
    the JAX ``BatchAligner.semiglobal`` on the window the mapper picks."""
    rng = np.random.default_rng(77)
    genome = rng.choice(list(b"ACGT"), size=6000).astype("uint8").tobytes()
    start = 1234
    read = bytearray(genome[start : start + 4100])
    for pos in rng.integers(100, 4000, size=40):
        _mutate(read, int(pos))
    got = ReadMapper(genome, device="cpu").map_batch([bytes(read)])[0]
    ws, we = start - 8, start + 4100 + 8  # the seed at offset 0, flank 8
    want = JaxBatchAligner(JaxScoring.from_scores(-5, -1, 2, -2)).semiglobal([bytes(read)], [genome[ws:we]])[0]
    assert (got.pos, got.strand, got.score, got.cigar) == (ws + want.ystart, "+", want.score, want.cigar())
    assert _aln_fields(got.alignment) == _aln_fields(want)
    assert got.score > 0 and "X" in got.cigar
