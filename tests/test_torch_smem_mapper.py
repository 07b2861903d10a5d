"""The port's ``SmemReadMapper`` against the JAX package's, read for read
(position, strand, score, CIGAR): perfect reads on both strands, mixed
substitutions and indels, ragged lengths, an empty and a random read,
reads at the genome's ends (the '-' strand split at G + 1), the chunked
and streamed paths, the seed chain's packed (B, 5) seeds at E = 16 and 32,
a shrunken slot budget that sends lanes through the wide retry and the
host oracle, and the index cache both ways (a cache of another genome is
refused). Small sizes: a 5,000 bp genome, tens of reads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.alphabets import dna as jax_dna
from rust_bio_tpu.data_structures.serialize import load_fm_index as jax_load_fm_index
from rust_bio_tpu.pipelines.read_mapper import SmemReadMapper as JaxSmemReadMapper
from rust_bio_tpu_torch.data_structures.serialize import load_fm_index
from rust_bio_tpu_torch.pipelines import SmemReadMapper


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(1234)
    return rng.choice(list(b"ACGT"), size=5000).astype("uint8").tobytes()


@pytest.fixture(scope="module")
def mappers(genome):
    return SmemReadMapper(genome, device="cpu"), JaxSmemReadMapper(genome)


def _key(m):
    return (m.pos, m.strand, m.score, m.cigar)


def _mutate(rng, read: bytes, n_edits: int) -> bytes:
    """Substitutions (70%) and 1-2 bp insertions or deletions (15% each)."""
    r = bytearray(read)
    for _ in range(n_edits):
        at = int(rng.integers(5, len(r) - 5))
        kind = rng.random()
        if kind < 0.7:
            r[at] = b"ACGT"[(b"ACGT".index(r[at]) + int(rng.integers(1, 4))) % 4]
        elif kind < 0.85:
            r[at:at] = rng.choice(list(b"ACGT"), size=int(rng.integers(1, 3))).astype("uint8").tobytes()
        else:
            del r[at : at + int(rng.integers(1, 3))]
    return bytes(r)


def _reads(genome: bytes, seed: int):
    """(reads, origins): perfect 100 bp reads on both strands, reads with
    mixed errors at ragged lengths, reads at both genome ends, an empty
    read and a random one (origin -1)."""
    rng = np.random.default_rng(seed)
    reads, origins = [], []
    for k in range(12):
        s = int(rng.integers(0, len(genome) - 100))
        r = genome[s : s + 100]
        reads.append(jax_dna.revcomp(r) if k % 2 else r)
        origins.append((s, "-" if k % 2 else "+"))
    for k in range(16):
        ln = int(rng.integers(40, 141))
        s = int(rng.integers(0, len(genome) - ln))
        r = _mutate(rng, genome[s : s + ln], int(rng.integers(1, 4)))
        reads.append(jax_dna.revcomp(r) if k % 3 == 0 else r)
        origins.append((s, "-" if k % 3 == 0 else "+"))
    reads += [genome[-60:], jax_dna.revcomp(genome[:70]), genome[:50], jax_dna.revcomp(genome[-80:])]
    origins += [(len(genome) - 60, "+"), (0, "-"), (0, "+"), (len(genome) - 80, "-")]
    reads += [b"", rng.choice(list(b"ACGT"), size=100).astype("uint8").tobytes()]
    origins += [(-1, "+"), (-1, "+")]
    return reads, origins


def test_map_batch_equals_jax(genome, mappers):
    port, jax_m = mappers
    reads, origins = _reads(genome, 7)
    for k in port.seed_stats:
        port.seed_stats[k] = 0
    got = port.map_batch(reads)
    want = jax_m.map_batch(reads)
    assert [_key(m) for m in got] == [_key(m) for m in want]
    for k, (m, (s, strand)) in enumerate(zip(got[:12], origins[:12])):
        assert (m.pos, m.strand, m.cigar, m.score) == (s, strand, "100=", 200), k
    for k in range(28, 32):  # the ends: '+' before G, '-' past G + 1
        assert (got[k].pos, got[k].strand) == origins[k], k
    assert got[-2].pos == -1 and got[-1].pos == -1
    assert got[5].alignment.operations == want[5].alignment.operations
    # the random read found no SMEM of 19 at its middle: the quarter retry ran
    assert port.seed_stats["main_launches"] == 1 and port.seed_stats["quarter_launches"] == 1
    assert port.seed_stats["quarter_lanes"] >= 2


def test_map_stream_equals_jax_and_map_batch(genome, mappers, monkeypatch):
    port, jax_m = mappers
    batches = [_reads(genome, seed)[0] for seed in (8, 9, 10)]
    got = list(port.map_stream(batches))
    want = list(jax_m.map_stream(batches))
    assert [[_key(m) for m in b] for b in got] == [[_key(m) for m in b] for b in want]
    assert [[_key(m) for m in b] for b in got] == [[_key(m) for m in port.map_batch(b)] for b in batches]
    # a batch of at least twice the chunk maps in chunks through the stream
    flat = [r for b in batches for r in b]
    monkeypatch.setattr(SmemReadMapper, "_PIPE_CHUNK", 16)
    assert [_key(m) for m in port.map_batch(flat)] == [_key(m) for b in got for m in b]


@pytest.mark.parametrize("E", [16, 32])
def test_seed_chain_equals_jax(genome, mappers, E):
    """The packed seeds (position, start, length, found, ovf) of the chain
    K-SMEM with its pick, then K4-locate (row 0 located for unfound
    lanes), equal ``_seed_kernel``'s."""
    port, jax_m = mappers
    reads, _ = _reads(genome, 11)
    pb, plens = np.zeros((len(reads), 140), np.uint8), np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        pb[i, : len(r)] = np.frombuffer(r, np.uint8)
        plens[i] = len(r)
    iis = np.maximum(plens // 2 - 1, 0).astype(np.int32)
    got = port._seed_kernel(*map(torch.from_numpy, (pb, plens, iis)), E=E).numpy().T
    want = np.asarray(jax_m._seed_kernel(jnp.asarray(pb), jnp.asarray(plens), jnp.asarray(iis), E=E))
    assert np.array_equal(got, want)
    assert want[:, 3].sum() > len(reads) // 2


def test_wide_retry_and_oracle(genome):
    """A tandem repeat sheds one occurrence a backward step, so a slot
    budget of 2 overflows: lanes go through the E = 4 wide retry and, where
    that overflows too, the host oracle; every read equals the JAX mapper's
    at the same budget, and the exact reads a mapper's at the full budget
    (a mutated read whose oracle lane finds no middle SMEM is not retried
    at its quarters, in both packages)."""
    rng = np.random.default_rng(23)
    unit = rng.choice(list(b"ACGT"), size=13).astype("uint8").tobytes()
    g = genome[:1500] + unit * 30 + genome[1500:3000]
    port = SmemReadMapper(g, device="cpu")
    small = SmemReadMapper(g, device="cpu")
    small._E0 = 2
    jax_small = JaxSmemReadMapper(g)
    jax_small._E0 = 2
    starts = [1400, 1450, 1495, 1520, 1600, 2100, 2500]
    reads = [g[s : s + 70] for s in starts] + [jax_dna.revcomp(g[1480 : 1480 + 70])]
    reads += [_mutate(rng, g[s : s + 90], 2) for s in (1430, 1470, 1510)]
    got = small.map_batch(reads)
    assert small.seed_stats["wide_launches"] == 1 and small.seed_stats["wide_lanes"] > 0
    assert small.seed_stats["oracle_lanes"] > 0
    assert [_key(m) for m in got] == [_key(m) for m in jax_small.map_batch(reads)]
    assert [_key(m) for m in got[:8]] == [_key(m) for m in port.map_batch(reads[:8])]
    assert port.seed_stats["oracle_lanes"] == 0


def test_index_cache_both_ways(genome, mappers, tmp_path):
    """A cache written by the port loads in the JAX ``load_fm_index`` (hash
    checked) with the JAX index's arrays, and a JAX mapper maps from it as
    from its own build; a cache written by the JAX mapper loads in the port's;
    a cache of another genome is refused by both."""
    port, jax_m = mappers
    reads, _ = _reads(genome, 12)
    want = [_key(m) for m in jax_m.map_batch(reads)]
    port_cache = str(tmp_path / "port.npz")
    built = SmemReadMapper(genome, index_cache=port_cache, device="cpu")
    assert "sais_s" in built.build_s
    jidx, meta = jax_load_fm_index(port_cache, return_meta=True)
    for name in ("less", "sym_of", "sa_sample", "sent_rows", "sent_vals"):
        assert np.array_equal(np.asarray(getattr(jidx, name)), np.asarray(getattr(jax_m.index, name))), name
    assert np.array_equal(np.asarray(jidx.bits), np.asarray(jax_m.index.bits))
    assert np.array_equal(jidx.bwt_host(), jax_m.index.bwt_host())
    assert (jidx.n, jidx.s, jidx.sentinel, jidx.symbols) == (jax_m.index.n, 8, 36, jax_m.index.symbols)
    assert meta["genome_sha256"] == __import__("hashlib").sha256(genome).hexdigest()[:16]
    assert [_key(m) for m in JaxSmemReadMapper(genome, index_cache=port_cache).map_batch(reads)] == want
    loaded = SmemReadMapper(genome, index_cache=port_cache, device="cpu")
    assert "load_s" in loaded.build_s
    assert [_key(m) for m in loaded.map_batch(reads)] == want

    jax_cache = str(tmp_path / "jax.npz")
    JaxSmemReadMapper(genome, index_cache=jax_cache)
    from_jax = SmemReadMapper(genome, index_cache=jax_cache, device="cpu")
    assert [_key(m) for m in from_jax.map_batch(reads)] == want
    assert torch.equal(load_fm_index(jax_cache, device="cpu").sa_sample, from_jax.index.sa_sample)

    other = genome[:2500] + genome[2501:] + b"A"  # same length, another genome
    with pytest.raises(ValueError, match="another genome"):
        SmemReadMapper(other, index_cache=port_cache, device="cpu")
    with pytest.raises(AssertionError):
        JaxSmemReadMapper(other, index_cache=port_cache)
    with pytest.raises(ValueError, match="symbols"):
        SmemReadMapper(genome[:4000], index_cache=jax_cache, device="cpu")


def test_to_cpu_and_empty_batch(genome, mappers):
    port, _ = mappers
    twin = port.to("cpu")
    reads, _ = _reads(genome, 13)
    assert [_key(m) for m in twin.map_batch(reads)] == [_key(m) for m in port.map_batch(reads)]
    assert twin.fmd.fm is twin.index
    assert port.map_batch([]) == []
    assert [_key(m) for m in port.map_batch([b""])] == [(-1, "+", 0, "")]
