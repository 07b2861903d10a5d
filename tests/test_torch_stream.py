"""The port's ``StreamingMapper`` (over a ``device="cpu"`` ``ReadMapper``)
against the JAX package's on ``tests/test_stream.py``'s fixture (a 4,000 bp
genome, 40 reads of 80 bp) plus reverse-complemented, mutated and random
reads: every shard, checkpoint and final TSV byte for byte the JAX
class's; a crash and its resume; an edited input restarting."""

import os

import numpy as np
import pytest

from rust_bio_tpu.pipelines import ReadMapper as JaxReadMapper
from rust_bio_tpu.pipelines.stream import StreamingMapper as JaxStreamingMapper
from rust_bio_tpu_torch.alphabets import dna
from rust_bio_tpu_torch.pipelines import ReadMapper, StreamingMapper


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(99)
    genome = rng.choice(list(b"ACGT"), size=4000).astype("uint8").tobytes()
    d = tmp_path_factory.mktemp("stream")
    fq = d / "reads.fq"
    starts = [int(s) for s in rng.integers(0, len(genome) - 80, size=40)]
    with open(fq, "w") as f:
        for k, s in enumerate(starts):
            seq = genome[s : s + 80].decode()
            f.write(f"@r{k}\n{seq}\n+\n{'I' * 80}\n")
    mixed = d / "mixed.fq"
    with open(mixed, "w") as f:
        for k, s in enumerate(rng.integers(0, len(genome) - 80, size=24)):
            r = bytearray(genome[s : s + 80])
            if k % 3 == 1:
                r[int(rng.integers(30, 50))] = ord("A") if r[40] != ord("A") else ord("C")
            read = dna.revcomp(bytes(r)) if k % 2 else bytes(r)
            if k % 8 == 7:
                read = rng.choice(list(b"ACGT"), size=80).astype("uint8").tobytes()
            f.write(f"@m{k} desc\n{read.decode()}\n+\n{'I' * 80}\n")
    port = ReadMapper(genome, seed_len=20, flank=8, device="cpu")
    jax_ = JaxReadMapper(genome, seed_len=20, flank=8)
    return port, jax_, str(fq), str(mixed), d, starts


def _run(cls, mapper, fq, out_dir, batch_size):
    """Run and finalize: (processed, stats without the clock's fields,
    {shard name: bytes} before finalize, checkpoint bytes, final bytes)."""
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "out.tsv")
    ck = os.path.join(out_dir, "ck.json")
    stats = []
    sm = cls(mapper, batch_size=batch_size, on_stats=stats.append)
    n = sm.run(fq, out, ck)
    shards = {p: open(os.path.join(out_dir, p), "rb").read() for p in sorted(os.listdir(out_dir)) if ".shard-" in p}
    ckb = open(ck, "rb").read()
    sm.finalize(out)
    assert not any(".shard-" in p for p in os.listdir(out_dir))
    stats = [{k: v for k, v in s.items() if k not in ("reads_per_s", "seconds")} for s in stats]
    return n, stats, shards, ckb, open(out, "rb").read()


@pytest.mark.parametrize("which,batch_size", [("fixture", 16), ("mixed", 7), ("mixed", 64)])
def test_stream_files_match_jax(setup, which, batch_size):
    port, jax_, fq, mixed, d, starts = setup
    path = fq if which == "fixture" else mixed
    tag = f"{which}-{batch_size}"
    got = _run(StreamingMapper, port, path, str(d / f"port-{tag}"), batch_size)
    want = _run(JaxStreamingMapper, jax_, path, str(d / f"jax-{tag}"), batch_size)
    assert got == want
    n_reads = 40 if which == "fixture" else 24
    assert got[0] == -(-n_reads // batch_size) and len(got[2]) == got[0]
    lines = got[4].decode().strip().split("\n")
    assert len(lines) == n_reads
    if which == "fixture":
        for k, (line, s) in enumerate(zip(lines, starts)):
            rid, pos, strand, score, cigar = line.split("\t")
            assert rid == f"r{k}" and int(pos) == s and cigar == "80="
    else:
        assert any("\t-\t" in line for line in lines) and any("\t-1\t" in line for line in lines)


def test_crash_resume_matches_jax(setup, tmp_path):
    """A mapper that raises on its second batch: shard 0 committed and
    untouched by the resume, no partial shard 1, the resume maps 2 batches,
    and the final file is the JAX class's uninterrupted one."""
    port, jax_, fq, mixed, d, starts = setup
    out = str(tmp_path / "out.tsv")
    ck = str(tmp_path / "ck.json")

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}
    real = port.map_batch

    def flaky(reads, ids=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise Boom()
        return real(reads, ids)

    port.map_batch = flaky
    sm = StreamingMapper(port, batch_size=16)
    try:
        with pytest.raises(Boom):
            sm.run(fq, out, ck)
    finally:
        port.map_batch = real
    shard0 = sm._shard_path(out, 0)
    assert os.path.exists(shard0) and not os.path.exists(sm._shard_path(out, 1))
    before = (open(shard0, "rb").read(), os.stat(shard0).st_mtime_ns)
    assert open(ck).read() == '{"fingerprint": "%s", "last_batch": 0}' % _fingerprint(fq)
    stats = []
    sm.on_stats = stats.append
    assert sm.run(fq, out, ck) == 2
    assert [s["batch"] for s in stats] == [1, 2]
    assert (open(shard0, "rb").read(), os.stat(shard0).st_mtime_ns) == before
    sm.finalize(out)
    want = _run(JaxStreamingMapper, jax_, fq, str(tmp_path / "jax"), 16)
    assert open(out, "rb").read() == want[4]


def _fingerprint(path):
    from rust_bio_tpu.pipelines.stream import _fingerprint as jax_fingerprint
    from rust_bio_tpu_torch.pipelines.stream import _fingerprint as port_fingerprint

    assert port_fingerprint(path) == jax_fingerprint(path)
    return port_fingerprint(path)


def test_input_change_restarts(setup, tmp_path):
    port, jax_, fq, mixed, d, starts = setup
    out = str(tmp_path / "out3.tsv")
    ck = str(tmp_path / "ck3.json")
    sm = StreamingMapper(port, batch_size=32)
    assert sm.run(fq, out, ck) == 2
    assert sm.run(fq, out, ck) == 0  # the same input resumes past its end
    # the same checkpoint against a different input must not skip anything
    fq2 = str(tmp_path / "other.fq")
    with open(fq2, "w") as f:
        f.write("@x\n" + "ACGT" * 20 + "\n+\n" + "I" * 80 + "\n")
    assert sm.run(fq2, out, ck) == 1
    assert open(ck).read() == '{"fingerprint": "%s", "last_batch": 0}' % _fingerprint(fq2)
