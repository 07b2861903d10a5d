"""The port's readers and writers (``rust_bio_tpu_torch.io``) against the
JAX package's on the same inputs: every case runs once on each package and
the records (as plain fields), the written bytes and the batches must be
equal. The cases are those of ``tests/test_io.py`` plus FASTQ files on
disk, a wrapped FASTA writer and ``pad_batch``."""

import dataclasses
import enum
import io

import numpy as np
import pytest

import rust_bio_tpu.io as jax_io
import rust_bio_tpu.io.batch  # noqa: F401  (not imported by the package)
import rust_bio_tpu_torch.io as port_io
import rust_bio_tpu_torch.io.batch  # noqa: F401

FASTA_TEXT = b""">id desc
ACCGTAGGCTGA
CCGTAGGCTGAA
CGTAGGCTGAAA
GTAGGCTGAAAA
CCCC
>id2
ATTGTTGTTTTA
ATTGTTGTTTTA
ATTGTTGTTTTA
GGGG
"""

FASTQ_TEXT = b"""@id desc
ACCGTAGGCTGA
+
IIIIIIIIIIII
@id2
ATTGTTGTTTTA
+
IIIIIIIIIIII
"""

BED_TEXT = "1\t5\t5000\tname1\tup\n2\t3\t5005\tname2\tup\n"
BEDPE_TEXT = "1\t5\t5000\t2\t10\t5010\tname1\t5\t+\t-\n"
GFF_TEXT = "P0A7B8\tUniProtKB\tInitiator methionine\t1\t1\t.\t.\t.\tNote=Removed,Obsolete;ID=test\n"
GTF_TEXT = '1\thavana\tgene\t11869\t14409\t.\t+\t.\tgene_id "ENSG0000"; gene_name "DDX11L1";\n'


def plain(x):
    """A structure of builtins, equal across the two packages' classes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, plain(x.value))
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if type(x).__module__.startswith("rust_bio_tpu"):  # a plain class of either package (gff.Phase)
        return (type(x).__name__, plain(vars(x)))
    return x


def fasta_reader(m, tmp):
    recs = list(m.fasta.Reader(io.BytesIO(FASTA_TEXT)).records())
    assert recs[0].seq == b"ACCGTAGGCTGACCGTAGGCTGAACGTAGGCTGAAAGTAGGCTGAAAACCCC" and recs[1].desc is None
    return recs, [r.check() for r in recs], [r.is_empty() for r in recs]


def fasta_record_check(m, tmp):
    return [m.fasta.Record(id=i, seq=s).check() for i, s in (("", b"ACGT"), ("x", b"AC GT"), ("x", b"AC-GT.*"))]


def fasta_writer(m, tmp):
    outs = []
    for width in (12, 5, None):
        out = io.BytesIO()
        w = m.fasta.Writer(out, line_width=width)
        for r in m.fasta.Reader(io.BytesIO(FASTA_TEXT)).records():
            w.write_record(r)
        w.write("x", "with desc", "acgtn")
        w.flush()
        outs.append(out.getvalue())
    return outs, list(m.fasta.Reader(io.BytesIO(outs[1])).records())


def fasta_indexed_reader(m, tmp):
    p = tmp / "test.fa"
    p.write_bytes(FASTA_TEXT)
    idx = m.fasta.Index.build(p)
    r = m.fasta.IndexedReader(open(p, "rb"), idx)
    got = [[(s.name, s.len) for s in idx.sequences()]]
    for call, args in (("fetch", ("id", 12, 26)), ("fetch_all", ("id2",)), ("fetch_by_rid", (0, 0, 4)), ("fetch_all_by_rid", (1,))):
        getattr(r, call)(*args)
        got.append(r.read())
    r.fetch("id", 3, 9)
    got.append(list(r.read_iter()))
    fai = tmp / "test.fa.fai"
    idx.write(fai)
    got.append(fai.read_bytes())
    got.append([(s.name, s.len) for s in m.fasta.Index.new(open(fai, "rb")).sequences()])
    got.append(m.fasta.IndexedReader.from_file(p).index.sequences()[1].len)
    assert got[1] == b"CCGTAGGCTGAACG" and got[3] == b"ACCG"
    return got, m.fasta.read_all(p)


def fastq_reader(m, tmp):
    recs = list(m.fastq.Reader(io.BytesIO(FASTQ_TEXT)).records())
    bad = m.fastq.Record(id="x", seq=b"ACGT", qual=b"III")
    assert recs[0].qual == b"IIIIIIIIIIII" and bad.check() is not None
    return recs, [r.check() for r in recs], bad.check()


def fastq_writer_and_file(m, tmp):
    out = io.BytesIO()
    w = m.fastq.Writer(out)
    for r in m.fastq.Reader(io.BytesIO(FASTQ_TEXT)).records():
        w.write_record(r)
    w.write("r3", None, "ACGTN", "!!II#")
    w.flush()
    p = tmp / "reads.fq"
    p.write_bytes(out.getvalue())
    return out.getvalue(), m.fastq.read_all(p), list(m.fastq.Reader.from_file(p).records())


def fastx_autodetect(m, tmp):
    kinds = [m.fastx.get_kind(FASTA_TEXT), m.fastx.get_kind(FASTQ_TEXT)]
    q = list(m.fastx.EitherRecords(io.BytesIO(FASTQ_TEXT)))
    a = list(m.fastx.EitherRecords(io.BytesIO(FASTA_TEXT)))
    p = tmp / "x.fq"
    p.write_bytes(FASTQ_TEXT)
    kinds.append(m.fastx.get_kind_file(p))
    fields = [(r.kind, r.id, r.desc, r.seq, r.qual, r.check()) for r in q + a]
    conv = [q[0].to_fasta(), a[0].to_fastq(), a[1].to_fastq(ord("#"))]
    assert a[0].to_fastq().qual == b"I" * len(a[0].seq)
    return kinds, fields, conv, [r.id for r in m.fastx.EitherRecords.from_file(p)]


def bed_roundtrip(m, tmp):
    recs = list(m.bed.Reader(io.StringIO(BED_TEXT)).records())
    out = io.StringIO()
    w = m.bed.Writer(out)
    for r in recs:
        w.write(r)
    r = recs[0]
    r.set_strand("-")
    r.set_name("renamed")
    assert out.getvalue() == BED_TEXT
    return recs, [(x.name(), x.score(), x.strand()) for x in recs], out.getvalue(), r.to_line()


def bedpe_roundtrip(m, tmp):
    r = list(m.bedpe.Reader(io.StringIO(BEDPE_TEXT)).records())[0]
    out = io.StringIO()
    m.bedpe.Writer(out).write(r)
    assert out.getvalue() == BEDPE_TEXT
    r.push_aux("extra")
    return r, (r.name(), r.score(), r.strand1(), r.strand2(), r.aux_get(0)), out.getvalue(), r.to_line()


def gff3_roundtrip(m, tmp):
    r = list(m.gff.Reader(io.StringIO(GFF_TEXT), m.gff.GffType.GFF3).records())[0]
    out = io.StringIO()
    m.gff.Writer(out, m.gff.GffType.GFF3).write(r)
    back = list(m.gff.Reader(io.StringIO(out.getvalue()), m.gff.GffType.GFF3).records())
    assert r.attributes["Note"] == ["Removed", "Obsolete"] and back[0].attributes == r.attributes
    return r, r.attribute("ID"), out.getvalue(), back


def gff3_percent_encoding(m, tmp):
    r = m.gff.Record(
        seqname="c1", source="s", feature_type="gene", start=1, end=10,
        attributes={"Note": ["a;b=c"], "X": ["1", "2"], "Y": ["p,q"]},
    )
    out = io.StringIO()
    m.gff.Writer(out, m.gff.GffType.GFF3).write(r)
    back = list(m.gff.Reader(io.StringIO(out.getvalue()), m.gff.GffType.GFF3).records())
    assert back[0].attributes["Y"] == ["p,q"]
    return out.getvalue(), back, m.gff.gff3_encode("a;b=c,d%"), m.gff.gff3_decode("a%3Bb%3Dc%2Cd%25")


def gtf2_attributes(m, tmp):
    r = list(m.gff.Reader(io.StringIO(GTF_TEXT), m.gff.GffType.GTF2).records())[0]
    out = io.StringIO()
    m.gff.Writer(out, m.gff.GffType.GTF2).write(r)
    assert r.attribute("gene_name") == "DDX11L1" and "%" not in out.getvalue()
    return r, out.getvalue()


def newick_roundtrip(m, tmp):
    t = m.newick.from_string("(A:0.1,B:0.2,(C:0.3,D:0.4)E:0.5)F;")
    s = m.newick.to_string(t)
    p = tmp / "t.nwk"
    m.newick.write(p, t)
    assert t.leaf_names() == ["A", "B", "C", "D"] and t.node_count() == 6
    return t, s, m.newick.read(p), m.newick.from_string(s).leaf_names()


def batching(m, tmp):
    rng = np.random.default_rng(0)
    records = []
    for i in range(300):
        n = int(rng.integers(30, 200))
        records.append(m.fastq.Record(id=f"r{i}", seq=rng.choice(list(b"ACGT"), size=n).astype("uint8").tobytes(), qual=b"I" * n))
    batches = list(m.batch.bucketed_batches(records, batch_size=64))
    assert sum(len(b) for b in batches) == 300
    raw = list(m.batch.bucketed_batches([b"ACGT", b"A" * 70, b""], batch_size=2, pad_to_multiple=4))
    return batches, raw, m.batch.pad_batch(["AC", b"GGT", np.frombuffer(b"T", np.uint8)], quals=[b"II", b"#!!", b"I"])


CASES = [
    fasta_reader, fasta_record_check, fasta_writer, fasta_indexed_reader, fastq_reader, fastq_writer_and_file,
    fastx_autodetect, bed_roundtrip, bedpe_roundtrip, gff3_roundtrip, gff3_percent_encoding, gtf2_attributes,
    newick_roundtrip, batching,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_port_io_matches_jax_io(case, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = plain(case(port_io, tmp_path / "port"))
    want = plain(case(jax_io, tmp_path / "jax"))
    assert got == want


def test_io_package_is_the_ports():
    assert set(port_io.__dict__) >= {"bed", "bedpe", "fasta", "fastq", "fastx", "gff", "newick"}
    for name in ("bed", "bedpe", "fasta", "fastq", "fastx", "gff", "newick", "batch"):
        assert getattr(port_io, name).__name__ == f"rust_bio_tpu_torch.io.{name}"
