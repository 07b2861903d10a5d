"""The port stands alone: no file of ``rust_bio_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and the entry points
refuse to run without a card unless the caller asks for the CPU; each C
entry point the wrappers bind is the one its source defines."""

import ast
import re
from pathlib import Path

import pytest
import torch

from rust_bio_tpu_torch import native
from rust_bio_tpu_torch.alignment import sparse
from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, BatchBandedAligner, Scoring, banded, banded_device
from rust_bio_tpu_torch import scores
from rust_bio_tpu_torch.alphabets import dna, protein
from rust_bio_tpu_torch.carry import banded_inputs, fm_index_from_arrays, pairhmm_from_params
from rust_bio_tpu_torch.data_structures import bit_tree
from rust_bio_tpu_torch.data_structures import bwt, fmd_device, fmindex, serialize
from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
from rust_bio_tpu_torch.ops import fmd as fmd_ops
from rust_bio_tpu_torch.ops import hmm as hmm_ops
from rust_bio_tpu_torch.ops import pairhmm as pairhmm_ops
from rust_bio_tpu_torch import io as port_io
from rust_bio_tpu_torch.io import batch as io_batch
from rust_bio_tpu_torch.pipelines import ReadMapper, SmemReadMapper, StreamingMapper, stream
from rust_bio_tpu_torch.stats import hmm, pairhmm, probs
from rust_bio_tpu_torch.stats.hmm.device import BatchDiscreteHMM, BatchGaussianHMM
from rust_bio_tpu_torch.stats.hmm import device as hmm_device
from rust_bio_tpu_torch.stats.pairhmm import (
    BatchHomopolyPairHMM,
    BatchPairHMM,
    BatchPairHMMExact,
    BatchPairHMMLinear,
    device as pairhmm_device,
    exact as pairhmm_exact,
    homopoly_device,
    homopolypairhmm,
)
from rust_bio_tpu_torch.utils import fastexp

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "rust_bio_tpu")


def _port_files():
    return sorted((ROOT / "rust_bio_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_port_has_its_files():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names
    assert "rust_bio_tpu_torch/carry.py" in names
    assert "rust_bio_tpu_torch/scores/__init__.py" in names
    # the port loads its own copy of the substitution matrices
    assert Path(scores.__file__).parent == ROOT / "rust_bio_tpu_torch" / "scores"
    assert (ROOT / "rust_bio_tpu_torch" / "scores" / "matrices.npz").is_file()
    assert scores.blosum62(ord("W"), ord("W")) == 11 and protein.alphabet().is_word(b"MKV")
    # the banded aligner's own copies: sparse chaining, the Fenwick tree,
    # the band and host oracle, the host C++ band builder
    for mod, rel in (
        (sparse, "alignment/sparse.py"), (bit_tree, "data_structures/bit_tree.py"),
        (banded, "alignment/pairwise/banded.py"), (banded_device, "alignment/pairwise/banded_device.py"),
        (native, "native.py"),
        # the PairHMM family's: fastexp, LogProb, the host oracles, the
        # batched forwards and their kernels' wrappers
        (fastexp, "utils/fastexp.py"), (probs, "stats/probs/__init__.py"),
        (pairhmm, "stats/pairhmm/__init__.py"), (homopolypairhmm, "stats/pairhmm/homopolypairhmm.py"),
        (pairhmm_device, "stats/pairhmm/device.py"), (pairhmm_exact, "stats/pairhmm/exact.py"),
        (homopoly_device, "stats/pairhmm/homopoly_device.py"), (pairhmm_ops, "ops/pairhmm.py"),
        # the FMD index and SMEM seeding: the host oracle and its Occ, the
        # index files, the batched search and K-SMEM's wrapper
        (fmindex, "data_structures/fmindex.py"), (bwt, "data_structures/bwt.py"),
        (serialize, "data_structures/serialize.py"), (fmd_device, "data_structures/fmd_device.py"),
        (fmd_ops, "ops/fmd.py"),
        # the io readers and writers, the checkpointed stream, the HMM's host
        # oracle, batched classes and kernels' wrappers
        (port_io, "io/__init__.py"), (io_batch, "io/batch.py"), (port_io.fasta, "io/fasta.py"),
        (port_io.fastq, "io/fastq.py"), (port_io.fastx, "io/fastx.py"), (port_io.bed, "io/bed.py"),
        (port_io.bedpe, "io/bedpe.py"), (port_io.gff, "io/gff.py"), (port_io.newick, "io/newick.py"),
        (stream, "pipelines/stream.py"), (hmm, "stats/hmm/__init__.py"), (hmm_device, "stats/hmm/device.py"),
        (hmm_ops, "ops/hmm.py"),
    ):
        assert Path(mod.__file__) == ROOT / "rust_bio_tpu_torch" / rel
    assert native.SOURCE == ROOT / "rust_bio_tpu_torch" / "csrc" / "band_build.cpp" and native.SOURCE.is_file()
    csrc = ROOT / "rust_bio_tpu_torch" / "ops" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "walk_sweep.cu", "fm_search.cu", "rle_merge.cu", "fmd_smem.cu",
        "sw_warp.cu", "sw_global_rows.cu", "walk_global_seg.cu", "walk_steps.cu",
        "sw_columns.cu", "sw_banded.cu", "pairhmm_scaled.cu", "pairhmm_log.cu", "pairhmm_exact.cu",
        "pairhmm_homopoly.cu", "hmm.cu",
    }
    assert StreamingMapper.__module__ == "rust_bio_tpu_torch.pipelines.stream"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = Scoring.from_scores(-5, -1, 2, -2)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchAligner(sc)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFMIndex(b"AC$GT", dna.n_alphabet())
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFMIndex.from_text(b"ACGT$")
    with pytest.raises(RuntimeError, match="CUDA"):
        fm_index_from_arrays({}, {"n": 1, "s": 1, "sentinel": 36, "symbols": []})
    with pytest.raises(RuntimeError, match="CUDA"):
        ReadMapper(b"ACGTACGTTGCA")
    with pytest.raises(RuntimeError, match="CUDA"):
        SmemReadMapper(b"ACGTACGTTGCA")
    with pytest.raises(RuntimeError, match="CUDA"):
        serialize.load_fm_index("no-such-file.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchBandedAligner(sc, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        banded_inputs([[0]], [[1]], range(8))
    gaps = (-12.8, -12.2, float("-inf"), float("-inf"))
    hops = (-9.2, -9.2, -0.7, -0.7)
    for make in (
        lambda **kw: BatchPairHMM(*gaps, **kw), lambda **kw: BatchPairHMMLinear(*gaps, **kw),
        lambda **kw: BatchPairHMMExact(*gaps, **kw), lambda **kw: BatchHomopolyPairHMM(*gaps, *hops, **kw),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        pairhmm_from_params("BatchPairHMM", BatchPairHMM(*gaps, device="cpu").g)
    A = [[-0.1, -2.3], [-2.3, -0.1]]
    for make in (
        lambda **kw: BatchDiscreteHMM(A, [[-0.7, -0.7], [-0.1, -2.3]], [-0.7, -0.7], **kw),
        lambda **kw: BatchGaussianHMM(A, [(0.0, 1.0), (1.0, 0.5)], [-0.7, -0.7], **kw),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu").device.type == "cpu"
    assert BatchBandedAligner(sc, 8, 8, device="cpu").device.type == "cpu"
    assert BatchAligner(sc, device="cpu").device.type == "cpu"


def _kernels():
    from rust_bio_tpu_torch.ops import _build, fm, sw, walk

    return [k for m in (sw, walk, pairhmm_ops, fm, fmd_ops, hmm_ops) for k in vars(m).values() if isinstance(k, _build.CudaKernel)]


@pytest.mark.parametrize("kernel", _kernels(), ids=lambda k: k.symbol)
def test_kernel_entry_points_match_their_sources(kernel):
    """Each C entry point a wrapper binds is defined in the one source it
    names, and in no other, with the wrapper's arguments in order (a
    pointer for ``void*``, ``long long`` for ``long long``, else ``int``)
    and the stream last: K7's ``sw_scan_local`` in ``sw_warp.cu`` only."""
    import ctypes

    from rust_bio_tpu_torch.ops import _build

    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        m = re.search(r"^int %s\(([^)]*)\)" % kernel.symbol, path.read_text(), re.M)
        if m:
            found[path.stem] = [" ".join(p.split()) for p in m.group(1).split(",")]
    assert list(found) == [kernel.source]
    params = found[kernel.source]
    kinds = [_build.PTR if "void*" in p else ctypes.c_longlong if p.startswith("long long") else _build.INT for p in params]
    assert kinds == kernel.argtypes + [_build.PTR] and params[-1].endswith("stream")
