"""PyTorch + CUDA port of ``rust_bio_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package reimplements its main
path with hand-written CUDA kernels (``ops/csrc/*.cu``, built with nvcc for
``sm_90a`` at first use and bound with ``ctypes``):

- ``BatchAligner.global_``, ``.semiglobal``, ``.local``, ``.custom`` and
  ``.scores(...)`` in those four modes, and the packed results
  (``PackedSemiglobal``), under ``MatchParams`` scoring or a substitution
  matrix (BLOSUM/PAM from :mod:`rust_bio_tpu_torch.scores`, a (256, 256)
  table or a callable) (:mod:`rust_bio_tpu_torch.alignment.pairwise`);
- ``DeviceFMIndex`` construction, backward search and locate
  (:mod:`rust_bio_tpu_torch.data_structures.fm_device`), and loading of
  index files written by the JAX package (:mod:`rust_bio_tpu_torch.carry`);
- the FM-seeded read mapper ``ReadMapper`` and the SMEM-seeded
  ``SmemReadMapper`` (:mod:`rust_bio_tpu_torch.pipelines`) over
  ``DeviceFMDIndex``'s batched SMEM search, kernel K-SMEM
  (:mod:`rust_bio_tpu_torch.data_structures.fmd_device`), and index files
  in the JAX package's format both ways
  (:mod:`rust_bio_tpu_torch.data_structures.serialize`);
- the banded aligner ``BatchBandedAligner`` (k-mer bands through long
  targets; its band builder is host C++, ``csrc/band_build.cpp``, built
  with the host compiler at first use by :mod:`rust_bio_tpu_torch.native`);
- the PairHMM family ``BatchPairHMMLinear``, ``BatchPairHMM``,
  ``BatchPairHMMExact`` and ``BatchHomopolyPairHMM`` with their host
  oracles (:mod:`rust_bio_tpu_torch.stats.pairhmm`).

Entry points take ``device=None``, which means the CUDA device; without one
they raise ``RuntimeError``. Pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels (what the CPU tests do).
"""

from rust_bio_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
