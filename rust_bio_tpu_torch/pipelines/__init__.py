"""End-to-end pipelines built from the port's kernels (port of
``rust_bio_tpu.pipelines``: the FM-seeded ``ReadMapper`` and the
SMEM-seeded ``SmemReadMapper``)."""

from rust_bio_tpu_torch.pipelines.read_mapper import MappedRead, ReadMapper, SmemReadMapper

__all__ = ["MappedRead", "ReadMapper", "SmemReadMapper"]
