"""End-to-end pipelines built from the port's kernels (port of
``rust_bio_tpu.pipelines``: the FM-seeded ``ReadMapper``)."""

from rust_bio_tpu_torch.pipelines.read_mapper import MappedRead, ReadMapper

__all__ = ["MappedRead", "ReadMapper"]
