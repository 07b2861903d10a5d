"""End-to-end pipelines built from the port's kernels (port of
``rust_bio_tpu.pipelines``: the FM-seeded ``ReadMapper``, the
SMEM-seeded ``SmemReadMapper`` and the checkpointed ``StreamingMapper``)."""

from rust_bio_tpu_torch.pipelines.read_mapper import MappedRead, ReadMapper, SmemReadMapper
from rust_bio_tpu_torch.pipelines.stream import StreamingMapper

__all__ = ["MappedRead", "ReadMapper", "SmemReadMapper", "StreamingMapper"]
