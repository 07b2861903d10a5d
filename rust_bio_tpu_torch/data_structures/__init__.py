"""Index structures (port of ``rust_bio_tpu.data_structures``): suffix
array, BWT, the device FM-index, the FMD index with its SMEM search, the
host FM/FMD oracles and index files."""
