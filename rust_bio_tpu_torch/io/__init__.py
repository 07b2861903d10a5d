"""I/O layer: FASTA/FASTQ/FASTX, BED/BEDPE, GFF/GTF, Newick.

Reference parity: src/io/. Host-side parsing (buffered / mmap), with
``batch`` providing the padded/bucketed batching of records into arrays
ready for the card — the layer the reference does not have. The port's own
copy of ``rust_bio_tpu.io``: host code, the same records and bytes.
"""

from rust_bio_tpu_torch.io import bed, bedpe, fasta, fastq, fastx, gff, newick  # noqa: F401
