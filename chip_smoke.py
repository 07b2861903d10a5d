#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``rust_bio_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

1. Builds the CUDA kernels from ``rust_bio_tpu_torch/ops/csrc`` with nvcc
   (``sm_90a``) and, beside them, the host library (the band builder, the
   SA-IS and the CIGAR emitter, ``rust_bio_tpu_torch/csrc/``) with the host
   compiler, and prints the card's name and power limit.
2. Drives the global path through its entry points with every launch
   counter at 0: ``BatchAligner.global_`` and ``.scores(..., "global")``
   on 8192 random 150 bp pairs and on 8192 pairs at 2% divergence, then a
   ``DeviceFMIndex`` built on the card from a random 4,641,652 bp DNA text
   (the length of E. coli K-12 MG1655, GenBank U00096.3) searched with
   65,536 20-mers (half sampled from the text, half mutated) and located
   (K4, K4-locate); the 2%-divergence pairs also through the compact path
   (``global_packed_compact_async_arrays``: K1, K2, K-merge), finished
   alone and as 8 handles with one pull (``packed_compact_finish_many``).
   Every alignment must re-score to its score and consume both sequences,
   agree with ``scores`` and, on a subset, with the plain PyTorch path on
   the CPU; every compact CIGAR must equal ``global_packed(...).cigars()``
   with no lane past R runs; every sampled query must be COMPLETE and
   locate to its start, and a subset of interval sizes must equal a
   brute-force count.
3. Drives the read mapper with the counters at 0 again: a ``ReadMapper``
   built on the card over that text as genome maps 8192 150 bp reads (half
   reverse-complemented, 1% substitutions) plus 256 random reads. Every
   mapped read's CIGAR must re-score to its score against the genome and
   consume the read; every read with an error-free seed window on its
   strand must map to its origin, or else (an end substitution can make an
   indel alignment score more; the count is printed) to what the port's CPU
   path maps it to, position, score and CIGAR; the random reads must stay
   unmapped; on 64 reads the card must equal the port's CPU path. The
   mapper's 8192 extension pairs (the reads in their 166 bp windows) go,
   with the counters at 0 once more, through
   ``semiglobal_packed_compact_async_arrays`` (K5, K6, K-merge):
   their CIGARs must equal the dense path's, which come from the native
   emitter and must equal the numpy merge.
3b. Drives local and custom alignment with the counters at 0 again:
   ``BatchAligner.local`` and ``.scores(..., "local")`` on both pair corpora
   of step 2, and ``BatchAligner.custom`` and ``.scores(..., "custom")``
   with BWA-MEM's soft-clip scoring on the mapper's 8192 oriented reads,
   their first and last 0-30 bases replaced by random bases, against their
   166 bp origin windows. Every alignment must re-score to its score (clip
   ops at their penalties), agree with ``scores`` and, on 64 pairs, with
   the CPU path; every custom alignment must consume both sequences.
3c. Drives protein alignment under BLOSUM62 with the counters at 0 again
   (``Scoring.new(-11, -1, blosum62)``, rust-bio's doctest scoring: BLASTP's
   default gap costs, existence 11 and extension 1, in rust-bio's affine
   form): 8192 homolog pairs (x of 250-450 residues, y = x at 30%
   substitutions and 3% single-residue indels) through ``global_``,
   ``local``, ``global_packed(...).cigars()`` and ``scores`` in global and
   local mode; 8192 domain pairs (y a protein of 250-450 residues, x an
   80-200 residue segment of it at 20% substitutions) through
   ``semiglobal``, ``semiglobal_packed(...).cigars()``, ``scores(...,
   "semiglobal")`` and ``custom`` with x soft-clipped at -10 per end and y's
   ends free. Every alignment must re-score to its score under the LUT,
   every global alignment consume both sequences, ``scores`` agree with the
   alignments; 64 pairs of each mode, 256 pairs under PAM250 and 256
   random-byte pairs must equal the CPU path.
3d. Drives long-sequence global alignment (the block-row engine, the wide
   pack) with the counters at 0 again: 128 STR-bearing DNA pairs in the
   geometry of rust-bio's pairwise bench (benches/pairwise.rs:140-158,
   built as bench.py:601-614: a 4,600-5,600 bp backbone with six 200 bp
   tracts of a 4 bp motif, y = x at 5% substitutions and 0.5% indels of
   1-3 bp), 8 pairs whose x carries a 4,200-4,800 bp insertion into a
   600-800 bp y (a structural-variant insertion), and 64 protein pairs of
   4,200-5,000 residues (titin fragments, mucins) at 30% substitutions and
   3% indels under BLOSUM62, through ``global_``,
   ``global_packed(...).cigars()`` and ``scores(..., "global")``. Every
   alignment must re-score to its score over both sequences, agree with
   ``scores`` and its CIGAR; 4 pairs of each corpus must equal the CPU
   path; every insertion pair must hold an Ins run of 4,096 or more.
3e. Drives the clip modes at long x (K15, K15-LUT and K15-walk) with the
   counters at 0 again, on phase 3d's STR backbones and long proteins:
   ``semiglobal`` on 128 pairs (x the backbone, y the mutated backbone with
   200-400 random bp on each side: a long read in its reference window),
   ``local`` on 128 pairs (x the backbone with 200-400 bp random flanks, y
   the mutated backbone), ``custom`` on those pairs under phase 3b's
   BWA-MEM clips, and ``local`` under BLOSUM62 on 64 long proteins with
   100-200 random residues on each side of x; each with ``scores``. Every
   alignment must re-score to its score (clip ops at their penalties) and
   agree with ``scores``; every semiglobal alignment consume all of x; the
   local and custom alignments cover 90% of the core; 4 pairs of each
   corpus equal the CPU path.
3f. Drives the banded aligner (``BatchBandedAligner``, k = w = 8: the
   host band build, K16 and K16-walk) with the counters at 0 again, in the
   JAX package's bench geometries (bench.py:1138-1238): three batches of
   2048 150 bp reads, each cut from its own random 20 kb target with 4
   random substitutions, through ``semiglobal_async`` / ``semiglobal_finish``
   on a one-thread executor and once through ``semiglobal``; 256 1 kb reads
   at 20 substitutions in 20 kb targets through ``semiglobal``; phase 3d's
   128 STR pairs through ``global_`` (a dense tb of about 8 GB); ``local``
   on the first 512 reads; ``custom`` on phase 3b's 8192 clipped reads
   under its BWA-MEM clips. Every alignment must re-score to its score (clip
   ops at their penalties), every semiglobal and global one consume all of
   x, every global one all of y; on 16 pairs of each corpus (8 of the 1 kb
   and the STR corpora) the card must equal the port's host oracle
   ``banded.Aligner`` and ``BatchBandedAligner(device="cpu")``; the
   pipelined batches must equal the synchronous call (each run after an
   untimed warm-up call, as ``bench.py:1169`` warms its aligner).
3g. Drives the PairHMM family with the counters at 0 again: 4096 pairs in
   the reference bench's geometry (benches/pairhmm.rs:9-19, built as
   bench.py:225-248: x a 207 bp haplotype, y a 54 bp substring with 2
   random bases written, gap probabilities 2.8e-6 and 5.1e-6 without
   extension) through ``BatchPairHMMLinear`` (K17) semiglobal, 256 of them
   global; 8192 GATK-like pairs (HaplotypeCaller's PairHMM on 2x150 bp
   Illumina data: 150 bp reads at 1% substitutions in 300-500 bp haplotypes,
   gap open phred 45, continuation phred 10) with shared Q30 emissions and
   with per-lane ones from a per-read mean quality, and 64 of them with
   the read as x, which underflow K17 and re-run on K17-log; 1024 bench
   pairs through ``BatchPairHMMExact`` (K17-exact) unbanded and at
   ``max_edit_dist`` 4; 2048 bench haplotypes with their error-free reads
   through ``BatchHomopolyPairHMM`` (K17-homopoly, bench.py:423-460's hop
   parameters). No bench lane may fall back, every read-as-x lane must,
   every result must be finite; 16 pairs a corpus (4 homopoly) must agree
   with the host oracles (run in worker processes beside the card; the
   exact path within 1e-12 relative, the f32 classes within the JAX
   suites' rel 2e-3, abs 2e-3) and 64 with the CPU path.
3h. Drives the FM index at genome scale with the counters at 0 again, in
   the JAX bench's fm_large geometry (bench.py:792-868, :1640): a random
   50,000,000 bp text and its sentinel, the suffix array by the native
   SA-IS on the host (timed), the index and its q = 12 table built on the
   card, 65,536 20-mers sampled from the text through ``search_batch_lut``
   (K4-LUT) and K4, located (K4-locate); the same index with ``force_u32``
   (the uint32 K4-LUT, K4 and K4-locate). Every query must be COMPLETE at
   mlen 20 and locate to its start; both modes must agree. Then a random
   2,200,000,001-byte ACGT array with one sentinel, made on the card and
   taken as a BWT (no suffix array), indexed with its table: the uint32
   K4 and K4-LUT on 65,536 random 20-mers must equal their plain versions
   on the card, with intervals past 2^31 and word indices past 2^26.
3i. Drives the SMEM read mapper (``SmemReadMapper``: K-SMEM with the seed
   pick in its epilog, K4-locate, then K5 and K6) with the counters at 0
   again, after phase 4 has freed 3h's 2.2 G index: the FMD index of phase
   2's genome (the text ``T$revcomp(T)$``, 9,283,306 symbols, the native
   SA-IS, timed with its tables), 8192 100 bp reads with two mixed errors
   each (bench.py:678-696; 70% substitutions, 15% 1-2 bp insertions, 15%
   deletions), every second one reverse-complemented, through
   ``map_batch``, then 3 x 8192 through ``map_stream``; at least 90% must
   map at their origin on their strand (bench.py:716-717), every CIGAR
   re-score to its score, 64 reads equal the CPU path. K-SMEM's launches
   must equal the seed paths' (main, quarter and wide retries; the lanes of
   each and of the host oracle printed). K-SMEM is held against its plain
   version on the 8192 read middles in both modes at E = 16 and 32 (all
   seven outputs) and with its pick, its mapper-mode SMEMs on 256 lanes
   against the host oracle. Then a random 50,000,000 bp genome (FMD text
   100,000,002 symbols): built once into an index cache in a temporary
   directory, loaded back by a second mapper with the genome check, a
   cache of another genome refused; 6 x 1024 reads with 2 substitutions
   streamed, 90% at their origin. Then the 1 Mbp repeat genome
   (bench.py:755) with 8192 reads: 90% of the uniquely originating reads at
   their origin, the seed paths' lanes printed (and whether any reached
   the host oracle).
3j. Drives the checkpointed stream (``StreamingMapper`` over phase 3's
   ``ReadMapper``: K4, K4-locate, K5, K6) with the counters at 0 again: a
   FASTQ of 32,768 150 bp reads cut from phase 2's genome (1%
   substitutions, every second one reverse-complemented, Q40 strings) in a
   temporary directory, mapped in the class's default 4096-read batches (8
   shards). ``run`` then ``finalize`` must give, line for line, the TSV of
   ``map_batch`` on the same batches, ``on_stats`` fire once a batch; a
   mapper that raises on the sixth batch leaves exactly the five earlier
   shards, the rerun maps 3 batches, leaves those shards' bytes and
   ``mtime_ns`` alone and finalizes to the same file; an edited input
   restarts and maps all 8 batches.
3k. Drives the HMM (``BatchDiscreteHMM``, ``BatchGaussianHMM``,
   ``baum_welch_batch``: K-HMM-vit, K-HMM-fwd, K-HMM-bwd) with the counters
   at 0 again: the JAX bench's dishonest casino (bench.py:1241-1266; 2
   states, 6 symbols) on 8192 x 1000 observations and on 8192 ragged
   sequences of 1-1000; a 5-state copy-number Gaussian HMM (means 0.05-2.0,
   sd 0.10-0.30, stay 0.999) on 4096 x 1000 depths sampled from its chain;
   a 128-state model over 20 symbols, with an end vector, on 1024 x 500
   (one block a sequence);
   each through ``viterbi_batch``, ``forward_batch`` and
   ``backward_batch``; Baum-Welch on 1024 casino sequences, 3 iterations
   (the log-likelihoods must not fall; the emission rows log-sum to 0
   within 1e-6, the transition rows within 5e-5). Forward and backward
   totals must agree; 16 casino and Gaussian sequences agree with the host
   oracle (totals within 2e-4 relative, each path's float64 score within
   1e-3 of the oracle's best); 64 a corpus and Baum-Welch on 64 agree with
   the port's CPU path. Each kernel is held against its plain version on
   every corpus (Viterbi paths equal and the discrete probabilities bit for
   bit, the Gaussian within 1e-6; forward and backward within 1e-4 of
   max(1, |x|)) and timed there.
4. Holds each kernel against its plain PyTorch version on the card at the
   main-path shapes (bit for bit: integer outputs, tolerance 0; the PairHMM
   kernels within their stated tolerances) and times both with CUDA
   events (K5, K7, K9, K11, K7-LUT, K12, K13, K13-LUT, K15 and K15-LUT also
   without traceback; K16 also without its tb's zero-fill; K18 also on
   phase 3d's long proteins, K3 also on its STR pairs, K3's block launch;
   K14 with its tile geometry and path steps; K2, K6, K8 and K10 with
   their warp geometry and registers, K6, K8 and K10 as the one launch
   that holds the prolog each folds in; K5, K7, K17 and K17-exact
   with their lane geometry, K17 also on the GATK-like pairs, with the
   count of lanes bit-identical to its plain version); holds K6 on K5's
   pair-major view and K8 on K7's, K2, K8 and K10 on
   K11's and K7-LUT's pair-major views of the homolog corpus, K6 on K12's of
   the domain corpus and K16-walk on K16's of the 1 kb reads and the STR
   pairs; K4 with its geometry and registers, K4-locate on phase 2's rows
   and on 8192 random rows (the mapper's batch); K-merge on phase 2's
   and the mapper's walk streams; K4-LUT and the uint32 K4, K4-LUT and
   K4-locate on phase 3h's indexes; K-SMEM (in phase 3i); the HMM kernels
   (in phase 3k); times K13-LUT on the
   homolog corpus beside K11, and K1 against K13 and K9 against K15 on 600
   bp, 1 kb and 2 kb batches.
5. Prints alignments/s, queries/s, located rows/s and mapped reads/s, device-only and
   delivered, for DNA and for protein, short and long; the banded
   aligner's reads/s (pipelined and synchronous) and pairs/s, with the host
   band build's seconds a batch and a cProfile of one batch of reads; the
   PairHMM pairs/s of each 3g corpus; the compact path's delivered pairs/s
   (8 handles, one pull), the 50 Mbp index's queries/s through K4-LUT and
   K4, and the host SA-IS seconds; the SMEM mapper's reads/s (the seed
   chain device-only, ``map_batch`` and ``map_stream`` delivered) at 4.6
   and 50 Mbp and on the repeat genome, and its FMD builds' seconds; the
   stream's reads/s delivered beside ``map_batch``'s; the HMM's Viterbi,
   forward and backward sequences/s, device-only and delivered, and the
   Baum-Welch seconds.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``. Exits non-zero, with no result
line, without a CUDA device, outside a checkout of the repository, or on
any failed check.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks: HBM rate, and the
# CUDA-core rate for 32-bit integer work: 67 TFLOP/s of float32 counts an
# FMA as two operations, i.e. one 32-bit instruction per core per clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2

# 32-bit operations per DP cell in the inner loops of csrc/sw_warp.cu's K1,
# K7, K9 and K5 (compares, selects, adds, max,
# the run counter, the cell packing and, in K5, K7 and K9, the clip
# candidates and the Sn/Ly update; K7 and K9 add the running x-suffix
# maximum; loads, stores and address arithmetic not counted), the
# insertion chain as the prefix maximum: i * ge, T - i * ge, the maximum,
# P + i * ge and I[i-1] + ge (K3: the first four). K7 computes K9's cell
K1_OPS_PER_CELL = 34
K3_OPS_PER_CELL = 14
K5_OPS_PER_CELL = 42
K9_OPS_PER_CELL = 52
K7_OPS_PER_CELL = K9_OPS_PER_CELL
# csrc/sw_global_rows.cu: K1's cell without the run counter and nibble, the
# seam's select of the chain (2)
K13_OPS_PER_CELL = 31
# csrc/sw_columns.cu K15: K9's cell without the run counter and nibble, S
# chosen from MIN_SCORE up (one take more)
K15_OPS_PER_CELL = 50
# csrc/sw_banded.cu K16 per band cell, counted from its band rows: the
# match compare and score select (4), the Del extend/open and its bits (7,
# the previous s-bits' shift and mask among them), the y-prefix clip (3),
# S~ (3), the three chain opens (5), the Ins maximum (4), the i-bits
# decision (6), four takes (12), the x-suffix running maximum (5), the
# Sn/Ly update (3) and the cell packing (4); the shuffles and the scan that
# spread a column over a warp are not counted (the recurrence in order needs
# none)
K16_OPS_PER_CELL = 56
# the LUT-fed kernels (K11, K18, K12, K7/K9 and K13 fed by the LUT) do the
# same operations, the LUT read in place of the match/mismatch select

DEVICE = "cuda"
# about 10 ms of the card's clock: longer than the host takes to enqueue
# queued_ms's launches
QUEUE_SLEEP_CYCLES = 20_000_000
GO, GE, MA, MI = -5, -1, 2, -2
B_ALN, LEN = 8192, 150
TEXT_LEN = 4_641_652
B_FM, QLEN = 65_536, 20
B_READS, READ_LEN, B_RANDOM = 8192, 150, 256
SEED_LEN, SEED_TRIES, FLANK = 20, 3, 8
SEED_STARTS = (0, 65, 130)  # the mapper's seed windows on a 150 bp read
# custom mode: BWA-MEM's -A1 -B4 -O6 -E1 -L5 in the affine form, x clipped
# at 5 per end, the reference window's ends free; reads lose up to 30
# bases at each end to random ones (adapter read-through, chimeric ends)
CUSTOM_PENS, CUSTOM_XCLIP, CUSTOM_YCLIP, MAX_JUNK = (-6, -1, 1, -4), -5, 0, 30
# protein: BLOSUM62 with BLASTP's default gap costs in rust-bio's affine
# form; homologs of 250-450 residues, domains of 80-200 in proteins of
# 250-450; custom mode soft-clips the domain's ends at -10 each
AA = b"ARNDCQEGHILKMFPSTWYV"
PROT_GO, PROT_GE = -11, -1
B_PROT, PROT_LEN, DOMAIN_LEN = 8192, (250, 450), (80, 200)
HOMOLOG_SUB, HOMOLOG_INDEL, DOMAIN_SUB = 0.30, 0.03, 0.20
DOMAIN_XCLIP, DOMAIN_YCLIP = -10, 0
# long global (3d): STR pairs as bench.py:601-614 builds them, insertion
# pairs, long proteins; K1 against K13 (and K9 against K15) at these x
# lengths
B_STR, STR_LEN, STR_TRACTS, STR_MOTIF = 128, (4600, 5600), 6, 4
STR_SUB, STR_INDEL = 0.05, 0.005
B_SV, SV_WINDOW, SV_INSERT = 8, (600, 800), (4200, 4800)
B_LPROT, LPROT_LEN = 64, (4200, 5000)
T_ROWS_LENS = (600, 1000, 2000)
# long clip modes (3e): random flanks around phase 3d's sequences
LONG_FLANK, LPROT_FLANK = (200, 400), (100, 200)
SEMI_CLIPS = (-858_993_459, -858_993_459, 0, 0)  # MIN_SCORE: the x-clips off
# the banded aligner (3f): bench.py:1138-1238's geometries, k = w = 8
BAND_K = BAND_W = 8
B_BAND, BAND_READ, BAND_TARGET, BAND_SUBS, BAND_BATCHES = 2048, 150, 20_000, 4, 3
B_KB, KB_READ, KB_SUBS = 256, 1000, 20
B_BAND_LOCAL, BAND_ORACLE, BAND_ORACLE_LONG = 512, 16, 8
# PairHMM (3g): the reference bench's pairs (benches/pairhmm.rs:9-19, built
# as bench.py:225-286: x a 207 bp haplotype, y a 54 bp substring of it with
# 2 random bases written, Illumina gap and substitution rates) and GATK
# HaplotypeCaller's PairHMM calls on 2x150 bp Illumina data: 150 bp reads at
# 1% substitutions in haplotypes of a 300 bp active region with up to 100 bp
# of padding a side, gap open phred 45, gap continuation phred 10, base
# qualities Q30 shared or a per-read mean of Q20-Q40
HMM_INS, HMM_DEL, HMM_SUBST = 2.8e-6, 5.1e-6, 0.0021
B_HMM, HMM_HAP, HMM_READ, HMM_ERRORS, B_HMM_GLOBAL = 4096, 207, 54, 2, 256
B_GATK, GATK_READ, GATK_REGION, GATK_PAD, GATK_SUB = 8192, 150, 300, 100, 0.01
GATK_GAP_OPEN, GATK_GAP_CONT, GATK_Q, GATK_Q_RANGE, B_GATK_SWAP = 10**-4.5, 0.1, 30.0, (20.0, 40.0), 64
B_HMM_EXACT, HMM_MED, B_HOMOPOLY, HOP, HOP_EXTEND = 1024, 4, 2048, 1e-4, 0.5
# the compact path (phase 2): K handles of the 2%-divergence pairs finished
# with one pull, as bench.py:1350-1360 chains them
COMPACT_HANDLES = 8
# the FM index at genome scale (3h): the JAX bench's fm_large row
# (bench.py:792-868, :1640): a random 50 Mbp text, 65,536 20-mers sampled
# from it, the q = 12 table; and a random 2,200,000,001-symbol array with
# one sentinel taken as a BWT, past 2^31 (a SA-IS of a real text of that
# length takes far longer than this run)
FM_LARGE_LEN, FM_LUT_Q, FM_BIG_LEN = 50_000_000, 12, 2_200_000_001
# the SMEM read mapper (3i): the JAX bench's SMEM rows (bench.py:292-330,
# :678-750, :1013-1060): 100 bp reads with two mixed errors each (70%
# substitutions, 15% 1-2 bp insertions, 15% deletions, 10 bp or more from
# the ends), both strands, over phase 2's genome (8192 through map_batch,
# 3 x 8192 through map_stream); a random 50 Mbp genome (6 x 1024 reads, 2
# substitutions each) built once into an index cache and loaded back; the
# 1 Mbp repeat genome (bench.py:755: 15% segmental duplications, 5%
# tandem repeats); K-SMEM held against its plain version at E = 16 and 32
# in both modes, its mapper outputs on 256 lanes against the host oracle
SMEM_LEN, B_SMEM, SMEM_STREAM = 100, 8192, 3
SMEM_LARGE_LEN, B_SMEM_LARGE, SMEM_LARGE_BATCHES = 50_000_000, 1024, 6
SMEM_REPEAT_LEN, SMEM_ORACLE, SMEM_MIN_SEED = 1_000_000, 256, 19
# 32-bit operations K-SMEM's function needs, counted from csrc/fmd_smem.cu
# (loads, stores, addresses, shuffles and ballots not counted): a phase-1
# step ranks KE symbols at two ends (the mask, the popcount, the add: 3
# each), sums them (2 KE: the lower end's select, the difference and the
# running sum) and forms the extension (8); a phase-2 slot step two ranks
# (6), the size and lower bound (4), the append and emit tests (8)
SMEM_OPS_PHASE1_PER_SYMBOL, SMEM_OPS_PHASE1_STEP, SMEM_OPS_SLOT_STEP = 8, 8, 18
# operations the run merge needs per stream entry, whatever kernel does it:
# the keep test, the compare with the previous kept run's kind, the add to
# its length and the add to the run count (the warp's ballots, shuffles and
# scan are the design's, not the function's, and are not counted)
MERGE_OPS_PER_ENTRY = 4
# pairs held to the host oracle (16 a corpus, 4 homopoly: the Python
# oracles take 0.1-7 s a pair; they run in worker processes beside the card)
# and to the port's CPU path
HMM_ORACLE = {
    "bench": 12, "bench_global": 4, "gatk": 6, "gatk_per_lane": 6, "gatk_read_as_x": 4,
    "exact": 8, "exact_banded": 8, "homopoly": 4,
}
HMM_CPU = 64
# the f32 classes on the card against the CPU path: the same plain
# arithmetic, but the host's exp and log differ from the card's by an ulp,
# and over 300-500 rows of f32 the two part by up to 4.0e-5 of max(1, |p|)
# (K17 on the card parts from its plain version there only where its Y
# recurrence, split at the lane stripes, rounds otherwise); the kernels
# against their plain versions on the card are held to 1e-5
CPU_PATH_F32_TOL = 1e-4
# H100 SXM published peaks outside the tensor cores: 67 TFLOP/s f32, 34
# TFLOP/s f64, an FMA counted as two; the PairHMM kernels are built with
# -fmad=false, so each counted operation is one instruction: 33.5 T and
# 17 T a second
F32_OPS_PER_S = 67e12 / 2
F64_OPS_PER_S = 34e12 / 2
# operations a DP cell, counted from the inner loops of csrc/pairhmm_*.cu
# (an exp or a log1p counted as one; loads, stores, addresses not counted):
# K17: 3 rescaling products, m_in's 3 products and 2 sums, the emission's
# compare and select, 1 product for fm, 4 for fx, 3 for fy (A, the chain's
# product and sum; the stripe's carry term left out, as the lanes' scan),
# 3 max, the ylen compare; a logaddexp is 10 (compare, 2 selects, the surrogate test, a
# difference, the clamp's compare and select, exp, log1p, the sum); K17-log:
# 4 logaddexps, 9 sums, the emission select, the first-column test;
# K17-homopoly: 29 logaddexps, 33 sums, 20 compares and selects; K17-exact:
# the 10-nat shortcut's path (3 sums, the partial sort's 6 and the shortcut
# test's 2, the emission's 3, 4 sums and 2 tests for the gap states), a lower
# bound: the data decide how often the full sum runs
K17_OPS_PER_CELL = 22
K17_LOG_OPS_PER_CELL = 52
K17_HOMOPOLY_OPS_PER_CELL = 343
K17_EXACT_OPS_PER_CELL = 20
# the checkpointed stream (3j): 32,768 150 bp reads cut from phase 2's
# genome (every second one reverse-complemented, 1% substitutions, Q40
# strings) in a FASTQ, StreamingMapper's default 4096-read batches over
# phase 3's ReadMapper; the crash on the sixth batch
B_STREAM, STREAM_BATCH, STREAM_CRASH_AT = 32_768, 4096, 5
# the HMM (3k): the JAX bench's dishonest casino (bench.py:1241-1266,
# hmm/mod.rs's doc example: 2 states, 6 symbols), 8192 x 1000 and 8192
# ragged sequences of 1-1000; a 5-state copy-number HMM segmenting read
# depth (means 0.05-2.0 of the diploid depth, sd 0.10-0.30, stay 0.999),
# 4096 x 1000 sampled from the chain; a 128-state model over 20 symbols
# (Dirichlet rows), 1024 x 500, past one warp a sequence; Baum-Welch on
# 1024 casino sequences, 3 iterations
HMM_B, HMM_T, HMM_GAUSS_B, HMM_WIDE = 8192, 1000, 4096, (128, 20, 1024, 500)
HMM_BW_B, HMM_BW_ITER, HMM_SEQ_ORACLE, HMM_SEQ_CPU = 1024, 3, 16, 64
CN_MEANS = (0.05, 0.5, 1.0, 1.5, 2.0)
CN_SDS = (0.10, 0.15, 0.20, 0.25, 0.30)
CN_STAY = 0.999
# operations an active step needs for one state of the HMM scans, counted
# from csrc/hmm.cu (an exp or a log counted as one; shuffles, loads, stores
# not counted): Viterbi S candidates of 4 (the add, the compare, two
# selects) and the emission's add; forward and backward S candidates of 6
# (the add, the max, the difference, the clamp, the exp, the sum), the log,
# the add, the surrogate test and select, the emission's add; the Gaussian
# density adds 4 (the difference, two products, the difference); the
# backtrack one gather a step
HMM_VIT_OPS_PER_CAND, HMM_VIT_OPS_STEP = 4, 1
HMM_LSE_OPS_PER_CAND, HMM_LSE_OPS_STEP = 6, 5
HMM_GAUSS_OPS = 4


def fm_corpus(rng):
    """Phase 2's FM inputs from ``rng``: the text (TEXT_LEN random bases and
    the sentinel, uint8) and B_FM 20-mers, the first B_FM // 2 sampled from
    the text at ``starts``, the rest with one substitution each."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    text_arr = np.concatenate([acgt[rng.integers(0, 4, size=TEXT_LEN)], np.frombuffer(b"$", np.uint8)])
    n_sampled = B_FM // 2
    starts = rng.integers(0, TEXT_LEN - QLEN, size=B_FM)
    pats_np = text_arr[starts[:, None] + np.arange(QLEN)[None, :]].copy()
    mpos = rng.integers(0, QLEN, size=B_FM - n_sampled)
    rows_m = np.arange(n_sampled, B_FM)
    pats_np[rows_m, mpos] = acgt[(np.searchsorted(acgt, pats_np[rows_m, mpos]) + rng.integers(1, 4, size=rows_m.size)) % 4]
    return text_arr, starts, pats_np


def fm_inputs(seed: int):
    """``fm_corpus`` as main() draws it for ``seed`` (after the 150 bp pairs;
    main() checks that the two agree)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 4, size=(B_ALN, LEN))
    rng.integers(0, 4, size=(B_ALN, LEN))
    mut = rng.random(size=(B_ALN, LEN)) < 0.02
    rng.integers(0, 4, size=int(mut.sum()))
    return fm_corpus(rng)


def fm_large_corpus(rng):
    """Phase 3h's text (FM_LARGE_LEN random bases and the sentinel, uint8)
    and B_FM 20-mers sampled from it with their starts."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    text = np.concatenate([acgt[rng.integers(0, 4, size=FM_LARGE_LEN)], np.frombuffer(b"$", np.uint8)])
    starts = rng.integers(0, FM_LARGE_LEN - QLEN, size=B_FM)
    return text, starts, text[starts[:, None] + np.arange(QLEN)[None, :]].copy()


def random_bwt(torch, dev, seed: int, n: int):
    """n random A/C/G/T bytes with one sentinel at a random place, made on
    the card (``seed``'s generator), ``1 << 26`` at a time."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lut = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    step = 1 << 26
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        out[lo:hi] = lut[torch.randint(0, 4, (hi - lo,), device=dev, generator=g)]
    out[int(torch.randint(0, n, (1,), device=dev, generator=g))] = ord("$")
    return out


def interval_rows(lower, upper):
    """The suffix-array rows of intervals [lower, upper), concatenated."""
    sizes = upper - lower
    return (np.repeat(lower - np.cumsum(sizes) + sizes, sizes) + np.arange(int(sizes.sum()))).astype(np.int32)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi exit {out.returncode}: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def kernel_registers(library: Path, pattern: str, field: str = "REG") -> dict:
    """Registers a thread of each kernel in ``library`` whose mangled name
    matches ``pattern``, keyed by the pattern's groups joined by ","
    (``cuobjdump -res-usage``); ``field`` "STACK": its stack frame's bytes
    instead, where spilled registers go; {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-res-usage", str(library)], capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump -res-usage {library.name}: exit {out.returncode}")
    regs, name = {}, None
    for line in out.stdout.splitlines():
        if line.strip().startswith("Function "):
            name = re.search(pattern, line)
        elif name and "REG:" in line:
            regs[",".join(name.groups())] = int(re.search(field + r":(\d+)", line).group(1))
            name = None
    return regs


def cuda_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed runs,
    after one warm-up run (``warm``; the long kernels are warm from their
    check launch)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(torch, fn, reps: int) -> float:
    """Device milliseconds a call of ``fn()`` (a launch that needs no host
    sync): the card sleeps while the host enqueues ``reps`` calls between two
    events, so the events time the launches back to back, without the
    host's enqueue gaps that ``cuda_ms`` counts for a short launch."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(torch, fn):
    """(``fn()``, its milliseconds by CUDA events): one run."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def host_s(torch, fn, reps: int) -> float:
    """Median host seconds of ``fn()`` ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def rescore(kinds, x: bytes, y: bytes, pens=(GO, GE, MA, MI)):
    """(score, x consumed, y consumed) of a list of op kinds under the
    affine model gap(k) = go + ge * (k - 1); None if a Match/Subst
    contradicts x, y."""
    return rescore_ops([(k, 0) for k in kinds], x, y, pens)


def rescore_ops(ops, x: bytes, y: bytes, pens=(GO, GE, MA, MI), xclip=None, yclip=None, lut=None):
    """``rescore`` of (kind, len) ops, with Xclip/Yclip ops at the clip
    penalties ``xclip``/``yclip`` (None: a clip op fails), consuming their
    length of x or y. With ``lut`` (a (256, 256) nested list) a Match or
    Subst scores ``lut[x_i][y_j]`` instead of ``pens``' match/mismatch."""
    go, ge, ma, mi = pens
    i = j = score = 0
    prev = None
    for k, n in ops:
        if k in ("Match", "Subst"):
            if i >= len(x) or j >= len(y) or (x[i] == y[j]) != (k == "Match"):
                return None
            score += lut[x[i]][y[j]] if lut is not None else (ma if k == "Match" else mi)
            i += 1
            j += 1
        elif k == "Ins":
            score += ge if prev == "Ins" else go
            i += 1
        elif k == "Del":
            score += ge if prev == "Del" else go
            j += 1
        elif k == "Xclip" and xclip is not None:
            score += xclip
            i += n
        elif k == "Yclip" and yclip is not None:
            score += yclip
            j += n
        else:
            return None
        prev = k
    return score, i, j


CIGAR_KIND = {"=": "Match", "X": "Subst", "I": "Ins", "D": "Del"}
OP_CHAR = {kind: ch for ch, kind in CIGAR_KIND.items()}


def cigar_kinds(cigar: str):
    """The op kinds of a CIGAR without clips, one per base."""
    out, n = [], 0
    for ch in cigar:
        if ch.isdigit():
            n = 10 * n + int(ch)
        else:
            out.extend([CIGAR_KIND[ch]] * n)
            n = 0
    return out


def cigar_of(ops) -> str:
    """The CIGAR of an op list: runs of '=', 'X', 'I', 'D'; clip ops skipped."""
    out, prev, n = [], None, 0
    for op in ops:
        ch = OP_CHAR.get(op.kind)
        if ch is None:
            continue
        if ch == prev:
            n += 1
            continue
        if prev:
            out.append(f"{n}{prev}")
        prev, n = ch, 1
    if prev:
        out.append(f"{n}{prev}")
    return "".join(out)


def occurrences(text: bytes, pat: bytes):
    at = text.find(pat)
    while at >= 0:
        yield at
        at = text.find(pat, at + 1)


def seeds_hit_elsewhere(genome: bytes, strands, oriented, origin: int) -> bool:
    """Whether a seed window of a read on either of its ``strands`` (the
    read and its reverse complement) occurs in the genome anywhere but at
    its true place, which only the ``oriented`` strand has: ``origin`` plus
    the window's offset (``oriented`` None: a random read, no true place)."""
    for seq in strands:
        for s in SEED_STARTS:
            true = origin + s if seq == oriented else -1
            if any(pos != true for pos in occurrences(genome, seq[s : s + SEED_LEN])):
                return True
    return False


def fields(a):
    return (a.score, a.xstart, a.xend, a.ystart, a.yend, [op.kind for op in a.operations])


def defined(outs, mlens, nlens):
    """K5's outputs with what the kernel leaves unwritten set to 0: traceback
    cells past column nlens[b] or below row mlens[b], final rows below
    mlens[b]."""
    import torch

    tb, *finals = outs
    N, X, _ = tb.shape
    rows = torch.arange(X, device=tb.device)
    keep = (torch.arange(N, device=tb.device)[:, None, None] < nlens[None, None, :]) & (
        rows[None, :, None] <= mlens[None, None, :]
    )
    keep_f = rows[None, :] <= mlens[:, None]
    return [torch.where(keep, tb.to(torch.int32), 0)] + [torch.where(keep_f, f, 0) for f in finals]


def defined_clip(outs, mlens, nlens):
    """K7's / K9's outputs with what the kernel leaves unwritten set to 0:
    traceback cells past column nlens[b] (column 0 is index 0) or below row
    mlens[b], lx past column nlens[b], final rows below mlens[b]."""
    import torch

    tb, lx, *finals = outs
    Nc, X, _ = tb.shape
    cols = torch.arange(Nc, device=tb.device)
    rows = torch.arange(X, device=tb.device)
    keep = (cols[:, None, None] <= nlens[None, None, :]) & (rows[None, :, None] <= mlens[None, None, :])
    keep_f = rows[None, :] <= mlens[:, None]
    return [torch.where(keep, tb.to(torch.int32), 0), torch.where(cols[:, None] <= nlens[None, :], lx, 0)] + [
        torch.where(keep_f, f, 0) for f in finals
    ]


def k2_launch_ms(torch, walk, tb, mlens, nlens, reps: int) -> float:
    """Milliseconds of K2's launch alone, without its wrapper's input checks
    (a host sync each for the lengths): its C entry point called with the
    wrapper's arguments, the same in every tree since K2 reads strides."""
    N, X, B = tb.shape
    outs = [torch.empty((N, B), dtype=torch.uint16, device=tb.device) for _ in range(2)]
    outs.append(torch.empty(B, dtype=torch.uint16, device=tb.device))
    args = (tb.data_ptr(), mlens.data_ptr(), nlens.data_ptr(), B, X, N, *walk._walk_strides(tb), *(o.data_ptr() for o in outs))
    return cuda_ms(torch, lambda: walk.SWEEP_WALK_GLOBAL.launch(tb.device, *args), reps)


def semi_path_cells(outs) -> int:
    """The tb cells K6's sweep reads, from ``sweep_walk_semiglobal``'s
    outputs: one an emitted op, and each pair's entry cell."""
    return int(outs[0].long().sum() + (outs[1].long() > 0).sum()) + outs[0].shape[1]


def semi_walk_bytes(outs, mlens, N: int) -> int:
    """Bytes K6 with its fixed-column prolog must move, from its outputs:
    the sweep's tb cells (2 bytes each), the fixed column's cells the
    prolog reads (4 bytes each: its Ins run from row mlens, the exit row and
    the row below it, or the one entry cell), mlens and nlens; written,
    ins_cnt and exit_op (N, B), ins0 and the five (B,) int32 fields."""
    B = outs[0].shape[1]
    fixed = int((outs[3].long().minimum(mlens.long() + 1) + 1).sum())
    return 2 * semi_path_cells(outs) + 4 * fixed + 8 * B + 2 * 2 * N * B + 2 * B + 4 * 5 * B


def clip_path_cells(outs, ins_at: int) -> int:
    """The tb cells K8's or K10's sweep reads, from its outputs: one an
    emitted op, and each pair's entry cell."""
    return int(outs[ins_at].long().sum() + (outs[ins_at + 1].long() > 0).sum()) + outs[ins_at].shape[1]


def clip_walk_bytes(outs, ins_at: int, n_out: int, mlens, custom: bool) -> int:
    """Bytes K8 or K10 with its prolog must move, from its outputs: the
    sweep's tb cells (2 bytes each), the fixed column's cells the prolog
    reads (4 bytes each: an Ins run's rows from its slot, up to mlens + 1,
    and one more a step), K10's lx at each x-suffix jump, lx_n, mlens and
    nlens; written, the n_out (N + 1, B) uint16 column outputs, fix_codes
    and fix_lens (B, 4) and the four (B,) int32 coordinates."""
    Nc, B = outs[ins_at].shape
    fix_codes, fix_lens = outs[n_out].long(), outs[n_out + 1].long()
    runs = int((fix_lens.minimum(mlens.long()[:, None] + 1) * (fix_codes == 1)).sum())
    fixed = runs + int((fix_codes != 0).sum()) + B
    jumps = int((outs[0].long() > 0).sum()) if custom else 0
    return 2 * clip_path_cells(outs, ins_at) + 4 * fixed + 4 * jumps + 12 * B + 2 * n_out * Nc * B + 32 * B + 16 * B


def clip_walk_inputs(torch, scan, mlens, nlens, pens, clips):
    """The fixed final column and x-suffix clip length K8/K10 start from,
    from a K7/K9 scan (``BatchAligner._custom_device``'s steps)."""
    from rust_bio_tpu_torch.alignment.pairwise.batched import _geometry, _suffix_fixups

    tb, lx, S_f, I_f, Sn_f, Ly_f, tbk = scan
    B, X = S_f.shape
    rows, row_ge1, mlens_c, is_row_m = _geometry(B, X - 1, mlens)
    _, tb_fixed, Lx_n, lx_set = _suffix_fixups(
        S_f, I_f, Sn_f, tbk, B, X - 1, rows, row_ge1, mlens, mlens_c, is_row_m, (pens[0], pens[1], *clips)
    )
    tbfix = (tb_fixed.to(torch.int32) & 0xFFF) | (Ly_f << 12)
    return tbfix, torch.where(lx_set, Lx_n, lx.gather(0, nlens.long()[None, :])[0])


def protein_corpora(rng):
    """The homolog and domain corpora as (x bytes, y bytes) lists: residues
    uniform over the 20 amino acids; a substitution draws one of the 19
    other residues; an indel deletes the residue or inserts a random one
    after it, with equal odds."""
    aa = np.frombuffer(AA, np.uint8)

    def protein():
        return aa[rng.integers(0, 20, size=int(rng.integers(PROT_LEN[0], PROT_LEN[1] + 1)))]

    homolog, domain = ([], []), ([], [])
    for _ in range(B_PROT):
        x = protein()
        homolog[0].append(x.tobytes())
        homolog[1].append(homolog_of(rng, x).tobytes())
        t = protein()
        m = int(rng.integers(DOMAIN_LEN[0], DOMAIN_LEN[1] + 1))
        s0 = int(rng.integers(0, t.size - m + 1))
        domain[0].append(substitute(rng, t[s0 : s0 + m], DOMAIN_SUB).tobytes())
        domain[1].append(t.tobytes())
    return homolog, domain


def substitute(rng, seq, rate):
    """``seq`` with each residue at ``rate`` replaced by one of the 19 others."""
    aa = np.frombuffer(AA, np.uint8)
    rank = np.zeros(256, np.int64)
    rank[aa] = np.arange(20)
    mut = rng.random(seq.size) < rate
    out = seq.copy()
    out[mut] = aa[(rank[seq[mut]] + rng.integers(1, 20, size=int(mut.sum()))) % 20]
    return out


def homolog_of(rng, x):
    """A homolog of protein ``x``: ``HOMOLOG_SUB`` substitutions, then
    ``HOMOLOG_INDEL`` single-residue indels (deletion or insertion after
    the residue, equal odds)."""
    aa = np.frombuffer(AA, np.uint8)
    y = substitute(rng, x, HOMOLOG_SUB)
    indel = rng.random(y.size) < HOMOLOG_INDEL
    ins = indel & (rng.random(y.size) < 0.5)
    # row-major: each kept residue, then the residue inserted after it
    both = np.stack([y, aa[rng.integers(0, 20, size=y.size)]], axis=1)
    return both[np.stack([~indel | ins, ins], axis=1)]


def long_corpora(rng):
    """Phase 3d's three corpora as (x bytes, y bytes) lists: STR pairs,
    insertion pairs, long protein homologs."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    aa = np.frombuffer(AA, np.uint8)
    str_pairs, sv_pairs, prot_pairs = ([], []), ([], []), ([], [])
    for _ in range(B_STR):
        n = int(rng.integers(STR_LEN[0], STR_LEN[1] + 1))
        x = acgt[rng.integers(0, 4, size=n)]
        motif = acgt[rng.integers(0, 4, size=STR_MOTIF)]
        for _ in range(STR_TRACTS):
            s = int(rng.integers(0, n - 200))
            x[s : s + 200] = np.tile(motif, 200 // STR_MOTIF)
        y = x.copy()
        sub = rng.random(n) < STR_SUB
        y[sub] = acgt[rng.integers(0, 4, size=int(sub.sum()))]
        # indels of 1-3 bp at STR_INDEL of the sites: a deletion or an
        # insertion of random bases before the site, equal odds
        pieces, prev = [], 0
        for s in np.nonzero(rng.random(n) < STR_INDEL)[0]:
            k = int(rng.integers(1, 4))
            if s < prev:
                continue
            pieces.append(y[prev:s])
            if rng.random() < 0.5:
                prev = min(int(s) + k, n)
            else:
                pieces.append(acgt[rng.integers(0, 4, size=k)])
                prev = int(s)
        pieces.append(y[prev:])
        str_pairs[0].append(x.tobytes())
        str_pairs[1].append(np.concatenate(pieces).tobytes())
    for _ in range(B_SV):
        y = acgt[rng.integers(0, 4, size=int(rng.integers(SV_WINDOW[0], SV_WINDOW[1] + 1)))]
        insert = acgt[rng.integers(0, 4, size=int(rng.integers(SV_INSERT[0], SV_INSERT[1] + 1)))]
        at = int(rng.integers(1, y.size))
        sv_pairs[0].append(np.concatenate([y[:at], insert, y[at:]]).tobytes())
        sv_pairs[1].append(y.tobytes())
    for _ in range(B_LPROT):
        x = aa[rng.integers(0, 20, size=int(rng.integers(LPROT_LEN[0], LPROT_LEN[1] + 1)))]
        prot_pairs[0].append(x.tobytes())
        prot_pairs[1].append(homolog_of(rng, x).tobytes())
    return str_pairs, sv_pairs, prot_pairs


def long_clip_corpora(rng, long_sets):
    """Phase 3e's corpora from phase 3d's STR backbones x, their mutated
    copies y and the long protein homologs, as (x bytes, y bytes) lists:
    semiglobal (x, flank + y + flank), local (flank + x + flank, y), protein
    local (flank + x + flank, y); and for the two local corpora each pair's
    (left flank, core) lengths in x."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    aa = np.frombuffer(AA, np.uint8)

    def flank(syms, span):
        return syms[rng.integers(0, len(syms), size=int(rng.integers(span[0], span[1] + 1)))].tobytes()

    (sxs, sys_), _, (pxs, pys) = long_sets
    semi = (list(sxs), [flank(acgt, LONG_FLANK) + y + flank(acgt, LONG_FLANK) for y in sys_])
    lefts = [flank(acgt, LONG_FLANK) for _ in sxs]
    local = ([fl + x + flank(acgt, LONG_FLANK) for fl, x in zip(lefts, sxs)], list(sys_))
    plefts = [flank(aa, LPROT_FLANK) for _ in pxs]
    prot = ([fl + x + flank(aa, LPROT_FLANK) for fl, x in zip(plefts, pxs)], list(pys))
    cores = ([(len(fl), len(x)) for fl, x in zip(lefts, sxs)], [(len(fl), len(x)) for fl, x in zip(plefts, pxs)])
    return semi, local, prot, cores


def longest_ins_run(ops) -> int:
    best = run = 0
    for op in ops:
        run = run + 1 if op.kind == "Ins" else 0
        best = max(best, run)
    return best


def rows_tb_err(torch, got, want, mlens, nlens, chunk: int = 256) -> int:
    """Max abs difference of two (N, X, B) tb tensors over the region the
    kernel defines (columns < nlens[b], rows <= mlens[b]), a chunk of
    columns at a time: a whole-tensor comparison would need a third
    multi-GB copy."""
    N, X, _ = got.shape
    rows_ok = torch.arange(X, device=got.device)[:, None] <= mlens[None, :]
    err = 0
    for c0 in range(0, N, chunk):
        g = got[c0 : c0 + chunk].to(torch.int32)
        w = want[c0 : c0 + chunk].to(torch.int32)
        cols_ok = torch.arange(c0, c0 + g.shape[0], device=got.device)[:, None, None] < nlens[None, None, :]
        err = max(err, int(torch.where(cols_ok & rows_ok[None], (g - w).abs(), 0).max()))
    return err


def band_corpora(rng):
    """Phase 3f's read corpora as (x bytes, y bytes) lists: ``BAND_BATCHES``
    batches of 150 bp reads and one of 1 kb reads, each cut at a random
    offset from its own random 20 kb target, with random bases written at
    ``BAND_SUBS`` / ``KB_SUBS`` random positions (bench.py:1157-1167)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def batch(n_pairs, m, subs):
        ys = acgt[rng.integers(0, 4, size=(n_pairs, BAND_TARGET))]
        at = rng.integers(0, BAND_TARGET - m, size=n_pairs)
        xs = ys[np.arange(n_pairs)[:, None], at[:, None] + np.arange(m)[None, :]]
        pos = rng.integers(0, m, size=(n_pairs, subs))
        xs[np.arange(n_pairs)[:, None], pos] = acgt[rng.integers(0, 4, size=(n_pairs, subs))]
        return [r.tobytes() for r in xs], [r.tobytes() for r in ys]

    reads = [batch(B_BAND, BAND_READ, BAND_SUBS) for _ in range(BAND_BATCHES)]
    return reads, batch(B_KB, KB_READ, KB_SUBS)


def pair_major_base(view):
    """The (B, N, Xp) tensor under a pair-major (N, X, B) tb view."""
    N, _, B = view.shape
    Xp = view.stride(0)
    return view.as_strided((B, N, Xp), (N * Xp, Xp, 1))


def band_cells(arrays) -> int:
    """The band cells K16 computes for a batch's device arrays (rows
    [max(1, start), min(end, m + 1)) of columns 1..nlens)."""
    _, _, ml, nl, st, en, _ = arrays
    Nc = st.shape[1] - 1
    cols = np.arange(1, Nc + 1)[None, :] <= nl[:, None]
    lo = np.maximum(st[:, 1:], 1)
    hi = np.minimum(en[:, 1:], ml[:, None].astype(np.int64) + 1)
    return int(np.where(cols, np.maximum(hi - lo, 0), 0).sum())


def host_profile(torch, fn, top: int = 14) -> dict:
    """cProfile of one ``fn()`` ending in a synchronize: its host seconds
    and the functions with the most time of their own (profiling adds a
    cost to every Python call, so read the shares, not the totals)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    total = time.perf_counter() - t0
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: kv[1][2], reverse=True)[:top]
    return {
        "profiled_s": total,
        "top_tottime": [[f"{Path(f).name}:{line}:{name}", calls, own, cum] for (f, line, name), (_, calls, own, cum, _) in rows],
    }


def mut_reads(genome: bytes, starts, length: int, rng):
    """Reads with two mixed errors each, 10 bp or more from the read ends so
    that the mapping position stays the window start (bench.py:678-696)."""
    reads = []
    for s in starts:
        r = bytearray(genome[s : s + length + 8])  # slack for deletions
        for _ in range(2):
            p = int(rng.integers(10, length - 10))
            kind = rng.random()
            if kind < 0.70:
                r[p] = int(rng.choice(list(b"ACGT")))
            elif kind < 0.85:
                del r[p : p + int(rng.integers(1, 3))]
            else:
                r[p:p] = rng.choice(list(b"ACGT"), size=int(rng.integers(1, 3))).astype(np.uint8).tobytes()
        reads.append(bytes(r[:length]))
    return reads


def repeat_genome(G: int, seed: int):
    """A random genome with 15% segmental duplications (0.5-3 kb copies) and
    5% tandem repeats (2-50 bp units, 10-100 copies) pasted over it, and
    the (G,) mask of positions never pasted over or copied from
    (bench.py:755-791)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=G, dtype=np.uint8)
    pasted = np.zeros(G, bool)
    placed = 0
    while placed < int(G * 0.15):
        L = int(rng.integers(500, 3000))
        src = int(rng.integers(0, G - L))
        dst = int(rng.integers(0, G - L))
        base[dst : dst + L] = base[src : src + L]
        pasted[dst : dst + L] = True
        pasted[src : src + L] = True
        placed += L
    placed = 0
    while placed < int(G * 0.05):
        u = int(rng.integers(2, 50))
        reps = int(rng.integers(10, 100))
        L = u * reps
        dst = int(rng.integers(0, G - L))
        base[dst : dst + L] = np.tile(rng.integers(0, 4, size=u, dtype=np.uint8), reps)
        pasted[dst : dst + L] = True
        placed += L
    return np.frombuffer(b"ACGT", np.uint8)[base].tobytes(), ~pasted


def both_strands(oriented):
    """Every second read reverse-complemented."""
    from rust_bio_tpu_torch.alphabets import dna

    return [dna.revcomp(o) if k % 2 else o for k, o in enumerate(oriented)]


def at_origin(mapped, starts) -> int:
    """Reads mapped at their start on their strand (every second one '-')."""
    return sum(m.pos == int(s) and m.strand == ("-" if k % 2 else "+") for k, (m, s) in enumerate(zip(mapped, starts)))


def smem_phase(torch, dev, seed: int, genome: bytes, sc, counters: dict, report, smi: str):
    """Phase 3i, the SMEM mapper with the launch counters at 0 (see the
    module docstring). Returns (the main path's launches, the rates, the
    seed paths' counts); reports K-SMEM's kernel row through ``report``."""
    import tempfile

    from rust_bio_tpu_torch.alphabets import dna
    from rust_bio_tpu_torch.ops import _build, fmd
    from rust_bio_tpu_torch.pipelines import SmemReadMapper
    from rust_bio_tpu_torch.data_structures.fmd_device import pad_batch

    G = len(genome)
    rng = np.random.default_rng((seed, 9))
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sm = SmemReadMapper(genome, sc, min_seed_len=SMEM_MIN_SEED, device=dev)
    build = {**sm.build_s, "total_s": time.perf_counter() - t0}
    starts = rng.integers(0, G - SMEM_LEN - 8, size=(1 + SMEM_STREAM) * B_SMEM)
    reads = both_strands(mut_reads(genome, starts, SMEM_LEN, rng))
    main_reads, main_starts = reads[:B_SMEM], starts[:B_SMEM]
    batches = [reads[B_SMEM * (k + 1) : B_SMEM * (k + 2)] for k in range(SMEM_STREAM)]
    mapped = sm.map_batch(main_reads)
    batch_stats = dict(sm.seed_stats)
    streamed = [m for part in sm.map_stream(batches) for m in part]
    smem_launches = {name: k.launches for name, k in counters.items()}
    path = ("fmd_smems", "fm_locate", "sw_scan_semiglobal", "sweep_walk_semiglobal")
    check(all(smem_launches[n] > 0 for n in path), f"a kernel of the SMEM mapper did not launch: {smem_launches}")
    stats = {k: sm.seed_stats[k] for k in sm.seed_stats}
    check(smem_launches["fmd_smems"] == stats["main_launches"] + stats["quarter_launches"] + stats["wide_launches"],
          f"3i: K-SMEM launches {smem_launches['fmd_smems']} != the seed paths' {stats}")
    ok_batch = at_origin(mapped, main_starts)
    ok_stream = at_origin(streamed, starts[B_SMEM:])
    check(ok_batch >= 0.9 * B_SMEM, f"3i: {ok_batch} of {B_SMEM} reads at their origin")
    check(ok_stream >= 0.9 * SMEM_STREAM * B_SMEM, f"3i: map_stream put {ok_stream} reads at their origin")
    for k, (read, m) in enumerate(zip(main_reads, mapped)):
        if m.pos >= 0:
            x = read if m.strand == "+" else dna.revcomp(read)
            got = rescore(cigar_kinds(m.cigar), x, genome[m.pos : m.pos + 2 * SMEM_LEN])
            check(got is not None and got[:2] == (m.score, len(x)), f"3i: read {k}: CIGAR {m.cigar} does not re-score to {m.score}")
    # the card against the plain versions on the CPU, 64 reads
    cpu = sm.to("cpu")
    key = lambda ms: [(m.pos, m.strand, m.score, m.cigar) for m in ms]  # noqa: E731
    check(key(mapped[:64]) == key(cpu.map_batch(main_reads[:64])), "3i: card != CPU plain path")
    del cpu
    print(json.dumps({
        "phase": "smem_mapper", "launches": smem_launches, "reads": B_SMEM, "at_origin": ok_batch,
        "stream_reads": SMEM_STREAM * B_SMEM, "stream_at_origin": ok_stream, "mapped": sum(m.pos >= 0 for m in mapped),
        "seed_paths_map_batch": batch_stats, "seed_paths_all": stats, "fmd_build": build, "text": 2 * G + 2,
        "seconds": time.perf_counter() - t_phase, "card": smi,
    }), flush=True)

    # K-SMEM against its plain version on the main path's 8192 lanes (the
    # read middles), both modes, E = 16 and 32; the pick; the host oracle
    pb, plens, _ = pad_batch(main_reads)
    iis = np.maximum(plens // 2 - 1, 0).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pb, plens, iis)]
    t = sm.fmd.tables
    err, checks = 0, {}
    for mapper in (True, False):
        for E in (16, 32):
            got = fmd.smems(t, *args, SMEM_MIN_SEED, E, E, mapper)
            torch.cuda.synchronize()
            want = fmd.smems_plain(t, *args, SMEM_MIN_SEED, E, E, mapper)
            e = max_abs_err(got, want)
            checks[f"{'mapper' if mapper else 'full'}_E{E}"] = {"max_abs_err": e, "ovf": int(want[6].sum()), "matches": int(want[5].sum())}
            err = max(err, e)
    check(err == 0, f"fmd_smems differs from its plain version: {checks}")
    pick = torch.empty((4, B_SMEM), dtype=torch.int32, device=dev)
    rows = fmd.seed_pick(t, *args, SMEM_MIN_SEED, sm._E0, pick)
    torch.cuda.synchronize()
    work = {}
    wrows, wpick = fmd.pick_plain(*fmd.smems_plain(t, *args, SMEM_MIN_SEED, sm._E0, sm._E0, True, work))
    err = max(err, max_abs_err([rows, pick], [wrows, wpick]))
    check(err == 0, "fmd_smems: the seed pick differs from its plain version")
    lanes = np.arange(0, B_SMEM, B_SMEM // SMEM_ORACLE)
    t0 = time.perf_counter()
    oracle_fmd = sm.host_fmd
    dev_lanes = sm.fmd.smems_batch(
        [main_reads[i] for i in lanes], iis[lanes], SMEM_MIN_SEED, 16, 16, host_oracle=oracle_fmd, mapper_mode=True
    )
    oracle = [oracle_fmd.smems(main_reads[i], int(iis[i]), SMEM_MIN_SEED) for i in lanes]
    drop_lor = lambda lanes_: [[(i.lower, i.size, i.match_size, p, n) for i, p, n in lane] for lane in lanes_]  # noqa: E731
    check(drop_lor(dev_lanes) == drop_lor(oracle), "fmd_smems: mapper-mode SMEMs != the host oracle's")
    oracle_s = time.perf_counter() - t0
    # the bytes this run's lanes need: a rank-row read of phase 1 as the
    # 32-byte sectors of its 2S words, a phase-2 slot rank as one sector,
    # two each a step; the reads, lengths, positions and the pick
    S = int(sm.index._fused.shape[0])
    row_bytes = 32 * -(-(8 * S) // 32)
    nbytes = 2 * row_bytes * work["phase1_steps"] + 2 * 32 * work["slot_steps"] + pb.size + 8 * B_SMEM + 20 * B_SMEM
    nops = (SMEM_OPS_PHASE1_PER_SYMBOL * sm.fmd.KE + SMEM_OPS_PHASE1_STEP) * work["phase1_steps"] + SMEM_OPS_SLOT_STEP * work["slot_steps"]
    out = torch.empty((4, B_SMEM), dtype=torch.int32, device=dev)
    launch = lambda: fmd.seed_pick(t, *args, SMEM_MIN_SEED, sm._E0, out)  # noqa: E731
    wide = lambda: fmd.seed_pick(t, *args, SMEM_MIN_SEED, 2 * sm._E0, out)  # noqa: E731
    full = lambda: fmd.smems(t, *args, SMEM_MIN_SEED, 16, 16, False)  # noqa: E731
    lib = _build.build(["fmd_smem"])["fmd_smem"]
    report(
        "fmd_smems", "rust_bio_tpu_torch/ops/csrc/fmd_smem.cu", "rust_bio_tpu/data_structures/fmd_device.py:143",
        [rows, pick], [wrows, wpick], cuda_ms(torch, launch, 20),
        cuda_ms(torch, lambda: fmd.pick_plain(*fmd.smems_plain(t, *args, SMEM_MIN_SEED, sm._E0, sm._E0, True)), 2),
        nbytes, nops, err=err, n_launches=smem_launches["fmd_smems"],
        queued_ms=queued_ms(torch, launch, 20), wide_ms=cuda_ms(torch, wide, 10), full_mode_ms=cuda_ms(torch, full, 5),
        checks=checks, work=work, lanes=B_SMEM, oracle_lanes=len(lanes), oracle_s=oracle_s,
        seed_paths=stats, geometry={"warps": fmd.SMEM_WARPS, "blocks": -(-B_SMEM // fmd.SMEM_WARPS)},
        registers=kernel_registers(lib, r"fmd_smems_kernelILb([01])E"),
        stack_bytes=kernel_registers(lib, r"fmd_smems_kernelILb([01])E", "STACK"),
    )
    del got, want, rows, pick, wrows, wpick, out

    # rates at 4.6 Mbp: the seed chain device-only (upload, K-SMEM with
    # the pick, K4-locate, one pull), map_batch and map_stream delivered
    rates = {}
    chain = lambda: sm._seed_arrays(pb, plens, iis, sm._E0).cpu()  # noqa: E731
    rates["smem_seed_chain_reads_per_s_device"] = B_SMEM / host_s(torch, chain, 5)
    rates["smem_reads_per_s_delivered"] = B_SMEM / host_s(torch, lambda: sm.map_batch(main_reads), 3)
    rates["smem_stream_reads_per_s_delivered"] = SMEM_STREAM * B_SMEM / host_s(torch, lambda: [len(p) for p in sm.map_stream(batches)], 2)
    rates["smem_fmd_sais_s"] = build["sais_s"]
    rates["smem_fmd_tables_s"] = build["tables_s"]
    print(json.dumps({"phase": "smem_mapper_profile", **host_profile(torch, lambda: sm.map_batch(main_reads))}), flush=True)
    del sm
    torch.cuda.empty_cache()

    # the genome scale: a random 50 Mbp genome, its index built once into a
    # cache and loaded back with the genome check; 6 x 1024 reads streamed
    t_scale = time.perf_counter()
    rng50 = np.random.default_rng((seed, 10))
    g50 = np.frombuffer(b"ACGT", np.uint8)[rng50.integers(0, 4, size=SMEM_LARGE_LEN, dtype=np.uint8)].tobytes()
    with tempfile.TemporaryDirectory() as td:
        cache = os.path.join(td, "smem_50mbp.npz")
        t0 = time.perf_counter()
        m50 = SmemReadMapper(g50, sc, min_seed_len=SMEM_MIN_SEED, index_cache=cache, device=dev)
        build50 = {**m50.build_s, "total_s": time.perf_counter() - t0, "cache_bytes": os.path.getsize(cache)}
        del m50
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        m50 = SmemReadMapper(g50, sc, min_seed_len=SMEM_MIN_SEED, index_cache=cache, device=dev)
        build50["reload_s"] = time.perf_counter() - t0
        check("load_s" in m50.build_s and m50.index.n == 2 * SMEM_LARGE_LEN + 2, "3i: the 50 Mbp mapper did not load its cache")
        other = bytearray(g50)
        other[SMEM_LARGE_LEN // 2] = ord("A") if other[SMEM_LARGE_LEN // 2] != ord("A") else ord("C")
        try:
            SmemReadMapper(bytes(other), sc, min_seed_len=SMEM_MIN_SEED, index_cache=cache, device=dev)
            refused = False
        except ValueError as e:
            refused = "another genome" in str(e)
        check(refused, "3i: a cache of another genome was not refused")
        del other
    starts50 = rng50.integers(0, SMEM_LARGE_LEN - SMEM_LEN, size=SMEM_LARGE_BATCHES * B_SMEM_LARGE)
    oriented = []
    for s in starts50:
        r = bytearray(g50[s : s + SMEM_LEN])
        for _ in range(2):
            r[int(rng50.integers(0, SMEM_LEN))] = int(rng50.choice(list(b"ACGT")))
        oriented.append(bytes(r))
    reads50 = both_strands(oriented)
    batches50 = [reads50[k * B_SMEM_LARGE : (k + 1) * B_SMEM_LARGE] for k in range(SMEM_LARGE_BATCHES)]
    for k in counters.values():
        k.launches = 0
    out50 = [m for part in m50.map_stream(batches50) for m in part]
    stats50 = dict(m50.seed_stats)
    launches50 = {n: counters[n].launches for n in path}
    check(all(v > 0 for v in launches50.values()), f"3i: a kernel of the 50 Mbp stream did not launch: {launches50}")
    ok50 = at_origin(out50, starts50)
    check(ok50 >= 0.9 * len(reads50), f"3i: {ok50} of {len(reads50)} reads at their origin at 50 Mbp")
    pb50, pl50, _ = pad_batch(batches50[0])
    ii50 = np.maximum(pl50 // 2 - 1, 0).astype(np.int32)
    a50 = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pb50, pl50, ii50)]
    out = torch.empty((4, B_SMEM_LARGE), dtype=torch.int32, device=dev)
    k_smem_50 = cuda_ms(torch, lambda: fmd.seed_pick(m50.fmd.tables, *a50, SMEM_MIN_SEED, m50._E0, out), 10)
    rates["smem_50mbp_seed_chain_reads_per_s_device"] = B_SMEM_LARGE / host_s(
        torch, lambda: m50._seed_arrays(pb50, pl50, ii50, m50._E0).cpu(), 5
    )
    rates["smem_50mbp_reads_per_s_delivered"] = B_SMEM_LARGE / host_s(torch, lambda: m50.map_batch(batches50[0]), 3)
    rates["smem_50mbp_stream_reads_per_s_delivered"] = len(reads50) / host_s(torch, lambda: [len(p) for p in m50.map_stream(batches50)], 2)
    rates["smem_50mbp_fmd_sais_s"] = build50["sais_s"]
    rates["smem_50mbp_fmd_tables_s"] = build50["tables_s"]
    rates["smem_50mbp_cache_load_s"] = build50["reload_s"]
    print(json.dumps({
        "phase": "smem_50mbp", "launches": launches50, "text": m50.index.n, "reads": len(reads50), "at_origin": ok50,
        "seed_paths": stats50, "build": build50, "k_smem_ms_1024": k_smem_50,
        "seconds": time.perf_counter() - t_scale, "card": smi,
    }), flush=True)
    del m50, a50, out
    torch.cuda.empty_cache()

    # the hard case: the 1 Mbp repeat genome, 8192 reads
    t_rep = time.perf_counter()
    grep, uniq = repeat_genome(SMEM_REPEAT_LEN, seed + 41)
    mrep = SmemReadMapper(grep, sc, min_seed_len=SMEM_MIN_SEED, device=dev)
    rrng = np.random.default_rng((seed, 11))
    rstarts = rrng.integers(0, SMEM_REPEAT_LEN - SMEM_LEN - 8, size=B_SMEM)
    cm = np.concatenate([[0], np.cumsum(~uniq)])
    unique = (cm[rstarts + SMEM_LEN] - cm[rstarts]) == 0
    rreads = both_strands(mut_reads(grep, rstarts, SMEM_LEN, rrng))
    rmapped = mrep.map_batch(rreads)
    rep_stats = dict(mrep.seed_stats)
    ok_rep = sum(m.pos == int(s) and m.strand == ("-" if k % 2 else "+") for k, (m, s, u) in enumerate(zip(rmapped, rstarts, unique)) if u)
    check(ok_rep >= 0.9 * int(unique.sum()), f"3i: {ok_rep} of {int(unique.sum())} uniquely originating repeat-genome reads at their origin")
    rates["smem_repeat_reads_per_s_delivered"] = B_SMEM / host_s(torch, lambda: mrep.map_batch(rreads), 2)
    print(json.dumps({
        "phase": "smem_repeats", "reads": B_SMEM, "unique_reads": int(unique.sum()), "unique_at_origin": ok_rep,
        "mapped": sum(m.pos >= 0 for m in rmapped), "seed_paths": rep_stats,
        "oracle_note": "no lane reached the host oracle" if rep_stats["oracle_lanes"] == 0 else "",
        "seconds": time.perf_counter() - t_rep, "card": smi,
    }), flush=True)
    del mrep
    torch.cuda.empty_cache()
    return smem_launches, rates, stats


def pairhmm_corpora(rng):
    """Phase 3g's inputs as numpy arrays: the bench pairs (x, y) with their
    first ``B_HOMOPOLY`` haplotypes' exact read substrings for the homopoly
    corpus (bench.py:423-460), and the GATK-like pairs (x, y, xlens, ylens,
    per-lane emissions)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rows = np.arange(B_HMM)[:, None]
    bx = acgt[rng.integers(0, 4, size=(B_HMM, HMM_HAP))]
    at = rng.integers(0, HMM_HAP - HMM_READ, size=B_HMM)[:, None] + np.arange(HMM_READ)[None, :]
    by = bx[rows, at]
    homo = (bx[:B_HOMOPOLY].copy(), by[:B_HOMOPOLY].copy())
    for _ in range(HMM_ERRORS):
        by[np.arange(B_HMM), rng.integers(0, HMM_READ, size=B_HMM)] = acgt[rng.integers(0, 4, size=B_HMM)]
    M = GATK_REGION + 2 * GATK_PAD
    gxl = (GATK_REGION + rng.integers(0, GATK_PAD + 1, size=(B_GATK, 2)).sum(1)).astype(np.int32)
    gx = acgt[rng.integers(0, 4, size=(B_GATK, M))]
    gx[np.arange(M)[None, :] >= gxl[:, None]] = 0
    off = rng.integers(0, gxl - GATK_READ + 1)[:, None] + np.arange(GATK_READ)[None, :]
    gy = gx[np.arange(B_GATK)[:, None], off]
    mut = rng.random(size=gy.shape) < GATK_SUB
    gy[mut] = acgt[(np.searchsorted(acgt, gy[mut]) + rng.integers(1, 4, size=int(mut.sum()))) % 4]
    gyl = np.full(B_GATK, GATK_READ, np.int32)
    err = 10.0 ** (-rng.uniform(*GATK_Q_RANGE, size=B_GATK) / 10.0)
    gep = np.stack([np.log1p(-err), np.log(err / 3.0), np.log1p(-err)], 1)
    return (bx, by), homo, (gx, gy, gxl, gyl, gep)


def hmm_lens(xs, ys, xlens, ylens):
    """The lengths of a PairHMM batch, full where not given."""
    B = len(xs)
    return (
        np.full(B, xs.shape[1], np.int32) if xlens is None else xlens,
        np.full(B, ys.shape[1], np.int32) if ylens is None else ylens,
    )


def hmm_emit(err: float, n: int = 3):
    """[ln p_match, ln p_mismatch, ln p_gap_emit (, ln p_emit_y)] of a base
    error probability."""
    return np.array([math.log1p(-err), math.log(err / 3.0)] + [math.log1p(-err)] * (n - 2))


def hmm_oracle(kind, gaps, hops, x: bytes, y: bytes, ep, semiglobal: bool, med=None, match_any=None) -> float:
    """The port's host oracle (``PairHMM`` or ``HomopolyPairHMM``) on one
    pair under the sequencing emission model ``ep``; ``match_any``, when
    given, replaces the homopoly oracle's match-to-match transitions (the
    JAX package's class derives them with ln 4 where the oracle subtracts
    4.0: ROADMAP Queue 3)."""
    from rust_bio_tpu_torch.stats.pairhmm import (
        EmissionParameters, GapParameters, Global, PairHMM, Semiglobal, XYEmission,
    )
    from rust_bio_tpu_torch.stats.pairhmm.homopolypairhmm import MATCH_STATES, Emission, HomopolyPairHMM, HopParameters

    class Em(EmissionParameters, Emission):
        def prob_emit_xy(self, i, j):
            return XYEmission.match_(ep[0]) if x[i] == y[j] else XYEmission.mismatch(ep[1])

        def prob_emit_x(self, i):
            return ep[2]

        def prob_emit_y(self, j):
            return ep[-1]

        def len_x(self):
            return len(x)

        def len_y(self):
            return len(y)

        def emission_x(self, i):
            return x[i]

        def emission_y(self, j):
            return y[j]

    class Gaps(GapParameters):
        def prob_gap_x(self):
            return gaps[0]

        def prob_gap_y(self):
            return gaps[1]

        def prob_gap_x_extend(self):
            return gaps[2]

        def prob_gap_y_extend(self):
            return gaps[3]

    class Hops(HopParameters):
        def prob_hop_x(self):
            return hops[0]

        def prob_hop_y(self):
            return hops[1]

        def prob_hop_x_extend(self):
            return hops[2]

        def prob_hop_y_extend(self):
            return hops[3]

    mode = Semiglobal() if semiglobal else Global()
    if kind == "homopoly":
        oracle = HomopolyPairHMM(Gaps(), Hops())
        if match_any is not None:
            for m1 in MATCH_STATES:
                for m2 in MATCH_STATES:
                    oracle.transition_probs[(m1, m2)] = match_any
        return float(oracle.prob_related(Em(), mode, med))
    return float(PairHMM(Gaps()).prob_related(Em(), mode, med))


def f32_err(got, want) -> float:
    """Max |got - want| / max(1, |want|) over the lanes both hold finite
    (the -3e38 lanes must be the same set); the f32 kernels' tolerance is
    1e-5."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(np.array_equal(got <= -1.5e38, want <= -1.5e38), "a lane underflowed on one side only")
    ok = want > -1.5e38
    return float((np.abs(got - want)[ok] / np.maximum(1.0, np.abs(want[ok]))).max()) if ok.any() else 0.0


def rel_err(got, want) -> float:
    """Max relative error (to max(1, |want|)) over finite lanes; the
    non-finite lanes must be equal."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    check(np.array_equal(np.isfinite(got), fin) and np.array_equal(got[~fin], want[~fin]), "non-finite lanes differ")
    return float((np.abs(got - want)[fin] / np.maximum(1.0, np.abs(want[fin]))).max()) if fin.any() else 0.0


def oracle_ok(got, want) -> bool:
    """The JAX suites' rule for the f32 classes against the f64 oracle: a
    lane at -inf or under -80 there is under -75 here, the rest within rel
    2e-3, abs 2e-3."""
    return all(
        (g < -75) if (w == float("-inf") or w < -80) else abs(g - w) <= max(2e-3, 2e-3 * abs(w))
        for g, w in zip(got, want)
    )


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0 for g, w in zip(got, want))



def stream_phase(torch, genome_arr, mapper, counters: dict, seed: int, smi: str):
    """Phase 3j, ``StreamingMapper`` over phase 3's mapper with the launch
    counters at 0 (see the module docstring). Returns (the counted run's
    launches, the rates)."""
    import tempfile

    from rust_bio_tpu_torch.alphabets import dna
    from rust_bio_tpu_torch.pipelines import StreamingMapper

    rng = np.random.default_rng((seed, 10))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    t_phase = time.perf_counter()
    origins = rng.integers(0, len(genome_arr) - READ_LEN, size=B_STREAM)
    cut = genome_arr[origins[:, None] + np.arange(READ_LEN)[None, :]].copy()
    mut = rng.random(size=cut.shape) < 0.01
    cut[mut] = acgt[(np.searchsorted(acgt, cut[mut]) + rng.integers(1, 4, size=int(mut.sum()))) % 4]
    seqs = [dna.revcomp(bytes(r)) if k % 2 else bytes(r) for k, r in enumerate(cut)]
    ids = [f"s{k}" for k in range(B_STREAM)]
    n_batches = -(-B_STREAM // STREAM_BATCH)
    with tempfile.TemporaryDirectory() as d:
        fq = os.path.join(d, "reads.fq")
        with open(fq, "w") as f:
            f.write("".join(f"@{i}\n{r.decode()}\n+\n{'I' * READ_LEN}\n" for i, r in zip(ids, seqs)))
        out, ck = os.path.join(d, "out.tsv"), os.path.join(d, "ck.json")
        stats = []
        sm = StreamingMapper(mapper, on_stats=stats.append)
        check(sm.batch_size == STREAM_BATCH, f"3j: StreamingMapper's default batch is {sm.batch_size}")
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        done = sm.run(fq, out, ck)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in counters.items()}
        path = ("fm_backward_search", "fm_locate", "sw_scan_semiglobal", "sweep_walk_semiglobal")
        check(all(launches[n] > 0 for n in path), f"3j: a kernel of the mapper did not launch: {launches}")
        check(done == n_batches, f"3j: run processed {done} batches, not {n_batches}")
        check([st["batch"] for st in stats] == list(range(n_batches)), f"3j: on_stats fired for {[st['batch'] for st in stats]}")
        sm.finalize(out)
        with open(out, "rb") as f:
            final = f.read()
        # map_batch of the same batches, formatted as the shards are
        t0 = time.perf_counter()
        want = []
        for o in range(0, B_STREAM, STREAM_BATCH):
            for m in mapper.map_batch(seqs[o : o + STREAM_BATCH], ids=ids[o : o + STREAM_BATCH]):
                want.append(f"{m.read_id}\t{m.pos}\t{m.strand}\t{m.score}\t{m.cigar}\n")
        batch_s = time.perf_counter() - t0
        check(final.decode().splitlines(keepends=True) == want, "3j: the streamed TSV != map_batch of the same batches")
        n_mapped = sum(1 for line in want if line.split("\t")[1] != "-1")
        # a crash on batch STREAM_CRASH_AT, then the resume
        out2, ck2 = os.path.join(d, "out2.tsv"), os.path.join(d, "ck2.json")
        sm2 = StreamingMapper(mapper)
        calls = {"n": 0}
        real = mapper.map_batch

        class Crash(RuntimeError):
            pass

        def flaky(reads, ids=None):
            calls["n"] += 1
            if calls["n"] == STREAM_CRASH_AT + 1:
                raise Crash()
            return real(reads, ids)

        mapper.map_batch = flaky
        try:
            sm2.run(fq, out2, ck2)
            fail("3j: the crashing mapper did not stop the run")
        except Crash:
            pass
        finally:
            del mapper.map_batch
        shards = [sm2._shard_path(out2, k) for k in range(n_batches)]
        check(all(os.path.exists(x) for x in shards[:STREAM_CRASH_AT]) and not any(os.path.exists(x) for x in shards[STREAM_CRASH_AT:]),
              "3j: the crash left other shards than the batches before it")
        kept = [(open(x, "rb").read(), os.stat(x).st_mtime_ns) for x in shards[:STREAM_CRASH_AT]]
        resumed = sm2.run(fq, out2, ck2)
        check(resumed == n_batches - STREAM_CRASH_AT, f"3j: the resume processed {resumed} batches")
        check([(open(x, "rb").read(), os.stat(x).st_mtime_ns) for x in shards[:STREAM_CRASH_AT]] == kept,
              "3j: the resume touched a shard written before the crash")
        sm2.finalize(out2)
        with open(out2, "rb") as f:
            check(f.read() == final, "3j: the resumed TSV != the uninterrupted one")
        # an edited input (one base of the first read) starts over
        with open(fq, "r+b") as f:
            f.seek(len(ids[0]) + 2)
            base = f.read(1)
            f.seek(len(ids[0]) + 2)
            f.write(b"A" if base != b"A" else b"C")
        t0 = time.perf_counter()
        redone = sm2.run(fq, out2, ck2)
        torch.cuda.synchronize()
        rerun_s = time.perf_counter() - t0
        check(redone == n_batches, f"3j: the edited input processed {redone} batches, not {n_batches}")
        sm2.finalize(out2)
        with open(out2, "rb") as f:
            check(len(f.read().splitlines()) == B_STREAM, "3j: the edited input's TSV lost lines")
    # the counted run is the first at 4096-read batches; the edited input's
    # run repeats it warm
    rates = {
        "stream_reads_per_s_delivered": B_STREAM / rerun_s, "stream_first_run_reads_per_s": B_STREAM / run_s,
        "stream_map_batch_reads_per_s": B_STREAM / batch_s,
    }
    print(json.dumps({
        "phase": "stream", "launches": launches, "reads": B_STREAM, "batches": n_batches, "mapped": n_mapped,
        "run_s": run_s, "rerun_s": rerun_s, "map_batch_s": batch_s, **rates, "resumed_batches": resumed, "edited_batches": redone,
        "seconds": time.perf_counter() - t_phase, "card": smi,
    }), flush=True)
    return launches, rates


def hmm_corpora(rng):
    """Phase 3k's models (ln probabilities) and sequences: {name: (kind,
    model arrays, sequences)}."""
    casino = tuple(np.log(np.asarray(a, np.float64)) for a in (
        [[0.95, 0.05], [0.1, 0.9]], [[1 / 6.0] * 6, [0.1, 0.1, 0.1, 0.1, 0.1, 0.5]], [0.5, 0.5],
    ))
    obs = rng.integers(0, 6, size=(HMM_B, HMM_T)).astype(np.int32)
    lens = rng.integers(1, HMM_T + 1, size=HMM_B)
    lens[:2] = [1, HMM_T]
    ragged = [rng.integers(0, 6, size=int(n)).astype(np.int32) for n in lens]
    S = len(CN_MEANS)
    A = np.full((S, S), (1 - CN_STAY) / (S - 1))
    np.fill_diagonal(A, CN_STAY)
    states = np.empty((HMM_GAUSS_B, HMM_T), np.int64)
    states[:, 0] = rng.integers(0, S, size=HMM_GAUSS_B)
    cum = np.cumsum(A, axis=1)
    u = rng.random(size=(HMM_GAUSS_B, HMM_T))
    for t in range(1, HMM_T):
        states[:, t] = np.minimum((u[:, t, None] > cum[states[:, t - 1]]).sum(axis=1), S - 1)
    depth = rng.normal(np.asarray(CN_MEANS)[states], np.asarray(CN_SDS)[states]).astype(np.float32)
    gauss = (np.log(A), list(zip(CN_MEANS, CN_SDS)), np.log(np.full(S, 1.0 / S)))
    Sw, Vw, Bw, Tw = HMM_WIDE
    # the wide model has an end vector, so the checks below reach the
    # kernels' use of it (Viterbi's last argmax, forward's total, the
    # backward start value)
    wide = tuple(np.log(a) for a in (
        rng.dirichlet(np.ones(Sw), size=Sw), rng.dirichlet(np.ones(Vw), size=Sw), rng.dirichlet(np.ones(Sw)),
        rng.dirichlet(np.ones(Sw)),
    ))
    return {
        "casino": ("discrete", casino, list(obs)),
        "ragged": ("discrete", casino, ragged),
        "gaussian": ("gaussian", gauss, list(depth)),
        "wide": ("discrete", wide, list(rng.integers(0, Vw, size=(Bw, Tw)).astype(np.int32))),
    }


def hmm_ops_count(lens, S: int, gauss: bool, vit: bool) -> int:
    """The operations one scan needs on these lengths (see HMM_*_OPS)."""
    steps = int(np.sum(np.asarray(lens, np.int64) - 1))
    e = HMM_GAUSS_OPS if gauss else 0
    if vit:
        return steps * S * (HMM_VIT_OPS_PER_CAND * S + HMM_VIT_OPS_STEP + e) + steps
    return steps * S * (HMM_LSE_OPS_PER_CAND * S + HMM_LSE_OPS_STEP + e)


def path_logprob(kind, arrays, seq, path) -> float:
    """A path's float64 ln probability under the model (pi, emissions,
    transitions; no end: the oracle's Viterbi takes none)."""
    A = arrays[0]
    if kind == "gaussian":
        mu = np.array([m for m, _ in arrays[1]])
        sd = np.array([s for _, s in arrays[1]])
        x = np.asarray(seq, np.float64)
        em = -0.5 * np.log(2 * np.pi) - np.log(sd[path]) - 0.5 * ((x - mu[path]) / sd[path]) ** 2
    else:
        em = arrays[1][path, np.asarray(seq)]
    return float(arrays[2][path[0]] + em.sum() + A[path[:-1], path[1:]].sum())


def hmm_phase(torch, dev, seed: int, counters: dict, smi: str, kernels: list):
    """Phase 3k, the HMM with the launch counters at 0 (see the module
    docstring), then its three kernels against their plain versions.
    Returns (the counted launches, the rates)."""
    from rust_bio_tpu_torch.ops import hmm as hmm_ops
    from rust_bio_tpu_torch.stats import hmm as oracle
    from rust_bio_tpu_torch.stats.hmm.device import BatchDiscreteHMM, BatchGaussianHMM, baum_welch_batch

    rng = np.random.default_rng((seed, 11))
    t_phase = time.perf_counter()
    sets = hmm_corpora(rng)

    def make(kind, arrays, device):
        cls = BatchGaussianHMM if kind == "gaussian" else BatchDiscreteHMM
        return cls(*arrays, device=device)

    models = {name: make(kind, arrays, dev) for name, (kind, arrays, _) in sets.items()}
    for k in counters.values():
        k.launches = 0
    out, delivered_s = {}, {}
    for name, (kind, arrays, seqs) in sets.items():
        m = models[name]
        t0 = time.perf_counter()
        out[name] = (m.viterbi_batch(seqs), m.forward_batch(seqs), m.backward_batch(seqs))
        delivered_s[name] = time.perf_counter() - t0
    bw_seqs = sets["casino"][2][:HMM_BW_B]
    t0 = time.perf_counter()
    bw_model, lls = baum_welch_batch(models["casino"], bw_seqs, n_iter=HMM_BW_ITER)
    torch.cuda.synchronize()
    bw_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    path = ("hmm_viterbi", "hmm_forward", "hmm_backward")
    check(all(launches[n] > 0 for n in path), f"3k: an HMM kernel did not launch: {launches}")
    summary = {}
    for name, (kind, arrays, seqs) in sets.items():
        (paths, prob), (fv, ft), (bv, bt) = out[name]
        B, T, S = len(seqs), max(len(x) for x in seqs), arrays[0].shape[0]
        check(paths.shape == (B, T) and fv.shape == bv.shape == (B, T, S), f"3k {name}: output shapes")
        check(np.isfinite(prob).all() and np.isfinite(ft).all() and np.isfinite(bt).all(), f"3k {name}: a total is not finite")
        check(((paths >= 0) & (paths < S)).all(), f"3k {name}: a path state outside the model")
        tot_err = float((np.abs(ft - bt) / np.maximum(1, np.abs(ft))).max())
        check(tot_err <= 2e-4, f"3k {name}: forward and backward totals part by {tot_err}")
        summary[name] = {"sequences": B, "T": T, "S": S, "fwd_bwd_total_rel_err": tot_err, "delivered_s": delivered_s[name]}
    # Baum-Welch: the log-likelihoods do not fall (float32 E-step noise
    # allowed: 1e-6 of the total); the emission rows log-sum to 0 within
    # 1e-6; the transition rows within 5e-5 (the float32 backward rows'
    # rounding at |b| near 1000 leaves them about 1e-5 off on the card and
    # 2e-5 in the JAX class: tests/test_torch_hmm.py
    # test_baum_welch_rows_as_jax)
    check(all(b >= a - 1e-6 * abs(a) for a, b in zip(lls, lls[1:])), f"3k: Baum-Welch log-likelihoods fell: {lls}")
    lse_rows = lambda t: np.log(np.exp(t.cpu().numpy().astype(np.float64)).sum(axis=-1))  # noqa: E731
    a_rows, b_rows = float(np.abs(lse_rows(bw_model.A)).max()), float(np.abs(lse_rows(bw_model.Bm)).max())
    check(b_rows <= 1e-6 and a_rows <= 5e-5, f"3k: Baum-Welch rows log-sum to {a_rows} (A), {b_rows} (Bm)")
    check(bw_model.device == dev, "3k: the trained model is not on the card")
    # the host oracle on 16 sequences of the casino and Gaussian corpora
    oracle_rows = {}
    for name in ("casino", "gaussian"):
        kind, arrays, seqs = sets[name]
        probs = tuple(np.exp(a) if not isinstance(a, list) else a for a in arrays)
        om = (oracle.GaussianModel if kind == "gaussian" else oracle.DiscreteEmissionModel).with_float(*probs)
        (paths, prob), (_, ft), (_, bt) = out[name]
        same, worst_tot, worst_path = 0, 0.0, 0.0
        for b in range(HMM_SEQ_ORACLE):
            seq = [float(v) for v in seqs[b]] if kind == "gaussian" else [int(v) for v in seqs[b]]
            o_path, o_prob = oracle.viterbi(om, seq)
            f_tot, b_tot = float(oracle.forward(om, seq)[1]), float(oracle.backward(om, seq)[1])
            worst_tot = max(worst_tot, abs(ft[b] - f_tot) / abs(f_tot), abs(bt[b] - b_tot) / abs(b_tot))
            worst_path = max(worst_path, abs(path_logprob(kind, arrays, seqs[b], paths[b]) - float(o_prob)))
            same += paths[b].tolist() == o_path
        check(worst_tot <= 2e-4, f"3k {name}: a total parts from the host oracle by {worst_tot} relative")
        check(worst_path <= 1e-3, f"3k {name}: a path scores {worst_path} off the oracle's best")
        oracle_rows[name] = {"sequences": HMM_SEQ_ORACLE, "equal_paths": same, "total_rel_err": worst_tot, "path_logprob_err": worst_path}
    # the port's CPU path: 64 sequences a corpus, and Baum-Welch on 64
    cpu_rows = {}
    for name, (kind, arrays, seqs) in sets.items():
        cm = make(kind, arrays, "cpu")
        sub = seqs[:HMM_SEQ_CPU]
        gm = models[name]
        (cp, cprob), (cfv, cft), (cbv, cbt) = cm.viterbi_batch(sub), cm.forward_batch(sub), cm.backward_batch(sub)
        (gp, gprob), (gfv, gft), (gbv, gbt) = gm.viterbi_batch(sub), gm.forward_batch(sub), gm.backward_batch(sub)
        check(np.array_equal(cp, gp), f"3k {name}: Viterbi paths on the card != the CPU path")
        err = max(rel_err(g, c) for g, c in ((gprob, cprob), (gfv, cfv), (gft, cft), (gbv, cbv), (gbt, cbt)))
        check(err <= CPU_PATH_F32_TOL, f"3k {name}: the card parts from the CPU path by {err}")
        cpu_rows[name] = {"viterbi_prob_bit_equal": bool(np.array_equal(gprob, cprob)), "max_err": err}
    # Baum-Welch on 64 sequences against the CPU path: the log-likelihoods
    # within 1e-5 relative; the trained ln parameters within 3e-5 (each is
    # a sum of f + b - ln P(x) over 64 sequences, terms near 1700 in size
    # whose float32 rounding parts where the card's exp/log and the host's
    # differ by an ulp: the largest parted by 1.06e-5 on an H100)
    cm, c_lls = baum_welch_batch(make("discrete", sets["casino"][1], "cpu"), bw_seqs[:HMM_SEQ_CPU], n_iter=HMM_BW_ITER)
    gm, g_lls = baum_welch_batch(models["casino"], bw_seqs[:HMM_SEQ_CPU], n_iter=HMM_BW_ITER)
    bw_errs = {n: float((getattr(gm, n).cpu() - getattr(cm, n)).abs().max()) for n in ("A", "Bm", "pi")}
    bw_err = max(bw_errs.values())
    ll_err = float(np.max(np.abs(np.subtract(g_lls, c_lls)) / np.abs(c_lls)))
    check(bw_err <= 3e-5 and ll_err <= 1e-5, f"3k: Baum-Welch on the card parts from the CPU path by {bw_errs}, lls {ll_err}")
    # sequences/s: device-only (device tensors through the class's scans,
    # with the wrappers' input check) and delivered (Python sequences to
    # numpy outputs), the casino corpus
    m = models["casino"]
    obs_d, lens_d = m._pad(sets["casino"][2])
    rates = {}
    for scan in ("viterbi", "forward", "backward"):
        rates[f"hmm_{scan}_seqs_per_s_device"] = HMM_B / host_s(torch, lambda f=getattr(m, "_" + scan): f(obs_d, lens_d), 5)
        rates[f"hmm_{scan}_seqs_per_s_delivered"] = HMM_B / host_s(
            torch, lambda f=getattr(m, scan + "_batch"): f(sets["casino"][2]), 2
        )
    rates["hmm_baum_welch_s"] = bw_s
    print(json.dumps({
        "phase": "hmm", "launches": launches, **summary, "baum_welch": {
            "sequences": HMM_BW_B, "iterations": HMM_BW_ITER, "log_likelihoods": lls, "A_row_lse": a_rows,
            "Bm_row_lse": b_rows, "seconds": bw_s, "cpu_max_err": bw_errs, "cpu_ll_rel_err": ll_err,
        }, "oracle": oracle_rows, "cpu_path": cpu_rows, **rates,
        "seconds": time.perf_counter() - t_phase, "card": smi,
    }), flush=True)

    # the kernels against their plain versions on the card, each corpus;
    # ms: the launch alone into outputs made once (the wrapper's input
    # check syncs the host)
    sources = {
        "hmm_viterbi": ("rust_bio_tpu/stats/hmm/device.py:105", hmm_ops.HMM_VITERBI, hmm_ops.viterbi, hmm_ops.viterbi_plain),
        "hmm_forward": ("rust_bio_tpu/stats/hmm/device.py:142", hmm_ops.HMM_FORWARD, hmm_ops.forward, hmm_ops.forward_plain),
        "hmm_backward": ("rust_bio_tpu/stats/hmm/device.py:168", hmm_ops.HMM_BACKWARD, hmm_ops.backward, hmm_ops.backward_plain),
    }
    per = {n: {} for n in sources}
    for name, (kind, arrays, seqs) in sets.items():
        m = models[name]
        obs_d, lens_d = m._pad(seqs)
        args = (m.A, m._emit_table(), m.pi, m.end, obs_d, lens_d)
        B, T = obs_d.shape
        S = m.A.shape[0]
        gauss = kind == "gaussian"
        V = 0 if gauss else m.Bm.shape[1]
        lens_np = lens_d.cpu().numpy()
        in_bytes = obs_d.numel() * 4 + B * 4 + 4 * (S * S + m._emit_table().numel() + 2 * S)
        for kname, (replaces, kernel, fn, plain) in sources.items():
            got = fn(*args)
            torch.cuda.synchronize()
            want, plain_ms = timed_once(torch, lambda: plain(*args))
            if kname == "hmm_viterbi":
                check(torch.equal(got[0], want[0]), f"{kname} {name}: paths differ from the plain version")
                err = rel_err(got[1].cpu().numpy(), want[1].cpu().numpy())
                check(err == 0 if not gauss else err <= 1e-6, f"{kname} {name}: probs part from the plain version by {err}")
                outs = (torch.empty((B, T, S), dtype=torch.uint8, device=dev), torch.empty_like(got[0]), torch.empty_like(got[1]))
                out_bytes = B * T * 4 + B * 4
            else:
                err = max(rel_err(g.cpu().numpy(), w.cpu().numpy()) for g, w in zip(got, want))
                check(err <= 1e-4, f"{kname} {name}: {err} from the plain version (tolerance 1e-4 of max(1, |x|))")
                outs = (torch.empty_like(got[0]), torch.empty_like(got[1]))
                out_bytes = B * T * S * 4 + B * 4
            M = m.A.t().contiguous() if kname == "hmm_backward" else m.A
            ms = cuda_ms(torch, lambda: hmm_ops.launch_only(kernel, M, *args[1:], V, gauss, *outs), 5)
            nbytes = in_bytes + out_bytes
            nops = hmm_ops_count(lens_np, S, gauss, kname == "hmm_viterbi")
            byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
            per[kname][name] = {
                "ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations", "bytes": nbytes, "ops": nops,
                "geometry": hmm_ops.geometry(S),
            }
    for kname, (replaces, kernel, _, _) in sources.items():
        main_row = per[kname]["casino"]
        row = {
            "name": kname, "route": "cuda", "source": "rust_bio_tpu_torch/ops/csrc/hmm.cu", "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max(r["max_abs_err"] for r in per[kname].values()),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
        }
        kernels.append(row)
        print(json.dumps({"phase": "kernel", **row, "tolerance": 0 if kname == "hmm_viterbi" else 1e-4,
                          "corpora": per[kname], "peak": "f32 67 TFLOP/s", "card": smi}), flush=True)
    return launches, rates

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    sys.path.insert(0, str(ROOT))
    try:
        import rust_bio_tpu_torch
    except ImportError as e:
        fail(f"rust_bio_tpu_torch not importable next to this script: {e}")
    check(Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(ROOT), "package outside this checkout")

    from rust_bio_tpu_torch import native
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, BatchBandedAligner, Scoring, banded
    from rust_bio_tpu_torch.alignment.pairwise import banded_device
    from rust_bio_tpu_torch.alignment.pairwise.batched import _columns_fixups, _fixed_column
    from rust_bio_tpu_torch.alignment.pairwise.tb import (
        TB_DEL, TB_MATCH, TB_SUBST, TB_XCLIP_SUFFIX, TB_YCLIP_PREFIX, TB_YCLIP_SUFFIX,
    )
    from rust_bio_tpu_torch.alphabets import Alphabet, dna
    from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
    from rust_bio_tpu_torch.data_structures.suffix_array import suffix_array_host
    from rust_bio_tpu_torch.ops import _build, fm, fmd, pairhmm, sw, walk
    from rust_bio_tpu_torch.ops import hmm as hmm_ops
    from rust_bio_tpu_torch.pipelines import ReadMapper
    from rust_bio_tpu_torch.scores import blosum62, dense_matrix, pam250
    from rust_bio_tpu_torch.stats.pairhmm import (
        BatchHomopolyPairHMM, BatchPairHMM, BatchPairHMMExact, BatchPairHMMLinear,
    )

    dev = torch.device(DEVICE)
    smi = nvidia_smi_line()
    print(f"card: {smi}", flush=True)

    # ---- 1. build ------------------------------------------------------
    # the host band builder compiles beside nvcc, so that phase 3f's timed
    # calls do not include its first-use build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.get_lib)
        _build.build()
        host_lib.result()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_flags": " ".join(_build.NVCC_FLAGS)}), flush=True)
    counters = {
        "sw_scan_global": sw.SCAN_GLOBAL,
        "sweep_walk_global": walk.SWEEP_WALK_GLOBAL,
        "sw_scores_global": sw.SCORES_GLOBAL_WARP,
        "sw_scores_global_rows": sw.SCORES_GLOBAL_ROWS,
        "fm_backward_search": fm.FM_BACKWARD_SEARCH,
        "fm_locate": fm.FM_LOCATE,
        "rle_merge": walk.RLE_MERGE,
        "fm_search_lut": fm.FM_SEARCH_LUT,
        "fm_search_lut_u32": fm.FM_SEARCH_LUT_U32,
        "fm_backward_search_u32": fm.FM_BACKWARD_SEARCH_U32,
        "fm_locate_u32": fm.FM_LOCATE_U32,
        "fmd_smems": fmd.FMD_SMEMS,
        "sw_scan_semiglobal": sw.SCAN_SEMIGLOBAL,
        "sweep_walk_semiglobal": walk.SWEEP_WALK_SEMIGLOBAL,
        "sw_scan_local": sw.SCAN_LOCAL,
        "sweep_walk_local": walk.SWEEP_WALK_LOCAL,
        "sw_scan_custom": sw.SCAN_CUSTOM,
        "sweep_walk_custom": walk.SWEEP_WALK_CUSTOM,
        "sw_scan_global_lut": sw.SCAN_GLOBAL_LUT,
        "sw_scores_global_lut": sw.SCORES_GLOBAL_LUT,
        "sw_scan_semiglobal_lut": sw.SCAN_SEMIGLOBAL_LUT,
        "sw_scan_local_lut": sw.SCAN_LOCAL_LUT,
        "sw_scan_custom_lut": sw.SCAN_CUSTOM_LUT,
        "sw_scan_global_rows": sw.SCAN_GLOBAL_ROWS,
        "sw_scan_global_rows_lut": sw.SCAN_GLOBAL_ROWS_LUT,
        "sweep_walk_global_seg": walk.SWEEP_WALK_GLOBAL_SEG,
        "sw_scan_columns": sw.SCAN_COLUMNS,
        "sw_scan_columns_lut": sw.SCAN_COLUMNS_LUT,
        "walk_steps": walk.WALK_STEPS,
        "sw_scan_banded": sw.SCAN_BANDED,
        "walk_banded": walk.WALK_BANDED,
        "pairhmm_fwd_scaled": pairhmm.PAIRHMM_FWD_SCALED,
        "pairhmm_fwd_log": pairhmm.PAIRHMM_FWD_LOG,
        "pairhmm_fwd_exact": pairhmm.PAIRHMM_FWD_EXACT,
        "pairhmm_fwd_homopoly": pairhmm.PAIRHMM_FWD_HOMOPOLY,
        "hmm_viterbi": hmm_ops.HMM_VITERBI,
        "hmm_forward": hmm_ops.HMM_FORWARD,
        "hmm_backward": hmm_ops.HMM_BACKWARD,
    }

    # ---- data, made from the seed ------------------------------------
    rng = np.random.default_rng(args.seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    xb = acgt[rng.integers(0, 4, size=(B_ALN, LEN))]
    yb = acgt[rng.integers(0, 4, size=(B_ALN, LEN))]
    yb_hi = xb.copy()
    mut = rng.random(size=(B_ALN, LEN)) < 0.02
    yb_hi[mut] = acgt[rng.integers(0, 4, size=int(mut.sum()))]
    corpora = {
        "random": ([bytes(r) for r in xb], [bytes(r) for r in yb]),
        "diverged2pct": ([bytes(r) for r in xb], [bytes(r) for r in yb_hi]),
    }
    text_arr, starts, pats_np = fm_corpus(rng)
    # scripts/time_fm.py and fm_trial.py time these inputs through fm_inputs
    check(np.array_equal(fm_inputs(args.seed)[2], pats_np), "fm_inputs no longer draws main()'s FM corpus")
    text = text_arr.tobytes()
    n_sampled = B_FM // 2
    queries = [bytes(r) for r in pats_np]
    # mapper reads: four batches of 150 bp from the text (the genome), 1%
    # substitutions, every second one reverse-complemented; the first
    # batch plus 256 random reads is the main batch
    genome = text[:-1]
    n_reads = 4 * B_READS
    origins = rng.integers(0, TEXT_LEN - READ_LEN, size=n_reads)
    oriented_np = text_arr[origins[:, None] + np.arange(READ_LEN)[None, :]].copy()
    rmut = rng.random(size=oriented_np.shape) < 0.01
    oriented_np[rmut] = acgt[(np.searchsorted(acgt, oriented_np[rmut]) + rng.integers(1, 4, size=int(rmut.sum()))) % 4]
    is_rev = np.arange(n_reads) % 2 == 1
    oriented = [bytes(r) for r in oriented_np]
    reads = [dna.revcomp(o) if r else o for o, r in zip(oriented, is_rev)]
    main_reads = reads[:B_READS] + [bytes(r) for r in acgt[rng.integers(0, 4, size=(B_RANDOM, READ_LEN))]]
    clean_seed = np.zeros(n_reads, bool)
    for s0 in SEED_STARTS:
        clean_seed |= ~rmut[:, s0 : s0 + SEED_LEN].any(axis=1)
    # the mapper's extension batch: the oriented reads against their
    # windows (origin -/+ FLANK), as the mapper builds it for seeded reads
    ws = np.maximum(origins[:B_READS] - FLANK, 0)
    nl_ext = (np.minimum(origins[:B_READS] + READ_LEN + FLANK, TEXT_LEN) - ws).astype(np.int32)
    W = int(nl_ext.max())
    yb_ext = text_arr[ws[:, None] + np.arange(W)[None, :]]
    yb_ext[np.arange(W)[None, :] >= nl_ext[:, None]] = 0
    xb_ext = oriented_np[:B_READS]
    ml_ext = np.full(B_READS, READ_LEN, np.int32)
    # the custom corpus: those reads with their first a and last b bases
    # replaced by random ones, against the same windows
    xb_clip = xb_ext.copy()
    junk = rng.integers(0, MAX_JUNK + 1, size=(B_READS, 2))
    cols_np = np.arange(READ_LEN)[None, :]
    ends = (cols_np < junk[:, :1]) | (cols_np >= READ_LEN - junk[:, 1:])
    xb_clip[ends] = acgt[rng.integers(0, 4, size=int(ends.sum()))]
    custom_xs = [bytes(r) for r in xb_clip]
    custom_ys = [bytes(yb_ext[k, : nl_ext[k]]) for k in range(B_READS)]
    (hxs, hys), (dxs, dys) = protein_corpora(rng)
    rand_bytes = [rng.integers(0, 256, size=int(rng.integers(1, 81))).astype(np.uint8).tobytes() for _ in range(512)]
    long_sets = long_corpora(rng)
    # 3e's flanks from a stream of their own, so the draws above stay as they were
    clip_sets = long_clip_corpora(np.random.default_rng((args.seed, 3)), long_sets)
    band_reads, kb_set = band_corpora(np.random.default_rng((args.seed, 4)))
    (hbx, hby), (hox, hoy), (gx, gy, gxl, gyl, gep) = pairhmm_corpora(np.random.default_rng((args.seed, 5)))

    # ---- 2. the global path, counted ----------------------------------
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()
    sc = Scoring.from_scores(GO, GE, MA, MI)
    ba = BatchAligner(sc, device=dev)
    results = {}
    for name, (xs, ys) in corpora.items():
        alns = ba.global_(xs, ys)
        scores = ba.scores(xs, ys, "global")
        check(len(alns) == B_ALN and scores.shape == (B_ALN,), f"{name}: result count")
        check(all(int(s) == a.score for s, a in zip(scores, alns)), f"{name}: scores() != global_ scores")
        for k, (a, x, y) in enumerate(zip(alns, xs, ys)):
            check(rescore([op.kind for op in a.operations], x, y) == (a.score, len(x), len(y)), f"{name}: pair {k} does not re-score to {a.score}")
            check((a.xstart, a.ystart, a.xend, a.yend) == (0, 0, len(x), len(y)), f"{name}: pair {k} coordinates")
        results[name] = alns
    # the compact path (bench.py:1325-1360): the 2%-divergence pairs with the
    # run merge on the card (K-merge), once alone and as COMPACT_HANDLES
    # handles finished with one pull; every CIGAR global_packed's, no lane
    # past R runs
    ml_np = np.full(B_ALN, LEN, np.int32)
    dense_cigars = ba.global_packed(*corpora["diverged2pct"]).cigars()
    comp = BatchAligner.packed_compact_finish(ba.global_packed_compact_async_arrays(xb, yb_hi, ml_np, ml_np))
    check(not comp.overflow.any(), "compact: a 2%-divergence lane overflowed R runs")
    check(comp.cigars() == dense_cigars, "compact: CIGARs != global_packed(...).cigars()")
    many = BatchAligner.packed_compact_finish_many(
        [ba.global_packed_compact_async_arrays(xb, yb_hi, ml_np, ml_np) for _ in range(COMPACT_HANDLES)]
    )
    check(all(not m.overflow.any() and m.cigars() == dense_cigars for m in many), "compact: finish_many != global_packed")
    compact_runs = comp._up["n_runs"]
    t0 = time.perf_counter()
    index = DeviceFMIndex.from_text(text, dna.n_alphabet(), sampling_rate=32, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    found = index.backward_search_batch(queries)
    sampled = found[:n_sampled]
    check(all(r.kind.value == "complete" for r in sampled), "a sampled query is not COMPLETE")
    lows = np.array([r.interval.lower for r in sampled])
    highs = np.array([r.interval.upper for r in sampled])
    fm_rows = interval_rows(lows, highs)
    pos = index.locate_batch(fm_rows)
    owner = np.repeat(np.arange(n_sampled), highs - lows)
    hit = np.zeros(n_sampled, bool)
    hit[owner[pos == starts[owner]]] = True
    check(bool(hit.all()), "locate: a sampled query's interval misses its start")
    for q in range(0, n_sampled, n_sampled // 64):
        check(starts[q] in index.locate_interval(sampled[q].interval), f"locate_interval: query {q}")
    launches = {name: k.launches for name, k in counters.items()}
    path_kernels = ("sw_scan_global", "sweep_walk_global", "sw_scores_global", "fm_backward_search", "fm_locate", "rle_merge")
    check(all(launches[n] > 0 for n in path_kernels), f"a kernel of the global path did not launch: {launches}")
    print(json.dumps({
        "phase": "main_path", "launches": launches, "fm_index_build_s": build_s,
        "compact_runs_max": int(compact_runs.max()), "compact_runs_mean": float(compact_runs.mean()),
        "seconds": time.perf_counter() - t_phase,
    }), flush=True)

    # small-input reference: the plain PyTorch path on the CPU, and a
    # brute-force count of pattern occurrences in the text
    cpu = BatchAligner(sc, device="cpu")
    for name, (xs, ys) in corpora.items():
        want = cpu.global_(xs[:64], ys[:64])
        check([fields(a) for a in results[name][:64]] == [fields(a) for a in want], f"{name}: card != CPU plain path")
    for q in list(range(0, 64)) + list(range(B_FM - 64, B_FM)):
        p, occ, at = queries[q], 0, text.find(queries[q])
        while at >= 0:
            occ += 1
            at = text.find(p, at + 1)
        r = found[q]
        size = r.interval.upper - r.interval.lower if r.kind.value == "complete" else 0
        check(size == occ, f"query {q}: interval size {size}, text holds {occ}")

    # ---- 3. the read mapper, counted -------------------------------------
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    mapper = ReadMapper(
        genome, sc, seed_len=SEED_LEN, seed_tries=SEED_TRIES, flank=FLANK, sa_sampling_rate=32, device=dev
    )
    torch.cuda.synchronize()
    mapper_build_s = time.perf_counter() - t0
    mapped = mapper.map_batch(main_reads)
    mapper_launches = {name: k.launches for name, k in counters.items()}
    path_kernels = ("fm_backward_search", "fm_locate", "sw_scan_semiglobal", "sweep_walk_semiglobal")
    check(all(mapper_launches[n] > 0 for n in path_kernels), f"a kernel of the mapper did not launch: {mapper_launches}")
    # the mapper's extension pairs through the compact path, counted apart;
    # the dense CIGARs come from the native emitter, which must equal the
    # numpy merge
    for k in counters.values():
        k.launches = 0
    dense_ext = ba.semiglobal_packed_finish(ba.semiglobal_packed_async_arrays(xb_ext, yb_ext, ml_ext, nl_ext))
    ext_cigars = dense_ext.cigars()
    check(ext_cigars == dense_ext.cigars_plain(), "the native CIGAR emitter != the numpy merge")
    semi_comp = BatchAligner.packed_compact_finish(ba.semiglobal_packed_compact_async_arrays(xb_ext, yb_ext, ml_ext, nl_ext))
    check(np.array_equal(semi_comp.score, dense_ext.score), "compact semiglobal: scores != the dense path's")
    check(semi_comp.cigars() == ext_cigars, "compact semiglobal: CIGARs != the dense path's")
    compact_launches = {name: k.launches for name, k in counters.items()}
    path_kernels = ("sw_scan_semiglobal", "sweep_walk_semiglobal", "rle_merge")
    check(all(compact_launches[n] > 0 for n in path_kernels), f"a kernel of the compact semiglobal path did not launch: {compact_launches}")
    check(len(mapped) == len(main_reads), "mapper: result count")
    exempt = []  # reads whose seed also occurs elsewhere in the genome
    # reads with a clean seed that map elsewhere than their origin (an end
    # substitution can make an indel alignment score more): held to the
    # port's CPU path instead
    off_origin = []
    for k, (read, m) in enumerate(zip(main_reads, mapped)):
        rc = dna.revcomp(read)
        if m.pos >= 0:
            x = read if m.strand == "+" else rc
            got = rescore(cigar_kinds(m.cigar), x, genome[m.pos : m.pos + 2 * READ_LEN])
            check(got is not None and got[:2] == (m.score, len(x)), f"read {k}: CIGAR {m.cigar} does not re-score to {m.score} over the read")
        if k < B_READS:
            want = (int(origins[k]), "-" if is_rev[k] else "+")
            if clean_seed[k] and (m.pos, m.strand) != want:
                if seeds_hit_elsewhere(genome, (read, rc), oriented[k], want[0]):
                    exempt.append(k)
                else:
                    off_origin.append(k)
        elif m.pos >= 0:
            check(seeds_hit_elsewhere(genome, (read, rc), None, -1), f"random read {k} mapped to {m.pos}")
            exempt.append(k)
    cpu_mapper = mapper.to("cpu")
    if off_origin:
        held = cpu_mapper.map_batch([main_reads[k] for k in off_origin])
        for k, c in zip(off_origin, held):
            m = mapped[k]
            check(
                (m.pos, m.strand, m.score, m.cigar) == (c.pos, c.strand, c.score, c.cigar),
                f"read {k}: mapped to {(m.pos, m.strand, m.score, m.cigar)}, the CPU path to {(c.pos, c.strand, c.score, c.cigar)}",
            )
    n_mapped = sum(m.pos >= 0 for m in mapped)
    print(json.dumps({
        "phase": "mapper", "launches": mapper_launches, "reads": len(main_reads), "mapped": n_mapped,
        "clean_seed_reads": int(clean_seed[:B_READS].sum()), "exempt_repeat_seeds": exempt,
        "off_origin_held_to_cpu": len(off_origin), "off_origin_reads": off_origin,
        "compact_semiglobal_overflow": int(semi_comp.overflow.sum()), "compact_semiglobal_launches": compact_launches,
        "mapper_index_build_s": mapper_build_s, "seconds": time.perf_counter() - t_phase,
    }), flush=True)
    # small-input reference: 64 reads through the port's CPU path, on the
    # card-built index moved to the CPU
    sample = list(range(60)) + list(range(len(main_reads) - 4, len(main_reads)))
    on_cpu = cpu_mapper.map_batch([main_reads[k] for k in sample])

    def mkey(m):
        return (m.pos, m.strand, m.score, m.cigar, None if m.alignment is None else fields(m.alignment))

    check([mkey(mapped[k]) for k in sample] == [mkey(m) for m in on_cpu], "mapper: card != CPU plain path")
    launches = {name: launches[name] + mapper_launches[name] + compact_launches[name] for name in counters}

    # ---- 3b. local and custom alignment, counted ---------------------------
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()
    local_out = {}
    for name, (xs, ys) in corpora.items():
        alns = ba.local(xs, ys)
        scores = ba.scores(xs, ys, "local")
        check(len(alns) == B_ALN and scores.shape == (B_ALN,), f"local {name}: result count")
        check(all(int(s) == a.score for s, a in zip(scores, alns)), f"local {name}: scores() != local scores")
        for k, (a, x, y) in enumerate(zip(alns, xs, ys)):
            got = rescore([op.kind for op in a.operations], x[a.xstart : a.xend], y[a.ystart : a.yend])
            check(got == (a.score, a.xend - a.xstart, a.yend - a.ystart), f"local {name}: pair {k} does not re-score to {a.score}")
        local_out[name] = alns
    csc = Scoring.from_scores(*CUSTOM_PENS).xclip(CUSTOM_XCLIP).yclip(CUSTOM_YCLIP)
    bac = BatchAligner(csc, device=dev)
    custom_alns = bac.custom(custom_xs, custom_ys)
    custom_scores = bac.scores(custom_xs, custom_ys, "custom")
    check(len(custom_alns) == B_READS and custom_scores.shape == (B_READS,), "custom: result count")
    check(all(int(s) == a.score for s, a in zip(custom_scores, custom_alns)), "custom: scores() != custom scores")
    n_clipped = 0
    for k, (a, x, y) in enumerate(zip(custom_alns, custom_xs, custom_ys)):
        ops = [(op.kind, op.len) for op in a.operations]
        got = rescore_ops(ops, x, y, CUSTOM_PENS, CUSTOM_XCLIP, CUSTOM_YCLIP)
        check(got == (a.score, len(x), len(y)), f"custom: pair {k} does not re-score to {a.score} over both sequences: {got}")
        n_clipped += any(kind == "Xclip" for kind, _ in ops)
    clip_launches = {name: k.launches for name, k in counters.items()}
    path_kernels = ("sw_scan_local", "sweep_walk_local", "sw_scan_custom", "sweep_walk_custom")
    check(all(clip_launches[n] > 0 for n in path_kernels), f"a kernel of the local/custom path did not launch: {clip_launches}")
    cpu_c = BatchAligner(csc, device="cpu")
    for name, (xs, ys) in corpora.items():
        check([fields(a) for a in local_out[name][:64]] == [fields(a) for a in cpu.local(xs[:64], ys[:64])], f"local {name}: card != CPU plain path")
    check([fields(a) for a in custom_alns[:64]] == [fields(a) for a in cpu_c.custom(custom_xs[:64], custom_ys[:64])], "custom: card != CPU plain path")
    print(json.dumps({
        "phase": "local_custom", "launches": clip_launches, "local_pairs": 2 * B_ALN, "custom_pairs": B_READS,
        "custom_with_xclip": n_clipped, "custom_mean_score": float(np.mean(custom_scores)),
        "seconds": time.perf_counter() - t_phase,
    }), flush=True)
    launches = {name: launches[name] + clip_launches[name] for name in counters}

    # ---- 3c. protein alignment under BLOSUM62, counted -------------------
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()
    psc = Scoring.new(PROT_GO, PROT_GE, blosum62)
    csc_p = psc.xclip(DOMAIN_XCLIP).yclip(DOMAIN_YCLIP)
    bp = BatchAligner(psc, device=dev)
    bpc = BatchAligner(csc_p, device=dev)
    lut_l = dense_matrix("blosum62").tolist()
    ppens = (PROT_GO, PROT_GE, None, None)
    prot = {
        "global": bp.global_(hxs, hys),
        "local": bp.local(hxs, hys),
        "semiglobal": bp.semiglobal(dxs, dys),
        "custom": bpc.custom(dxs, dys),
    }
    prot_scores = {
        "global": bp.scores(hxs, hys, "global"),
        "local": bp.scores(hxs, hys, "local"),
        "semiglobal": bp.scores(dxs, dys, "semiglobal"),
        "custom": bpc.scores(dxs, dys, "custom"),
    }
    cig_global = bp.global_packed(hxs, hys).cigars()
    cig_semi = bp.semiglobal_packed(dxs, dys).cigars()
    prot_launches = {name: k.launches for name, k in counters.items()}
    path_kernels = (
        "sw_scan_global_lut", "sweep_walk_global", "sw_scores_global_lut", "sw_scan_semiglobal_lut",
        "sweep_walk_semiglobal", "sw_scan_local_lut", "sweep_walk_local", "sw_scan_custom_lut", "sweep_walk_custom",
    )
    check(all(prot_launches[n] > 0 for n in path_kernels), f"a kernel of the protein path did not launch: {prot_launches}")
    for mode, alns in prot.items():
        check(len(alns) == B_PROT and prot_scores[mode].shape == (B_PROT,), f"protein {mode}: result count")
        check(all(int(sc_) == a.score for sc_, a in zip(prot_scores[mode], alns)), f"protein {mode}: scores() != alignment scores")
    for k, (a, x, y) in enumerate(zip(prot["global"], hxs, hys)):
        got = rescore_ops([(op.kind, 0) for op in a.operations], x, y, ppens, lut=lut_l)
        check(got == (a.score, len(x), len(y)), f"protein global: pair {k} does not re-score to {a.score} over both sequences")
    for k, (a, x, y) in enumerate(zip(prot["local"], hxs, hys)):
        got = rescore_ops([(op.kind, 0) for op in a.operations], x[a.xstart : a.xend], y[a.ystart : a.yend], ppens, lut=lut_l)
        check(got == (a.score, a.xend - a.xstart, a.yend - a.ystart), f"protein local: pair {k} does not re-score to {a.score}")
    for k, (a, x, y) in enumerate(zip(prot["semiglobal"], dxs, dys)):
        got = rescore_ops([(op.kind, 0) for op in a.operations], x, y[a.ystart : a.yend], ppens, lut=lut_l)
        check(got == (a.score, len(x), a.yend - a.ystart), f"protein semiglobal: pair {k} does not re-score to {a.score} over x")
    n_xclipped = 0
    for k, (a, x, y) in enumerate(zip(prot["custom"], dxs, dys)):
        ops = [(op.kind, op.len) for op in a.operations]
        got = rescore_ops(ops, x, y, ppens, DOMAIN_XCLIP, DOMAIN_YCLIP, lut=lut_l)
        check(got == (a.score, len(x), len(y)), f"protein custom: pair {k} does not re-score to {a.score} over both sequences")
        n_xclipped += any(kind == "Xclip" for kind, _ in ops)
    # the packed CIGARs spell the same operations as the alignments
    check(cig_global == [cigar_of(a.operations) for a in prot["global"]], "protein global_packed CIGARs != global_ operations")
    check(
        cig_semi == [cigar_of(a.operations) for a in prot["semiglobal"]],
        "protein semiglobal_packed CIGARs != semiglobal operations",
    )
    # small-input references: the CPU path, on 64 pairs of each mode, 256
    # homolog pairs under PAM250 and 256 random-byte pairs
    cpu_p, cpu_pc = BatchAligner(psc, device="cpu"), BatchAligner(csc_p, device="cpu")
    for mode, ref, (xs, ys) in (
        ("global", cpu_p, (hxs, hys)), ("local", cpu_p, (hxs, hys)),
        ("semiglobal", cpu_p, (dxs, dys)), ("custom", cpu_pc, (dxs, dys)),
    ):
        fn = "global_" if mode == "global" else mode
        want = getattr(ref, fn)(xs[:64], ys[:64])
        check([fields(a) for a in prot[mode][:64]] == [fields(a) for a in want], f"protein {mode}: card != CPU plain path")
    psc250 = Scoring.new(PROT_GO, PROT_GE, pam250)
    got = BatchAligner(psc250, device=dev).global_(hxs[:256], hys[:256])
    want = BatchAligner(psc250, device="cpu").global_(hxs[:256], hys[:256])
    check([fields(a) for a in got] == [fields(a) for a in want], "pam250 global: card != CPU plain path")
    rxs, rys = rand_bytes[:256], rand_bytes[256:]
    for mode, on_card, on_cpu in (("global", bp, cpu_p), ("semiglobal", bp, cpu_p), ("local", bp, cpu_p), ("custom", bpc, cpu_pc)):
        fn = "global_" if mode == "global" else mode
        got = getattr(on_card, fn)(rxs, rys)
        check([fields(a) for a in got] == [fields(a) for a in getattr(on_cpu, fn)(rxs, rys)], f"random bytes {mode}: card != CPU plain path")
        check(on_card.scores(rxs, rys, mode).tolist() == on_cpu.scores(rxs, rys, mode).tolist(), f"random bytes scores {mode}: card != CPU")
    print(json.dumps({
        "phase": "protein", "launches": prot_launches, "homolog_pairs": B_PROT, "domain_pairs": B_PROT,
        "mean_scores": {m: float(np.mean(v)) for m, v in prot_scores.items()}, "custom_with_xclip": n_xclipped,
        "homolog_max_len": [max(map(len, hxs)), max(map(len, hys))], "domain_max_len": [max(map(len, dxs)), max(map(len, dys))],
        "seconds": time.perf_counter() - t_phase,
    }), flush=True)
    launches = {name: launches[name] + prot_launches[name] for name in counters}
    del prot, prot_scores, cig_global, cig_semi

    # ---- 3d. long-sequence global alignment, counted -------------------------
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()
    long_runs = {}
    for name, (xs, ys), al in zip(("str", "insertion", "protein"), long_sets, (ba, ba, bp)):
        t0 = time.perf_counter()
        alns = al.global_(xs, ys)
        delivered_s = time.perf_counter() - t0
        long_runs[name] = (alns, al.global_packed(xs, ys).cigars(), al.scores(xs, ys, "global"), delivered_s)
    long_launches = {name: k.launches for name, k in counters.items()}
    path_kernels = ("sw_scan_global_rows", "sw_scan_global_rows_lut", "sweep_walk_global_seg", "sw_scores_global_rows", "sw_scores_global_lut")
    check(all(long_launches[n] > 0 for n in path_kernels), f"a kernel of the long global path did not launch: {long_launches}")
    long_summary = {}
    for name, (xs, ys), (al, ref, pens_, lut_) in zip(
        ("str", "insertion", "protein"), long_sets,
        ((ba, cpu, (GO, GE, MA, MI), None), (ba, cpu, (GO, GE, MA, MI), None), (bp, cpu_p, ppens, lut_l)),
    ):
        alns, cigs, scs, _ = long_runs[name]
        check(len(alns) == len(xs) and scs.shape == (len(xs),), f"long {name}: result count")
        check(all(int(s) == a.score for s, a in zip(scs, alns)), f"long {name}: scores() != global_ scores")
        for k, (a, x, y) in enumerate(zip(alns, xs, ys)):
            got = rescore_ops([(op.kind, 0) for op in a.operations], x, y, pens_, lut=lut_)
            check(got == (a.score, len(x), len(y)), f"long {name}: pair {k} does not re-score to {a.score} over both sequences")
            check((a.xstart, a.ystart, a.xend, a.yend) == (0, 0, len(x), len(y)), f"long {name}: pair {k} coordinates")
        check(cigs == [cigar_of(a.operations) for a in alns], f"long {name}: global_packed CIGARs != global_ operations")
        want = ref.global_(xs[:4], ys[:4])
        check([fields(a) for a in alns[:4]] == [fields(a) for a in want], f"long {name}: card != CPU plain path")
        runs = [longest_ins_run(a.operations) for a in alns]
        if name == "insertion":
            check(min(runs) >= 4096, f"insertion pairs: longest Ins runs {runs}, each must be >= 4096")
        long_summary[name] = {
            "pairs": len(xs), "max_len": [max(map(len, xs)), max(map(len, ys))],
            "mean_score": float(np.mean(scs)), "longest_ins_run": max(runs),
        }
    print(json.dumps({
        "phase": "long_global", "launches": long_launches, **long_summary, "seconds": time.perf_counter() - t_phase,
    }), flush=True)
    launches = {name: launches[name] + long_launches[name] for name in counters}
    long_delivered_s = {name: run[3] for name, run in long_runs.items()}
    del long_runs, alns, want

    # ---- 3e. long-sequence clip modes, counted ------------------------------
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()
    semi_set, local_set, prot_set, (dna_cores, prot_cores) = clip_sets
    clip_names = ("semiglobal", "local", "custom", "protein_local")
    clip_paths = ((ba, "semiglobal", semi_set), (ba, "local", local_set), (bac, "custom", local_set), (bp, "local", prot_set))
    clip_runs = {}
    for name, (al, mode, (xs, ys)) in zip(clip_names, clip_paths):
        t0 = time.perf_counter()
        alns = getattr(al, mode)(xs, ys)
        delivered_s = time.perf_counter() - t0
        clip_runs[name] = (alns, al.scores(xs, ys, mode), delivered_s)
    clip_long_launches = {name: k.launches for name, k in counters.items()}
    path_kernels = ("sw_scan_columns", "sw_scan_columns_lut", "walk_steps")
    check(all(clip_long_launches[n] > 0 for n in path_kernels), f"a kernel of the long clip-mode path did not launch: {clip_long_launches}")
    clip_summary = {}
    for name, (al, mode, (xs, ys)), ref, cores in zip(
        clip_names, clip_paths, (cpu, cpu, cpu_c, cpu_p), (None, dna_cores, dna_cores, prot_cores)
    ):
        alns, scs, _ = clip_runs[name]
        check(len(alns) == len(xs) and scs.shape == (len(xs),), f"long {name}: result count")
        check(all(int(s) == a.score for s, a in zip(scs, alns)), f"long {name}: scores() != alignment scores")
        pens_, lut_ = (ppens, lut_l) if name == "protein_local" else ((CUSTOM_PENS if name == "custom" else (GO, GE, MA, MI)), None)
        cover = []
        for k, (a, x, y) in enumerate(zip(alns, xs, ys)):
            ops = [(op.kind, op.len) for op in a.operations]
            if name == "custom":
                got = rescore_ops(ops, x, y, pens_, CUSTOM_XCLIP, CUSTOM_YCLIP)
                want = (a.score, len(x), len(y))
            else:
                got = rescore_ops(ops, x[a.xstart : a.xend], y[a.ystart : a.yend], pens_, lut=lut_)
                want = (a.score, a.xend - a.xstart, a.yend - a.ystart)
            check(got == want, f"long {name}: pair {k} does not re-score to {a.score}: {got}")
            if name == "semiglobal":
                check((a.xstart, a.xend) == (0, len(x)), f"long semiglobal: pair {k} does not consume all of x")
            else:
                left, core = cores[k]
                cover.append((min(a.xend, left + core) - max(a.xstart, left)) / core)
        if cover:
            check(min(cover) >= 0.9, f"long {name}: an alignment covers {min(cover):.3f} of its core")
        t0 = time.perf_counter()
        want = getattr(ref, mode)(xs[:4], ys[:4])
        check([fields(a) for a in alns[:4]] == [fields(a) for a in want], f"long {name}: card != CPU plain path")
        clip_summary[name] = {
            "pairs": len(xs), "max_len": [max(map(len, xs)), max(map(len, ys))],
            "mean_score": float(np.mean(scs)), "min_core_cover": min(cover) if cover else None,
            "delivered_s": clip_runs[name][2], "cpu_path_s": time.perf_counter() - t0,
        }
    print(json.dumps({
        "phase": "long_clip", "launches": clip_long_launches, **clip_summary, "seconds": time.perf_counter() - t_phase,
    }), flush=True)
    launches = {name: launches[name] + clip_long_launches[name] for name in counters}
    clip_delivered_s = {name: run[2] for name, run in clip_runs.items()}
    del clip_runs, alns, want

    # ---- 3f. the banded aligner, counted ---------------------------------
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()
    band_build_s = []
    real_build = native.band_build_batch

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = real_build(*a, **kw)
        band_build_s.append(time.perf_counter() - t0)
        return out

    bb = BatchBandedAligner(sc, BAND_K, BAND_W, device=dev)
    bbc = BatchBandedAligner(csc, BAND_K, BAND_W, device=dev)

    def band_pipeline():
        """The read batches through bench.py:1176-1188's pipeline."""
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(bb.semiglobal_async, *band_reads[0])
            out = []
            for nxt in range(1, BAND_BATCHES):
                handle = fut.result()
                fut = pool.submit(bb.semiglobal_async, *band_reads[nxt])
                out.append(bb.semiglobal_finish(handle))
            out.append(bb.semiglobal_finish(fut.result()))
        return out

    # untimed warm-up (bench.py:1169): the first pinned copies, launches and
    # allocations stay out of the timed calls
    bb.semiglobal(*band_reads[0])
    native.band_build_batch = timed_build
    t0 = time.perf_counter()
    band_pipe = band_pipeline()
    band_pipe_s = time.perf_counter() - t0
    # each corpus: (aligner, mode, pairs, (go, ge, match, mismatch), the
    # (x, y) clip penalties its ops re-score at, or None without clip ops)
    band_sets = {
        "reads": (bb, "semiglobal", band_reads[0], (GO, GE, MA, MI), None),
        "kb": (bb, "semiglobal", kb_set, (GO, GE, MA, MI), None),
        "str_global": (bb, "global_", long_sets[0], (GO, GE, MA, MI), None),
        "local": (bb, "local", (band_reads[0][0][:B_BAND_LOCAL], band_reads[0][1][:B_BAND_LOCAL]), (GO, GE, MA, MI), None),
        "custom": (bbc, "custom", (custom_xs, custom_ys), CUSTOM_PENS, (CUSTOM_XCLIP, CUSTOM_YCLIP)),
    }
    band_runs = {}
    for name, (al, mode, (xs, ys), _, _) in band_sets.items():
        t0 = time.perf_counter()
        alns = getattr(al, mode)(xs, ys)
        band_runs[name] = (alns, time.perf_counter() - t0)
    native.band_build_batch = real_build
    band_launches = {name: k.launches for name, k in counters.items()}
    check(
        all(band_launches[n] > 0 for n in ("sw_scan_banded", "walk_banded")),
        f"a kernel of the banded path did not launch: {band_launches}",
    )
    check([fields(a) for a in band_pipe[0]] == [fields(a) for a in band_runs["reads"][0]], "banded: pipelined != semiglobal")
    band_summary = {}
    for name, (al, mode, (xs, ys), pens_, clips_) in band_sets.items():
        alns = band_runs[name][0]
        check(len(alns) == len(xs), f"banded {name}: result count")
        for k, (a, x, y) in enumerate(zip(alns, xs, ys)):
            ops = [(op.kind, op.len) for op in a.operations]
            if clips_ is not None:
                got, want = rescore_ops(ops, x, y, pens_, *clips_), (a.score, len(x), len(y))
            else:
                got = rescore_ops(ops, x[a.xstart : a.xend], y[a.ystart : a.yend], pens_)
                want = (a.score, a.xend - a.xstart, a.yend - a.ystart)
            check(got == want, f"banded {name}: pair {k} does not re-score to {a.score}: {got}")
            if mode in ("semiglobal", "global_"):
                check((a.xstart, a.xend) == (0, len(x)), f"banded {name}: pair {k} does not consume all of x")
            if mode == "global_":
                check((a.ystart, a.yend) == (0, len(y)), f"banded {name}: pair {k} does not consume all of y")
        # small-input references: the host oracle and the CPU path
        t0 = time.perf_counter()
        n_ref = BAND_ORACLE_LONG if name in ("kb", "str_global") else BAND_ORACLE
        oracle = banded.Aligner(al.scoring, BAND_K, BAND_W)
        for k in range(n_ref):
            want = getattr(oracle, mode)(xs[k], ys[k])
            check(fields(alns[k]) == fields(want), f"banded {name}: pair {k} != the host oracle")
        on_cpu = getattr(BatchBandedAligner(al.scoring, BAND_K, BAND_W, device="cpu"), mode)(xs[:n_ref], ys[:n_ref])
        check([fields(a) for a in alns[:n_ref]] == [fields(a) for a in on_cpu], f"banded {name}: card != CPU plain path")
        band_summary[name] = {
            "pairs": len(xs), "max_len": [max(map(len, xs)), max(map(len, ys))],
            "mean_score": float(np.mean([a.score for a in alns])), "delivered_s": band_runs[name][1],
            "cpu_refs_s": time.perf_counter() - t0,
        }
    for b in range(1, BAND_BATCHES):
        for k, (a, x, y) in enumerate(zip(band_pipe[b], *band_reads[b])):
            got = rescore_ops([(op.kind, op.len) for op in a.operations], x, y[a.ystart : a.yend])
            check(got == (a.score, len(x), a.yend - a.ystart), f"banded pipelined batch {b}: pair {k} does not re-score")
    print(json.dumps({
        "phase": "banded", "launches": band_launches, **band_summary, "pipelined_s": band_pipe_s,
        "band_build_s": band_build_s, "seconds": time.perf_counter() - t_phase,
    }), flush=True)
    launches = {name: launches[name] + band_launches[name] for name in counters}
    band_delivered_s = {name: run[1] for name, run in band_runs.items()}
    del band_runs, band_pipe, alns

    # ---- 3g. the PairHMM family, counted -------------------------------
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()
    neg_inf = float("-inf")
    bench_gaps = (math.log(HMM_INS), math.log(HMM_DEL), neg_inf, neg_inf)
    gatk_gaps = (math.log(GATK_GAP_OPEN), math.log(GATK_GAP_OPEN), math.log(GATK_GAP_CONT), math.log(GATK_GAP_CONT))
    hops = (math.log(HOP), math.log(HOP), math.log(HOP_EXTEND), math.log(HOP_EXTEND))
    bench_emit, gatk_emit = hmm_emit(HMM_SUBST), hmm_emit(10.0 ** (-GATK_Q / 10.0))
    homo_emit = hmm_emit(HMM_SUBST, 4)
    # the read as x: GATK's first B_GATK_SWAP pairs the other way round
    sx, sy = gy[:B_GATK_SWAP].copy(), gx[:B_GATK_SWAP].copy()
    sxl, syl = gyl[:B_GATK_SWAP].copy(), gxl[:B_GATK_SWAP].copy()
    lin = BatchPairHMMLinear(*bench_gaps, device=dev)
    glin = BatchPairHMMLinear(*gatk_gaps, device=dev)
    exact = BatchPairHMMExact(*bench_gaps, device=dev)
    homo = BatchHomopolyPairHMM(*bench_gaps, *hops, device=dev)
    ex_x, ex_y = hbx[:B_HMM_EXACT], hby[:B_HMM_EXACT]
    # each corpus: (class, its call's arguments between the pairs and the
    # lengths, (x, y, xlens, ylens))
    hmm_sets = {
        "bench": (lin, (bench_emit, True), (hbx, hby, None, None)),
        "bench_global": (lin, (bench_emit, False), (hbx[:B_HMM_GLOBAL], hby[:B_HMM_GLOBAL], None, None)),
        "gatk": (glin, (gatk_emit, True), (gx, gy, gxl, gyl)),
        "gatk_per_lane": (glin, (gep, True), (gx, gy, gxl, gyl)),
        "gatk_read_as_x": (glin, (gatk_emit, True), (sx, sy, sxl, syl)),
        "exact": (exact, (bench_emit, True, None), (ex_x, ex_y, None, None)),
        "exact_banded": (exact, (bench_emit, True, HMM_MED), (ex_x, ex_y, None, None)),
        "homopoly": (homo, (homo_emit, True), (hox, hoy, None, None)),
    }
    def oracle_args(name, b):
        hmm, extra, (xs_, ys_, xl_, yl_) = hmm_sets[name]
        xl_, yl_ = hmm_lens(xs_, ys_, xl_, yl_)
        ep_ = extra[0] if extra[0].ndim == 1 else extra[0][b]
        return (
            "homopoly" if hmm is homo else "pairhmm", gatk_gaps if hmm is glin else bench_gaps, hops,
            xs_[b, : xl_[b]].tobytes(), ys_[b, : yl_[b]].tobytes(), ep_, extra[1], extra[2] if hmm is exact else None,
            float(homo.p["match_any"]) if hmm is homo else None,
        )

    # the host oracles run in worker processes while the card works
    oracle_pool = ProcessPoolExecutor(min(8, os.cpu_count() or 1), mp_context=multiprocessing.get_context("spawn"))
    oracle_jobs = {
        name: [oracle_pool.submit(hmm_oracle, *oracle_args(name, b)) for b in range(n)]
        for name, n in HMM_ORACLE.items()
    }
    hmm_runs = {}
    for name, (hmm, extra, (xs_, ys_, xl_, yl_)) in hmm_sets.items():
        log_before = pairhmm.PAIRHMM_FWD_LOG.launches
        t0 = time.perf_counter()
        out = hmm.prob_related_batch(xs_, ys_, *extra, xl_, yl_)
        hmm_runs[name] = (out, time.perf_counter() - t0, pairhmm.PAIRHMM_FWD_LOG.launches - log_before)
    hmm_launches = {name: k.launches for name, k in counters.items()}
    check(
        all(hmm_launches[n] > 0 for n in ("pairhmm_fwd_scaled", "pairhmm_fwd_log", "pairhmm_fwd_exact", "pairhmm_fwd_homopoly")),
        f"a kernel of the PairHMM path did not launch: {hmm_launches}",
    )
    # no bench lane falls back (bench.py:262); every read-as-x lane does
    check(hmm_runs["bench"][2] == 0 and bool((hmm_runs["bench"][0] > -1.5e38).all()), "pairhmm bench: a lane fell back")
    check(hmm_runs["gatk_read_as_x"][2] > 0, "pairhmm read as x: K17-log did not launch")
    hmm_summary = {}
    for name, (hmm, extra, (xs_, ys_, xl_, yl_)) in hmm_sets.items():
        out, secs, fell = hmm_runs[name]
        B_ = len(xs_)
        xl_, yl_ = hmm_lens(xs_, ys_, xl_, yl_)
        check(out.shape == (B_,) and bool(np.isfinite(out).all()) and bool((out <= 0).all()), f"pairhmm {name}: not finite or > 0")
        # global mode without gap extension has no path through 207 x 54:
        # 153 gaps, at most one between two matches (the oracle's -inf)
        no_path = int((out <= -1.5e38).sum())
        check(no_path == (B_ if name == "bench_global" else 0), f"pairhmm {name}: {no_path} lanes without a path")
        # references: the host oracle on a few pairs, the CPU path on 64
        t0 = time.perf_counter()
        gaps = gatk_gaps if hmm is glin else bench_gaps
        ep_, semi = extra[0], extra[1]
        med = extra[2] if hmm is exact else None
        n_or = HMM_ORACLE[name]
        want = [job.result() for job in oracle_jobs[name]]
        if hmm is exact:
            oracle_err = rel_err(out[:n_or], want)
            check(oracle_err <= 1e-12, f"pairhmm {name}: {oracle_err} from the host oracle")
        else:
            oracle_err = None
            check(oracle_ok(out[:n_or], want), f"pairhmm {name}: the host oracle differs")
        oracle_wait_s = time.perf_counter() - t0
        sub = (xs_[:HMM_CPU], ys_[:HMM_CPU], ep_ if ep_.ndim == 1 else ep_[:HMM_CPU], semi)
        if hmm is exact:
            cpu_out = BatchPairHMMExact(*gaps, device="cpu").prob_related_batch(*sub, med, xl_[:HMM_CPU], yl_[:HMM_CPU])
            cpu_err = rel_err(out[:HMM_CPU], cpu_out)
            check(cpu_err <= 1e-12, f"pairhmm {name}: card != CPU path ({cpu_err})")
        else:
            on_cpu = (
                BatchHomopolyPairHMM(*gaps, *hops, device="cpu") if hmm is homo else BatchPairHMMLinear(*gaps, device="cpu")
            )
            cpu_err = f32_err(out[:HMM_CPU], on_cpu.prob_related_batch(*sub, xl_[:HMM_CPU], yl_[:HMM_CPU]))
            check(cpu_err <= CPU_PATH_F32_TOL, f"pairhmm {name}: card != CPU path ({cpu_err})")
        hmm_summary[name] = {
            "pairs": B_, "max_len": [int(xl_.max()), int(yl_.max())], "mean_loglik": float(out[out > -1.5e38].mean()) if not no_path else None,
            "no_path": no_path,
            "fell_back": int(fell), "call_s": secs, "oracle_rel_err": oracle_err, "cpu_err": cpu_err,
            "refs_s": time.perf_counter() - t0, "oracle_wait_s": oracle_wait_s,
        }
    # the read-as-x lanes, re-run in log space, against the f64 forward
    f64_out = BatchPairHMM(*gatk_gaps, dtype=torch.float64, device=dev).prob_related_batch(sx, sy, gatk_emit, True, sxl, syl)
    hmm_summary["gatk_read_as_x"]["f64_err"] = f32_err(hmm_runs["gatk_read_as_x"][0], f64_out)
    check(hmm_summary["gatk_read_as_x"]["f64_err"] <= 1e-5, "pairhmm read as x: the f32 re-run != the f64 forward")
    oracle_pool.shutdown()
    print(json.dumps({
        "phase": "pairhmm", "launches": hmm_launches, **hmm_summary, "seconds": time.perf_counter() - t_phase,
    }), flush=True)
    launches = {name: launches[name] + hmm_launches[name] for name in counters}
    del hmm_runs

    # ---- 3h. the FM index at genome scale, counted ------------------------
    for k in counters.values():
        k.launches = 0
    t_phase = time.perf_counter()

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    large_text, large_starts, large_pats = fm_large_corpus(np.random.default_rng((args.seed, 7)))
    t0 = time.perf_counter()
    large_sa = suffix_array_host(large_text)
    sais_s = time.perf_counter() - t0
    large_bwt = large_text[large_sa - 1]  # sa == 0 reads the last symbol
    t0 = time.perf_counter()
    large = DeviceFMIndex(large_bwt, dna.n_alphabet(), sa=large_sa, sampling_rate=32, device=dev)
    torch.cuda.synchronize()
    large_index_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    large.build_kmer_lut(q=FM_LUT_Q)
    torch.cuda.synchronize()
    large_lut_s = time.perf_counter() - t0
    large_u32 = DeviceFMIndex(large_bwt, dna.n_alphabet(), sa=large_sa, sampling_rate=32, device=dev, force_u32=True)
    large_u32.build_kmer_lut(q=FM_LUT_Q)
    check(large_u32._big and not large._big, "3h: the index modes")
    del large_sa, large_bwt, large_text
    ll_np = np.full(B_FM, QLEN, np.int32)
    lp_d, ll_d = on_card(large_pats, ll_np)
    lut_np = large.search_batch_lut(large_pats, ll_np)
    k4_np = [o.cpu().numpy() for o in large.search_arrays(lp_d, ll_d)]
    check(all(np.array_equal(a, b) for a, b in zip(lut_np, k4_np)), "3h: K4-LUT != K4 on the 50 Mbp index")
    check(bool((lut_np[0] == fm.COMPLETE).all() and (lut_np[3] == QLEN).all()), "3h: a sampled query is not COMPLETE at mlen 20")
    for name, outs in (("K4-LUT", large_u32.search_arrays_lut(lp_d, ll_d)), ("K4", large_u32.search_arrays(lp_d, ll_d))):
        check(
            all(np.array_equal(o.cpu().numpy().astype(np.int64), w.astype(np.int64)) for o, w in zip(outs, k4_np)),
            f"3h: the uint32 {name} != the int32 index",
        )
    large_rows = interval_rows(lut_np[1], lut_np[2])
    large_pos = large.locate_batch(large_rows)
    check(np.array_equal(large_u32.locate_batch(large_rows), large_pos.astype(np.int64)), "3h: the uint32 K4-locate != the int32 index")
    owner = np.repeat(np.arange(B_FM), lut_np[2] - lut_np[1])
    hit = np.zeros(B_FM, bool)
    hit[owner[large_pos == large_starts[owner]]] = True
    check(bool(hit.all()), "3h: a query's located positions miss its start")
    # past 2^31: a random array taken as a BWT, no suffix array
    t0 = time.perf_counter()
    big = DeviceFMIndex(random_bwt(torch, dev, args.seed, FM_BIG_LEN), Alphabet(b"$ACGT"), device=dev)
    big.build_kmer_lut(q=FM_LUT_Q)
    torch.cuda.synchronize()
    big_build_s = time.perf_counter() - t0
    check(big._big and big.n == FM_BIG_LEN, "3h: the 2^31-plus index is not the uint32 one")
    bp_d, bl_d = on_card(np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng((args.seed, 8)).integers(0, 4, size=(B_FM, QLEN))], ll_np)
    big_k4 = big.search_arrays(bp_d, bl_d)
    big_lut = big._search_kernel_lut(bp_d, bl_d)
    torch.cuda.synchronize()
    big_args = (big._fused, big._less256, big.sym_of)
    check(
        all(torch.equal(g, w) for g, w in zip(big_k4, fm.backward_search_plain(*big_args, bp_d, bl_d, big.n, True))),
        "3h: the uint32 K4 != its plain version past 2^31",
    )
    big_lut_args = (*big_args, big._lut_rank, big._lut, FM_LUT_Q)
    check(
        all(torch.equal(g, w) for g, w in zip(big_lut, fm.search_lut_plain(*big_lut_args, bp_d, bl_d, big.n, True))),
        "3h: the uint32 K4-LUT != its plain version past 2^31",
    )
    check(all(torch.equal(g, w) for g, w in zip(big_lut[:4], big_k4)), "3h: the uint32 K4-LUT != K4 past 2^31")
    big_top = int(big_k4[2].max()) - 1
    check(big_top >= 2**31 and (big_top >> 5) >= 2**26, f"3h: no interval reaches past 2^31 / word 2^26 ({big_top})")
    scale_launches = {name: k.launches for name, k in counters.items()}
    path_kernels = ("fm_search_lut", "fm_backward_search", "fm_locate", "fm_search_lut_u32", "fm_backward_search_u32", "fm_locate_u32")
    check(all(scale_launches[n] > 0 for n in path_kernels), f"a kernel of the FM phase did not launch: {scale_launches}")
    print(json.dumps({
        "phase": "fm_scale", "launches": scale_launches, "text": FM_LARGE_LEN + 1, "queries": B_FM, "fm_sais_s": sais_s,
        "index_s": large_index_s, "lut_s": large_lut_s, "lut_misses": int(large._search_kernel_lut(lp_d, ll_d)[4].sum()),
        "located_rows": len(large_rows), "big_n": big.n, "big_build_s": big_build_s, "big_top_row": big_top,
        "big_misses": int(big_lut[4].sum()), "big_complete": int((big_k4[0] == fm.COMPLETE).sum()),
        "seconds": time.perf_counter() - t_phase,
    }), flush=True)
    launches = {name: launches[name] + scale_launches[name] for name in counters}

    # ---- 4. kernels against their plain versions, timed ---------------
    t_phase = time.perf_counter()
    def tens(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    xb_d, yb_d, ml_d, nl_d = tens(xb, yb, np.full(B_ALN, LEN, np.int32), np.full(B_ALN, LEN, np.int32))
    pens = (GO, GE, MA, MI)
    pats_d, plens_d = tens(pats_np, np.full(B_FM, QLEN, np.int32))
    kernels = []

    def report(name, source, replaces, got, want, ms, plain_ms, nbytes, nops, err=None, n_launches=None, **extra):
        """One kernel row; ``n_launches`` in place of the main path's count
        of ``name`` where the row is a second input of a kernel that has a
        row of its own (its count in the phase that runs that input)."""
        if err is None:
            err = max_abs_err(got, want)
        check(err == 0, f"{name}: kernel differs from its plain version (max abs err {err})")
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = nops / INT32_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name] if n_launches is None else n_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None,
        }
        kernels.append(row)
        print(json.dumps({"phase": "kernel", **row, "bytes": nbytes, "int_ops": nops, **extra, "card": smi}), flush=True)

    cells = B_ALN * LEN * LEN
    got = sw.scan_global(xb_d, yb_d, ml_d, nl_d, *pens)
    torch.cuda.synchronize()
    want = sw.scan_global_plain(xb_d, yb_d, ml_d, nl_d, *pens)
    report(
        "sw_scan_global", "rust_bio_tpu_torch/ops/csrc/sw_warp.cu", "rust_bio_tpu/ops/sw_pallas.py:559",
        got, want,
        cuda_ms(torch, lambda: sw.scan_global(xb_d, yb_d, ml_d, nl_d, *pens), 10),
        cuda_ms(torch, lambda: sw.scan_global_plain(xb_d, yb_d, ml_d, nl_d, *pens), 2),
        2 * B_ALN * LEN + 8 * B_ALN + 2 * LEN * (LEN + 1) * B_ALN + 4 * B_ALN + 4 * B_ALN * (LEN + 1),
        K1_OPS_PER_CELL * cells, stripes=sw.warp_geometry(LEN, sw.GLOBAL_WARP_LAYERS)[:2],
        tb_strides=list(got[1].stride()),
    )
    tb = got[1]
    wgot = walk.sweep_walk_global(tb, ml_d, nl_d)
    torch.cuda.synchronize()
    wwant = walk.sweep_walk_global_plain(tb, ml_d, nl_d)
    # the walk needs one traceback cell per emitted op (plus the entry cell)
    path_cells = int(wgot[0].long().sum() + (wgot[1].long() > 0).sum() + wgot[2].long().sum()) + B_ALN
    # K2's and K6's ms: the launch alone; wrapper_ms adds the input checks
    sweep_lib = _build.build(["walk_sweep"])["walk_sweep"]
    # registers and stack bytes of K2, K6 and the two clip instantiations
    # (sweep_walk_clip_kernel<false>: K8, <true>: K10)
    kernel_pattern = r"(sweep_walk_(?:semi)?global(?=_kernel)|sweep_walk_clip_kernelILb[01]E)"
    sweep_usage = {
        "registers": kernel_registers(sweep_lib, kernel_pattern),
        "stack_bytes": kernel_registers(sweep_lib, kernel_pattern, "STACK"),
    }
    report(
        "sweep_walk_global", f"rust_bio_tpu_torch/ops/csrc/{walk.SWEEP_WALK_GLOBAL.source}.cu",
        "rust_bio_tpu/ops/walk_pallas.py:74",
        wgot, wwant,
        k2_launch_ms(torch, walk, tb, ml_d, nl_d, 10),
        cuda_ms(torch, lambda: walk.sweep_walk_global_plain(tb, ml_d, nl_d), 2),
        2 * path_cells + 8 * B_ALN + 2 * 2 * LEN * B_ALN + 2 * B_ALN,
        8 * path_cells, wrapper_ms=cuda_ms(torch, lambda: walk.sweep_walk_global(tb, ml_d, nl_d), 10),
        geometry=walk.sweep_walk_geometry(B_ALN, LEN), tb_strides=list(tb.stride()), **sweep_usage,
    )
    del got, want, tb, wwant
    # K3: its warp launch on the 150 bp pairs (phase 2) and its block launch
    # on phase 3d's STR pairs (M = 5,588), the row's launches both routes'
    sgot = sw.scores_global(xb_d, yb_d, ml_d, nl_d, *pens)
    torch.cuda.synchronize()
    swant = sw.scores_global_plain(xb_d, yb_d, ml_d, nl_d, *pens)
    k3_long = tens(*ba._pad(*long_sets[0]))
    k3_M, k3_N = int(k3_long[0].shape[1]), int(k3_long[1].shape[1])
    check(sw.scores_route(LEN, B_ALN) == "warp" and sw.scores_route(k3_M, B_STR) == "rows", "K3's routes at 150 bp and 5.6 kb")
    lgot = sw.scores_global(*k3_long, *pens)
    torch.cuda.synchronize()
    lwant = sw.scores_global_plain(*k3_long, *pens)
    k3_ml, k3_nl = (t.cpu().numpy().astype(np.int64) for t in k3_long[2:])
    k3_long_bound = max(
        (k3_long[0].numel() + k3_long[1].numel() + 12 * len(k3_ml)) / HBM_BYTES_PER_S,
        K3_OPS_PER_CELL * int((k3_ml * k3_nl).sum()) / INT32_OPS_PER_S,
    ) * 1e3
    report(
        "sw_scores_global", "rust_bio_tpu_torch/ops/csrc/sw_warp.cu", "rust_bio_tpu/ops/sw_pallas.py:199",
        [sgot, lgot], [swant, lwant],
        cuda_ms(torch, lambda: sw.scores_global(xb_d, yb_d, ml_d, nl_d, *pens), 10),
        cuda_ms(torch, lambda: sw.scores_global_plain(xb_d, yb_d, ml_d, nl_d, *pens), 2),
        2 * B_ALN * LEN + 8 * B_ALN + 4 * B_ALN,
        K3_OPS_PER_CELL * cells,
        n_launches=launches["sw_scores_global"] + launches["sw_scores_global_rows"],
        route_launches={"warp": launches["sw_scores_global"], "rows": launches["sw_scores_global_rows"]},
        stripe_rows=sw.warp_geometry(LEN, sw.SCORE_WARP_LAYERS, sw.SCORE_WARP_SHARED_MAX)[0],
        long_source="rust_bio_tpu_torch/ops/csrc/sw_global_rows.cu",
        long_ms=cuda_ms(torch, lambda: sw.scores_global(*k3_long, *pens), 3),
        long_bound_ms=k3_long_bound, long_M=k3_M, long_N=k3_N,
        long_geometry=sw.rows_geometry(k3_M, score_only=True)[:3],
    )
    del k3_long, lgot, lwant
    fgot = index.search_arrays(pats_d, plens_d)
    torch.cuda.synchronize()
    fwant = fm.backward_search_plain(index._fused, index._less256, index.sym_of, pats_d, plens_d, index.n)
    # rank reads this run needs: two per matched step, one for a failing step
    steps_ok = int(fgot[3].long().sum())
    steps_failed = int((fgot[3] < plens_d).long().sum())
    fm_lib = _build.build(["fm_search"])["fm_search"]
    fm_pattern = r"(fm_search_kernel|fm_search_lut_kernel|fm_locate_kernel)I([ij])E"
    fm_usage = {
        "registers": kernel_registers(fm_lib, fm_pattern),
        "stack_bytes": kernel_registers(fm_lib, fm_pattern, "STACK"),
    }
    # K4's ms: the launch alone, into outputs made once; wrapper_ms adds the
    # input checks (the plens check waits for the card) and the outputs
    # (queued_ms: the launch's device time alone, without the host's gaps)
    fouts = [torch.empty_like(t) for t in fgot]
    k4_launch = lambda: fm.FM_BACKWARD_SEARCH.launch(  # noqa: E731
        dev, index._fused.data_ptr(), index._less256.data_ptr(), index.sym_of.data_ptr(), pats_d.data_ptr(),
        plens_d.data_ptr(), B_FM, QLEN, index._fused.shape[1], index.n, *(o.data_ptr() for o in fouts),
    )
    report(
        "fm_backward_search", "rust_bio_tpu_torch/ops/csrc/fm_search.cu", "rust_bio_tpu/ops/fm_pallas.py:123",
        fgot, fwant,
        cuda_ms(torch, k4_launch, 20),
        cuda_ms(torch, lambda: fm.backward_search_plain(index._fused, index._less256, index.sym_of, pats_d, plens_d, index.n), 2),
        B_FM * QLEN + 4 * B_FM + 16 * B_FM + 8 * (2 * steps_ok + steps_failed) + 2 * 256 * 4,
        12 * (steps_ok + steps_failed),
        wrapper_ms=cuda_ms(torch, lambda: index.search_arrays(pats_d, plens_d), 20),
        queued_ms=queued_ms(torch, k4_launch, 50),
        launch_equal=all(torch.equal(o, g) for o, g in zip(fouts, fgot)),
        geometry={"threads": fm.FM_THREADS, "blocks": -(-B_FM // fm.FM_THREADS)}, **fm_usage,
    )
    check(all(torch.equal(o, g) for o, g in zip(fouts, fgot)), "fm_backward_search: the timed launches' outputs differ")
    del fouts
    # K4-locate on phase 2's rows (the sampled queries' intervals) through
    # its wrapper, and on 8192 random rows (one a read: the mapper's batch)
    loc_tables = (index._fused, index.bwt_sym, index.less_sym, index.sa_sample, index.sent_rows, index.sent_vals)
    loc_rows = torch.from_numpy(fm_rows).to(dev)
    lgot = fm.locate(*loc_tables, loc_rows, index.s)
    torch.cuda.synchronize()
    lwant = fm.locate_plain(*loc_tables, loc_rows, index.s)
    loc_plain_ms = cuda_ms(torch, lambda: fm.locate_plain(*loc_tables, loc_rows, index.s), 2)
    # reads this run needs: the row and its result, a symbol byte and a
    # rank entry a step, the stop's sample (or a sentinel row's search)
    _, loc_steps = fm.locate_walk_plain(index._fused, index.bwt_sym, index.less_sym, loc_rows, index.s)
    loc_steps = loc_steps.cpu().numpy()
    rand_rows = torch.from_numpy(np.random.default_rng((args.seed, 6)).integers(0, index.n, size=B_READS).astype(np.int32)).to(dev)
    report(
        "fm_locate", "rust_bio_tpu_torch/ops/csrc/fm_search.cu",
        "rust_bio_tpu/data_structures/fm_device.py:753",
        [lgot], [lwant],
        cuda_ms(torch, lambda: fm.locate(*loc_tables, loc_rows, index.s), 20),
        loc_plain_ms,
        12 * len(fm_rows) + 9 * int(loc_steps.sum()) + 4 * len(index.symbols),
        12 * int(loc_steps.sum()),
        rows=len(fm_rows), steps=int(loc_steps.sum()), longest_walk=int(loc_steps.max()),
        queued_ms=queued_ms(torch, lambda: fm.locate(*loc_tables, loc_rows, index.s), 20),
        random_rows=B_READS, random_rows_ms=cuda_ms(torch, lambda: fm.locate(*loc_tables, rand_rows, index.s), 20),
        geometry={"threads": fm.FM_THREADS, "blocks": -(-len(fm_rows) // fm.FM_THREADS)},
    )
    del loc_rows, lgot, lwant, rand_rows
    # K-merge on phase 2's 2%-divergence pairs' K2 streams (R = 32), and on
    # the mapper's extension pairs' K6 streams (semiglobal_ms)
    R = BatchAligner._COMPACT_RUNS
    hi_d = tens(yb_hi)[0]
    sc_m, tb_m, _ = sw.scan_global(xb_d, hi_d, ml_d, nl_d, *pens)
    ic_m, eo_m, i0_m = walk.sweep_walk_global(tb_m, ml_d, nl_d)
    del tb_m
    mgot = walk.merge_rle(sc_m, ic_m, eo_m, i0_m, None, None, nl_d, None, ml_d, R)
    torch.cuda.synchronize()
    mwant = walk.merge_rle_plain(sc_m, ic_m, eo_m, i0_m, None, None, nl_d, None, ml_d, R)
    mout = torch.empty_like(mgot)
    merge_launch = lambda: walk.RLE_MERGE.launch(  # noqa: E731
        dev, sc_m.data_ptr(), ic_m.data_ptr(), eo_m.data_ptr(), i0_m.data_ptr(), 0, 0, nl_d.data_ptr(), 0,
        ml_d.data_ptr(), B_ALN, LEN, R, mout.data_ptr(),
    )
    ext_m = tens(xb_ext, yb_ext, ml_ext, nl_ext)
    sg_m = sw.scan_semiglobal(*ext_m, GO, GE, MA, MI, 0, 0)
    score_s, tbfix_s = _fixed_column(*sg_m[1:5], sg_m[5], ext_m[2], GO, GE)
    semi_walk = walk.sweep_walk_semiglobal(sg_m[0], tbfix_s, ext_m[2], ext_m[3])
    del sg_m
    semi_args = (score_s, *semi_walk[:5], ext_m[3], None, ext_m[2], R)
    sgot_m = walk.merge_rle(*semi_args)
    torch.cuda.synchronize()
    swant_m = walk.merge_rle_plain(*semi_args)
    entries = int(2 * B_ALN * LEN + 3 * B_ALN)
    report(
        "rle_merge", "rust_bio_tpu_torch/ops/csrc/rle_merge.cu", "rust_bio_tpu/alignment/pairwise/batched.py:800",
        [mgot, sgot_m], [mwant, swant_m],
        cuda_ms(torch, merge_launch, 20),
        cuda_ms(torch, lambda: walk.merge_rle_plain(sc_m, ic_m, eo_m, i0_m, None, None, nl_d, None, ml_d, R), 2),
        4 * B_ALN * LEN + 2 * B_ALN + 12 * B_ALN + 2 * (5 + R) * B_ALN,
        MERGE_OPS_PER_ENTRY * entries,
        queued_ms=queued_ms(torch, merge_launch, 50),
        wrapper_ms=cuda_ms(torch, lambda: walk.merge_rle(sc_m, ic_m, eo_m, i0_m, None, None, nl_d, None, ml_d, R), 20),
        semiglobal_ms=cuda_ms(torch, lambda: walk.merge_rle(*semi_args), 20),
        launch_equal=torch.equal(mout, mgot), R=R, runs_max=int((mgot[4].long() & 0x7FFF).max()),
        geometry={"warps": walk.MERGE_WARPS, "blocks": -(-B_ALN // walk.MERGE_WARPS)},
    )
    check(torch.equal(mout, mgot), "rle_merge: the timed launches' output differs")
    del sc_m, ic_m, eo_m, i0_m, mgot, mwant, mout, ext_m, semi_walk, semi_args, sgot_m, swant_m

    # K4-LUT and the uint32 K4, K4-LUT and K4-locate on phase 3h's indexes
    def fm_bytes(outs, plens, q=0, hits=None):
        """(bytes, rank steps) a search needs: the patterns, lengths,
        outputs and byte tables, an 8-byte rank entry a rank read (two a
        matched step past the table, one a failing step), an 8-byte table
        entry a lane that hits the table."""
        mlen = outs[3].long()
        start = torch.zeros_like(mlen) if hits is None else torch.where(hits, q, 0)
        ok = int((mlen - start).clamp(min=0).sum())
        failed = int((mlen < plens).long().sum())
        n_hits = 0 if hits is None else int(hits.sum())
        return B_FM * QLEN + 4 * B_FM + 17 * B_FM + 8 * (2 * ok + failed) + 8 * n_hits + 3 * 256 * 4, ok + failed

    def lut_call(index, pats, plens, outs, miss, kernel):
        return lambda: kernel.launch(
            dev, index._fused.data_ptr(), index._less256.data_ptr(), index.sym_of.data_ptr(),
            index._lut_rank.data_ptr(), index._lut.data_ptr(), FM_LUT_Q, pats.data_ptr(), plens.data_ptr(),
            B_FM, QLEN, index._fused.shape[1], index.n, *(o.data_ptr() for o in outs), miss.data_ptr(),
        )

    def k4_call(index, pats, plens, outs, kernel):
        return lambda: kernel.launch(
            dev, index._fused.data_ptr(), index._less256.data_ptr(), index.sym_of.data_ptr(), pats.data_ptr(),
            plens.data_ptr(), B_FM, QLEN, index._fused.shape[1], index.n, *(o.data_ptr() for o in outs),
        )

    for name, fmi, q_pats, q_lens in (("fm_search_lut", large, lp_d, ll_d), ("fm_search_lut_u32", big, bp_d, bl_d)):
        u = fmi._big
        lut_args = (fmi._fused, fmi._less256, fmi.sym_of, fmi._lut_rank, fmi._lut, FM_LUT_Q)
        got = fm.search_lut(*lut_args, q_pats, q_lens, fmi.n, u)
        torch.cuda.synchronize()
        want = fm.search_lut_plain(*lut_args, q_pats, q_lens, fmi.n, u)
        nbytes, steps = fm_bytes(got, q_lens, FM_LUT_Q, ~got[4])
        louts = [torch.empty(B_FM, dtype=torch.int32, device=dev) for _ in range(4)]
        lmiss = torch.empty(B_FM, dtype=torch.bool, device=dev)
        kouts = [torch.empty(B_FM, dtype=torch.int32, device=dev) for _ in range(4)]
        launch = lut_call(fmi, q_pats, q_lens, louts, lmiss, fm.FM_SEARCH_LUT_U32 if u else fm.FM_SEARCH_LUT)
        k4 = k4_call(fmi, q_pats, q_lens, kouts, fm.FM_BACKWARD_SEARCH_U32 if u else fm.FM_BACKWARD_SEARCH)
        report(
            name, "rust_bio_tpu_torch/ops/csrc/fm_search.cu", "rust_bio_tpu/data_structures/fm_device.py:598",
            got, want,
            cuda_ms(torch, launch, 20),
            cuda_ms(torch, lambda: fm.search_lut_plain(*lut_args, q_pats, q_lens, fmi.n, u), 2),
            nbytes, 12 * steps + 4 * FM_LUT_Q * B_FM,
            queued_ms=queued_ms(torch, launch, 50), k4_queued_ms=queued_ms(torch, k4, 50), k4_ms=cuda_ms(torch, k4, 20),
            wrapper_ms=cuda_ms(torch, lambda: fmi.search_arrays_lut(q_pats, q_lens), 20),
            misses=int(got[4].sum()), text=fmi.n, table_bytes=8 * 4**FM_LUT_Q,
        )
        if u:
            kgot = fmi.search_arrays(q_pats, q_lens)
            torch.cuda.synchronize()
            kwant = fm.backward_search_plain(fmi._fused, fmi._less256, fmi.sym_of, q_pats, q_lens, fmi.n, True)
            nbytes, steps = fm_bytes(kgot, q_lens)
            report(
                "fm_backward_search_u32", "rust_bio_tpu_torch/ops/csrc/fm_search.cu", "rust_bio_tpu/ops/fm_pallas.py:123",
                kgot, kwant,
                cuda_ms(torch, k4, 20),
                cuda_ms(torch, lambda: fm.backward_search_plain(fmi._fused, fmi._less256, fmi.sym_of, q_pats, q_lens, fmi.n, True), 2),
                nbytes, 12 * steps, queued_ms=queued_ms(torch, k4, 50), text=fmi.n,
            )
    # the uint32 K4-locate on 3h's located rows, over the force_u32 twin
    u_tables = (large_u32._fused, large_u32.bwt_sym, large_u32.less_sym, large_u32.sa_sample, large_u32.sent_rows, large_u32.sent_vals)
    u_rows = large_u32._row_tensor(torch.from_numpy(large_rows.astype(np.int64)).to(dev))
    ugot = fm.locate(*u_tables, u_rows, large_u32.s, True)
    torch.cuda.synchronize()
    uwant = fm.locate_plain(*u_tables, u_rows, large_u32.s, True)
    _, u_steps = fm.locate_walk_plain(large_u32._fused, large_u32.bwt_sym, large_u32.less_sym, u_rows.long() & fm.U32_MASK, large_u32.s, True)
    u_steps = u_steps.cpu().numpy()
    report(
        "fm_locate_u32", "rust_bio_tpu_torch/ops/csrc/fm_search.cu", "rust_bio_tpu/data_structures/fm_device.py:753",
        [ugot], [uwant],
        cuda_ms(torch, lambda: fm.locate(*u_tables, u_rows, large_u32.s, True), 20),
        cuda_ms(torch, lambda: fm.locate_plain(*u_tables, u_rows, large_u32.s, True), 2),
        12 * len(large_rows) + 9 * int(u_steps.sum()) + 4 * len(large_u32.symbols),
        12 * int(u_steps.sum()),
        rows=len(large_rows), steps=int(u_steps.sum()), longest_walk=int(u_steps.max()),
        queued_ms=queued_ms(torch, lambda: fm.locate(*u_tables, u_rows, large_u32.s, True), 20),
        int32_ms=cuda_ms(torch, lambda: large.locate_rows(torch.from_numpy(large_rows).to(dev)), 20),
    )
    # every name that holds a table of the 2.2 G index or the uint32 twin,
    # so that the empty_cache below returns their blocks to the card
    del big, large_u32, bp_d, bl_d, big_k4, big_lut, big_args, big_lut_args, u_tables, u_rows, ugot, uwant
    del fmi, lut_args, got, want, launch, k4, louts, lmiss, kouts, kgot, kwant
    torch.cuda.empty_cache()

    ext = tens(xb_ext, yb_ext, ml_ext, nl_ext)
    sg = (GO, GE, MA, MI, 0, 0)
    got = sw.scan_semiglobal(*ext, *sg)
    torch.cuda.synchronize()
    want = sw.scan_semiglobal_plain(*ext, *sg)
    # K5 runs one warp a pair in sw_warp.cu (K12's lanes); its score-only
    # call skips the tb stores
    only = sw.scan_semiglobal(*ext, *sg, traceback=False)
    torch.cuda.synchronize()
    check(only[0] is None, "sw_scan_semiglobal: the score-only call returned a tb")
    for g, w in zip(defined((got[0], *only[1:]), ext[2], ext[3])[1:], defined(want, ext[2], ext[3])[1:]):
        check(torch.equal(g, w), "sw_scan_semiglobal: the score-only finals differ from the plain version's")
    del only
    R5, placement5, _ = sw.warp_geometry(READ_LEN, sw.LOCAL_WARP_LAYERS)
    report(
        "sw_scan_semiglobal", f"rust_bio_tpu_torch/ops/csrc/{sw.SCAN_SEMIGLOBAL.source}.cu", "rust_bio_tpu/ops/sw_pallas.py:855",
        defined(got, ext[2], ext[3]), defined(want, ext[2], ext[3]),
        cuda_ms(torch, lambda: sw.scan_semiglobal(*ext, *sg), 10),
        cuda_ms(torch, lambda: sw.scan_semiglobal_plain(*ext, *sg), 2),
        B_READS * (READ_LEN + W) + 8 * B_READS + 2 * (READ_LEN + 1) * int(nl_ext.sum()) + 5 * 4 * B_READS * (READ_LEN + 1),
        K5_OPS_PER_CELL * READ_LEN * int(nl_ext.sum()),
        scores_only_ms=cuda_ms(torch, lambda: sw.scan_semiglobal(*ext, *sg, traceback=False), 10),
        stripe_rows=R5, placement=placement5, live_lanes=-(-(READ_LEN + 1) // R5), tb_strides=list(got[0].stride()),
        # registers of the instantiations <TB, ONCHIP>
        registers=kernel_registers(_build.build(["sw_warp"])["sw_warp"], r"scan_semiglobal_warp_kernelILb([01])ELb([01])ENS_11MatchParams"),
    )
    del want
    tb5 = got[0]
    _, tbfix = _fixed_column(*got[1:], ext[2], GO, GE)
    wgot = walk.sweep_walk_semiglobal(tb5, tbfix, ext[2], ext[3])
    torch.cuda.synchronize()
    wwant = walk.sweep_walk_semiglobal_plain(tb5, tbfix, ext[2], ext[3])
    # ms: the fused launch (the fixed column's prolog and the sweep)
    report(
        "sweep_walk_semiglobal", f"rust_bio_tpu_torch/ops/csrc/{walk.SWEEP_WALK_SEMIGLOBAL.source}.cu",
        "rust_bio_tpu/ops/walk_pallas.py:609",
        wgot, wwant,
        cuda_ms(torch, lambda: walk.sweep_walk_semiglobal_launch(tb5, tbfix, ext[2], ext[3]), 10),
        cuda_ms(torch, lambda: walk.sweep_walk_semiglobal_plain(tb5, tbfix, ext[2], ext[3]), 2),
        semi_walk_bytes(wgot, ext[2], W), 8 * semi_path_cells(wgot),
        wrapper_ms=cuda_ms(torch, lambda: walk.sweep_walk_semiglobal(tb5, tbfix, ext[2], ext[3]), 10),
        geometry=walk.sweep_walk_geometry(int(tb5.shape[2]), int(tb5.shape[0])), tb_strides=list(tb5.stride()), **sweep_usage,
    )
    del got, tb5, wwant

    # K7 and K8 on the random corpus (local scoring), K9 and K10 on the
    # custom corpus; the plain versions run on the same inputs
    def clip_kernels(scan_name, walk_name, args, pens, clips, nlens_np, ops_per_cell, replaces):
        local = all(c == 0 for c in clips)

        def scan_fn(plain=False, traceback=True):
            if local:
                return (sw.scan_local_plain if plain else sw.scan_local)(*args, *pens, traceback=traceback)
            return (sw.scan_custom_plain if plain else sw.scan_custom)(*args, *pens, *clips, traceback=traceback)

        got = scan_fn()
        torch.cuda.synchronize()
        want = scan_fn(plain=True)
        ml_d_, nl_d_ = args[2], args[3]
        Bq, Mq = args[0].shape
        Nq = args[1].shape[1]
        cells_q = Mq * int(nlens_np.sum())
        # K7 and K9 run one warp a pair in sw_warp.cu (K7-LUT's and
        # K9-LUT's lanes)
        extra = {"scores_only_ms": cuda_ms(torch, lambda: scan_fn(traceback=False), 10)}
        R_, placement_, _ = sw.warp_geometry(Mq, sw.LOCAL_WARP_LAYERS)
        extra.update(stripe_rows=R_, placement=placement_, live_lanes=-(-(Mq + 1) // R_), tb_strides=list(got[0].stride()))
        report(
            scan_name, f"rust_bio_tpu_torch/ops/csrc/{sw.SCAN_LOCAL.source if local else sw.SCAN_CUSTOM.source}.cu",
            replaces[0], defined_clip(got, ml_d_, nl_d_), defined_clip(want, ml_d_, nl_d_),
            cuda_ms(torch, scan_fn, 10), cuda_ms(torch, lambda: scan_fn(plain=True), 2),
            Bq * (Mq + Nq) + 8 * Bq + 2 * (Mq + 1) * int((nlens_np + 1).sum()) + 4 * (Nq + 1) * Bq + 5 * 4 * Bq * (Mq + 1),
            ops_per_cell * cells_q, **extra,
        )
        del want
        clip_walk(walk_name, walk_name, got, ml_d_, nl_d_, pens, clips, replaces[1])
        del got

    def clip_walk(row, walk_name, scan, ml_d_, nl_d_, pens, clips, replaces, n_launches=None):
        """K8 or K10 (``walk_name``) on a K7 / K9 / K7-LUT scan's tb, in the
        row ``row``: its one launch timed with the prolog it folds in
        (``ms``), and with the wrapper's input checks (``wrapper_ms``)."""
        tb_q, lx_q = scan[0], scan[1]
        Nq, _, Bq = tb_q.shape
        tbfix, lx_n = clip_walk_inputs(torch, scan, ml_d_, nl_d_, pens, clips)
        winputs = (tb_q, tbfix, lx_q, lx_n, ml_d_, nl_d_)
        custom = walk_name == "sweep_walk_custom"
        wrapper, plain, launch = (getattr(walk, walk_name + end) for end in ("", "_plain", "_launch"))
        # K10's outputs (pre, ins_cnt, exit_op, exit_len, post, ...), K8's (ins_cnt, exit_op, ...)
        n_out, ins_at = (walk.CLIP_CUSTOM_OUTPUTS, 1) if custom else (walk.CLIP_LOCAL_OUTPUTS, 0)
        wgot = wrapper(*winputs)
        torch.cuda.synchronize()
        wwant = plain(*winputs)
        report(
            row, f"rust_bio_tpu_torch/ops/csrc/{walk.SWEEP_WALK_CUSTOM.source}.cu", replaces,
            wgot, wwant,
            cuda_ms(torch, lambda: launch(*winputs), 10), cuda_ms(torch, lambda: plain(*winputs), 2),
            clip_walk_bytes(wgot, ins_at, n_out, ml_d_, custom), 8 * clip_path_cells(wgot, ins_at), n_launches=n_launches,
            wrapper_ms=cuda_ms(torch, lambda: wrapper(*winputs), 10), tb_strides=list(tb_q.stride()),
            geometry=walk.clip_walk_geometry(Bq, Nq - 1, custom), **sweep_usage,
        )
        del wgot, wwant

    clip_kernels(
        "sw_scan_local", "sweep_walk_local", (xb_d, yb_d, ml_d, nl_d), pens, (0, 0, 0, 0),
        np.full(B_ALN, LEN), K7_OPS_PER_CELL,
        ("rust_bio_tpu/ops/sw_pallas.py:1966", "rust_bio_tpu/ops/walk_pallas.py:916"),
    )
    cust = tens(xb_clip, yb_ext, ml_ext, nl_ext)
    custom_clips = (CUSTOM_XCLIP, CUSTOM_XCLIP, CUSTOM_YCLIP, CUSTOM_YCLIP)
    clip_kernels(
        "sw_scan_custom", "sweep_walk_custom", cust, CUSTOM_PENS, custom_clips,
        nl_ext, K9_OPS_PER_CELL,
        ("rust_bio_tpu/ops/sw_pallas.py:1601", "rust_bio_tpu/ops/walk_pallas.py:1128"),
    )

    # K11, K18 and K7 fed by BLOSUM62 on the homolog corpus, K12 and K9 fed
    # by it on the domain corpus; the plain versions take the feeder's
    # stream (or, for K18, its (B, M, N) tensor) of the same inputs
    lut_d = torch.from_numpy(dense_matrix("blosum62")).to(dev)
    hxb, hyb, hml, hnl = bp._pad(hxs, hys)
    dxb, dyb, dml, dnl = bp._pad(dxs, dys)
    hom = tens(hxb, hyb, hml, hnl)
    dom = tens(dxb, dyb, dml, dnl)

    def lut_bytes(xb_, yb_, ml_, nl_, out_bytes):
        """Bytes a LUT-fed scan must move: sequences, lengths and the LUT
        read once, ``out_bytes`` written."""
        return xb_.size + yb_.size + 8 * len(ml_) + 256 * 256 * 4 + out_bytes

    hcells = int((hml.astype(np.int64) * hnl).sum())
    h_tb = 2 * int(((hml.astype(np.int64) + 1) * hnl).sum())  # the cells K11 writes
    h_rows = int((hml.astype(np.int64) + 1).sum())
    plain_k11 = lambda: sw.scan_global_lut_plain(sw.subs2_stream_plain(hom[0], hom[1], lut_d), hom[2], hom[3], PROT_GO, PROT_GE)  # noqa: E731
    got = sw.scan_global_lut(*hom, PROT_GO, PROT_GE, lut_d)
    torch.cuda.synchronize()
    want = plain_k11()
    k11_ms = cuda_ms(torch, lambda: sw.scan_global_lut(*hom, PROT_GO, PROT_GE, lut_d), 5)
    report(
        "sw_scan_global_lut", "rust_bio_tpu_torch/ops/csrc/sw_warp.cu", "rust_bio_tpu/ops/sw_pallas.py:1129",
        [got[0]] + defined(got[1:], hom[2], hom[3]), [want[0]] + defined(want[1:], hom[2], hom[3]),
        k11_ms, cuda_ms(torch, plain_k11, 1),
        lut_bytes(hxb, hyb, hml, hnl, 4 * B_PROT + h_tb + 4 * h_rows),
        K1_OPS_PER_CELL * hcells,
        scores_only_ms=cuda_ms(torch, lambda: sw.scan_global_lut(*hom, PROT_GO, PROT_GE, lut_d, traceback=False), 5),
        stripe_rows=sw.warp_geometry(hxb.shape[1], sw.GLOBAL_WARP_LAYERS)[0],
    )
    del want
    # K2 on K11's pair-major view (the protein path's launches)
    tb = got[1]
    wgot = walk.sweep_walk_global(tb, hom[2], hom[3])
    torch.cuda.synchronize()
    wwant = walk.sweep_walk_global_plain(tb, hom[2], hom[3])
    path_cells = int(wgot[0].long().sum() + (wgot[1].long() > 0).sum() + wgot[2].long().sum()) + B_PROT
    report(
        "sweep_walk_global_homolog", f"rust_bio_tpu_torch/ops/csrc/{walk.SWEEP_WALK_GLOBAL.source}.cu",
        "rust_bio_tpu/ops/walk_pallas.py:74",
        wgot, wwant,
        k2_launch_ms(torch, walk, tb, hom[2], hom[3], 10),
        cuda_ms(torch, lambda: walk.sweep_walk_global_plain(tb, hom[2], hom[3]), 2),
        2 * path_cells + 8 * B_PROT + 2 * 2 * hyb.shape[1] * B_PROT + 2 * B_PROT,
        8 * path_cells, n_launches=prot_launches["sweep_walk_global"], tb_strides=list(tb.stride()),
        wrapper_ms=cuda_ms(torch, lambda: walk.sweep_walk_global(tb, hom[2], hom[3]), 10),
    )
    del got, tb, wgot, wwant
    # for comparison, not a route: the block-a-pair design (K13-LUT, with
    # traceback) on the same homolog corpus
    print(json.dumps({
        "phase": "k13_lut_homolog", "ms": cuda_ms(torch, lambda: sw.scan_global_rows_lut(*hom, PROT_GO, PROT_GE, lut_d), 3),
        "k11_ms": k11_ms, "pairs": B_PROT, "M": int(hxb.shape[1]), "N": int(hyb.shape[1]), "card": smi,
    }), flush=True)
    plain_k18 = lambda: sw.scores_global_lut_plain(sw.subs_tensor_plain(hom[0], hom[1], lut_d), hom[2], hom[3], PROT_GO, PROT_GE)  # noqa: E731
    sgot = sw.scores_global_lut(*hom, PROT_GO, PROT_GE, lut_d)
    torch.cuda.synchronize()
    # K18's other main-path input: phase 3d's long proteins (M = 4,978,
    # 46 KB of state a warp); the plain version 16 pairs at a time
    # (a (16, M, N) substitution tensor each)
    k18_lxb, k18_lyb, k18_lml, k18_lnl = bp._pad(*long_sets[2])
    k18_long = tens(k18_lxb, k18_lyb, k18_lml, k18_lnl)
    lgot = sw.scores_global_lut(*k18_long, PROT_GO, PROT_GE, lut_d)
    torch.cuda.synchronize()
    lwant = torch.cat([
        sw.scores_global_lut_plain(
            sw.subs_tensor_plain(k18_long[0][k : k + 16], k18_long[1][k : k + 16], lut_d),
            k18_long[2][k : k + 16], k18_long[3][k : k + 16], PROT_GO, PROT_GE,
        )
        for k in range(0, B_LPROT, 16)
    ])
    long_bound = max(
        lut_bytes(k18_lxb, k18_lyb, k18_lml, k18_lnl, 4 * B_LPROT) / HBM_BYTES_PER_S,
        K3_OPS_PER_CELL * int((k18_lml.astype(np.int64) * k18_lnl).sum()) / INT32_OPS_PER_S,
    ) * 1e3
    report(
        "sw_scores_global_lut", "rust_bio_tpu_torch/ops/csrc/sw_warp.cu", "rust_bio_tpu/ops/sw_pallas.py:79",
        [sgot, lgot], [plain_k18(), lwant],
        cuda_ms(torch, lambda: sw.scores_global_lut(*hom, PROT_GO, PROT_GE, lut_d), 5), cuda_ms(torch, plain_k18, 1),
        lut_bytes(hxb, hyb, hml, hnl, 4 * B_PROT),
        K3_OPS_PER_CELL * hcells,
        stripe_rows=sw.warp_geometry(hxb.shape[1], sw.SCORE_WARP_LAYERS, sw.SCORE_WARP_SHARED_MAX)[0],
        long_ms=cuda_ms(torch, lambda: sw.scores_global_lut(*k18_long, PROT_GO, PROT_GE, lut_d), 3),
        long_bound_ms=long_bound, long_M=int(k18_lxb.shape[1]), long_N=int(k18_lyb.shape[1]),
        long_geometry=sw.warp_geometry(k18_lxb.shape[1], sw.SCORE_WARP_LAYERS, sw.SCORE_WARP_SHARED_MAX)[:2],
    )
    del lgot, lwant, k18_long
    dcells = int((dml.astype(np.int64) * dnl).sum())
    d_tb = 2 * int(((dml.astype(np.int64) + 1) * dnl).sum())
    d_rows = int((dml.astype(np.int64) + 1).sum())
    plain_k12 = lambda: sw.scan_semiglobal_lut_plain(sw.subs2_stream_plain(dom[0], dom[1], lut_d), dom[2], dom[3], PROT_GO, PROT_GE, 0, 0)  # noqa: E731
    got = sw.scan_semiglobal_lut(*dom, PROT_GO, PROT_GE, lut_d, 0, 0)
    torch.cuda.synchronize()
    want = plain_k12()
    only = sw.scan_semiglobal_lut(*dom, PROT_GO, PROT_GE, lut_d, 0, 0, traceback=False)
    report(
        "sw_scan_semiglobal_lut", "rust_bio_tpu_torch/ops/csrc/sw_warp.cu", "rust_bio_tpu/ops/sw_pallas.py:1328",
        defined(got, dom[2], dom[3]) + defined([want[0]] + list(only[1:]), dom[2], dom[3])[1:],
        defined(want, dom[2], dom[3]) + defined(want, dom[2], dom[3])[1:],
        cuda_ms(torch, lambda: sw.scan_semiglobal_lut(*dom, PROT_GO, PROT_GE, lut_d, 0, 0), 5), cuda_ms(torch, plain_k12, 1),
        lut_bytes(dxb, dyb, dml, dnl, d_tb + 5 * 4 * d_rows),
        K5_OPS_PER_CELL * dcells,
        scores_only_ms=cuda_ms(torch, lambda: sw.scan_semiglobal_lut(*dom, PROT_GO, PROT_GE, lut_d, 0, 0, traceback=False), 5),
        stripe_rows=sw.warp_geometry(dxb.shape[1], sw.LOCAL_WARP_LAYERS)[0],
    )
    del want, only
    # K6 on K12's pair-major view (the protein path's semiglobal walk)
    tb = got[0]
    _, tbfix = _fixed_column(*got[1:], dom[2], PROT_GO, PROT_GE)
    wgot = walk.sweep_walk_semiglobal(tb, tbfix, dom[2], dom[3])
    torch.cuda.synchronize()
    wwant = walk.sweep_walk_semiglobal_plain(tb, tbfix, dom[2], dom[3])
    report(
        "sweep_walk_semiglobal_domain", f"rust_bio_tpu_torch/ops/csrc/{walk.SWEEP_WALK_SEMIGLOBAL.source}.cu",
        "rust_bio_tpu/ops/walk_pallas.py:609",
        wgot, wwant,
        cuda_ms(torch, lambda: walk.sweep_walk_semiglobal_launch(tb, tbfix, dom[2], dom[3]), 10),
        cuda_ms(torch, lambda: walk.sweep_walk_semiglobal_plain(tb, tbfix, dom[2], dom[3]), 2),
        semi_walk_bytes(wgot, dom[2], dyb.shape[1]), 8 * semi_path_cells(wgot), n_launches=prot_launches["sweep_walk_semiglobal"],
        wrapper_ms=cuda_ms(torch, lambda: walk.sweep_walk_semiglobal(tb, tbfix, dom[2], dom[3]), 10),
        tb_strides=list(tb.stride()),
    )
    del got, tb, wgot, wwant
    clip_cases = (
        ("sw_scan_local_lut", hom, (hxb, hyb, hml, hnl), (0, 0, 0, 0), K7_OPS_PER_CELL),
        ("sw_scan_custom_lut", dom, (dxb, dyb, dml, dnl), (DOMAIN_XCLIP, DOMAIN_XCLIP, DOMAIN_YCLIP, DOMAIN_YCLIP), K9_OPS_PER_CELL),
    )
    for name, args_d, (xb_, yb_, ml_, nl_), clips, ops_per_cell in clip_cases:
        local = name == "sw_scan_local_lut"

        def scan_fn(plain=False, traceback=True, args_d=args_d, clips=clips, local=local):
            if plain:
                subs2 = sw.subs2_stream_plain(args_d[0], args_d[1], lut_d)
                if local:
                    return sw.scan_local_lut_plain(subs2, args_d[2], args_d[3], PROT_GO, PROT_GE)
                return sw.scan_custom_lut_plain(subs2, args_d[2], args_d[3], PROT_GO, PROT_GE, *clips)
            if local:
                return sw.scan_local_lut(*args_d, PROT_GO, PROT_GE, lut_d, traceback=traceback)
            return sw.scan_custom_lut(*args_d, PROT_GO, PROT_GE, lut_d, *clips, traceback=traceback)

        got = scan_fn()
        torch.cuda.synchronize()
        want = scan_fn(plain=True)
        rows_ = int((ml_.astype(np.int64) + 1).sum())
        R_, placement_, _ = sw.warp_geometry(xb_.shape[1], sw.LOCAL_WARP_LAYERS)
        extra = {
            "scores_only_ms": cuda_ms(torch, lambda: scan_fn(traceback=False), 5),
            "stripe_rows": R_, "placement": placement_,
        }
        report(
            name, "rust_bio_tpu_torch/ops/csrc/sw_warp.cu",
            "rust_bio_tpu/alignment/pairwise/batched.py:948",
            defined_clip(got, args_d[2], args_d[3]), defined_clip(want, args_d[2], args_d[3]),
            cuda_ms(torch, scan_fn, 5), cuda_ms(torch, lambda: scan_fn(plain=True), 1),
            lut_bytes(xb_, yb_, ml_, nl_, 2 * int(((ml_.astype(np.int64) + 1) * (nl_ + 1)).sum()) + 4 * int((nl_ + 1).sum()) + 5 * 4 * rows_),
            ops_per_cell * int((ml_.astype(np.int64) * nl_).sum()), **extra,
        )
        del want
        if local:
            # K8 (the protein path's walk) and K10 on K7-LUT's pair-major view
            for walk_name, replaces in (
                ("sweep_walk_local", "rust_bio_tpu/ops/walk_pallas.py:916"),
                ("sweep_walk_custom", "rust_bio_tpu/ops/walk_pallas.py:1128"),
            ):
                clip_walk(
                    f"{walk_name}_homolog", walk_name, got, args_d[2], args_d[3], (PROT_GO, PROT_GE), clips, replaces,
                    n_launches=prot_launches[walk_name],
                )
        del got

    # K13 and K14 on the STR corpus, K13 fed by BLOSUM62 on the long
    # proteins: one check launch against the plain version (a second
    # multi-GB tb, compared a chunk of columns at a time; the score-only
    # call's scores too), the plain version timed by that one run, the
    # kernel by 5 warm launches, and by 5 more without traceback
    # (scores_only_ms: the same launch without the tb stores)
    def rows_kernel(name, args_d, ml_np, nl_np, scan, plain, replaces, table_bytes=0):
        score, tb_ = scan()
        torch.cuda.synchronize()
        (pscore, ptb), plain_ms = timed_once(torch, plain)
        err = max(
            max_abs_err([score], [pscore]), max_abs_err([scan(traceback=False)[0]], [pscore]),
            rows_tb_err(torch, tb_, ptb, args_d[2], args_d[3]),
        )
        del ptb, pscore
        Bq = len(ml_np)
        ml64 = ml_np.astype(np.int64)
        report(
            name, "rust_bio_tpu_torch/ops/csrc/sw_global_rows.cu", replaces, None, None,
            cuda_ms(torch, scan, 5), plain_ms,
            args_d[0].numel() + args_d[1].numel() + 8 * Bq + table_bytes + 4 * Bq + 2 * int(((ml64 + 1) * nl_np).sum()),
            K13_OPS_PER_CELL * int((ml64 * nl_np).sum()), err=err,
            scores_only_ms=cuda_ms(torch, lambda: scan(traceback=False), 5),
        )
        return tb_

    sxb, syb, sml, snl = ba._pad(*long_sets[0])
    sargs = tens(sxb, syb, sml, snl)
    tb = rows_kernel(
        "sw_scan_global_rows", sargs, sml, snl,
        lambda traceback=True: sw.scan_global_rows(*sargs, *pens, traceback=traceback),
        lambda: sw.scan_global_rows_plain(*sargs, *pens), "rust_bio_tpu/ops/sw_pallas.py:2260",
    )
    wgot = walk.sweep_walk_global_seg(tb, sargs[2], sargs[3])
    torch.cuda.synchronize()
    wwant, wplain_ms = timed_once(torch, lambda: walk.sweep_walk_global_seg_plain(tb, sargs[2], sargs[3]))
    path_cells = int(wgot[0].long().sum() + (wgot[1].long() > 0).sum() + wgot[2].long().sum()) + B_STR
    report(
        "sweep_walk_global_seg", "rust_bio_tpu_torch/ops/csrc/walk_global_seg.cu", "rust_bio_tpu/ops/walk_pallas.py:313",
        wgot, wwant, cuda_ms(torch, lambda: walk.sweep_walk_global_seg(tb, sargs[2], sargs[3]), 5), wplain_ms,
        2 * path_cells + 8 * B_STR + 2 * 2 * syb.shape[1] * B_STR + 2 * B_STR,
        8 * path_cells,
        tile=walk.seg_walk_geometry(), vector_rows=walk._vector_rows(tb), path_steps=path_cells,
        path_steps_max=int((wgot[0].long().sum(0) + (wgot[1].long() > 0).sum(0) + wgot[2].long()).max()) + 1,
    )
    del tb, wgot, wwant
    lxb, lyb, lml, lnl = bp._pad(*long_sets[2])
    largs = tens(lxb, lyb, lml, lnl)
    tb = rows_kernel(
        "sw_scan_global_rows_lut", largs, lml, lnl,
        lambda traceback=True: sw.scan_global_rows_lut(*largs, PROT_GO, PROT_GE, lut_d, traceback=traceback),
        lambda: sw.scan_global_rows_lut_plain(*largs, PROT_GO, PROT_GE, lut_d),
        "rust_bio_tpu/alignment/pairwise/batched.py:948", 256 * 256 * 4,
    )
    del tb

    # K15 and K15-walk on the long semiglobal corpus, K15-LUT on the long
    # protein local corpus: one check launch against the plain version (tb
    # compared 256 columns at a time), the plain version timed by that one
    # run, the kernel by 5 warm launches, and by 5 more without traceback
    # (scores_only_ms: the same launch without the tb and lx stores);
    # geometry (T, R, placement) and the tb's strides (its pair-major view);
    # K15-walk on that view (tile: its launch, vector_rows: 16-byte copies)
    def columns_kernel(name, args_d, scan, plain, replaces, table_bytes=0):
        got = scan()
        torch.cuda.synchronize()
        want, plain_ms = timed_once(torch, plain)
        ml_d_, nl_d_ = args_d[2], args_d[3]
        cols_ok = torch.arange(got[1].shape[0], device=dev)[:, None] <= nl_d_[None, :]
        rows_ok = torch.arange(got[2].shape[1], device=dev)[None, :] <= ml_d_[:, None]
        err = max(
            rows_tb_err(torch, got[0], want[0], ml_d_, nl_d_ + 1),
            max_abs_err([torch.where(cols_ok, got[1], 0)], [torch.where(cols_ok, want[1], 0)]),
            max_abs_err([torch.where(rows_ok, g, 0) for g in got[2:]], [torch.where(rows_ok, w, 0) for w in want[2:]]),
        )
        del want
        ml64, nl64 = ml_d_.long(), nl_d_.long()
        Bq = ml_d_.shape[0]
        report(
            name, "rust_bio_tpu_torch/ops/csrc/sw_columns.cu", replaces, None, None,
            cuda_ms(torch, scan, 5), plain_ms,
            args_d[0].numel() + args_d[1].numel() + 8 * Bq + table_bytes + 2 * int(((ml64 + 1) * (nl64 + 1)).sum())
            + 4 * int((nl64 + 1).sum()) + 5 * 4 * int((ml64 + 1).sum()),
            K15_OPS_PER_CELL * int((ml64 * nl64).sum()), err=err,
            scores_only_ms=cuda_ms(torch, lambda: scan(traceback=False), 5),
            geometry=sw.columns_geometry(int(args_d[0].shape[1]))[:3], tb_strides=list(got[0].stride()),
        )
        return got

    cargs = tens(*ba._pad(*semi_set))
    scan = columns_kernel(
        "sw_scan_columns", cargs, lambda traceback=True: sw.scan_columns(*cargs, *pens, *SEMI_CLIPS, traceback=traceback),
        lambda: sw.scan_columns_plain(*cargs, *pens, *SEMI_CLIPS), "rust_bio_tpu/ops/sw_pallas.py:313",
    )
    _columns_fixups(scan, cargs[2], cargs[3], (GO, GE, *SEMI_CLIPS))
    winputs = (scan[0], scan[1], scan[5], cargs[2], cargs[3])
    wgot = walk.walk_steps(*winputs)
    torch.cuda.synchronize()
    wwant, wplain_ms = timed_once(torch, lambda: walk.walk_steps_plain(*winputs))
    # one cell a step plus the entry cell's; lx or Ly on each clip step
    steps = int((wgot[0] > 0).sum())
    clip_steps = int((wgot[0] >= 5).sum())
    T, Bq = wgot[0].shape
    report(
        "walk_steps", "rust_bio_tpu_torch/ops/csrc/walk_steps.cu", "rust_bio_tpu/alignment/pairwise/batched.py:507",
        wgot, wwant, cuda_ms(torch, lambda: walk.walk_steps(*winputs), 5), wplain_ms,
        2 * (steps + Bq) + 4 * clip_steps + 8 * Bq + 3 * T * Bq + 16 * Bq,
        8 * (steps + Bq),
        tile=walk.seg_walk_geometry(), vector_rows=walk._vector_rows(scan[0]), tb_strides=list(scan[0].stride()),
        path_steps=steps, path_steps_max=int((wgot[0] > 0).sum(0).max()),
    )
    del scan, winputs, wgot, wwant
    pargs = tens(*bp._pad(*prot_set))
    columns_kernel(
        "sw_scan_columns_lut", pargs,
        lambda traceback=True: sw.scan_columns_lut(*pargs, PROT_GO, PROT_GE, lut_d, 0, 0, 0, 0, traceback=traceback),
        lambda: sw.scan_columns_lut_plain(*pargs, PROT_GO, PROT_GE, lut_d, 0, 0, 0, 0),
        "rust_bio_tpu/alignment/pairwise/batched.py:948", 256 * 256 * 4,
    )
    # K16 on the 1 kb corpus (its row) and the STR corpus (a dense tb of
    # about 8 GB; compared 256 columns at a time), the plain version timed by
    # one run, the kernel by 3 (ms: the wrapper with its tb zero-fill,
    # lengths checked on the host as the aligner does; kernel_ms: the launch
    # alone into the outputs of the checked call); K16-walk on both
    # corpora, on K16's pair-major view (its row: the 1 kb corpus, the STR
    # pairs in its str_global_* fields)
    def banded_arrays(al, mode, xs, ys):
        sc_ = {
            "semiglobal": al.scoring.with_clips(*SEMI_CLIPS), "global_": al.scoring.with_clips(*SEMI_CLIPS[:1] * 4),
            "local": al.scoring.with_clips(0, 0, 0, 0), "custom": al.scoring,
        }[mode]
        _out, run_idx, _crop, _c0s, arrays = al._band_batch(xs, ys, sc_, banded_device.AlignmentMode.Custom, False)
        check(len(run_idx) == len(xs), f"banded kernel check: {len(xs) - len(run_idx)} pairs off the device")
        return arrays

    def banded_scan(arrays, plain=False):
        t = tens(*arrays[:6])
        if plain:
            return sw.scan_banded_plain(*t[:4], arrays[6], *t[4:])
        return sw.scan_banded(*t[:4], arrays[6], *t[4:])

    band_k16 = {}
    for name, arrays in (("kb", banded_arrays(bb, "semiglobal", *kb_set)), ("str_global", banded_arrays(bb, "global_", *long_sets[0]))):
        got = banded_scan(arrays)
        torch.cuda.synchronize()
        want, plain_ms = timed_once(torch, lambda arrays=arrays: banded_scan(arrays, plain=True))
        ml_d_, nl_d_ = tens(arrays[2], arrays[3])
        err = max(rows_tb_err(torch, got[0], want[0], ml_d_, nl_d_), max_abs_err(got[1:], want[1:]))
        want_finals = [w.clone() for w in want[1:]]
        del want
        t = tens(*arrays[:6])
        ms = cuda_ms(torch, lambda t=t, arrays=arrays: sw.scan_banded(*t[:4], arrays[6], *t[4:]), 3)
        outs = (pair_major_base(got[0]), *got[1:])
        kernel_ms = cuda_ms(torch, lambda t=t, arrays=arrays, outs=outs: sw.scan_banded_launch(outs, *t[:4], arrays[6], *t[4:]), 3)
        check(max_abs_err(got[1:], want_finals) == 0, f"K16 {name}: a repeated launch changed the finals")
        Bq, Mq = arrays[0].shape
        Nq = arrays[1].shape[1]
        cells_q = band_cells(arrays)
        # the dense pair-major tb once (its band cells and its rows' padding
        # to Xp are in it), x and y, the lengths, the bands, lx and the
        # five finals
        nbytes = (
            2 * Nq * sw.pair_major_pitch(Mq) * Bq + Bq * (Mq + Nq) + 8 * Bq + 2 * 4 * Bq * (Nq + 1) + 4 * Nq * Bq
            + 5 * 4 * Bq * (Mq + 1)
        )
        warps = sw.banded_geometry(Mq, Bq, torch.cuda.get_device_properties(dev).multi_processor_count)[0]
        band_k16[name] = (got, arrays, err, ms, plain_ms, nbytes, K16_OPS_PER_CELL * cells_q, cells_q, kernel_ms, warps)
        del got, outs
    # K16-walk on K16's pair-major view of both corpora, before their tbs go
    def banded_walk(got, arrays):
        t_ = tens(*arrays[:6])
        _, winputs = banded_device._walk_inputs(got, t_[2], t_[3], arrays[6], t_[4], t_[5])
        wgot = walk.walk_banded(*winputs)
        torch.cuda.synchronize()
        wwant, wplain_ms = timed_once(torch, lambda: walk.walk_banded_plain(*winputs))
        err = max_abs_err(wgot, wwant)
        ms = cuda_ms(torch, lambda: walk.walk_banded(*winputs), 5)
        # one 2-byte tb cell a step plus the entry cell's; in column nlens
        # (the steps before the first op that leaves it, and that op) the
        # 4-byte tbfix cell in its place, which holds Ly; lx on x-suffix
        # clip steps
        codes = wgot[0].cpu().numpy().astype(np.int64)
        lens = wgot[1].cpu().to(torch.int32).numpy()
        steps = int((codes > 0).sum())
        leaves = np.isin(codes, (TB_DEL, TB_SUBST, TB_MATCH, TB_YCLIP_PREFIX)) | ((codes == TB_YCLIP_SUFFIX) & (lens > 0))
        fix_steps = int(np.where(leaves.any(0), leaves.argmax(0) + 1, (codes > 0).sum(0)).sum())
        xsuffix_steps = int((codes == TB_XCLIP_SUFFIX).sum())
        T, Bq = codes.shape
        nbytes = 2 * (steps + Bq) + 2 * fix_steps + 4 * xsuffix_steps + 8 * Bq + 3 * T * Bq + 16 * Bq
        return {
            "err": err, "ms": ms, "plain_ms": wplain_ms, "bytes": nbytes, "ops": 8 * (steps + Bq), "steps": steps,
            "longest_steps": int((codes > 0).sum(0).max()), "tb_strides": list(winputs[0].stride()),
        }

    walk_kb = banded_walk(band_k16["kb"][0], band_k16["kb"][1])
    walk_str = banded_walk(band_k16["str_global"][0], band_k16["str_global"][1])
    _, _, _, _, _, sbytes, sops, scells, skernel_ms, swarps = band_k16["str_global"]
    _, _, kerr, kms, kplain_ms, kbytes, kops, kcells, kkernel_ms, kwarps = band_k16["kb"]
    report(
        "sw_scan_banded", "rust_bio_tpu_torch/ops/csrc/sw_banded.cu", "rust_bio_tpu/ops/sw_pallas.py:2514", None, None,
        kms, kplain_ms, kbytes, kops, err=max(kerr, band_k16["str_global"][2]), band_cells=kcells,
        kernel_ms=kkernel_ms, warps_a_block=kwarps,
        str_global_ms=band_k16["str_global"][3], str_global_kernel_ms=skernel_ms, str_global_warps_a_block=swarps,
        str_global_plain_ms=band_k16["str_global"][4],
        str_global_bound_ms=max(sbytes / HBM_BYTES_PER_S, sops / INT32_OPS_PER_S) * 1e3, str_global_band_cells=scells,
    )
    del band_k16
    # K16-walk's row: the 1 kb corpus, and the STR pairs beside it
    report(
        "walk_banded", "rust_bio_tpu_torch/ops/csrc/walk_steps.cu", "rust_bio_tpu/alignment/pairwise/banded_device.py:231",
        None, None, walk_kb["ms"], walk_kb["plain_ms"], walk_kb["bytes"], walk_kb["ops"],
        err=max(walk_kb["err"], walk_str["err"]), steps=walk_kb["steps"], longest_steps=walk_kb["longest_steps"],
        tb_strides=walk_kb["tb_strides"], tile_geometry=walk.seg_walk_geometry(),
        str_global_ms=walk_str["ms"], str_global_plain_ms=walk_str["plain_ms"],
        str_global_bound_ms=max(walk_str["bytes"] / HBM_BYTES_PER_S, walk_str["ops"] / INT32_OPS_PER_S) * 1e3,
        str_global_bound_by="bytes" if walk_str["bytes"] / HBM_BYTES_PER_S >= walk_str["ops"] / INT32_OPS_PER_S else "operations",
        str_global_steps=walk_str["steps"], str_global_longest_steps=walk_str["longest_steps"],
        str_global_max_abs_err=walk_str["err"],
    )

    # the PairHMM kernels on 3g's corpora; floats, each within its stated
    # tolerance of its plain version on the same inputs (f32: 1e-5 of
    # max(1, |p|) and the same -3e38 lanes; f64 log space and homopoly
    # 1e-12 relative; K17-exact 1e-14 relative); bounds: operations over
    # the f32 or f64 peak, or bytes when larger
    def report_float(name, source, replaces, err, tol, ms, plain_ms, nbytes, nops, ops_per_s, **extra):
        check(err <= tol, f"{name}: {err} from its plain version (tolerance {tol})")
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = nops / ops_per_s * 1e3
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None,
        }
        kernels.append(row)
        print(json.dumps({"phase": "kernel", **row, "tolerance": tol, "bytes": nbytes, "ops": nops, **extra, "card": smi}), flush=True)

    def hmm_inputs(xs_, ys_, xl_=None, yl_=None):
        xl_, yl_ = hmm_lens(xs_, ys_, xl_, yl_)
        return tens(xs_, ys_, xl_, yl_), xl_.astype(np.int64), yl_.astype(np.int64)

    def hmm_bytes(xs_, ys_, out_bytes, emit_bytes):
        # x and y, the lengths, the emissions and the output, once
        return xs_.size + ys_.size + 8 * len(xs_) + emit_bytes + out_bytes * len(xs_)

    def hmm_check(fn, plain_fn, err_fn, reps):
        """(max error, kernel ms, plain ms, lanes bit-identical) of a kernel
        and its plain version on the same inputs."""
        got = fn()
        torch.cuda.synchronize()
        want, plain_ms = timed_once(torch, plain_fn)
        same = int((got == want).sum())
        return err_fn(got.cpu().numpy(), want.cpu().numpy()), cuda_ms(torch, fn, reps), plain_ms, same

    lin_emit = torch.from_numpy(np.exp(bench_emit).astype(np.float32)).to(dev)
    bargs, bxl, byl = hmm_inputs(hbx, hby)
    err, ms, plain_ms, same = hmm_check(
        lambda: pairhmm.pairhmm_fwd_scaled(*bargs, lin._lin_params, lin_emit, True),
        lambda: pairhmm.pairhmm_fwd_scaled_plain(*bargs, lin._lin_params, lin_emit, True), f32_err, 10,
    )
    # GATK-like pairs, per-lane emissions: every column of the padded width
    g_args, g_xl, _ = hmm_inputs(gx, gy, gxl, gyl)
    g_emit = torch.from_numpy(np.exp(gep).astype(np.float32)).to(dev)
    g_err, g_ms, g_plain_ms, g_same = hmm_check(
        lambda: pairhmm.pairhmm_fwd_scaled(*g_args, glin._lin_params, g_emit, True),
        lambda: pairhmm.pairhmm_fwd_scaled_plain(*g_args, glin._lin_params, g_emit, True), f32_err, 5,
    )
    g_ops = K17_OPS_PER_CELL * int(g_xl.sum()) * gy.shape[1]
    report_float(
        "pairhmm_fwd_scaled", "rust_bio_tpu_torch/ops/csrc/pairhmm_scaled.cu", "rust_bio_tpu/ops/pairhmm_pallas.py:48",
        max(err, g_err), 1e-5, ms, plain_ms, hmm_bytes(hbx, hby, 4, 12), K17_OPS_PER_CELL * int(bxl.sum()) * hby.shape[1],
        F32_OPS_PER_S, peak="f32 67 TFLOP/s", gatk_ms=g_ms, gatk_plain_ms=g_plain_ms, gatk_err=g_err,
        gatk_bound_ms=max(hmm_bytes(gx, gy, 4, 12 * B_GATK) / HBM_BYTES_PER_S, g_ops / F32_OPS_PER_S) * 1e3,
        geometry=list(pairhmm.pairhmm_scaled_geometry(hby.shape[1], B_HMM, sw._sm_count(dev))),
        gatk_geometry=list(pairhmm.pairhmm_scaled_geometry(gy.shape[1], B_GATK, sw._sm_count(dev))),
        bit_identical_lanes=same, lanes=B_HMM, gatk_bit_identical_lanes=g_same, gatk_lanes=B_GATK,
        # registers of the instantiations <SEMI, C> (C 0: the scratch's)
        registers=kernel_registers(_build.build(["pairhmm_scaled"])["pairhmm_scaled"], r"pairhmm_scaled_warp_kernelILb([01])ELi(\d+)E"),
    )
    # K17-log on the read-as-x lanes (its main-path inputs), f32 and f64; on
    # the bench pairs too, beside K17
    s_args, s_xl, s_yl = hmm_inputs(sx, sy, sxl, syl)
    s_cells = int((s_xl * s_yl).sum())
    log_f32 = torch.from_numpy(gatk_emit).float().to(dev)
    err, ms, plain_ms, _ = hmm_check(
        lambda: pairhmm.pairhmm_fwd_log(*s_args, glin._log_params, log_f32, True),
        lambda: pairhmm.pairhmm_fwd_log_plain(*s_args, glin._log_params, log_f32, True), f32_err, 5,
    )
    g64 = BatchPairHMM(*gatk_gaps, dtype=torch.float64, device=dev)
    log_f64 = torch.from_numpy(gatk_emit).to(dev)
    err64, ms64, plain_ms64, _ = hmm_check(
        lambda: pairhmm.pairhmm_fwd_log(*s_args, g64._log_params, log_f64, True),
        lambda: pairhmm.pairhmm_fwd_log_plain(*s_args, g64._log_params, log_f64, True), rel_err, 5,
    )
    check(err64 <= 1e-12, f"pairhmm_fwd_log f64: {err64} from its plain version")
    b_log = torch.from_numpy(bench_emit).float().to(dev)
    sms = sw._sm_count(dev)
    s_geom = pairhmm.pairhmm_log_geometry(sy.shape[1], B_GATK_SWAP, torch.float32, sms)
    s_geom64 = pairhmm.pairhmm_log_geometry(sy.shape[1], B_GATK_SWAP, torch.float64, sms)
    report_float(
        "pairhmm_fwd_log", "rust_bio_tpu_torch/ops/csrc/pairhmm_log.cu", "rust_bio_tpu/stats/pairhmm/device.py:85",
        err, 1e-5, ms, plain_ms, hmm_bytes(sx, sy, 4, 12), K17_LOG_OPS_PER_CELL * s_cells, F32_OPS_PER_S,
        peak="f32 67 TFLOP/s", cells=s_cells, f64_ms=ms64, f64_plain_ms=plain_ms64, f64_rel_err=err64,
        f64_bound_ms=max(hmm_bytes(sx, sy, 8, 24) / HBM_BYTES_PER_S, K17_LOG_OPS_PER_CELL * s_cells / F64_OPS_PER_S) * 1e3,
        bench_ms=cuda_ms(torch, lambda: pairhmm.pairhmm_fwd_log(*bargs, lin._log_params, b_log, True), 5),
        bench_bound_ms=K17_LOG_OPS_PER_CELL * int((bxl * byl).sum()) / F32_OPS_PER_S * 1e3,
        stripe_cols=s_geom[0], warps_per_block=s_geom[1], placement=s_geom[2], f64_placement=s_geom64[2],
    )
    # K17-exact on the exact corpus, banded at 4 (the reference bench's
    # setting) and unbanded; the skip masks bit for bit
    e_args, e_xl, e_yl = hmm_inputs(ex_x, ex_y)
    e_emit = torch.from_numpy(bench_emit).to(dev)
    got, skip = pairhmm.pairhmm_fwd_exact(*e_args, exact._params, e_emit, True, HMM_MED, True)
    torch.cuda.synchronize()
    (want, wskip), plain_ms = timed_once(
        torch, lambda: pairhmm.pairhmm_fwd_exact_plain(*e_args, exact._params, e_emit, True, HMM_MED, True)
    )
    check(torch.equal(skip, wskip), "pairhmm_fwd_exact: the skip mask differs from its plain version")
    err = rel_err(got.cpu().numpy(), want.cpu().numpy())
    bit_equal = int((got.view(torch.int64) == want.view(torch.int64)).sum())
    check(bit_equal == B_HMM_EXACT, f"pairhmm_fwd_exact: {B_HMM_EXACT - bit_equal} banded lanes differ in their bits")
    e_cells = int((e_xl * e_yl).sum()) - int(skip.sum())
    ms = cuda_ms(torch, lambda: pairhmm.pairhmm_fwd_exact(*e_args, exact._params, e_emit, True, HMM_MED), 5)
    del skip, wskip
    u_err, u_ms, u_plain_ms, u_same = hmm_check(
        lambda: pairhmm.pairhmm_fwd_exact(*e_args, exact._params, e_emit, True),
        lambda: pairhmm.pairhmm_fwd_exact_plain(*e_args, exact._params, e_emit, True), rel_err, 5,
    )
    check(u_same == B_HMM_EXACT, f"pairhmm_fwd_exact: {B_HMM_EXACT - u_same} unbanded lanes differ in their bits")
    u_cells = int((e_xl * e_yl).sum())
    e_geometry = {
        name: pairhmm.pairhmm_exact_geometry(ex_y.shape[1], B_HMM_EXACT, banded, sw._sm_count(dev))
        for name, banded in (("geometry", True), ("unbanded_geometry", False))
    }
    report_float(
        "pairhmm_fwd_exact", "rust_bio_tpu_torch/ops/csrc/pairhmm_exact.cu", "rust_bio_tpu/stats/pairhmm/exact.py:150",
        max(err, u_err), 1e-14, ms, plain_ms, hmm_bytes(ex_x, ex_y, 8, 24), K17_EXACT_OPS_PER_CELL * e_cells,
        F64_OPS_PER_S, peak="f64 34 TFLOP/s", banded_cells=e_cells, bit_identical_lanes=bit_equal, lanes=B_HMM_EXACT,
        unbanded_ms=u_ms, unbanded_plain_ms=u_plain_ms, unbanded_bit_identical_lanes=u_same,
        unbanded_bound_ms=K17_EXACT_OPS_PER_CELL * u_cells / F64_OPS_PER_S * 1e3, **e_geometry,
    )
    # K17-homopoly on the homopoly corpus, f32 (the main path's) and f64
    h_args, h_xl, h_yl = hmm_inputs(hox, hoy)
    h_cells = int((h_xl * h_yl).sum())
    h_emit = torch.from_numpy(homo_emit).float().to(dev)
    err, ms, plain_ms, _ = hmm_check(
        lambda: pairhmm.pairhmm_fwd_homopoly(*h_args, homo._params, h_emit, True),
        lambda: pairhmm.pairhmm_fwd_homopoly_plain(*h_args, homo._params, h_emit, True), f32_err, 5,
    )
    homo64 = BatchHomopolyPairHMM(*bench_gaps, *hops, dtype=torch.float64, device=dev)
    h_emit64 = torch.from_numpy(homo_emit).to(dev)
    err64, ms64, plain_ms64, _ = hmm_check(
        lambda: pairhmm.pairhmm_fwd_homopoly(*h_args, homo64._params, h_emit64, True),
        lambda: pairhmm.pairhmm_fwd_homopoly_plain(*h_args, homo64._params, h_emit64, True), rel_err, 3,
    )
    check(err64 <= 1e-12, f"pairhmm_fwd_homopoly f64: {err64} from its plain version")
    report_float(
        "pairhmm_fwd_homopoly", "rust_bio_tpu_torch/ops/csrc/pairhmm_homopoly.cu",
        "rust_bio_tpu/stats/pairhmm/homopoly_device.py:114",
        err, 1e-5, ms, plain_ms, hmm_bytes(hox, hoy, 4, 16), K17_HOMOPOLY_OPS_PER_CELL * h_cells, F32_OPS_PER_S,
        peak="f32 67 TFLOP/s", cells=h_cells, f64_ms=ms64, f64_plain_ms=plain_ms64, f64_rel_err=err64,
        f64_bound_ms=max(hmm_bytes(hox, hoy, 8, 32) / HBM_BYTES_PER_S, K17_HOMOPOLY_OPS_PER_CELL * h_cells / F64_OPS_PER_S) * 1e3,
        geometry=[list(pairhmm.pairhmm_log_geometry(hoy.shape[1], hoy.shape[0], dt, sw._sm_count(dev), pairhmm.HOMOPOLY_STATES))
                  for dt in (torch.float32, torch.float64)],
    )
    # T_ROWS: K1 (one warp a pair over lane stripes) against K13 (one
    # block a pair; its speed does not depend on rb), on 128 pairs
    # at 600 bp, 1 kb and 2 kb (y = x at 5% substitutions); T_COLUMNS: K9
    # (one warp a pair) against K15 (one block a pair) on the same pairs
    # in semiglobal mode
    t_rows, t_columns = {}, {}
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for L in T_ROWS_LENS:
        xq = acgt[rng.integers(0, 4, size=(B_STR, L))]
        yq = xq.copy()
        mut = rng.random(size=xq.shape) < STR_SUB
        yq[mut] = acgt[rng.integers(0, 4, size=int(mut.sum()))]
        q = tens(xq, yq, np.full(B_STR, L, np.int32), np.full(B_STR, L, np.int32))
        t_rows[f"k1_ms_{L}"] = cuda_ms(torch, lambda: sw.scan_global(*q, *pens), 2)
        t_rows[f"k13_ms_{L}"] = cuda_ms(torch, lambda: sw.scan_global_rows(*q, *pens), 2)
        t_columns[f"k9_ms_{L}"] = cuda_ms(torch, lambda: sw.scan_custom(*q, *pens, *SEMI_CLIPS), 2)
        t_columns[f"k15_ms_{L}"] = cuda_ms(torch, lambda: sw.scan_columns(*q, *pens, *SEMI_CLIPS), 2)
    print(json.dumps({"phase": "t_rows", "pairs": B_STR, **t_rows, "card": smi}), flush=True)
    print(json.dumps({"phase": "t_columns", "pairs": B_STR, **t_columns, "card": smi}), flush=True)
    print(json.dumps({"phase": "kernel_checks", "seconds": time.perf_counter() - t_phase}), flush=True)

    # ---- 3i. the SMEM read mapper, counted (after phase 4, which frees
    # phase 3h's 2.2 G index; K-SMEM's kernel row is reported here) ------
    smem_launches, smem_rates, _ = smem_phase(torch, dev, args.seed, genome, sc, counters, report, smi)
    launches = {name: launches[name] + smem_launches[name] for name in counters}

    # ---- 3j. the checkpointed stream over phase 3's mapper, counted ------
    stream_launches, stream_rates = stream_phase(torch, np.frombuffer(genome, np.uint8), mapper, counters, args.seed, smi)
    launches = {name: launches[name] + stream_launches[name] for name in counters}

    # ---- 3k. the HMM, counted (its kernel rows reported there) -----------
    scan_launches, scan_rates = hmm_phase(torch, dev, args.seed, counters, smi, kernels)
    launches = {name: launches[name] + scan_launches[name] for name in counters}

    # ---- 5. end-to-end rates --------------------------------------------
    t_phase = time.perf_counter()
    rates = {**smem_rates, **stream_rates, **scan_rates}
    for name, (xs, ys) in corpora.items():
        yarr = yb if name == "random" else yb_hi
        ml_np = np.full(B_ALN, LEN, np.int32)
        dev_s = host_s(torch, lambda: ba.global_packed_arrays(xb, yarr, ml_np, ml_np), 5)
        del_s = host_s(torch, lambda: ba.global_(xs, ys), 3)
        rates[f"global_{name}_alignments_per_s_device"] = B_ALN / dev_s
        rates[f"global_{name}_alignments_per_s_delivered"] = B_ALN / del_s
    rates["scores_global_pairs_per_s"] = B_ALN / host_s(torch, lambda: ba.scores(*corpora["random"], "global"), 3)
    rates["fm_queries_per_s_device"] = B_FM / host_s(torch, lambda: index.search_arrays(pats_d, plens_d), 10)
    rates["fm_queries_per_s_delivered"] = B_FM / host_s(torch, lambda: index.backward_search_batch(queries), 3)
    rates["fm_index_build_s"] = build_s
    # the compact path: COMPACT_HANDLES handles of the 2%-divergence pairs,
    # one stacked pull, every CIGAR formatted (bench.py:1350-1360)
    hi_ml = np.full(B_ALN, LEN, np.int32)

    def run_compact():
        handles = [ba.global_packed_compact_async_arrays(xb, yb_hi, hi_ml, hi_ml) for _ in range(COMPACT_HANDLES)]
        for r in BatchAligner.packed_compact_finish_many(handles):
            r.cigars()

    rates["compact_global_pairs_per_s_delivered"] = COMPACT_HANDLES * B_ALN / host_s(torch, run_compact, 3)
    # phase 3h's 50 Mbp index: K4-LUT and K4 device-only (each with its
    # wrapper's length check), K4-LUT delivered from numpy; the host SA-IS
    rates["fm_lut_queries_per_s_device"] = B_FM / host_s(torch, lambda: large.search_arrays_lut(lp_d, ll_d), 10)
    rates["fm_lut_queries_per_s_delivered"] = B_FM / host_s(torch, lambda: large.search_batch_lut(large_pats, ll_np), 3)
    rates["fm_large_queries_per_s_device"] = B_FM / host_s(torch, lambda: large.search_arrays(lp_d, ll_d), 10)
    rates["fm_sais_s"] = sais_s
    fm_rows_d = torch.from_numpy(fm_rows).to(dev)
    rates["fm_locate_rows_per_s_device"] = len(fm_rows) / host_s(torch, lambda: index.locate_rows(fm_rows_d), 10)
    rates["mapper_reads_per_s"] = len(main_reads) / host_s(torch, lambda: mapper.map_batch(main_reads), 3)
    stream = [reads[o : o + B_READS] for o in range(0, n_reads, B_READS)]
    rates["mapper_stream_reads_per_s"] = n_reads / host_s(torch, lambda: [len(p) for p in mapper.map_stream(stream)], 2)
    rates["semiglobal_pairs_per_s_device"] = B_READS / host_s(
        torch, lambda: ba.semiglobal_packed_async_arrays(xb_ext, yb_ext, ml_ext, nl_ext), 5
    )
    rates["semiglobal_pairs_per_s_delivered"] = B_READS / host_s(
        torch,
        lambda: ba.semiglobal_packed_finish(ba.semiglobal_packed_async_arrays(xb_ext, yb_ext, ml_ext, nl_ext)).cigars(),
        3,
    )
    rates["mapper_index_build_s"] = mapper_build_s
    ml_np = np.full(B_ALN, LEN, np.int32)
    rates["local_alignments_per_s_device"] = B_ALN / host_s(
        torch, lambda: ba._custom_device(xb, yb, ml_np, ml_np, (0, 0, 0, 0)), 5
    )
    rates["local_alignments_per_s_delivered"] = B_ALN / host_s(torch, lambda: ba.local(*corpora["random"]), 3)
    rates["scores_local_pairs_per_s"] = B_ALN / host_s(torch, lambda: ba.scores(*corpora["random"], "local"), 3)
    rates["custom_alignments_per_s_device"] = B_READS / host_s(
        torch, lambda: bac._custom_device(xb_clip, yb_ext, ml_ext, nl_ext, custom_clips), 5
    )
    rates["custom_alignments_per_s_delivered"] = B_READS / host_s(torch, lambda: bac.custom(custom_xs, custom_ys), 3)
    rates["scores_custom_pairs_per_s"] = B_READS / host_s(torch, lambda: bac.scores(custom_xs, custom_ys, "custom"), 3)
    rates["protein_global_alignments_per_s_device"] = B_PROT / host_s(torch, lambda: bp.global_packed_arrays(hxb, hyb, hml, hnl), 5)
    rates["protein_global_alignments_per_s_delivered"] = B_PROT / host_s(torch, lambda: bp.global_(hxs, hys), 2)
    rates["scores_protein_global_pairs_per_s"] = B_PROT / host_s(torch, lambda: bp.scores(hxs, hys, "global"), 3)
    rates["protein_local_alignments_per_s_device"] = B_PROT / host_s(
        torch, lambda: bp._custom_device(hxb, hyb, hml, hnl, (0, 0, 0, 0)), 5
    )
    rates["protein_local_alignments_per_s_delivered"] = B_PROT / host_s(torch, lambda: bp.local(hxs, hys), 2)
    rates["protein_semiglobal_pairs_per_s_device"] = B_PROT / host_s(
        torch, lambda: bp.semiglobal_packed_async_arrays(dxb, dyb, dml, dnl), 5
    )
    rates["protein_semiglobal_pairs_per_s_delivered"] = B_PROT / host_s(torch, lambda: bp.semiglobal(dxs, dys), 2)
    # long global: device-only from one run of the packed path; delivered
    # from phase 3d's counted global_ call
    rates["global_long_device"] = B_STR / host_s(torch, lambda: ba.global_packed_async_arrays(sxb, syb, sml, snl), 1)
    rates["global_long_delivered"] = B_STR / long_delivered_s["str"]
    rates["protein_global_long_device"] = B_LPROT / host_s(
        torch, lambda: bp.global_packed_async_arrays(lxb, lyb, lml, lnl), 1
    )
    rates["protein_global_long_delivered"] = B_LPROT / long_delivered_s["protein"]
    # long clip modes: device-only from one run of the device path (K15,
    # the fixups, K15-walk, the pack); delivered from phase 3e's counted call
    for name, (al, mode, (xs, ys)) in zip(clip_names, clip_paths):
        padded = al._pad(xs, ys)
        rates[f"{name}_long_device"] = len(xs) / host_s(torch, lambda: al._columns_device(*padded, al._clips(mode)), 1)
        rates[f"{name}_long_delivered"] = len(xs) / clip_delivered_s[name]
    # the banded aligner: reads/s for the 150 bp reads, pipelined (three
    # batches) and synchronous, delivered, each the median of 3 warm runs
    # taken back to back; pairs/s device-only (from the upload of one
    # batch's band arrays to the packed tensor on the card) and delivered
    # (phase 3f's counted calls); the host band build's seconds, one a batch
    # in call order (phase 3f's)
    rates["banded_reads_per_s_pipelined"] = BAND_BATCHES * B_BAND / host_s(torch, band_pipeline, 3)
    rates["banded_reads_per_s_sync"] = B_BAND / host_s(torch, lambda: bb.semiglobal(*band_reads[0]), 3)
    for name, (al, mode, (xs, ys), _, _) in band_sets.items():
        arrays = banded_arrays(al, mode, xs, ys)
        up = lambda arrays=arrays: banded_device._align_batch_device_banded_mp(  # noqa: E731
            *[banded_device._upload(a, dev) for a in arrays[:4]], arrays[6],
            *[banded_device._upload(a, dev) for a in arrays[4:6]],
        )
        rates[f"banded_{name}_pairs_per_s_device"] = len(xs) / host_s(torch, up, 2)
        rates[f"banded_{name}_pairs_per_s_delivered"] = len(xs) / band_delivered_s[name]
    rates["banded_band_build_s"] = band_build_s
    # PairHMM pairs/s: device-only from the device-resident inputs through
    # the class's forward (K17 then, on the two corpora whose every lane
    # falls back, the log-space re-run of every lane), delivered through
    # prob_related_batch from numpy (warm, the median of 3)
    for name, (hmm, extra, (xs_, ys_, xl_, yl_)) in hmm_sets.items():
        args_, _, _ = hmm_inputs(xs_, ys_, xl_, yl_)
        if hmm is exact:
            fwd = lambda hmm=hmm, a=args_, e=torch.from_numpy(extra[0]).to(dev), x=extra: hmm._forward(*a, e, x[1], x[2])  # noqa: E731
        elif hmm is homo:
            fwd = lambda hmm=hmm, a=args_, e=torch.from_numpy(extra[0]).float().to(dev), x=extra: hmm._forward(*a, e, x[1])  # noqa: E731
        else:
            e_lin = torch.from_numpy(np.exp(extra[0]).astype(np.float32)).to(dev)
            e_log = torch.from_numpy(extra[0]).float().to(dev)

            def fwd(hmm=hmm, a=args_, e=e_lin, el=e_log, x=extra, name=name):
                out = hmm._forward(*a, e, x[1])
                if name in ("bench_global", "gatk_read_as_x"):
                    out = BatchPairHMM._forward(hmm, *a, el, x[1])
                return out

        rates[f"pairhmm_{name}_pairs_per_s_device"] = len(xs_) / host_s(torch, fwd, 3)
        rates[f"pairhmm_{name}_pairs_per_s_delivered"] = len(xs_) / host_s(
            torch, lambda hmm=hmm, x=extra, a=(xs_, ys_, xl_, yl_): hmm.prob_related_batch(a[0], a[1], *x, a[2], a[3]), 3
        )
    print(json.dumps({"phase": "banded_profile", **host_profile(torch, lambda: bb.semiglobal(*band_reads[0]))}), flush=True)
    print(json.dumps({"phase": "mapper_profile", **host_profile(torch, lambda: mapper.map_batch(main_reads))}), flush=True)
    print(json.dumps({"phase": "rates", **rates, "seconds": time.perf_counter() - t_phase, "card": smi}), flush=True)
    print(json.dumps({"phase": "script", "seconds": time.perf_counter() - t_start}), flush=True)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
