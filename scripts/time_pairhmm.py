#!/usr/bin/env python3
"""Time K17-log (``pairhmm.pairhmm_fwd_log``) on one NVIDIA GPU on the
inputs of chip_smoke.py phase 3g: its main-path lanes, the 64 GATK-like
pairs with the 150 bp read as x and the 300-500 bp haplotype as y
(HaplotypeCaller's gap open phred 45, continuation phred 10, shared Q30
emissions), semiglobal, in float32 and float64; and the 4096 bench pairs
(x a 207 bp haplotype, y a 54 bp read, benches/pairhmm.rs:9-19), semiglobal,
and 256 of them global, in float32.

    python3 scripts/time_pairhmm.py [--root DIR] [--reps N] [--seed S]

``--root`` names the checkout whose ``rust_bio_tpu_torch`` is timed (default:
the one holding this script), so that two trees can be compared on one card
in one call; the inputs come from this checkout's chip_smoke.py generator
either way. For each input it prints one JSON line: the median of ``--reps``
CUDA-event-timed launches after one warm-up, the launch geometry where the
timed tree has ``pairhmm_log_geometry``, a checksum of the output's raw bits
(int64 sums, plain and weighted by lane, of the float32 or float64 words
read as integers: equal checksums from two trees are equal outputs, bit for
bit), and the card's name and power limit as nvidia-smi reports them. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def checksum(torch, out) -> list:
    bits = out.view(torch.int64 if out.dtype == torch.float64 else torch.int32).to(torch.int64)
    w = torch.arange(1, bits.numel() + 1, device=bits.device)
    return [int(bits.sum()), int((bits * w).sum())]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_pairhmm: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, str(root))
    import rust_bio_tpu_torch
    from rust_bio_tpu_torch.ops import pairhmm
    from rust_bio_tpu_torch.stats.pairhmm import BatchPairHMM

    if not Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"time_pairhmm: rust_bio_tpu_torch from {rust_bio_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.nvidia_smi_line()
    (hbx, hby), _, (gx, gy, gxl, gyl, _) = cs.pairhmm_corpora(np.random.default_rng((args.seed, 5)))
    neg_inf = float("-inf")
    bench_gaps = (math.log(cs.HMM_INS), math.log(cs.HMM_DEL), neg_inf, neg_inf)
    gatk_gaps = (math.log(cs.GATK_GAP_OPEN), math.log(cs.GATK_GAP_OPEN), math.log(cs.GATK_GAP_CONT), math.log(cs.GATK_GAP_CONT))
    bench_emit, gatk_emit = cs.hmm_emit(cs.HMM_SUBST), cs.hmm_emit(10.0 ** (-cs.GATK_Q / 10.0))
    sx, sy, sxl, syl = gy[: cs.B_GATK_SWAP], gx[: cs.B_GATK_SWAP], gyl[: cs.B_GATK_SWAP], gxl[: cs.B_GATK_SWAP]

    def tens(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    full = lambda xs_: np.full(len(xs_), xs_.shape[1], np.int32)  # noqa: E731
    cases = (
        ("gatk_read_as_x", (sx, sy, sxl, syl), gatk_gaps, gatk_emit, torch.float32, True),
        ("gatk_read_as_x", (sx, sy, sxl, syl), gatk_gaps, gatk_emit, torch.float64, True),
        ("bench", (hbx, hby, full(hbx), full(hby)), bench_gaps, bench_emit, torch.float32, True),
        ("bench_global", (hbx[: cs.B_HMM_GLOBAL], hby[: cs.B_HMM_GLOBAL], full(hbx[: cs.B_HMM_GLOBAL]),
                          full(hby[: cs.B_HMM_GLOBAL])), bench_gaps, bench_emit, torch.float32, False),
    )
    for name, arrays, gaps, emit, dtype, semi in cases:
        a = tens(*arrays)
        params = BatchPairHMM(*gaps, dtype=dtype, device=dev)._log_params
        e = torch.from_numpy(emit).to(dtype).to(dev)
        fn = lambda a=a, params=params, e=e, semi=semi: pairhmm.pairhmm_fwd_log(*a, params, e, semi)  # noqa: E731
        out = fn()
        torch.cuda.synchronize()
        B, N = a[1].shape
        geometry = (
            {"geometry": list(pairhmm.pairhmm_log_geometry(N, B, dtype, torch.cuda.get_device_properties(dev).multi_processor_count))}
            if hasattr(pairhmm, "pairhmm_log_geometry") else {}
        )
        print(json.dumps({
            "kernel": "pairhmm_fwd_log", "input": name, "dtype": str(dtype).split(".")[1], "semiglobal": semi,
            "root": str(root), "pairs": B, "M": int(a[0].shape[1]), "N": N,
            "cells": int((arrays[2].astype(np.int64) * arrays[3]).sum()), **geometry, "reps": args.reps,
            "ms": cs.cuda_ms(torch, fn, args.reps, warm=False), "checksum": checksum(torch, out), "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
