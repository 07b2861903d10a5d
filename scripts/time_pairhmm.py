#!/usr/bin/env python3
"""Time K17 (``pairhmm.pairhmm_fwd_scaled``) on one NVIDIA GPU on the
inputs of chip_smoke.py phase 3g: the 4096 bench pairs (x a 207 bp
haplotype, y a 54 bp read, benches/pairhmm.rs:9-19, shared emissions, no
gap extension) and the 8192 GATK-like pairs (x a 300-500 bp haplotype, y a
150 bp read, gap open phred 45, continuation phred 10, per-lane emissions
from a mean base quality of Q20-Q40), semiglobal, in float32, as
``BatchPairHMMLinear`` calls it; K17-log (``pairhmm.pairhmm_fwd_log``) on
its main-path lanes, the 64 GATK-like
pairs with the 150 bp read as x and the 300-500 bp haplotype as y
(HaplotypeCaller's gap open phred 45, continuation phred 10, shared Q30
emissions), semiglobal, in float32 and float64; and the 4096 bench pairs
(x a 207 bp haplotype, y a 54 bp read, benches/pairhmm.rs:9-19), semiglobal,
and 256 of them global, in float32; and K17-homopoly
(``pairhmm.pairhmm_fwd_homopoly``) on phase 3g's 2048 homopoly pairs (the
bench pairs' first 2048 haplotypes and their exact read substrings, hop
open 1e-4, extension 0.5), semiglobal (the main path's) and global, in
float32 and float64; and K17-exact (``pairhmm.pairhmm_fwd_exact``) on phase
3g's 1024 exact pairs (the first 1024 bench pairs), semiglobal, unbanded
and at ``max_edit_dist`` 4, with a checksum of the skip mask too.

    python3 scripts/time_pairhmm.py [--root DIR] [--reps N] [--seed S]

``--root`` names the checkout whose ``rust_bio_tpu_torch`` is timed (default:
the one holding this script), so that two trees can be compared on one card
in one call; the inputs come from this checkout's chip_smoke.py generator
either way. For each input it prints one JSON line: the median of ``--reps``
CUDA-event-timed launches after one warm-up, the launch geometry where the
timed tree has ``pairhmm_log_geometry`` (K17-exact: ``pairhmm_exact_geometry``;
K17: ``pairhmm_scaled_geometry``),
a checksum of the output's raw bits
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
    from rust_bio_tpu_torch.stats.pairhmm import BatchHomopolyPairHMM, BatchPairHMM, BatchPairHMMExact, BatchPairHMMLinear

    if not Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"time_pairhmm: rust_bio_tpu_torch from {rust_bio_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.nvidia_smi_line()
    (hbx, hby), (hox, hoy), (gx, gy, gxl, gyl, gep) = cs.pairhmm_corpora(np.random.default_rng((args.seed, 5)))
    neg_inf = float("-inf")
    bench_gaps = (math.log(cs.HMM_INS), math.log(cs.HMM_DEL), neg_inf, neg_inf)
    gatk_gaps = (math.log(cs.GATK_GAP_OPEN), math.log(cs.GATK_GAP_OPEN), math.log(cs.GATK_GAP_CONT), math.log(cs.GATK_GAP_CONT))
    bench_emit, gatk_emit = cs.hmm_emit(cs.HMM_SUBST), cs.hmm_emit(10.0 ** (-cs.GATK_Q / 10.0))
    hops = (math.log(cs.HOP), math.log(cs.HOP), math.log(cs.HOP_EXTEND), math.log(cs.HOP_EXTEND))
    sx, sy, sxl, syl = gy[: cs.B_GATK_SWAP], gx[: cs.B_GATK_SWAP], gyl[: cs.B_GATK_SWAP], gxl[: cs.B_GATK_SWAP]

    def tens(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    full = lambda xs_: np.full(len(xs_), xs_.shape[1], np.int32)  # noqa: E731
    homo = (hox, hoy, full(hox), full(hoy))
    cases = (
        ("pairhmm_fwd_log", "gatk_read_as_x", (sx, sy, sxl, syl), gatk_gaps, gatk_emit, torch.float32, True),
        ("pairhmm_fwd_log", "gatk_read_as_x", (sx, sy, sxl, syl), gatk_gaps, gatk_emit, torch.float64, True),
        ("pairhmm_fwd_log", "bench", (hbx, hby, full(hbx), full(hby)), bench_gaps, bench_emit, torch.float32, True),
        ("pairhmm_fwd_log", "bench_global", (hbx[: cs.B_HMM_GLOBAL], hby[: cs.B_HMM_GLOBAL], full(hbx[: cs.B_HMM_GLOBAL]),
                                             full(hby[: cs.B_HMM_GLOBAL])), bench_gaps, bench_emit, torch.float32, False),
        *(("pairhmm_fwd_homopoly", "homopoly", homo, bench_gaps, cs.hmm_emit(cs.HMM_SUBST, 4), dtype, semi)
          for dtype in (torch.float32, torch.float64) for semi in (True, False)),
    )
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # K17 with BatchPairHMMLinear's parameters and probabilities
    for name, arrays, gaps, emit in (
        ("bench", (hbx, hby, full(hbx), full(hby)), bench_gaps, np.exp(bench_emit)),
        ("gatk_per_lane", (gx, gy, gxl, gyl), gatk_gaps, np.exp(gep)),
    ):
        a = tens(*arrays)
        e = torch.from_numpy(emit.astype(np.float32)).to(dev)
        params = BatchPairHMMLinear(*gaps, device=dev)._lin_params
        fn = lambda a=a, params=params, e=e: pairhmm.pairhmm_fwd_scaled(*a, params, e, True)  # noqa: E731
        out = fn()
        torch.cuda.synchronize()
        B, N = a[1].shape
        geometry = (
            {"geometry": list(pairhmm.pairhmm_scaled_geometry(N, B, sms))}
            if hasattr(pairhmm, "pairhmm_scaled_geometry") else {}
        )
        print(json.dumps({
            "kernel": "pairhmm_fwd_scaled", "input": name, "dtype": "float32", "semiglobal": True,
            "root": str(root), "pairs": B, "M": int(a[0].shape[1]), "N": N,
            "cells": int((arrays[2].astype(np.int64) * N).sum()), **geometry, "reps": args.reps,
            "ms": cs.cuda_ms(torch, fn, args.reps, warm=False), "checksum": checksum(torch, out),
            "underflowed": int((out <= -1.5e38).sum()), "card": card,
        }), flush=True)
    for kernel, name, arrays, gaps, emit, dtype, semi in cases:
        a = tens(*arrays)
        e = torch.from_numpy(emit).to(dtype).to(dev)
        if kernel == "pairhmm_fwd_log":
            params = BatchPairHMM(*gaps, dtype=dtype, device=dev)._log_params
            fwd, states = pairhmm.pairhmm_fwd_log, 3
        else:
            params = BatchHomopolyPairHMM(*gaps, *hops, dtype=dtype, device=dev)._params
            fwd, states = pairhmm.pairhmm_fwd_homopoly, getattr(pairhmm, "HOMOPOLY_STATES", None)
        fn = lambda a=a, params=params, e=e, semi=semi, fwd=fwd: fwd(*a, params, e, semi)  # noqa: E731
        out = fn()
        torch.cuda.synchronize()
        B, N = a[1].shape
        geometry = {}
        if hasattr(pairhmm, "pairhmm_log_geometry") and states is not None:
            geo = pairhmm.pairhmm_log_geometry(N, B, dtype, sms) if states == 3 else pairhmm.pairhmm_log_geometry(N, B, dtype, sms, states)
            geometry = {"geometry": list(geo)}
        print(json.dumps({
            "kernel": kernel, "input": name, "dtype": str(dtype).split(".")[1], "semiglobal": semi,
            "root": str(root), "pairs": B, "M": int(a[0].shape[1]), "N": N,
            "cells": int((arrays[2].astype(np.int64) * arrays[3]).sum()), **geometry, "reps": args.reps,
            "ms": cs.cuda_ms(torch, fn, args.reps, warm=False), "checksum": checksum(torch, out), "card": card,
        }), flush=True)
    ex = tens(hbx[: cs.B_HMM_EXACT], hby[: cs.B_HMM_EXACT], full(hbx[: cs.B_HMM_EXACT]), full(hby[: cs.B_HMM_EXACT]))
    params = BatchPairHMMExact(*bench_gaps, device=dev)._params
    e = torch.from_numpy(bench_emit).to(dev)
    for med in (None, cs.HMM_MED):
        out, skip = pairhmm.pairhmm_fwd_exact(*ex, params, e, True, med, True)
        torch.cuda.synchronize()
        fn = lambda med=med: pairhmm.pairhmm_fwd_exact(*ex, params, e, True, med)  # noqa: E731
        B, N = ex[1].shape
        geometry = (
            {"geometry": list(pairhmm.pairhmm_exact_geometry(N, B, med is not None, sms))}
            if hasattr(pairhmm, "pairhmm_exact_geometry") else {}
        )
        print(json.dumps({
            "kernel": "pairhmm_fwd_exact", "input": "exact" if med is None else "exact_banded", "max_edit_dist": med,
            "dtype": "float64", "semiglobal": True, "root": str(root), "pairs": B, "M": int(ex[0].shape[1]), "N": N,
            "cells": B * int(ex[0].shape[1]) * N, "skipped": int(skip.sum()), **geometry, "reps": args.reps,
            "ms": cs.cuda_ms(torch, fn, args.reps, warm=False), "checksum": checksum(torch, out),
            "skip_checksum": checksum(torch, skip.to(torch.int32).reshape(-1)), "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
