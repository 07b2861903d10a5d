#!/usr/bin/env python3
"""Trials of variants of K15-walk (csrc/walk_steps.cu) on one NVIDIA GPU, on
K15's tb of chip_smoke.py phase 3e's 128 STR pairs (semiglobal mode, after
the fixups, as ``time_columns.py`` builds it): other warps a block
(WARPS), other offsets of the tile fetched to the left (AHEAD), and for
each variant the tile fills a pair needs and how many of them the tile
fetched ahead served (counted by the variant itself).

    python3 scripts/steps_trial.py [--warps 2] [--ahead 16] [--reps 5] [--seed 7]

``--warps`` (at most 3: two tiles a warp in 48 KB of static shared memory)
and ``--ahead`` take comma-separated lists; every pair of
values is one variant, made from the source in this checkout by text
substitution (each must apply), built with nvcc into ``ops/_build/`` and
put in place of the ``walk_steps`` entry point. For each it prints one
JSON line: the median of ``--reps`` CUDA-event-timed launches, a checksum
of the outputs (``time_columns.walk_checksum``: it must equal the tree's),
fills and hits per pair, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

COUNTERS = '''
__device__ unsigned long long trial_counts[2];  // fills, fills the tile fetched ahead served
extern "C" int trial_read_counts(unsigned long long* out, int reset) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, trial_counts, sizeof(trial_counts));
  if (rc == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    rc = cudaMemcpyToSymbol(trial_counts, zero, sizeof(zero));
  }
  return static_cast<int>(rc);
}
'''


def variant_source(src: str, warps: int, ahead: int) -> str:
    subs = [
        ("constexpr int WARPS = 2;", f"constexpr int WARPS = {warps};"),
        ("constexpr int AHEAD = 16;", f"constexpr int AHEAD = {ahead};"),
        ("namespace {\n", "namespace {\n" + COUNTERS.replace('extern "C" int', "int")),
        ("  bool swapped = false;\n",
         "  bool swapped = false;\n  if (threadIdx.x % LANES == 0) atomicAdd(&trial_counts[0], 1ULL);\n"),
        ("      swapped = true;\n",
         "      swapped = true;\n      if (threadIdx.x % LANES == 0) atomicAdd(&trial_counts[1], 1ULL);\n"),
    ]
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"steps_trial: the source no longer holds {old!r} once")
        src = src.replace(old, new)
    return src + '\nextern "C" int trial_counts_of(unsigned long long* out, int reset) { return trial_read_counts(out, reset); }\n'


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warps", default="2")
    ap.add_argument("--ahead", default="16")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("steps_trial: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import time_columns
    from rust_bio_tpu_torch.alignment.pairwise.batched import _columns_fixups
    from rust_bio_tpu_torch.ops import _build, sw, walk

    _build.BUILD_DIR.mkdir(exist_ok=True)
    source = (_build.CSRC / "walk_steps.cu").read_text()
    variants = [(int(w), int(a)) for w in args.warps.split(",") for a in args.ahead.split(",")]
    libs, procs = {}, []
    for w, a in variants:
        src = _build.BUILD_DIR / f"trial_walk_steps_w{w}_a{a}.cu"
        src.write_text(variant_source(source, w, a))
        libs[w, a] = src.with_suffix(".so")
        procs.append(subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(libs[w, a]), str(src)]))
    if any(p.wait() != 0 for p in procs):
        print("steps_trial: nvcc failed", file=sys.stderr)
        return 1
    cargs, _, _ = time_columns.inputs(torch, chip_smoke, args.seed)
    pens = (chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI)
    scan = sw.scan_columns(*cargs, *pens, *chip_smoke.SEMI_CLIPS)
    _columns_fixups(scan, cargs[2], cargs[3], (chip_smoke.GO, chip_smoke.GE, *chip_smoke.SEMI_CLIPS))
    winputs = (scan[0], scan[1], scan[5], cargs[2], cargs[3])
    B = int(cargs[0].shape[0])
    card = chip_smoke.nvidia_smi_line()
    kernel = walk.WALK_STEPS
    for (w, a), path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, kernel.symbol)
        fn.argtypes = kernel.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        kernel._fn = fn
        counts = (ctypes.c_ulonglong * 2)()
        lib.trial_counts_of.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.trial_counts_of(ctypes.addressof(counts), 1)
        out = walk.walk_steps(*winputs)
        torch.cuda.synchronize()
        if lib.trial_counts_of(ctypes.addressof(counts), 1) != 0:
            print("steps_trial: reading the counters failed", file=sys.stderr)
            return 1
        print(json.dumps({
            "kernel": "walk_steps", "warps": w, "ahead": a, "pairs": B, "reps": args.reps,
            "ms": chip_smoke.cuda_ms(torch, lambda: walk.walk_steps(*winputs), args.reps),
            "checksum": time_columns.walk_checksum(torch, out), "steps_per_pair": int((out[0] > 0).sum()) / B,
            "fills_per_pair": counts[0] / B, "ahead_hits_per_pair": counts[1] / B, "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
