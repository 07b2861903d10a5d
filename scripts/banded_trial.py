#!/usr/bin/env python3
"""Trials of variants of K16 (csrc/sw_banded.cu) on one NVIDIA GPU: the
band rows a lane computes in a chunk (LANE_ROWS: a chunk is 32 x that
many rows; the aligner's bands are 33 rows wide at k = w = 8), and where
the previous column's s-bits come from (``--stamped true``: the kernel's
shared layer, stamped with their column; ``false``: read back from the
previous column of the tb, the layer holding column 0's only).

    python3 scripts/banded_trial.py [--lane-rows 1,2,4] [--stamped false,true] [--reps 5]

``--lane-rows`` and ``--stamped`` take comma-separated lists; every pair of
values is one variant. A variant is made from the source in this checkout
by the substitutions below (each must apply once), built with nvcc into
``ops/_build/``, and put in place of K16's entry point. For each variant it
prints ``time_banded.py``'s lines for the 1 kb reads and the STR pairs
(their checksums must equal those of the kernel in the tree: equal
outputs on those corpora; a variant kept in the tree must pass the card
tests).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

LANE_ROWS = "constexpr int LANE_ROWS = 2;"
# the stamped layer's read and write, and the tb read-back in their place
STAMPED_READ = """      const int w = L(SBITS, r);
      return (w >> 4) == j - 1 ? w & 0xF : TB_START;
"""
TB_READ = """      return j >= 2 ? (tbcol[static_cast<ptrdiff_t>(r) - Xp] >> 8) & 0xF : L(SBITS, r);
"""
STAMPED_WRITE = """      L(SBITS, r) = ((cell >> 8) & 0xF) | (j << 4);
"""


def variant_source(src: str, lane_rows: int, stamped: str) -> str:
    subs = [(LANE_ROWS, LANE_ROWS.replace("2;", f"{lane_rows};"))]
    if stamped == "false":
        subs += [(STAMPED_READ, TB_READ), (STAMPED_WRITE, "")]
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"banded_trial: the source holds {old!r} {src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lane-rows", default="1,2,4")
    ap.add_argument("--stamped", default="false,true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("banded_trial: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import time_banded
    from rust_bio_tpu_torch.ops import _build, sw

    _build.BUILD_DIR.mkdir(exist_ok=True)
    source = (_build.CSRC / "sw_banded.cu").read_text()
    variants = [(int(k), s) for k in args.lane_rows.split(",") for s in args.stamped.split(",")]
    libs, procs = {}, []
    for k, s in variants:
        src = _build.BUILD_DIR / f"trial_sw_banded_rows{k}_stamped{s}.cu"
        src.write_text(variant_source(source, k, s))
        libs[k, s] = src.with_suffix(".so")
        procs.append(subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(libs[k, s]), str(src)]))
    if any(p.wait() != 0 for p in procs):
        print("banded_trial: nvcc failed", file=sys.stderr)
        return 1
    for (k, s), path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), sw.SCAN_BANDED.symbol)
        fn.argtypes = sw.SCAN_BANDED.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sw.SCAN_BANDED._fn = fn
        time_banded.time_corpora(torch, chip_smoke, sw, args.seed, args.reps, lane_rows=k, stamped=s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
