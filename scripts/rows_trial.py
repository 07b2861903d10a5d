#!/usr/bin/env python3
"""Trials of variants of K13 and K13-LUT (csrc/sw_global_rows.cu) on one
NVIDIA GPU: other stripe counts (T_STRIPES, the most threads a block), and
other forms of the tb stores: ``vector`` (the source's: 8 cells packed into
one 16-byte store), ``scalar`` (each cell's 2 bytes stored as it is made)
and ``streaming`` (the 16-byte store with the evict-first hint, ``__stcs``).

    python3 scripts/rows_trial.py [--stripes 256] [--stores vector] [--reps 5]

``--stripes`` and ``--stores`` take comma-separated lists; every pair of
values is one variant. A variant is made from the source in this checkout
by the substitutions below (each must apply), built with nvcc into
``ops/_build/``, and put in place of the K13 and K13-LUT entry points (and
``ops.sw``'s stripe count, which sizes the scratch). For each variant it
prints ``time_rows.py``'s lines (their checksums must equal those of the
kernel in the tree).
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

STRIPES = "constexpr int T_STRIPES = 256;"
VECTOR_STORE = "*reinterpret_cast<uint4*>(tbcol + g * GROUP) = make_uint4(w[0], w[1], w[2], w[3]);"
STORES = {
    "vector": (),
    "scalar": (
        ("          s_up_old = sp;\n", "          if constexpr (TB) tbcol[r] = static_cast<uint16_t>(cell);\n          s_up_old = sp;\n"),
        (VECTOR_STORE, "(void)w;"),
    ),
    "streaming": ((VECTOR_STORE, "__stcs(reinterpret_cast<uint4*>(tbcol + g * GROUP), make_uint4(w[0], w[1], w[2], w[3]));"),),
}


def variant_source(src: str, stripes: int, stores: str) -> str:
    for old, new in ((STRIPES, STRIPES.replace("256", str(stripes))),) + STORES[stores]:
        if src.count(old) != 1:
            raise SystemExit(f"rows_trial: the source no longer holds {old!r} once")
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stripes", default="256")
    ap.add_argument("--stores", default="vector")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("rows_trial: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import time_rows
    from rust_bio_tpu_torch.ops import _build, sw

    _build.BUILD_DIR.mkdir(exist_ok=True)
    source = (_build.CSRC / "sw_global_rows.cu").read_text()
    variants = [(int(t), st) for t in args.stripes.split(",") for st in args.stores.split(",")]
    libs, procs = {}, []
    for t, st in variants:
        src = _build.BUILD_DIR / f"trial_sw_global_rows_t{t}_{st}.cu"
        src.write_text(variant_source(source, t, st))
        libs[t, st] = src.with_suffix(".so")
        procs.append(subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(libs[t, st]), str(src)]))
    if any(p.wait() != 0 for p in procs):
        print("rows_trial: nvcc failed", file=sys.stderr)
        return 1
    for (t, st), path in libs.items():
        lib = ctypes.CDLL(str(path))
        sw._ROWS_STRIPES = t
        for kernel in (sw.SCAN_GLOBAL_ROWS, sw.SCAN_GLOBAL_ROWS_LUT):
            fn = getattr(lib, kernel.symbol)
            fn.argtypes = kernel.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            kernel._fn = fn
        time_rows.time_scans(torch, chip_smoke, sw, args.seed, args.reps, stripes=t, stores=st)
    return 0


if __name__ == "__main__":
    sys.exit(main())
