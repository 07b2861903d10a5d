#!/usr/bin/env python3
"""Trials of variants of K11 and K7-LUT (csrc/sw_warp.cu) on one NVIDIA GPU:
other counts of warps (pairs) a block (WARPS), and the Del and Ins
maxima through Hopper's DPX instruction ``__viaddmax_s32`` (max(a + b, c)
in one instruction; the Del and Ins bits then read "the maximum is not the
open candidate", which is the same test as "extend > open").

    python3 scripts/warp_trial.py [--warps 4] [--dpx off] [--reps 5]

``--warps`` and ``--dpx`` (``off``, ``on``) take comma-separated lists;
every pair of values is one variant. A variant is made from the source in
this checkout by the substitutions below (each must apply), built with nvcc
into ``ops/_build/``, and put in place of the K11 and K7-LUT entry points.
For each variant it prints ``time_lut.py``'s lines for K11 and K7-LUT on
the homolog corpus (their checksums must equal those of the kernel in the
tree: equal checksums, equal outputs on that corpus, which does not wrap
int32; a variant kept in the tree must pass the card tests, whose LUT near
+-2^30 does).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))

WARPS = "constexpr int WARPS = 4;             // pairs a block"
# the Del and Ins choices of both kernels' cells
CHOICE = re.compile(
    r"(?P<ind> *)const int d_ext = add\(dp, ge\);\n"
    r" *const int d_open = add\(sp, go\);\n"
    r" *const bool d_wins = d_ext > d_open;\n"
    r" *(?P<bd>(?:const )?int best_d) = d_wins \? d_ext : d_open;\n"
    r" *const int d_bits = d_wins \? TB_DEL : sbp;\n"
    r" *const int t_open = add\(st_up, go\);\n"
    r" *const int i_ext = add\(bi_up, ge\);\n"
    r" *(?P<bi>(?:const )?int best_i) = max\(i_ext, t_open\);\n"
    r" *const int i_bits = i_ext > t_open \? TB_INS : sbits_up;\n"
)


def _dpx(m: re.Match) -> str:
    ind = m.group("ind")
    return "".join(f"{ind}{line}\n" for line in (
        "const int d_open = add(sp, go);",
        f"{m.group('bd')} = __viaddmax_s32(dp, ge, d_open);",
        "const int d_bits = best_d != d_open ? TB_DEL : sbp;",
        "const int t_open = add(st_up, go);",
        f"{m.group('bi')} = __viaddmax_s32(bi_up, ge, t_open);",
        "const int i_bits = best_i != t_open ? TB_INS : sbits_up;",
    ))


def variant_source(src: str, warps: int, dpx: str) -> str:
    if src.count(WARPS) != 1:
        raise SystemExit(f"warp_trial: the source no longer holds {WARPS!r} once")
    src = src.replace(WARPS, WARPS.replace("= 4;", f"= {warps};"))
    if dpx == "on":
        src, n = CHOICE.subn(_dpx, src)
        if n != 2:
            raise SystemExit(f"warp_trial: the Del/Ins choice found {n} times, not in both kernels")
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warps", default="4")
    ap.add_argument("--dpx", default="off")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("warp_trial: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import time_lut
    from rust_bio_tpu_torch.ops import _build, sw

    _build.BUILD_DIR.mkdir(exist_ok=True)
    source = (_build.CSRC / "sw_warp.cu").read_text()
    variants = [(int(w), d) for w in args.warps.split(",") for d in args.dpx.split(",")]
    libs, procs = {}, []
    for w, d in variants:
        src = _build.BUILD_DIR / f"trial_sw_warp_w{w}_dpx{d}.cu"
        src.write_text(variant_source(source, w, d))
        libs[w, d] = src.with_suffix(".so")
        procs.append(subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(libs[w, d]), str(src)]))
    if any(p.wait() != 0 for p in procs):
        print("warp_trial: nvcc failed", file=sys.stderr)
        return 1
    for (w, d), path in libs.items():
        lib = ctypes.CDLL(str(path))
        sw._WARP_PAIRS = w
        for kernel in (sw.SCAN_GLOBAL_LUT, sw.SCAN_LOCAL_LUT):
            fn = getattr(lib, kernel.symbol)
            fn.argtypes = kernel.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            kernel._fn = fn
        time_lut.time_scans(torch, chip_smoke, sw, args.seed, args.reps, warps=w, dpx=d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
