#!/usr/bin/env python3
"""Trials of variants of K15 (csrc/sw_columns.cu) on one NVIDIA GPU: other
stripe counts (T_STRIPES, the most threads a block), the cells computed
but their tb stores skipped (what the stores themselves cost), and blocks run in
thread-block clusters of C pairs held within E steps of each other by a
cluster barrier (does keeping the blocks that share the tb's 32-byte
sectors in step let L2 merge their 2-byte stores?).

    python3 scripts/columns_trial.py [--stripes 1024] [--clusters 1] [--every 4] [--reps 3]
                                     [--placements shared,scratch] [--stores cs,plain,off]

``--stripes``, ``--clusters`` and ``--stores`` take comma-separated lists;
every triple of values is one variant (``--stores cs``: the source's
streaming stores, ``__stcs``; ``plain``: plain 16-byte stores; ``off``: a
thread's word is stored only where all its bits are set, which 12-bit
cells never are, so the cells stay computed and nothing is stored; its
checksums then differ), timed in each of ``--placements`` (``scratch``:
the row state in the device scratch, ``sw.COLUMNS_SHARED_MAX_M`` set to
-1). A variant is made from the source in this checkout
by the substitutions below (each must apply), built with nvcc into
``ops/_build/``, and put in place of the K15 and K15-LUT entry points (and
``ops.sw``'s stripe count, which sizes the scratch); a cluster variant pads
the grid to whole clusters and steps every block of a cluster as often as
its longest pair. For a cluster variant it prints how many clusters the
card holds at once at K15's launch on the STR pairs
(``cudaOccupancyMaxActiveClusters``); for each variant, ``time_columns.py``'s
lines (their checksums must equal those of the kernel in the tree).
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

SUBSTITUTIONS = (
    ("#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n#include <cooperative_groups.h>\n"),
    ("  const int ml = mlens[b];\n  const int nl = nlens[b];",
     "  const bool real = b < B;\n  const int ml = real ? mlens[b] : 0;\n  const int nl = real ? nlens[b] : -1;"),
    ("  const bool owner = t < t_act;", "  const bool owner = real && t < t_act;"),
    ("  const int steps = nl + t_act;",
     "  int steps = nl + t_act;\n"
     "  for (int k = b / CLUSTER * CLUSTER; k < b / CLUSTER * CLUSTER + CLUSTER && k < B; ++k)\n"
     "    steps = max(steps, nlens[k] + mlens[k] / R + 1);"),
    ("    __syncthreads();\n  }\n",
     "    __syncthreads();\n    if (s % EVERY == EVERY - 1) cooperative_groups::this_cluster().sync();\n  }\n"),
    ("  kernel<<<B, T, smem, static_cast<cudaStream_t>(stream)>>>(",
     "  if (CLUSTER > 8) cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
     "  cudaLaunchConfig_t cfg = {};\n"
     "  cfg.gridDim = dim3((B + CLUSTER - 1) / CLUSTER * CLUSTER);\n"
     "  cfg.blockDim = dim3(T);\n"
     "  cfg.dynamicSmemBytes = smem;\n"
     "  cfg.stream = static_cast<cudaStream_t>(stream);\n"
     "  cudaLaunchAttribute attr[1];\n"
     "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
     "  attr[0].val.clusterDim.x = CLUSTER;\n"
     "  attr[0].val.clusterDim.y = 1;\n"
     "  attr[0].val.clusterDim.z = 1;\n"
     "  cfg.attrs = attr;\n"
     "  cfg.numAttrs = 1;\n"
     "  cudaLaunchKernelEx(&cfg, kernel,"),
)
PROBE = """
extern "C" int trial_max_clusters(int T, int smem) {
  auto kernel = scan_columns_kernel<true, true, MatchParams>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (CLUSTER > 8) cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * 16);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}
"""


STRIPES = "constexpr int T_STRIPES = 1024;"
STORE = "    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w0, w1, w2, w3));"


def variant_source(src: str, stripes: int, cluster: int, stores: str = "cs") -> str:
    subs = [(STRIPES, STRIPES.replace("1024", str(stripes)))]
    if stores == "off":
        subs.append((STORE, "    if ((w0 & w1 & w2 & w3) == 0xFFFFFFFFu)\n  " + STORE))
    elif stores == "plain":
        subs.append((STORE, "    *reinterpret_cast<uint4*>(dst) = make_uint4(w0, w1, w2, w3);"))
    if cluster > 1:
        subs += SUBSTITUTIONS
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"columns_trial: the source no longer holds {old!r} once")
        src = src.replace(old, new)
    return src + (PROBE if cluster > 1 else "")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stripes", default="1024")
    ap.add_argument("--clusters", default="1")
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--placements", default="shared")
    ap.add_argument("--stores", default="cs")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("columns_trial: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import time_columns
    from rust_bio_tpu_torch.ops import _build, sw

    _build.BUILD_DIR.mkdir(exist_ok=True)
    source = (_build.CSRC / "sw_columns.cu").read_text()
    variants = [
        (int(t), int(c), st) for t in args.stripes.split(",") for c in args.clusters.split(",")
        for st in args.stores.split(",")
    ]
    libs, procs = {}, []
    for t, c, st in variants:
        src = _build.BUILD_DIR / f"trial_sw_columns_t{t}_c{c}_{st}.cu"
        src.write_text(variant_source(source, t, c, st))
        libs[t, c, st] = src.with_suffix(".so")
        procs.append(subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, f"-DCLUSTER={c}",
                                       f"-DEVERY={args.every}", "-o", str(libs[t, c, st]), str(src)]))
    if any(p.wait() != 0 for p in procs):
        print("columns_trial: nvcc failed", file=sys.stderr)
        return 1
    cargs, _, _ = time_columns.inputs(torch, chip_smoke, args.seed)
    for (t, c, st), path in libs.items():
        lib = ctypes.CDLL(str(path))
        sw._COLUMNS_STRIPES = t
        T, R, _, smem = sw.columns_geometry(cargs[0].shape[1])
        if c > 1:
            lib.trial_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
            print(json.dumps({
                "stripes": t, "cluster": c, "threads": T, "shared_bytes": smem,
                "max_active_clusters": lib.trial_max_clusters(T, smem),
                "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            }), flush=True)
        for kernel in (sw.SCAN_COLUMNS, sw.SCAN_COLUMNS_LUT):
            fn = getattr(lib, kernel.symbol)
            fn.argtypes = kernel.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            kernel._fn = fn
        fields = {"stripes": t, "threads": T, "rows": R, "cluster": c, "stores": st}
        if c > 1:
            fields["every"] = args.every
        shared_max = sw.COLUMNS_SHARED_MAX_M
        for placement in args.placements.split(","):
            sw.COLUMNS_SHARED_MAX_M = shared_max if placement == "shared" else -1
            time_columns.time_scans(torch, chip_smoke, sw, args.seed, args.reps, placement=placement, **fields)
        sw.COLUMNS_SHARED_MAX_M = shared_max
    return 0


if __name__ == "__main__":
    sys.exit(main())
