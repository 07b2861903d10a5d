#!/usr/bin/env python3
"""Time K18 (``sw.scores_global_lut``) and K17-log (``pairhmm.pairhmm_fwd_log``)
of a checkout on one NVIDIA GPU in each place their state can live, by
setting the module budgets their wrappers read:

- K18 on chip_smoke.py phase 3d's 64 long protein pairs (M about 5,000)
  and phase 3c's 8192 homologs (M = 450), its two state layers in the
  device scratch (``SCORE_WARP_SHARED_MAX`` 0) and in shared memory (its
  default, a quarter of a block's 232,448 bytes a warp);
- K17-log on phase 3g's 64 read-as-x lanes (N = 500), float32 and float64,
  the same with y cut to its first 256 bases (eight columns a lane), and
  its 4096 bench pairs (N = 54), its state where the geometry puts it
  (registers up to ``LOG_REG_BYTES`` a lane, else the device scratch) and
  in the device scratch (``LOG_REG_BYTES`` 0);
- K17-homopoly (``pairhmm.pairhmm_fwd_homopoly``) on phase 3g's 2048
  homopoly pairs (N = 54, C = 2), float32 and float64, semiglobal, in
  registers (``HOMOPOLY_REG_BYTES`` at 14 * 2 * 8 bytes, so float64 too)
  and in the device scratch (``HOMOPOLY_REG_BYTES`` 0).

    python3 scripts/placement_trial.py [--root DIR] [--reps N] [--seed S]

One JSON line a kernel, input and placement: the median of ``--reps``
CUDA-event-timed launches after one warm-up, the geometry, a checksum of
the outputs (int64 sums of the scores, or of the float words read as
integers: every placement of an input must print the same one), and the
card's name and power limit. Exits non-zero without a CUDA device.
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
    if out.dtype.is_floating_point:
        out = out.view(torch.int64 if out.dtype == torch.float64 else torch.int32)
    bits = out.to(torch.int64)
    w = torch.arange(1, bits.numel() + 1, device=bits.device)
    return [int(bits.sum()), int((bits * w).sum())]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("placement_trial: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, str(root))
    import rust_bio_tpu_torch
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
    from rust_bio_tpu_torch.ops import pairhmm, sw
    from rust_bio_tpu_torch.scores import blosum62, dense_matrix
    from rust_bio_tpu_torch.stats.pairhmm import BatchHomopolyPairHMM, BatchPairHMM

    if not Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"placement_trial: rust_bio_tpu_torch from {rust_bio_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.nvidia_smi_line()

    def tens(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def line(**fields):
        print(json.dumps({**fields, "root": str(root), "reps": args.reps, "card": card}), flush=True)

    # K18
    (hxs, hys), _ = cs.protein_corpora(np.random.default_rng(args.seed))
    _, _, (lxs, lys) = cs.long_corpora(np.random.default_rng(args.seed))
    bp = BatchAligner(Scoring.new(cs.PROT_GO, cs.PROT_GE, blosum62), device=dev)
    lut = torch.from_numpy(dense_matrix("blosum62")).to(dev)
    default_budget = sw.SCORE_WARP_SHARED_MAX
    for name, (xs, ys) in (("long_protein", (lxs, lys)), ("homolog", (hxs, hys))):
        a = tens(*bp._pad(xs, ys))
        M = int(a[0].shape[1])
        for budget in (0, default_budget):
            sw.SCORE_WARP_SHARED_MAX = budget
            fn = lambda a=a: sw.scores_global_lut(*a, cs.PROT_GO, cs.PROT_GE, lut)  # noqa: E731
            out = fn()
            torch.cuda.synchronize()
            line(
                kernel="sw_scores_global_lut", input=name, pairs=int(a[0].shape[0]), M=M, N=int(a[1].shape[1]),
                geometry=list(sw.warp_geometry(M, sw.SCORE_WARP_LAYERS, budget)), score_warp_shared_max=budget,
                ms=cs.cuda_ms(torch, fn, args.reps, warm=False), checksum=checksum(torch, out),
            )
    sw.SCORE_WARP_SHARED_MAX = default_budget

    # K17-log
    (hbx, hby), (hox, hoy), (gx, gy, gxl, gyl, _) = cs.pairhmm_corpora(np.random.default_rng((args.seed, 5)))
    k = cs.B_GATK_SWAP
    neg_inf = float("-inf")
    gatk = (math.log(cs.GATK_GAP_OPEN), math.log(cs.GATK_GAP_OPEN), math.log(cs.GATK_GAP_CONT), math.log(cs.GATK_GAP_CONT))
    bench = (math.log(cs.HMM_INS), math.log(cs.HMM_DEL), neg_inf, neg_inf)
    full = lambda xs_: np.full(len(xs_), xs_.shape[1], np.int32)  # noqa: E731
    inputs = (
        ("gatk_read_as_x", tens(gy[:k], gx[:k], gyl[:k], gxl[:k]), gatk, cs.hmm_emit(10.0 ** (-cs.GATK_Q / 10.0)),
         (torch.float32, torch.float64)),
        ("gatk_read_as_x_y256", tens(gy[:k], gx[:k, :256], gyl[:k], np.minimum(gxl[:k], 256)), gatk,
         cs.hmm_emit(10.0 ** (-cs.GATK_Q / 10.0)), (torch.float32, torch.float64)),
        ("bench", tens(hbx, hby, full(hbx), full(hby)), bench, cs.hmm_emit(cs.HMM_SUBST), (torch.float32, torch.float64)),
    )
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    reg_bytes = pairhmm.LOG_REG_BYTES
    for name, a, gaps, emit, dtypes in inputs:
        B, N = a[1].shape
        for dtype in dtypes:
            params = BatchPairHMM(*gaps, dtype=dtype, device=dev)._log_params
            e = torch.from_numpy(emit).to(dtype).to(dev)
            for place, rbytes in (("geometry", reg_bytes), ("scratch", 0)):
                pairhmm.LOG_REG_BYTES = rbytes
                fn = lambda a=a, params=params, e=e: pairhmm.pairhmm_fwd_log(*a, params, e, True)  # noqa: E731
                out = fn()
                torch.cuda.synchronize()
                line(
                    kernel="pairhmm_fwd_log", input=name, dtype=str(dtype).split(".")[1], placement=place,
                    geometry=list(pairhmm.pairhmm_log_geometry(N, B, dtype, sms)),
                    ms=cs.cuda_ms(torch, fn, args.reps, warm=False), checksum=checksum(torch, out),
                )
    # K17-homopoly
    if hasattr(pairhmm, "HOMOPOLY_REG_BYTES"):
        a = tens(hox, hoy, full(hox), full(hoy))
        B, N = a[1].shape
        hops = (math.log(cs.HOP), math.log(cs.HOP), math.log(cs.HOP_EXTEND), math.log(cs.HOP_EXTEND))
        homopoly_bytes = pairhmm.HOMOPOLY_REG_BYTES
        for dtype in (torch.float32, torch.float64):
            params = BatchHomopolyPairHMM(*bench, *hops, dtype=dtype, device=dev)._params
            e = torch.from_numpy(cs.hmm_emit(cs.HMM_SUBST, 4)).to(dtype).to(dev)
            for place, rbytes in (("registers", pairhmm.HOMOPOLY_STATES * 2 * 8), ("scratch", 0)):
                pairhmm.HOMOPOLY_REG_BYTES = rbytes
                fn = lambda a=a, params=params, e=e: pairhmm.pairhmm_fwd_homopoly(*a, params, e, True)  # noqa: E731
                out = fn()
                torch.cuda.synchronize()
                line(
                    kernel="pairhmm_fwd_homopoly", input="homopoly", dtype=str(dtype).split(".")[1], placement=place,
                    geometry=list(pairhmm.pairhmm_log_geometry(N, B, dtype, sms, pairhmm.HOMOPOLY_STATES)),
                    ms=cs.cuda_ms(torch, fn, args.reps, warm=False), checksum=checksum(torch, out),
                )
        pairhmm.HOMOPOLY_REG_BYTES = homopoly_bytes
    pairhmm.LOG_REG_BYTES = reg_bytes
    return 0


if __name__ == "__main__":
    sys.exit(main())
