#!/usr/bin/env python3
"""Time K13 (``sw.scan_global_rows``) and K13-LUT (``sw.scan_global_rows_lut``)
on one NVIDIA GPU, on the inputs of chip_smoke.py phase 3d: 128 STR pairs
(4.6-5.6 kb, y at 5% substitutions and 0.5% indels) under (-5, -1, 2, -2),
and 64 long proteins (4.2-5.0 k residues, homologs at 30% substitutions and
3% indels) under BLOSUM62 with gap costs (-11, -1); and K3
(``sw.scores_global``, one thread a pair) on the STR pairs, the launch of
phase 3d's ``scores(..., "global")``.

    python3 scripts/time_rows.py [--root DIR] [--reps N] [--seed S]

``--root`` names the checkout whose ``rust_bio_tpu_torch`` is timed (default:
the one holding this script), so that two trees can be compared on one card
in one call; the inputs come from this checkout's chip_smoke.py generators
either way. For each kernel it prints one JSON line: the median of ``--reps``
CUDA-event-timed launches after one warm-up, with traceback and, where the
timed tree's wrapper takes ``traceback=False``, without it
(``scores_only_ms``, else null); the launch's threads and rows a thread
where the tree has ``rows_geometry``; a checksum of the score and of the tb
cells the kernel defines (columns 1..nlens, rows 0..mlens; equal checksums
from two trees: equal outputs); and the card's name and power limit as
nvidia-smi reports them. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def checksum(torch, score, tb, ml, nl) -> list:
    """Two int64 sums over the score and the defined tb cells (tb indexed
    ``tb[j-1, i, b]``, whatever its layout), 256 columns at a time: plain
    and weighted by row and column."""
    plain = int(score.to(torch.int64).sum())
    weighted = int((score.to(torch.int64) * torch.arange(1, score.numel() + 1, device=score.device)).sum())
    rows = torch.arange(tb.shape[1], device=ml.device)
    for c0 in range(0, tb.shape[0], 256):
        cols = torch.arange(c0, min(c0 + 256, tb.shape[0]), device=ml.device)
        keep = (cols[:, None, None] < nl[None, None, :]) & (rows[None, :, None] <= ml[None, None, :])
        cells = torch.where(keep, tb[c0 : c0 + 256].to(torch.int64), 0)
        plain += int(cells.sum())
        weighted += int((cells * (cols[:, None, None] * 65537 + rows[None, :, None] + 1)).sum())
    return [plain, weighted]


def inputs(torch, chip_smoke, seed: int):
    """(STR pairs, long proteins) as (xb, yb, mlens, nlens) tensors on the
    card, padded as ``BatchAligner`` pads them, and the BLOSUM62 LUT."""
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
    from rust_bio_tpu_torch.scores import blosum62, dense_matrix

    dev = torch.device("cuda")
    str_set, _, prot_set = chip_smoke.long_corpora(np.random.default_rng(seed))
    ba = BatchAligner(Scoring.from_scores(chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI), device=dev)
    bp = BatchAligner(Scoring.new(chip_smoke.PROT_GO, chip_smoke.PROT_GE, blosum62), device=dev)

    def tens(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    return tens(ba._pad(*str_set)), tens(bp._pad(*prot_set)), torch.from_numpy(dense_matrix("blosum62")).to(dev)


def time_scans(torch, chip_smoke, sw, seed: int, reps: int, **fields) -> None:
    """Time K13 on the STR pairs and K13-LUT on the long proteins; one JSON
    line each, with ``fields``."""
    sargs, pargs, lut = inputs(torch, chip_smoke, seed)
    card = chip_smoke.nvidia_smi_line()
    pens = (chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI)
    score_only = "traceback" in inspect.signature(sw.scan_global_rows).parameters
    cases = (
        ("sw_scan_global_rows", sargs, lambda **kw: sw.scan_global_rows(*sargs, *pens, **kw)),
        ("sw_scan_global_rows_lut", pargs, lambda **kw: sw.scan_global_rows_lut(
            *pargs, chip_smoke.PROT_GO, chip_smoke.PROT_GE, lut, **kw)),
    )
    for name, a, scan in cases:
        score, tb = scan()
        torch.cuda.synchronize()
        total = checksum(torch, score, tb, a[2], a[3])
        del score, tb
        ms = chip_smoke.cuda_ms(torch, scan, reps, warm=False)
        only = chip_smoke.cuda_ms(torch, lambda: scan(traceback=False), reps) if score_only else None
        M = int(a[0].shape[1])
        geometry = dict(zip(("threads", "rows"), sw.rows_geometry(M)[:2])) if hasattr(sw, "rows_geometry") else {}
        print(json.dumps({
            "kernel": name, **fields, "pairs": int(a[0].shape[0]), "M": M, "N": int(a[1].shape[1]), **geometry,
            "reps": reps, "ms": ms, "scores_only_ms": only, "checksum": total, "card": card,
        }), flush=True)
    k3 = lambda: sw.scores_global(*sargs, *pens)  # noqa: E731
    score = k3()
    torch.cuda.synchronize()
    w = torch.arange(1, score.numel() + 1, device=score.device)
    print(json.dumps({
        "kernel": "sw_scores_global", **fields, "pairs": int(sargs[0].shape[0]), "M": int(sargs[0].shape[1]),
        "N": int(sargs[1].shape[1]), "reps": reps, "ms": chip_smoke.cuda_ms(torch, k3, reps, warm=False),
        "checksum": [int(score.to(torch.int64).sum()), int((score.to(torch.int64) * w).sum())], "card": card,
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_rows: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke

    sys.path.insert(0, str(root))
    import rust_bio_tpu_torch
    from rust_bio_tpu_torch.ops import sw

    if not Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"time_rows: rust_bio_tpu_torch from {rust_bio_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    time_scans(torch, chip_smoke, sw, args.seed, args.reps, root=str(root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
