#!/usr/bin/env python3
"""Time K13 (``sw.scan_global_rows``) and K13-LUT (``sw.scan_global_rows_lut``)
on one NVIDIA GPU, on the inputs of chip_smoke.py phase 3d: 128 STR pairs
(4.6-5.6 kb, y at 5% substitutions and 0.5% indels) under (-5, -1, 2, -2),
and 64 long proteins (4.2-5.0 k residues, homologs at 30% substitutions and
3% indels) under BLOSUM62 with gap costs (-11, -1); K3
(``sw.scores_global``) on the STR pairs, the launch of phase 3d's
``scores(..., "global")``; and K14 (``walk.sweep_walk_global_seg``) on the
pair-major tb that the tree's K13 returns for the STR pairs and for phase
3d's 8 insertion pairs (x carrying 4.2-4.8 kb into 600-800 bp y).

    python3 scripts/time_rows.py [--root DIR] [--reps N] [--seed S] [--routes]

``--root`` names the checkout whose ``rust_bio_tpu_torch`` is timed (default:
the one holding this script), so that two trees can be compared on one card
in one call; the inputs come from this checkout's chip_smoke.py generators
either way. For each kernel it prints one JSON line: the median of ``--reps``
CUDA-event-timed launches after one warm-up (K3 two launches where one
takes over a second), with traceback and, where the timed tree's wrapper
takes ``traceback=False``, without it (``scores_only_ms``, else null); the
launch's threads and rows a thread where the tree has ``rows_geometry``,
K3's route where it has ``scores_route``, K14's tile where it has
``seg_walk_geometry``; a checksum of the outputs (K13: the score and the
tb cells it defines, columns 1..nlens, rows 0..mlens; K3: the scores; K14:
ins_cnt, exit_op and ins0; equal checksums from two trees: equal
outputs); and the card's name and power limit as nvidia-smi reports them.
``--routes`` also times K3's two launches (``scores_global_warp``,
``scores_global_rows``) apart, on random DNA pairs of 150, 300 and 600 bp,
1, 2, 3.5 and 5.6 kb at 128, 512, 2048 and 8192 pairs, with a checksum of
each: the numbers that set ``sw.scores_route``'s limits. Exits non-zero
without a CUDA device, or with ``--routes`` on a tree without the two
launches.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
ROUTE_LENGTHS = (150, 300, 600, 1000, 2000, 3500, 5600)
ROUTE_PAIRS = (128, 512, 2048, 8192)


def _sums(torch, *ts) -> list:
    """Two int64 sums over tensors, plain and weighted by place."""
    plain = weighted = 0
    for t in ts:
        t = t.to(torch.int64).reshape(-1)
        plain += int(t.sum())
        weighted += int((t * torch.arange(1, t.numel() + 1, device=t.device)).sum())
    return [plain, weighted]


def checksum(torch, score, tb, ml, nl) -> list:
    """Two int64 sums over the score and the defined tb cells (tb indexed
    ``tb[j-1, i, b]``, whatever its layout), 256 columns at a time: plain
    and weighted by row and column."""
    plain, weighted = _sums(torch, score)
    rows = torch.arange(tb.shape[1], device=ml.device)
    for c0 in range(0, tb.shape[0], 256):
        cols = torch.arange(c0, min(c0 + 256, tb.shape[0]), device=ml.device)
        keep = (cols[:, None, None] < nl[None, None, :]) & (rows[None, :, None] <= ml[None, None, :])
        cells = torch.where(keep, tb[c0 : c0 + 256].to(torch.int64), 0)
        plain += int(cells.sum())
        weighted += int((cells * (cols[:, None, None] * 65537 + rows[None, :, None] + 1)).sum())
    return [plain, weighted]


def inputs(torch, chip_smoke, seed: int):
    """(STR pairs, insertion pairs, long proteins) as (xb, yb, mlens,
    nlens) tensors on the card, padded as ``BatchAligner`` pads them, and
    the BLOSUM62 LUT."""
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
    from rust_bio_tpu_torch.scores import blosum62, dense_matrix

    dev = torch.device("cuda")
    str_set, sv_set, prot_set = chip_smoke.long_corpora(np.random.default_rng(seed))
    ba = BatchAligner(Scoring.from_scores(chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI), device=dev)
    bp = BatchAligner(Scoring.new(chip_smoke.PROT_GO, chip_smoke.PROT_GE, blosum62), device=dev)

    def tens(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    return (
        tens(ba._pad(*str_set)), tens(ba._pad(*sv_set)), tens(bp._pad(*prot_set)),
        torch.from_numpy(dense_matrix("blosum62")).to(dev),
    )


def time_scans(torch, chip_smoke, sw, walk, seed: int, reps: int, **fields) -> None:
    """Time K13 on the STR pairs and K13-LUT on the long proteins, K3 on the
    STR pairs, K14 on K13's tb of the STR and insertion pairs; one JSON
    line each, with ``fields``."""
    sargs, vargs, pargs, lut = inputs(torch, chip_smoke, seed)
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score = k3()
    torch.cuda.synchronize()
    k3_reps = reps if time.perf_counter() - t0 < 1.0 else 2
    M = int(sargs[0].shape[1])
    print(json.dumps({
        "kernel": "sw_scores_global", **fields, "pairs": int(sargs[0].shape[0]), "M": M,
        "N": int(sargs[1].shape[1]), "route": sw.scores_route(M, int(sargs[0].shape[0])) if hasattr(sw, "scores_route") else "one thread a pair",
        "reps": k3_reps, "ms": chip_smoke.cuda_ms(torch, k3, k3_reps, warm=False),
        "checksum": _sums(torch, score), "card": card,
    }), flush=True)

    tile = walk.seg_walk_geometry() if hasattr(walk, "seg_walk_geometry") else "one thread a pair"
    for name, a in (("str", sargs), ("insertion", vargs)):
        tb = sw.scan_global_rows(*a, *pens)[1]
        fn = lambda tb=tb, a=a: walk.sweep_walk_global_seg(tb, a[2], a[3])  # noqa: E731
        out = fn()
        torch.cuda.synchronize()
        steps = int(out[0].long().sum() + (out[1].long() > 0).sum() + out[2].long().sum()) + int(a[0].shape[0])
        print(json.dumps({
            "kernel": "sweep_walk_global_seg", "input": name, **fields, "pairs": int(a[0].shape[0]),
            "M": int(a[0].shape[1]), "N": int(a[1].shape[1]), "tb_strides": list(tb.stride()), "tile": tile,
            "path_steps": steps, "reps": reps, "ms": chip_smoke.cuda_ms(torch, fn, reps), "checksum": _sums(torch, *out),
            "card": card,
        }), flush=True)
        del tb, out


def time_routes(torch, chip_smoke, sw, seed: int, reps: int, **fields) -> None:
    """K3's two launches apart on random DNA pairs of each length in
    ``ROUTE_LENGTHS`` at each count in ``ROUTE_PAIRS``; one JSON line a
    launch and shape."""
    dev = torch.device("cuda")
    card = chip_smoke.nvidia_smi_line()
    pens = (chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for B in ROUTE_PAIRS:
        for L in ROUTE_LENGTHS:
            a = [torch.from_numpy(v).to(dev) for v in (
                acgt[rng.integers(0, 4, size=(B, L))], acgt[rng.integers(0, 4, size=(B, L))],
                np.full(B, L, np.int32), np.full(B, L, np.int32),
            )]
            for route, fn in (("warp", sw.scores_global_warp), ("rows", sw.scores_global_rows)):
                call = lambda fn=fn: fn(*a, *pens)  # noqa: E731
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                score = call()
                torch.cuda.synchronize()
                n = reps if time.perf_counter() - t0 < 1.0 else 2
                geometry = (
                    sw.warp_geometry(L, sw.SCORE_WARP_LAYERS, sw.SCORE_WARP_SHARED_MAX)[:2] if route == "warp"
                    else sw.rows_geometry(L, score_only=True)[:3]
                )
                print(json.dumps({
                    "kernel": f"sw_scores_global_{route}", **fields, "pairs": B, "M": L, "N": L,
                    "geometry": geometry, "chosen": sw.scores_route(L, B) == route, "reps": n,
                    "ms": chip_smoke.cuda_ms(torch, call, n, warm=False), "checksum": _sums(torch, score), "card": card,
                }), flush=True)
            del a, score


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--routes", action="store_true")
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
    from rust_bio_tpu_torch.ops import sw, walk

    if not Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"time_rows: rust_bio_tpu_torch from {rust_bio_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    if args.routes and not hasattr(sw, "scores_global_rows"):
        print("time_rows: --routes needs a tree with scores_global_warp and scores_global_rows", file=sys.stderr)
        return 1
    time_scans(torch, chip_smoke, sw, walk, args.seed, args.reps, root=str(root))
    if args.routes:
        time_routes(torch, chip_smoke, sw, args.seed, args.reps, root=str(root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
