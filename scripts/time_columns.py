#!/usr/bin/env python3
"""Time K15 (``sw.scan_columns``), K15-walk (``walk.walk_steps``) and
K15-LUT (``sw.scan_columns_lut``) on one NVIDIA GPU, on inputs in the
geometry of chip_smoke.py phase 3e: 128 STR pairs (4.6-5.6 kb backbones, y
with 200-400 bp random flanks) in semiglobal mode, and 64 long proteins
(4.2-5.0 k residues with 100-200 residue flanks) in local mode under
BLOSUM62. K15-walk walks K15's tb of the STR pairs as the aligner does,
after ``_columns_fixups``: each tree its own tb.

    python3 scripts/time_columns.py [--root DIR] [--reps N] [--seed S]

``--root`` names the checkout whose ``rust_bio_tpu_torch`` is timed (default:
the one holding this script), so that two trees can be compared on one card
in one call; the inputs come from this checkout's chip_smoke.py generators
either way. For each kernel it prints one JSON line: the median of ``--reps``
CUDA-event-timed launches after one warm-up, with traceback and without
(``scores_only_ms``; the scans), a checksum of the outputs the kernel
defines (equal checksums from two trees: equal outputs), the tb's strides,
and the card's name and power limit as nvidia-smi reports them. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def checksum(torch, out, ml, nl) -> list:
    """Two int64 sums over the defined outputs of a scan (tb and lx over
    columns 0..nlens, the finals over rows 0..mlens): plain and weighted by
    row and column."""
    tb, lx, *finals = out
    rows = torch.arange(finals[0].shape[1], device=ml.device)
    plain = weighted = 0
    if tb is not None:
        for c0 in range(0, tb.shape[0], 256):
            cols = torch.arange(c0, min(c0 + 256, tb.shape[0]), device=ml.device)
            keep = (cols[:, None, None] <= nl[None, None, :]) & (rows[None, :, None] <= ml[None, None, :])
            cells = torch.where(keep, tb[c0 : c0 + 256].to(torch.int64), 0)
            plain += int(cells.sum())
            weighted += int((cells * (cols[:, None, None] * 65537 + rows[None, :, None] + 1)).sum())
        cols = torch.arange(lx.shape[0], device=ml.device)
        lxm = torch.where(cols[:, None] <= nl[None, :], lx.to(torch.int64), 0)
        plain += int(lxm.sum())
        weighted += int((lxm * (cols[:, None] + 1)).sum())
    for k, f in enumerate(finals):
        fm = torch.where(rows[None, :] <= ml[:, None], f.to(torch.int64), 0)
        plain += int(fm.sum())
        weighted += int((fm * (rows[None, :] + 7 * k + 1)).sum())
    return [plain, weighted]


def walk_checksum(torch, out) -> list:
    """Two int64 sums over K15-walk's outputs (op codes and lengths, the
    coordinates): plain and weighted by step and pair."""
    codes, lens, *coords = (o.to(torch.int64) for o in out)
    T, B = codes.shape
    w = torch.arange(1, T + 1, device=codes.device)[:, None] * 131 + torch.arange(B, device=codes.device)[None, :]
    plain = int(codes.sum() + lens.sum()) + sum(int(c.sum()) for c in coords)
    weighted = int((codes * w).sum() + (lens * (w + 7)).sum())
    weighted += sum(int((c * (torch.arange(B, device=c.device) + 3 * k + 1)).sum()) for k, c in enumerate(coords))
    return [plain, weighted]


def inputs(torch, chip_smoke, seed: int):
    """(STR pairs, long proteins) as (xb, yb, mlens, nlens) tensors on the
    card, padded as ``BatchAligner`` pads them, and the BLOSUM62 LUT."""
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
    from rust_bio_tpu_torch.scores import blosum62, dense_matrix

    dev = torch.device("cuda")
    long_sets = chip_smoke.long_corpora(np.random.default_rng(seed))
    semi_set, _, prot_set, _ = chip_smoke.long_clip_corpora(np.random.default_rng((seed, 3)), long_sets)
    ba = BatchAligner(Scoring.from_scores(chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI), device=dev)
    bp = BatchAligner(Scoring.new(chip_smoke.PROT_GO, chip_smoke.PROT_GE, blosum62), device=dev)

    def tens(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    return tens(ba._pad(*semi_set)), tens(bp._pad(*prot_set)), torch.from_numpy(dense_matrix("blosum62")).to(dev)


def time_scans(torch, chip_smoke, sw, seed: int, reps: int, walk=None, fixups=None, **fields) -> None:
    """Time K15 on the STR pairs and K15-LUT on the long proteins, and, given
    the tree's ``ops.walk`` and ``batched._columns_fixups``, K15-walk on
    K15's tb; one JSON line each, with ``fields``."""
    cargs, pargs, lut = inputs(torch, chip_smoke, seed)
    card = chip_smoke.nvidia_smi_line()
    pens = (chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI)
    cases = (
        ("sw_scan_columns", cargs, lambda tb=True: sw.scan_columns(*cargs, *pens, *chip_smoke.SEMI_CLIPS, traceback=tb)),
        ("sw_scan_columns_lut", pargs, lambda tb=True: sw.scan_columns_lut(
            *pargs, chip_smoke.PROT_GO, chip_smoke.PROT_GE, lut, 0, 0, 0, 0, traceback=tb)),
    )
    for name, a, scan in cases:
        out = scan()
        torch.cuda.synchronize()
        total = checksum(torch, out, a[2], a[3])
        strides = list(out[0].stride())
        if walk is not None and name == "sw_scan_columns":
            fixups(out, a[2], a[3], (chip_smoke.GO, chip_smoke.GE, *chip_smoke.SEMI_CLIPS))
            winputs = (out[0], out[1], out[5], a[2], a[3])
            wtotal = walk_checksum(torch, walk.walk_steps(*winputs))
            wms = chip_smoke.cuda_ms(torch, lambda: walk.walk_steps(*winputs), reps)
            print(json.dumps({
                "kernel": "walk_steps", **fields, "pairs": int(a[0].shape[0]), "reps": reps, "ms": wms,
                "checksum": wtotal, "tb_strides": strides, "card": card,
            }), flush=True)
            del winputs
        del out
        ms = chip_smoke.cuda_ms(torch, scan, reps, warm=False)
        only = chip_smoke.cuda_ms(torch, lambda: scan(False), reps)
        print(json.dumps({
            "kernel": name, **fields, "pairs": int(a[0].shape[0]), "M": int(a[0].shape[1]),
            "N": int(a[1].shape[1]), "reps": reps, "ms": ms, "scores_only_ms": only, "checksum": total,
            "tb_strides": strides, "card": card,
        }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_columns: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke

    sys.path.insert(0, str(root))
    import rust_bio_tpu_torch
    from rust_bio_tpu_torch.alignment.pairwise.batched import _columns_fixups
    from rust_bio_tpu_torch.ops import sw, walk

    if not Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"time_columns: rust_bio_tpu_torch from {rust_bio_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    time_scans(torch, chip_smoke, sw, args.seed, args.reps, walk, _columns_fixups, root=str(root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
