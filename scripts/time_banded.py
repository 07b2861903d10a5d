#!/usr/bin/env python3
"""Time K16 (``sw.scan_banded``) and K16-walk (``walk.walk_banded``, on
K16's tb after the fixups, as the aligner runs it) on one NVIDIA GPU, on the
inputs the banded aligner gives them in chip_smoke.py phase 3f: 256 1 kb reads (20 random
substitutions) in their 20 kb targets through ``semiglobal`` (the band
build's cropped windows), and 128 STR pairs from phase 3d's generator
(4.6-5.6 kb, y at 5% substitutions and 0.5% indels) through ``global_`` (a
dense tb of about 8 GB), both under (-5, -1, 2, -2), k = w = 8.

    python3 scripts/time_banded.py [--root DIR] [--reps N] [--seed S]

``--root`` names the checkout whose ``rust_bio_tpu_torch`` is timed (default:
the one holding this script), so that two trees can be compared on one card
in one call; the reads and pairs come from this checkout's chip_smoke.py
generators, and the bands from the timed tree's ``BatchBandedAligner``
(its host band build). For each corpus it prints one JSON line: the median
of ``--reps`` CUDA-event-timed calls of the wrapper (with its tb zero-fill)
after one warm-up, and where the timed tree has ``scan_banded_launch`` the
launch alone into the outputs of a checked call (``kernel_ms``, else
null); the warps a block where the tree has ``banded_geometry``; the band
cells; a checksum of the outputs (the tb read as ``tb[j - 1, i, b]``
whatever its layout, over columns 1..nlens and every row, lx and the five
finals; equal checksums from two trees: equal outputs); and the card's
name and power limit as nvidia-smi reports them. Then, for each corpus, one
line for K16-walk on that tb: the median of ``--reps`` timed launches, its
steps, and a checksum of its op codes, lengths and coordinates (as
``scripts/time_columns.py``'s of K15-walk). Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def checksum(torch, outs, nl) -> list:
    """Two int64 sums, plain and weighted by place, of K16's outputs: the tb
    cells of columns 1..nlens (every row: the kernel zero-fills the rest), 64
    columns at a time, then lx (N, B) over columns 1..nlens and the (B,
    M + 1) finals whole."""
    tb, lx, *finals = outs
    total = [0, 0]
    rows = torch.arange(tb.shape[1], device=nl.device)

    def add(t, w):
        t = t.to(torch.int64)
        total[0] += int(t.sum())
        total[1] += int((t * w).sum())

    for c0 in range(0, tb.shape[0], 64):
        cols = torch.arange(c0, min(c0 + 64, tb.shape[0]), device=nl.device)
        keep = cols[:, None, None] < nl[None, None, :]
        add(torch.where(keep, tb[c0 : c0 + 64].to(torch.int64), 0), cols[:, None, None] * 65537 + rows[None, :, None] + 1)
    cols = torch.arange(lx.shape[0], device=nl.device)
    add(torch.where(cols[:, None] < nl[None, :], lx, 0), cols[:, None] * 7 + 1)
    for f in finals:
        add(f, torch.arange(f.shape[1], device=nl.device)[None, :] * 7 + 1)
    return total


def time_corpora(torch, chip_smoke, sw, walk, seed: int, reps: int, **fields) -> None:
    """Time K16 and K16-walk on the 1 kb reads and the STR pairs; one JSON
    line each, with ``fields``."""
    from time_columns import walk_checksum

    from rust_bio_tpu_torch.alignment.pairwise import BatchBandedAligner, Scoring, banded_device
    from rust_bio_tpu_torch.alignment.types import AlignmentMode

    dev = torch.device("cuda")
    card = chip_smoke.nvidia_smi_line()
    _, kb_set = chip_smoke.band_corpora(np.random.default_rng((seed, 4)))
    str_set = chip_smoke.long_corpora(np.random.default_rng(seed))[0]
    sc = Scoring.from_scores(chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI)
    bb = BatchBandedAligner(sc, chip_smoke.BAND_K, chip_smoke.BAND_W, device=dev)
    semi = sc.with_clips(*chip_smoke.SEMI_CLIPS)
    glob = sc.with_clips(*chip_smoke.SEMI_CLIPS[:1] * 4)
    for name, scoring, (xs, ys) in (("kb_semiglobal", semi, kb_set), ("str_global", glob, str_set)):
        _out, run_idx, _crop, _c0s, arrays = bb._band_batch(xs, ys, scoring, AlignmentMode.Custom, False)
        if len(run_idx) != len(xs):
            raise RuntimeError(f"{name}: {len(xs) - len(run_idx)} pairs off the device")
        *host, pens8 = arrays
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host]
        call = lambda t=t, pens8=pens8: sw.scan_banded(*t[:4], pens8, *t[4:])  # noqa: E731
        outs = call()
        torch.cuda.synchronize()
        total = checksum(torch, outs, t[3])
        ms = chip_smoke.cuda_ms(torch, call, reps, warm=False)
        kernel_ms = None
        if hasattr(sw, "scan_banded_launch"):
            base = chip_smoke.pair_major_base(outs[0])
            kernel_ms = chip_smoke.cuda_ms(
                torch, lambda: sw.scan_banded_launch((base, *outs[1:]), *t[:4], pens8, *t[4:]), reps
            )
            torch.cuda.synchronize()
            if checksum(torch, outs, t[3]) != total:
                raise RuntimeError(f"{name}: a repeated launch changed the outputs")
        _, winputs = banded_device._walk_inputs(outs, t[2], t[3], pens8, t[4], t[5])
        wout = walk.walk_banded(*winputs)
        torch.cuda.synchronize()
        wtotal = walk_checksum(torch, wout)
        steps = int((wout[0] > 0).sum())
        wms = chip_smoke.cuda_ms(torch, lambda: walk.walk_banded(*winputs), reps)
        del outs, winputs, wout
        B, M = host[0].shape
        N = host[1].shape[1]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        warps = sw.banded_geometry(M, B, sms)[0] if hasattr(sw, "banded_geometry") else None
        print(json.dumps({
            "kernel": "sw_scan_banded", "corpus": name, **fields, "pairs": B, "M": M, "N": N,
            "band_cells": chip_smoke.band_cells(arrays), "warps_a_block": warps, "reps": reps, "ms": ms,
            "kernel_ms": kernel_ms, "checksum": total, "card": card,
        }), flush=True)
        print(json.dumps({
            "kernel": "walk_banded", "corpus": name, **fields, "pairs": B, "steps": steps, "reps": reps, "ms": wms,
            "checksum": wtotal, "card": card,
        }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_banded: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "scripts"))
    import chip_smoke

    sys.path.insert(0, str(root))
    import rust_bio_tpu_torch
    from rust_bio_tpu_torch.ops import sw, walk

    if not Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"time_banded: rust_bio_tpu_torch from {rust_bio_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    time_corpora(torch, chip_smoke, sw, walk, args.seed, args.reps, root=str(root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
