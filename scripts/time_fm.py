#!/usr/bin/env python3
"""Time K4 (``DeviceFMIndex.search_arrays``) and the locate walk
(``DeviceFMIndex.locate_rows``) of a checkout on one NVIDIA GPU, on
chip_smoke.py's FM inputs: the index of its 4,641,652 bp random text
(``sampling_rate`` 32) built on the card, its 65,536 20-mers (half sampled
from the text, half with one substitution), phase 2's locate rows (the
suffix-array rows of the sampled queries' intervals) and 8192 random rows
(one a read, as the mapper's locate batch).

    python3 scripts/time_fm.py [--root DIR] [--reps N] [--seed S]

``--root`` names the checkout whose ``rust_bio_tpu_torch`` is timed (default:
the one holding this script), so that two trees can be compared on one card
in one call (parent, change, change, parent); the inputs come from this
checkout's chip_smoke.py either way. For each function it prints one JSON
line: the median of ``--reps`` CUDA-event-timed calls after one warm-up
(K4 10 x ``--reps``), the host seconds of one call ending in a synchronize
(median of ``--reps``), a checksum of the outputs (int64 sums, plain and
weighted by place: equal checksums from two trees, equal outputs), and the
card's name and power limit as nvidia-smi reports them. K4's launch is
also timed alone (``launch_ms``: ``FM_BACKWARD_SEARCH.launch`` into
outputs made once, without the wrapper's checks, whose length check waits
for the card), and where the tree's index has ``_locate`` (the locate
without ``locate_rows``' range check, which waits for the card too), so
is that; ``queued_ms`` times those launches back to back behind a sleep
of the card (chip_smoke.py ``queued_ms``: device time without the host's
enqueue gaps). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def checksum(torch, outs) -> list:
    total = [0, 0]
    for t in outs:
        t = t.to(torch.int64).flatten()
        w = torch.arange(1, t.numel() + 1, device=t.device)
        total = [total[0] + int(t.sum()), total[1] + int((t * w).sum())]
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_fm: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke

    sys.path.insert(0, str(root))
    import rust_bio_tpu_torch
    from rust_bio_tpu_torch.alphabets import dna
    from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
    from rust_bio_tpu_torch.ops import fm

    if not Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"time_fm: rust_bio_tpu_torch from {rust_bio_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = chip_smoke.nvidia_smi_line()
    text_arr, _, pats_np = chip_smoke.fm_inputs(args.seed)
    index = DeviceFMIndex.from_text(text_arr.tobytes(), dna.n_alphabet(), sampling_rate=32, device=dev)
    pats = torch.from_numpy(pats_np).to(dev)
    plens = torch.full((len(pats_np),), chip_smoke.QLEN, dtype=torch.int32, device=dev)
    search = lambda: index.search_arrays(pats, plens)  # noqa: E731
    found = search()
    status, lower, upper, _ = (t.cpu().numpy() for t in found)
    n_sampled = len(pats_np) // 2
    outs = [torch.empty_like(t) for t in found]
    nw = index._fused.shape[1]
    launch = lambda: fm.FM_BACKWARD_SEARCH.launch(  # noqa: E731
        dev, index._fused.data_ptr(), index._less256.data_ptr(), index.sym_of.data_ptr(), pats.data_ptr(),
        plens.data_ptr(), len(pats_np), chip_smoke.QLEN, nw, index.n, *(o.data_ptr() for o in outs),
    )
    launch_ms = chip_smoke.cuda_ms(torch, launch, 10 * args.reps)
    print(json.dumps({
        "function": "search_arrays (K4)", "root": str(root), "queries": len(pats_np), "reps": 10 * args.reps,
        "ms": chip_smoke.cuda_ms(torch, search, 10 * args.reps), "launch_ms": launch_ms,
        "queued_ms": chip_smoke.queued_ms(torch, launch, 10 * args.reps),
        "host_s": chip_smoke.host_s(torch, search, args.reps),
        "checksum": checksum(torch, found), "launch_checksum": checksum(torch, outs), "card": card,
    }), flush=True)
    sampled = status[:n_sampled] == 2
    phase2 = chip_smoke.interval_rows(lower[:n_sampled][sampled], upper[:n_sampled][sampled])
    rand = np.random.default_rng((args.seed, 6)).integers(0, index.n, size=chip_smoke.B_READS).astype(np.int32)
    for name, rows_np in (("phase 2 rows", phase2), ("random rows", rand)):
        rows = torch.from_numpy(rows_np).to(dev)
        loc = lambda rows=rows: index.locate_rows(rows)  # noqa: E731
        alone = getattr(index, "_locate", None)
        print(json.dumps({
            "function": "locate_rows", "input": name, "root": str(root), "rows": len(rows_np), "reps": args.reps,
            "ms": chip_smoke.cuda_ms(torch, loc, args.reps), "host_s": chip_smoke.host_s(torch, loc, args.reps),
            "launch_ms": None if alone is None else chip_smoke.cuda_ms(torch, lambda rows=rows: alone(rows), 10 * args.reps),
            "queued_ms": None if alone is None else chip_smoke.queued_ms(torch, lambda rows=rows: alone(rows), 10 * args.reps),
            "checksum": checksum(torch, [loc()]), "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
