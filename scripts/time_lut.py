#!/usr/bin/env python3
"""Time K11 (``sw.scan_global_lut``) and K7-LUT (``sw.scan_local_lut``) on one
NVIDIA GPU, on the homolog corpus of chip_smoke.py phase 3c: 8192 protein
pairs, x of 250-450 residues, y x at 30% substitutions and 3%
single-residue indels, and K12 (``sw.scan_semiglobal_lut``, y-clips 0) and
K9-LUT (``sw.scan_custom_lut``, the domain's clips) on its domain corpus:
8192 domains of 80-200 residues at 20% substitutions in proteins of
250-450, all under BLOSUM62 with gap costs (-11, -1); K18
(``sw.scores_global_lut``) on the homolog corpus and on phase 3d's 64 long
protein pairs (4,200-5,000 residues, 30% substitutions, 3% indels).

    python3 scripts/time_lut.py [--root DIR] [--reps N] [--seed S] [--dna | --walks]

``--root`` names the checkout whose ``rust_bio_tpu_torch`` is timed (default:
the one holding this script), so that two trees can be compared on one card
in one call; the inputs come from this checkout's chip_smoke.py generator
either way. For each kernel it prints one JSON line: the median of ``--reps``
CUDA-event-timed launches after one warm-up, with traceback and, where the
timed tree's wrapper takes ``traceback=False``, without it
(``scores_only_ms``, else null); the source the tree builds it from, and
the rows a lane where that is ``sw_warp`` (for K18, where the tree has
K18's shared budget); a checksum
of the outputs the kernel defines (the score
or the finals, and the tb cells read as ``tb[j, i, b]`` whatever the tb's
layout; equal checksums from two trees: equal outputs); and the card's name
and power limit as nvidia-smi reports them. Then it times the launches of
the walks K2 and K8, which read K11's and K7-LUT's pair-major tb, on the
tb of K1 and K7 over chip_smoke.py's 8192 random 150 bp DNA pairs (K7's
pair-major view where the tree's K7 runs in ``sw_warp``), and of K6, which
reads K12's, on K5's tb of the same pairs (a pair-major view where the
tree's K5 runs in ``sw_warp``, else contiguous), and K3
(``sw.scores_global``) on those pairs, as chip_smoke.py phase 2 times it
(10 x ``--reps`` launches, a checksum of their outputs; K2 and K6 through
their wrappers, K6's with its fixed-column prolog, and K2's launch alone
too, ``launch_ms``), and K8 and K10 on K7's and K9's tb of those pairs
(chip_smoke.py's custom-mode penalties and clips for K9), through their
wrappers and as the tree's own launch (``launch_ms``: where the tree's
``*_launch`` takes the wrapper's inputs, the one launch with the prolog
it folds in; where it takes the prolog's entry state, the launch alone,
the torch prolog run once before);
then K1, K5
(y-clips 0), K7 and K9 (chip_smoke.py's custom-mode penalties and clips) on
the same pairs, with checksums as the protein scans', K7 and K9, and K5
where the tree's wrapper takes ``traceback=False``, also without traceback
(``scores_only_ms``), with the source each is built from and the rows a
lane of those that run in ``sw_warp``. ``--dna``: the
150 bp DNA rows only. ``--walks``: the walks only, K2, K8, K10 and K6 on
the DNA pairs, then K2 on K11's tb of the homolog corpus, K8 and K10 on
K7-LUT's and K6 on K12's tb of the domain corpus (through their wrappers,
K8 and K10 also as the tree's launch; 10 x ``--reps`` launches, a
checksum of their outputs). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def _sums(torch, t, weights) -> list:
    t = t.to(torch.int64)
    return [int(t.sum()), int((t * weights).sum())]


def checksum(torch, outs, ml, nl, first_col: int) -> list:
    """Int64 sums, plain and weighted by place, of the outputs a scan
    defines: ``outs`` is (tb, then per-pair tensors (B,) or (B, M+1), rows
    past mlens ignored, or lx (N+1, B), columns past nlens ignored). tb
    column c holds DP column c + first_col; the cells of columns
    first_col..nlens and rows 0..mlens count, 128 columns at a time."""
    tb, *rest = outs
    total = [0, 0]
    rows = torch.arange(tb.shape[1], device=ml.device)
    for c0 in range(0, tb.shape[0], 128):
        cols = torch.arange(c0, min(c0 + 128, tb.shape[0]), device=ml.device)
        keep = (cols[:, None, None] + first_col <= nl[None, None, :]) & (rows[None, :, None] <= ml[None, None, :])
        cells = torch.where(keep, tb[c0 : c0 + 128].to(torch.int64), 0)
        total = [a + b for a, b in zip(total, _sums(torch, cells, cols[:, None, None] * 65537 + rows[None, :, None] + 1))]
    for t in rest:
        if t.dim() == 1:
            w = torch.arange(1, t.numel() + 1, device=t.device)
        elif t.shape[0] == ml.shape[0]:  # (B, M+1) finals
            cols = torch.arange(t.shape[1], device=t.device)
            t = torch.where(cols[None, :] <= ml[:, None], t, 0)
            w = cols[None, :] * 7 + 1
        else:  # lx (N+1, B)
            cols = torch.arange(t.shape[0], device=t.device)
            t = torch.where(cols[:, None] <= nl[None, :], t, 0)
            w = cols[:, None] * 7 + 1
        total = [a + b for a, b in zip(total, _sums(torch, t, w))]
    return total


def time_scans(torch, chip_smoke, sw, seed: int, reps: int, **fields) -> None:
    """Time K11 and K7-LUT on the homolog corpus and K12 on the domain
    corpus; one JSON line each, with ``fields``."""
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
    from rust_bio_tpu_torch.scores import blosum62, dense_matrix

    dev = torch.device("cuda")
    (hxs, hys), (dxs, dys) = chip_smoke.protein_corpora(np.random.default_rng(seed))
    bp = BatchAligner(Scoring.new(chip_smoke.PROT_GO, chip_smoke.PROT_GE, blosum62), device=dev)
    hom = [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in bp._pad(hxs, hys)]
    dom = [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in bp._pad(dxs, dys)]
    lut = torch.from_numpy(dense_matrix("blosum62")).to(dev)
    card = chip_smoke.nvidia_smi_line()
    pens = (chip_smoke.PROT_GO, chip_smoke.PROT_GE, lut)
    dclips = (chip_smoke.DOMAIN_XCLIP, chip_smoke.DOMAIN_XCLIP, chip_smoke.DOMAIN_YCLIP, chip_smoke.DOMAIN_YCLIP)
    cases = (
        ("sw_scan_global_lut", sw.scan_global_lut, hom, (), 1, (3, lambda out: [out[1], out[0], out[2]])),
        ("sw_scan_local_lut", sw.scan_local_lut, hom, (), 0, (5, list)),
        ("sw_scan_semiglobal_lut", sw.scan_semiglobal_lut, dom, (0, 0), 1, (5, list)),
        ("sw_scan_custom_lut", sw.scan_custom_lut, dom, dclips, 0, (5, list)),
    )
    kernels = {k.symbol: k for k in vars(sw).values() if isinstance(k, type(sw.SCAN_GLOBAL_LUT))}
    for name, fn, a, clips, first_col, (layers, order) in cases:
        scan = lambda fn=fn, a=a, clips=clips, **kw: fn(*a, *pens, *clips, **kw)  # noqa: E731
        out = scan()
        torch.cuda.synchronize()
        total = checksum(torch, order(out), a[2], a[3], first_col)
        del out
        ms = chip_smoke.cuda_ms(torch, scan, reps, warm=False)
        score_only = "traceback" in inspect.signature(fn).parameters
        only = chip_smoke.cuda_ms(torch, lambda: scan(traceback=False), reps) if score_only else None
        M = int(a[0].shape[1])
        source = kernels[name].source
        rows = {"stripe_rows": sw.warp_geometry(M, layers)[0]} if source == "sw_warp" else {}
        print(json.dumps({
            "kernel": name, **fields, "source": source, "pairs": int(a[0].shape[0]), "M": M, "N": int(a[1].shape[1]), **rows,
            "reps": reps, "ms": ms, "scores_only_ms": only, "checksum": total, "card": card,
        }), flush=True)


def time_k18(torch, chip_smoke, sw, seed: int, reps: int, **fields) -> None:
    """Time K18 on the homolog corpus and the long proteins; one JSON line
    each, with ``fields`` and a checksum of the scores."""
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
    from rust_bio_tpu_torch.scores import blosum62, dense_matrix

    dev = torch.device("cuda")
    (hxs, hys), _ = chip_smoke.protein_corpora(np.random.default_rng(seed))
    _, _, (lxs, lys) = chip_smoke.long_corpora(np.random.default_rng(seed))
    bp = BatchAligner(Scoring.new(chip_smoke.PROT_GO, chip_smoke.PROT_GE, blosum62), device=dev)
    lut = torch.from_numpy(dense_matrix("blosum62")).to(dev)
    card = chip_smoke.nvidia_smi_line()
    for name, (xs, ys) in (("homolog", (hxs, hys)), ("long_protein", (lxs, lys))):
        a = [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in bp._pad(xs, ys)]
        fn = lambda a=a: sw.scores_global_lut(*a, chip_smoke.PROT_GO, chip_smoke.PROT_GE, lut)  # noqa: E731
        out = fn()
        torch.cuda.synchronize()
        M = int(a[0].shape[1])
        rows = (
            {"stripe_rows": sw.warp_geometry(M, 2, sw.SCORE_WARP_SHARED_MAX)[:2]}
            if hasattr(sw, "SCORE_WARP_SHARED_MAX") else {}
        )
        print(json.dumps({
            "kernel": "sw_scores_global_lut", "input": name, **fields, "pairs": int(a[0].shape[0]), "M": M,
            "N": int(a[1].shape[1]), **rows, "reps": reps, "ms": chip_smoke.cuda_ms(torch, fn, reps, warm=False),
            "checksum": _sums(torch, out, torch.arange(1, out.numel() + 1, device=dev)), "card": card,
        }), flush=True)


def walk_sums(torch, out) -> list:
    """Int64 sums, plain and weighted by place, of every output tensor."""
    total = [0, 0]
    for t in out:
        w = torch.arange(1, t.numel() + 1, device=t.device).reshape(t.shape)
        total = [x + y for x, y in zip(total, _sums(torch, t, w))]
    return total


def clip_launch(walk, name, tb, tbfix, lx, lx_n, ml, nl):
    """K8's (``name`` "sweep_walk_local") or K10's launch as the timed tree
    has it: one launch with the wrapper's inputs, holding its prolog, or,
    where ``*_launch`` takes the prolog's entry state, the launch alone
    after that torch prolog, run here once."""
    launch = getattr(walk, f"{name}_launch")
    if len(inspect.signature(launch).parameters) == 6:
        return lambda: launch(tb, tbfix, lx, lx_n, ml, nl)
    if name == "sweep_walk_local":
        entry = walk.local_entry(tb, lx, tbfix, lx_n, ml, nl)[2:9]
        return lambda: launch(tb, *entry)
    entry = walk.resolve_fixed_column_custom(tbfix, lx_n, ml, nl)[2:7]
    return lambda: launch(tb, lx, *entry)


def time_clip_walks(torch, chip_smoke, walk, scans, card: str, reps: int, **fields) -> None:
    """Time K8 and K10 through their wrappers and as the tree's launch
    (``clip_launch``) on each of ``scans``: (walk name, input label, a K7 /
    K9 / K7-LUT scan's outputs, mlens, nlens, gap costs, clips); one JSON
    line each, with a checksum of the wrapper's outputs."""
    for name, what, scan, ml, nl, pens, clips in scans:
        tbfix, lx_n = chip_smoke.clip_walk_inputs(torch, scan, ml, nl, pens, clips)
        args = (scan[0], tbfix, scan[1], lx_n, ml, nl)
        wrapper = getattr(walk, name)
        out = wrapper(*args)
        torch.cuda.synchronize()
        t = scan[0]
        print(json.dumps({
            "kernel": name, **fields, "input": what, "pairs": int(t.shape[2]), "M": int(t.shape[1]) - 1,
            "N": int(t.shape[0]) - 1, "tb_strides": list(t.stride()), "reps": reps,
            "ms": chip_smoke.cuda_ms(torch, lambda: wrapper(*args), reps),
            "launch_ms": chip_smoke.cuda_ms(torch, clip_launch(walk, name, *args), reps),
            "checksum": walk_sums(torch, out), "card": card,
        }), flush=True)


def time_protein_walks(torch, chip_smoke, sw, walk, seed: int, reps: int, **fields) -> None:
    """Time K2 on K11's tb of the homolog corpus, K8 and K10 on K7-LUT's
    (``time_clip_walks``) and K6 (with its prolog) on K12's tb of the domain
    corpus, through their wrappers; one JSON line each, with a checksum of
    the outputs."""
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
    from rust_bio_tpu_torch.alignment.pairwise.batched import _fixed_column
    from rust_bio_tpu_torch.scores import blosum62, dense_matrix

    dev = torch.device("cuda")
    (hxs, hys), (dxs, dys) = chip_smoke.protein_corpora(np.random.default_rng(seed))
    bp = BatchAligner(Scoring.new(chip_smoke.PROT_GO, chip_smoke.PROT_GE, blosum62), device=dev)
    hom = [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in bp._pad(hxs, hys)]
    dom = [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in bp._pad(dxs, dys)]
    lut = torch.from_numpy(dense_matrix("blosum62")).to(dev)
    go, ge = chip_smoke.PROT_GO, chip_smoke.PROT_GE
    card = chip_smoke.nvidia_smi_line()
    tb = sw.scan_global_lut(*hom, go, ge, lut)[1]
    semi = sw.scan_semiglobal_lut(*dom, go, ge, lut, 0, 0)
    _, tbfix = _fixed_column(*semi[1:], dom[2], go, ge)
    for name, fn, t in (
        ("sweep_walk_global", lambda: walk.sweep_walk_global(tb, hom[2], hom[3]), tb),
        ("sweep_walk_semiglobal", lambda: walk.sweep_walk_semiglobal(semi[0], tbfix, dom[2], dom[3]), semi[0]),
    ):
        out = fn()
        torch.cuda.synchronize()
        launch = chip_smoke.k2_launch_ms(torch, walk, tb, hom[2], hom[3], reps) if t is tb else None
        print(json.dumps({
            "kernel": name, **fields, "input": "homolog" if t is tb else "domain", "pairs": int(t.shape[2]),
            "M": int(t.shape[1]) - 1, "N": int(t.shape[0]), "tb_strides": list(t.stride()), "reps": reps,
            "ms": chip_smoke.cuda_ms(torch, fn, reps), "launch_ms": launch, "checksum": walk_sums(torch, out),
            "card": card,
        }), flush=True)
    del tb, semi
    local = sw.scan_local_lut(*hom, go, ge, lut)
    time_clip_walks(torch, chip_smoke, walk, [
        (name, "homolog", local, hom[2], hom[3], (go, ge), (0, 0, 0, 0)) for name in ("sweep_walk_local", "sweep_walk_custom")
    ], card, reps, **fields)


def time_dna_walks(torch, chip_smoke, sw, walk, seed: int, reps: int, scans: bool = True, **fields) -> None:
    """Time K2 and K6 (through their wrappers), which read a pair-major tb
    through its strides, on the tbs of K1 and K5 over chip_smoke.py's 8192
    random 150 bp DNA pairs under (-5, -1, 2, -2) (K5 with y-clips 0), and
    K3 on those pairs, then K8 and K10 on K7's and K9's tb of those pairs
    (``time_clip_walks``); with ``scans``, then the scans; one JSON line
    each, with a checksum of the outputs."""
    from rust_bio_tpu_torch.alignment.pairwise.batched import _fixed_column

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    B, L = chip_smoke.B_ALN, chip_smoke.LEN
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = [torch.from_numpy(v).to(dev) for v in (
        acgt[rng.integers(0, 4, size=(B, L))], acgt[rng.integers(0, 4, size=(B, L))],
        np.full(B, L, np.int32), np.full(B, L, np.int32),
    )]
    pens = (chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI)
    card = chip_smoke.nvidia_smi_line()
    tb = sw.scan_global(*a, *pens)[1]
    k2 = lambda: walk.sweep_walk_global(tb, a[2], a[3])  # noqa: E731
    semi = sw.scan_semiglobal(*a, *pens, 0, 0)
    _, tbfix5 = _fixed_column(*semi[1:], a[2], chip_smoke.GO, chip_smoke.GE)
    k6 = lambda: walk.sweep_walk_semiglobal(semi[0], tbfix5, a[2], a[3])  # noqa: E731
    k3 = lambda: (sw.scores_global(*a, *pens),)  # noqa: E731
    for name, fn in (("sweep_walk_global", k2), ("sweep_walk_semiglobal", k6), ("sw_scores_global", k3)):
        out = fn()
        torch.cuda.synchronize()
        total = walk_sums(torch, out)
        tb_of = {k2: tb, k6: semi[0]}.get(fn)
        layout = "" if tb_of is None else (", contiguous tb" if tb_of.is_contiguous() else ", pair-major view")
        launch = chip_smoke.k2_launch_ms(torch, walk, tb, a[2], a[3], reps) if fn is k2 else None
        print(json.dumps({
            "kernel": name, **fields, "input": "150 bp DNA" + layout, "pairs": B,
            "reps": reps,
            "ms": chip_smoke.cuda_ms(torch, fn, reps), "launch_ms": launch, "checksum": total, "card": card,
        }), flush=True)
    cpens = chip_smoke.CUSTOM_PENS
    cclips = (chip_smoke.CUSTOM_XCLIP, chip_smoke.CUSTOM_XCLIP, chip_smoke.CUSTOM_YCLIP, chip_smoke.CUSTOM_YCLIP)
    del semi, tb
    time_clip_walks(torch, chip_smoke, walk, [
        ("sweep_walk_local", "150 bp DNA", sw.scan_local(*a, *pens), a[2], a[3], pens[:2], (0, 0, 0, 0)),
        ("sweep_walk_custom", "150 bp DNA", sw.scan_custom(*a, *cpens, *cclips), a[2], a[3], cpens[:2], cclips),
    ], card, reps, **fields)
    if not scans:
        return
    kernels = {k.symbol: k for k in vars(sw).values() if isinstance(k, type(sw.SCAN_GLOBAL))}
    n = max(1, reps // 10)
    for name, fn, first_col in (
        ("sw_scan_global", lambda **kw: sw.scan_global(*a, *pens), 1),
        ("sw_scan_semiglobal", lambda **kw: sw.scan_semiglobal(*a, *pens, 0, 0, **kw), 1),
        ("sw_scan_local", lambda **kw: sw.scan_local(*a, *pens, **kw), 0),
        ("sw_scan_custom", lambda **kw: sw.scan_custom(*a, *cpens, *cclips, **kw), 0),
    ):
        out = fn()
        torch.cuda.synchronize()
        outs = [out[1], out[0], out[2]] if name == "sw_scan_global" else list(out)
        total = checksum(torch, outs, a[2], a[3], first_col)
        del out, outs
        source = kernels[name].source
        layers = sw.GLOBAL_WARP_LAYERS if name == "sw_scan_global" else 5
        extra = {"stripe_rows": sw.warp_geometry(L, layers)[:2]} if source == "sw_warp" else {}
        clip = name in ("sw_scan_local", "sw_scan_custom") or (
            name == "sw_scan_semiglobal" and "traceback" in inspect.signature(sw.scan_semiglobal).parameters
        )
        print(json.dumps({
            "kernel": name, **fields, "input": "150 bp DNA", "source": source, **extra, "pairs": B, "reps": n,
            "ms": chip_smoke.cuda_ms(torch, fn, n),
            "scores_only_ms": chip_smoke.cuda_ms(torch, lambda: fn(traceback=False), n) if clip else None,
            "checksum": total, "card": card,
        }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--dna", action="store_true", help="the 150 bp DNA walks and scans only")
    ap.add_argument("--walks", action="store_true", help="the walks only: DNA, homolog and domain")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_lut: no CUDA device", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(HERE))
    import chip_smoke

    sys.path.insert(0, str(root))
    import rust_bio_tpu_torch
    from rust_bio_tpu_torch.ops import sw, walk

    if not Path(rust_bio_tpu_torch.__file__).resolve().is_relative_to(root):
        print(f"time_lut: rust_bio_tpu_torch from {rust_bio_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    if args.walks:
        time_dna_walks(torch, chip_smoke, sw, walk, args.seed, 10 * args.reps, scans=False, root=str(root))
        time_protein_walks(torch, chip_smoke, sw, walk, args.seed, 10 * args.reps, root=str(root))
        return 0
    if not args.dna:
        time_scans(torch, chip_smoke, sw, args.seed, args.reps, root=str(root))
        time_k18(torch, chip_smoke, sw, args.seed, args.reps, root=str(root))
    time_dna_walks(torch, chip_smoke, sw, walk, args.seed, 10 * args.reps, root=str(root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
