#!/usr/bin/env python3
"""Trials of variants of K2, K6, K8 and K10 (csrc/walk_sweep.cu) on one
NVIDIA GPU: other warps a block (WARPS); the column outputs stored by each
lane straight to device memory instead of staged in shared memory and
written out a block at a time (``--stage 0``); K8's and K10's stage limit
(``--clip-stage-kb``: 48 keeps K10's stage on the homolog view, 73,280
bytes, below the opt-in, so its lanes store their outputs directly; 96,
the source's, opts in); and K2's and K6's diagonal and row runs read
from a tile of the tb in shared memory instead of a cell a lane from
device memory (``--tile R``: 32 DP columns, one a lane, by the R rows that
end at the 8-row group of the path's row, filled with 16-byte loads when
the walk leaves it; the Ins runs and K6's fixed column keep their direct
loads; a variant whose shared memory passes 48 KB a block is skipped); and
a fixed number W of steps loaded a diagonal or row round (``--width W``)
in place of the source's, the last such run's (``--width 0``).

    python3 scripts/sweep_trial.py [--warps 16] [--stage 1,0] [--tile 0,32] [--width 0,32] [--clip-stage-kb 96,48]
                                   [--reps 50] [--seed 7]

Inputs, from chip_smoke.py's generators: K1's pair-major tb of 8192 random
150 bp DNA pairs and of 8192 pairs at 2% divergence (K2), K5's of the random
pairs with its fixed column (K6), K11's of the homolog corpus (K2) and
K12's of the domain corpus (K6); K7's of the random pairs (K8), K9's of
them under chip_smoke.py's custom-mode penalties and clips (K10), and
K7-LUT's of the homolog corpus (K8 and K10, N = 457). ``--warps``,
``--stage``, ``--tile``, ``--width`` and ``--clip-stage-kb`` take
comma-separated lists; every combination is one variant (stage 1, tile
0, width 0, clip stage 96 KB: the source's own design), made from this
checkout's source by text
substitution (each must apply), built with nvcc into ``ops/_build/`` and
called through ctypes as the wrappers call the tree's kernels. For each
variant and input it prints one JSON line: the median of ``--reps``
CUDA-event-timed launches, whether the outputs equal the tree's wrapper's,
the registers a thread (``cuobjdump -res-usage``), and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

TILE = '''
constexpr int TROWS = {rows};           // rows of a tile column, a multiple of 8
constexpr int TPITCH = TROWS + 8;       // uint16 between tile columns
struct Tile {{
  uint16_t* s;
  int jt, r0;
  __device__ bool holds(int i, int j) const {{
    return j <= jt && j > jt - LANES && i >= r0 && i < r0 + TROWS;
  }}
  // cell (i, j): -1 outside the column's rows, UNLOADED outside the tile
  __device__ int get(const Pair& p, int i, int j) const {{
    if (i < 0 || i >= p.X) return -1;
    return holds(i, j) ? s[(jt - j) * TPITCH + i - r0] : UNLOADED;
  }}
  // columns j - 31..j, the TROWS rows ending at the 8-row group of row i
  __device__ void fill(const Pair& p, int i, int j) {{
    __syncwarp();
    jt = j;
    r0 = max((i + 8) / 8 * 8 - TROWS, 0);
    const int jc = j - p.lane;
    if (jc >= 1) {{
      const uint16_t* col = p.tb + (jc - 1) * p.sj;
      uint16_t* dst = s + p.lane * TPITCH;
#pragma unroll
      for (int g = 0; g < TROWS / 8; ++g) {{
        const int r = r0 + 8 * g;
        if (r < p.X) *reinterpret_cast<uint4*>(dst + 8 * g) = __ldg(reinterpret_cast<const uint4*>(col + r));
      }}
    }}
    __syncwarp();
  }}
}};

'''


def variant_source(src: str, warps: int, stage: int, rows: int, width: int = 0, clip_kb: int = 96) -> str:
    subs = [("constexpr int WARPS = 16;", f"constexpr int WARPS = {warps};", 1)]
    if clip_kb != 96:
        subs.append(("constexpr int CLIP_STAGE_MAX_BYTES = 96 * 1024;", f"constexpr int CLIP_STAGE_MAX_BYTES = {clip_kb} * 1024;", 1))
    if not stage:
        subs.append(("  return bytes <= STAGE_MAX_BYTES ? static_cast<int>(bytes) : 0;", "  return 0;", 1))
        subs.append(("  return bytes <= CLIP_STAGE_MAX_BYTES ? static_cast<int>(bytes) : 0;", "  return 0;", 1))
    if width:
        subs += [
            ("  int width = LANES;", f"  int width = {width};", 2),
            ("      width = k < width ? max(k, MIN_WIDTH) : min(2 * width, LANES);", f"      width = {width};", 4),
        ]
    if rows:
        subs += [
            ("// The column sweep from column j, row i,", TILE.format(rows=rows) + "// The column sweep from column j, row i,", 1),
            ("  const int lane = p.lane;\n  if (done",
             "  const int lane = p.lane;\n  __shared__ __align__(16) uint16_t tile_mem[WARPS][LANES * TPITCH];\n"
             "  Tile tile{tile_mem[threadIdx.x / LANES], -1, 0};\n  if (done", 1),
            ("      const int c = lane >= width ? UNLOADED : (lj >= 1 ? p.cell(i - lane, lj) : -1);",
             "      if (!tile.holds(i, j)) tile.fill(p, i, j);\n"
             "      const int c = lane >= width ? UNLOADED : (lj >= 1 ? tile.get(p, i - lane, lj) : -1);", 1),
            ("      const int c = lane >= width ? UNLOADED : (lj >= 1 ? p.cell(i, lj) : -1);",
             "      if (!tile.holds(i, j)) tile.fill(p, i, j);\n"
             "      const int c = lane >= width ? UNLOADED : (lj >= 1 ? tile.get(p, i, lj) : -1);", 1),
        ]
    for old, new, count in subs:
        if src.count(old) != count:
            raise SystemExit(f"sweep_trial: the source no longer holds {old!r} {count} time(s)")
        src = src.replace(old, new)
    return src


def build(src: str, tag: str) -> Path:
    from rust_bio_tpu_torch.ops import _build

    digest = hashlib.sha256(src.encode()).hexdigest()[:12]
    cu = _build.BUILD_DIR / f"sweep_trial_{tag}_{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        _build.BUILD_DIR.mkdir(exist_ok=True)
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warps", default="16")
    ap.add_argument("--stage", default="1,0")
    ap.add_argument("--tile", default="0,32")
    ap.add_argument("--width", default="0")
    ap.add_argument("--clip-stage-kb", default="96")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sweep_trial: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from rust_bio_tpu_torch.alignment.pairwise import BatchAligner, Scoring
    from rust_bio_tpu_torch.alignment.pairwise.batched import _fixed_column
    from rust_bio_tpu_torch.ops import _build, sw, walk
    from rust_bio_tpu_torch.scores import blosum62, dense_matrix

    dev = torch.device("cuda")
    card = chip_smoke.nvidia_smi_line()
    rng = np.random.default_rng(args.seed)
    B, L = chip_smoke.B_ALN, chip_smoke.LEN
    acgt = np.frombuffer(b"ACGT", np.uint8)
    xb = acgt[rng.integers(0, 4, size=(B, L))]
    yb = acgt[rng.integers(0, 4, size=(B, L))]
    yb_hi = xb.copy()
    mut = rng.random(size=(B, L)) < 0.02
    yb_hi[mut] = acgt[rng.integers(0, 4, size=int(mut.sum()))]
    lens = np.full(B, L, np.int32)
    pens = (chip_smoke.GO, chip_smoke.GE, chip_smoke.MA, chip_smoke.MI)
    dna = [torch.from_numpy(v).to(dev) for v in (xb, yb, lens, lens)]
    div = [torch.from_numpy(v).to(dev) for v in (xb, yb_hi, lens, lens)]
    semi = sw.scan_semiglobal(*dna, *pens, 0, 0)
    _, tbfix5 = _fixed_column(*semi[1:], dna[2], chip_smoke.GO, chip_smoke.GE)
    (hxs, hys), (dxs, dys) = chip_smoke.protein_corpora(np.random.default_rng(args.seed))
    bp = BatchAligner(Scoring.new(chip_smoke.PROT_GO, chip_smoke.PROT_GE, blosum62), device=dev)
    hom = [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in bp._pad(hxs, hys)]
    dom = [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in bp._pad(dxs, dys)]
    lut = torch.from_numpy(dense_matrix("blosum62")).to(dev)
    pgo, pge = chip_smoke.PROT_GO, chip_smoke.PROT_GE
    dsemi = sw.scan_semiglobal_lut(*dom, pgo, pge, lut, 0, 0)
    _, tbfix12 = _fixed_column(*dsemi[1:], dom[2], pgo, pge)
    cases = [
        ("sweep_walk_global", "150 bp random", sw.scan_global(*dna, *pens)[1], None, dna),
        ("sweep_walk_global", "150 bp 2% diverged", sw.scan_global(*div, *pens)[1], None, div),
        ("sweep_walk_global", "homolog", sw.scan_global_lut(*hom, pgo, pge, lut)[1], None, hom),
        ("sweep_walk_semiglobal", "150 bp random", semi[0], tbfix5, dna),
        ("sweep_walk_semiglobal", "domain", dsemi[0], tbfix12, dom),
    ]
    for _, _, tb, _, _ in cases:
        assert walk._vector_rows(tb), "sweep_trial: a tb the tile fill cannot read 16 bytes at a time"
    # K8 and K10: (tb, tbfix, lx, lx_n) in place of the fixed column
    cclips = (chip_smoke.CUSTOM_XCLIP, chip_smoke.CUSTOM_XCLIP, chip_smoke.CUSTOM_YCLIP, chip_smoke.CUSTOM_YCLIP)
    for name, what, scan, a, gaps, clips in (
        ("sweep_walk_local", "150 bp random", sw.scan_local(*dna, *pens), dna, pens[:2], (0, 0, 0, 0)),
        ("sweep_walk_custom", "150 bp random", sw.scan_custom(*dna, *chip_smoke.CUSTOM_PENS, *cclips), dna,
         chip_smoke.CUSTOM_PENS[:2], cclips),
        ("sweep_walk_local", "homolog", sw.scan_local_lut(*hom, pgo, pge, lut), hom, (pgo, pge), (0, 0, 0, 0)),
        ("sweep_walk_custom", "homolog", sw.scan_local_lut(*hom, pgo, pge, lut), hom, (pgo, pge), (0, 0, 0, 0)),
    ):
        tbfix, lx_n = chip_smoke.clip_walk_inputs(torch, scan, a[2], a[3], gaps, clips)
        cases.append((name, what, scan[0], (tbfix, scan[1], lx_n), a))
    wants = []
    for name, _, tb, fix, a in cases:
        extra = () if fix is None else (fix,) if name == "sweep_walk_semiglobal" else fix
        wants.append(getattr(walk, name)(tb, *extra, a[2], a[3]))
    src = (_build.CSRC / "walk_sweep.cu").read_text()
    stream = torch.cuda.current_stream().cuda_stream
    variants = [
        (int(w), int(st), int(r), int(wd), int(kb))
        for w in args.warps.split(",") for st in args.stage.split(",") for r in args.tile.split(",")
        for wd in args.width.split(",") for kb in args.clip_stage_kb.split(",")
    ]
    kernels = {k.symbol: k for k in (walk.SWEEP_WALK_GLOBAL, walk.SWEEP_WALK_SEMIGLOBAL, walk.SWEEP_WALK_LOCAL, walk.SWEEP_WALK_CUSTOM)}
    for warps, stage, rows, width, clip_kb in variants:
        so = build(variant_source(src, warps, stage, rows, width, clip_kb), f"w{warps}_s{stage}_t{rows}_l{width}_c{clip_kb}")
        lib = ctypes.CDLL(str(so))
        regs = chip_smoke.kernel_registers(so, r"(sweep_walk_(?:semi)?global(?=_kernel)|sweep_walk_clip_kernelILb[01]E)")
        for (name, what, tb, fix, a), want in zip(cases, wants):
            N, X, Bq = tb.shape
            clip = name in ("sweep_walk_local", "sweep_walk_custom")
            if clip:
                stage_bytes = 2 * (5 if name == "sweep_walk_custom" else 2) * warps * N
                stage_bytes = stage_bytes if stage and stage_bytes <= clip_kb * 1024 else 0
            else:
                stage_bytes = 4 * warps * N if stage and 4 * warps * N <= 48 * 1024 else 0
            shared = (warps * 32 * (rows + 8) * 2 if rows and not clip else 0) + stage_bytes
            fields = {"trial": "walk_sweep", "kernel": name, "input": what, "warps": warps, "stage": stage,
                      "tile_rows": rows, "width": width, "clip_stage_kb": clip_kb, "shared_bytes": shared}
            if shared > (227 if clip else 48) * 1024:
                print(json.dumps({**fields, "skipped": f"{shared} shared bytes a block"}), flush=True)
                continue
            fn = getattr(lib, name)
            fn.argtypes = kernels[name].argtypes + [_build.PTR]
            fn.restype = _build.INT
            if clip:
                flat = torch.empty((len(want) - 6, N, Bq), dtype=torch.uint16, device=dev)
                small = [torch.empty((2, Bq, 4), dtype=torch.int32, device=dev), torch.empty((4, Bq), dtype=torch.int32, device=dev)]
                outs = [*flat.unbind(0), *small[0].unbind(0), *small[1].unbind(0)]
                head = [tb.data_ptr(), fix[0].data_ptr(), fix[1].data_ptr(), fix[2].data_ptr()]
                tail = [flat.data_ptr(), small[0][0].data_ptr(), small[0][1].data_ptr(), small[1].data_ptr()]
                dims = (Bq, X, N - 1)
            else:
                outs = [torch.empty_like(w) for w in want]
                head = [tb.data_ptr()] + ([] if fix is None else [fix.data_ptr()])
                tail = [o.data_ptr() for o in outs]
                dims = (Bq, X, N)

            def run():
                rc = fn(*head, a[2].data_ptr(), a[3].data_ptr(), *dims, *walk._walk_strides(tb), *tail, stream)
                if rc:
                    raise RuntimeError(f"sweep_trial: {name} CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            same = all(torch.equal(o, w) for o, w in zip(outs, want))
            print(json.dumps({
                **fields, "pairs": int(Bq), "M": int(X) - 1, "N": int(N), "reps": args.reps,
                "ms": chip_smoke.cuda_ms(torch, run, args.reps), "equal": same, "registers": regs, "card": card,
            }), flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
