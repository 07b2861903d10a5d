#!/usr/bin/env python3
"""Trials of variants of K4 and K4-locate (csrc/fm_search.cu) on one NVIDIA
GPU: other threads a block (``--threads``), other K4 step loops (``--k4``)
and the locate walk reading the symbol at pos from the S bit-planes of
pos's word, all S loaded together, with its rank at pos - 1 from the same
entry, in place of the bwt_sym gather and then the rank (``--planes 1``).

    python3 scripts/fm_trial.py [--threads 64,128,256] [--k4 source,shared,parent,paired,staged]
                                [--planes 0,1] [--reps 50] [--seed 7]

K4's loops (``--k4``): ``source`` this checkout's (both ranks of a step
issued together, the next step's byte, symbol and less loaded a step
ahead, off the rank chain); ``shared`` that loop with sym_of and less in
shared memory; ``parent`` PR 1-21's (the pattern byte, sym_of and less
read through L1 in the chain, the rank at l - 1 issued after the rank at r
has returned); ``paired`` that loop with both ranks of a step issued
together (one load where l - 1 and r share a word); ``staged`` paired,
each thread staging its pattern as codes (byte << 16 | symbol) in its own
column of shared memory, 32 steps at a time, before it walks, with sym_of
and less in shared memory.

Inputs, from chip_smoke.py's generator: the index of its 4,641,652 bp text
(``sampling_rate`` 32) built on the card, its 65,536 20-mers (K4), phase
2's locate rows and 8192 random rows (K4-locate). Each option takes a
comma-separated list; every combination is one variant, made from this
checkout's source by text substitution (each must apply), built with nvcc
into ``ops/_build/`` and called through ctypes with the wrappers'
arguments. For each variant and input it prints one JSON line: the median
of ``--reps`` CUDA-event-timed launches after one warm-up (``queued_ms``:
back to back behind a sleep of the card, chip_smoke.py ``queued_ms``),
whether the outputs equal the tree's wrapper's, the registers a thread
(``cuobjdump -res-usage``), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

# K4's other step loops: each replaces the kernel's body up to its stores
K4_START = "int* __restrict__ upper, int* __restrict__ mlen_out) {\n"
K4_END = "  status[q] = mlen > 0"
K4_PROLOG = """  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= B) return;
  const int plen = __ldg(plens + q);
  const uint8_t* pat = pats + static_cast<size_t>(q) * L;
  int l = 0;
  int r = n - 1;
  int pl = l;
  int pr = r;
  int mlen = 0;
  bool complete = true;
"""
K4_TABLES = """  __shared__ int sym_s[256];
  __shared__ int less_s[256];
  for (int i = threadIdx.x; i < 256; i += THREADS) {
    sym_s[i] = __ldg(sym_of + i);
    less_s[i] = __ldg(less + i);
  }
  __syncthreads();
"""
K4_LOOPS = {
    "parent": K4_PROLOG + """  for (int t = 0; t < plen; ++t) {
    const int a = pat[plen - 1 - t];
    const int sym = __ldg(sym_of + a);
    pl = l;
    pr = r;
    const int occ_r = sym >= 0 ? rank(fused, nw, r, sym) : 0;
    bool fail = occ_r == 0;
    if (!fail) {
      const int occ_lm1 = l > 0 ? rank(fused, nw, l - 1, sym) : 0;
      const int less_a = __ldg(less + a);
      const int l_new = less_a + occ_lm1;
      const int r_new = less_a + occ_r - 1;
      fail = l_new > r_new;
      if (!fail) {
        l = l_new;
        r = r_new;
        ++mlen;
      }
    }
    if (fail) {
      complete = false;
      break;
    }
  }
""",
    "paired": K4_PROLOG + """  for (int t = 0; t < plen; ++t) {
    const int a = __ldg(pat + (plen - 1 - t));
    const int sym = __ldg(sym_of + a);
    pl = l;
    pr = r;
    if (sym < 0) {
      complete = false;
      break;
    }
    const int2* plane = fused + static_cast<size_t>(sym) * nw;
    const int lm1 = l - 1;
    const int2 er = r >= 0 ? __ldg(plane + (r >> 5)) : make_int2(0, 0);
    const int2 el = lm1 >= 0 && (lm1 >> 5) != (r >> 5) ? __ldg(plane + (lm1 >> 5)) : er;
    const int less_a = __ldg(less + a);
    const int occ_r = r >= 0 ? count_to(er, r & 31) : 0;
    const int occ_l = lm1 >= 0 ? count_to(el, lm1 & 31) : 0;
    const int l_new = less_a + occ_l;
    const int r_new = less_a + occ_r - 1;
    if (occ_r == 0 || l_new > r_new) {
      complete = false;
      break;
    }
    l = l_new;
    r = r_new;
    ++mlen;
  }
""",
    "staged": """  constexpr int CHUNK = 32;
  __shared__ int sym_s[256];
  __shared__ int less_s[256];
  __shared__ int codes[CHUNK * THREADS];  // [step][thread]: a thread's own column
  for (int i = threadIdx.x; i < 256; i += THREADS) {
    sym_s[i] = __ldg(sym_of + i);
    less_s[i] = __ldg(less + i);
  }
  __syncthreads();
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= B) return;
  const int plen = __ldg(plens + q);
  const uint8_t* pat = pats + static_cast<size_t>(q) * L;
  int* code = codes + threadIdx.x;
  int l = 0;
  int r = n - 1;
  int pl = l;
  int pr = r;
  int mlen = 0;
  bool complete = true;
  for (int t0 = 0; complete && t0 < plen; t0 += CHUNK) {
    const int cnt = min(CHUNK, plen - t0);
    const uint8_t* last = pat + (plen - 1 - t0);
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const int a = __ldg(last - k);
      const int sym = sym_s[a];
      code[k * THREADS] = sym >= 0 ? (a << 16) | sym : -1;
    }
    for (int k = 0; k < cnt; ++k) {
      const int c = code[k * THREADS];
      pl = l;
      pr = r;
      if (c < 0) {
        complete = false;
        break;
      }
      const int2* plane = fused + static_cast<size_t>(c & 0xFFFF) * nw;
      const int lm1 = l - 1;
      // r < 0 only for an empty text, where rank(r) is 0
      const int2 er = r >= 0 ? __ldg(plane + (r >> 5)) : make_int2(0, 0);
      const int occ_r = r >= 0 ? count_to(er, r & 31) : 0;
      int2 el = er;
      if (lm1 >= 0 && (lm1 >> 5) != (r >> 5)) el = __ldg(plane + (lm1 >> 5));
      const int occ_l = lm1 >= 0 ? count_to(el, lm1 & 31) : 0;
      if (occ_r == 0) {
        complete = false;
        break;
      }
      const int less_a = less_s[c >> 16];
      const int l_new = less_a + occ_l;
      const int r_new = less_a + occ_r - 1;
      if (l_new > r_new) {
        complete = false;
        break;
      }
      l = l_new;
      r = r_new;
      ++mlen;
    }
  }
""",
}
PLANES = (
    """    const int sym = __ldg(bwt_sym + pos);
    if (sym == 0) break;
    pos = less_s[sym] + rank(fused, nw, pos - 1, sym);
""",
    """    const int w = pos >> 5;
    const unsigned below = (1u << (pos & 31)) - 1u;
    int sym = 0;
    int2 hit = make_int2(0, 0);
    for (int p0 = 0; p0 < S; p0 += 16) {
      int2 v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (p0 + j < S) v[j] = __ldg(fused + static_cast<size_t>(p0 + j) * nw + w);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (p0 + j < S && (static_cast<unsigned>(v[j].x) & (below + 1u)) != 0) {
          sym = p0 + j;
          hit = v[j];
        }
      if (hit.x != 0) break;
    }
    if (sym == 0) break;
    pos = less_s[sym] + hit.y + __popc(static_cast<unsigned>(hit.x) & below);
""",
)


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"fm_trial: the source no longer holds {old!r} once")
    return src.replace(old, new)


def variant_source(src: str, threads: int, k4: str, planes: int) -> str:
    src = replace_once(src, "constexpr int THREADS = 128;", f"constexpr int THREADS = {threads};")
    start = src.index(K4_START) + len(K4_START)
    if k4 == "shared":
        src = src[:start] + K4_TABLES + src[start:]
        for table, shared in (("sym_of", "sym_s"), ("less", "less_s")):
            for a in ("a", "a1"):
                src = replace_once(src, f"__ldg({table} + {a})", f"{shared}[{a}]")
    elif k4 != "source":
        src = src[:start] + K4_LOOPS[k4] + src[src.index(K4_END, start):]
    if planes:
        src = replace_once(src, *PLANES)
    return src


def build(src: str, tag: str) -> Path:
    from rust_bio_tpu_torch.ops import _build

    cu = _build.BUILD_DIR / f"fm_trial_{tag}.cu"
    so = cu.with_suffix(".so")
    _build.BUILD_DIR.mkdir(exist_ok=True)
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="64,128,256")
    ap.add_argument("--k4", default="source,shared," + ",".join(K4_LOOPS))
    ap.add_argument("--planes", default="0,1")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fm_trial: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from rust_bio_tpu_torch.alphabets import dna
    from rust_bio_tpu_torch.data_structures.fm_device import DeviceFMIndex
    from rust_bio_tpu_torch.ops import _build, fm

    source = (_build.CSRC / "fm_search.cu").read_text()
    dev = torch.device("cuda")
    card = chip_smoke.nvidia_smi_line()
    text_arr, _, pats_np = chip_smoke.fm_inputs(args.seed)
    index = DeviceFMIndex.from_text(text_arr.tobytes(), dna.n_alphabet(), sampling_rate=32, device=dev)
    pats = torch.from_numpy(pats_np).to(dev)
    plens = torch.full((len(pats_np),), chip_smoke.QLEN, dtype=torch.int32, device=dev)
    want_search = index.search_arrays(pats, plens)
    status, lower, upper = (t.cpu().numpy() for t in want_search[:3])
    n_sampled = len(pats_np) // 2
    sampled = status[:n_sampled] == fm.COMPLETE
    inputs = {
        "phase 2 rows": chip_smoke.interval_rows(lower[:n_sampled][sampled], upper[:n_sampled][sampled]),
        "random rows": np.random.default_rng((args.seed, 6)).integers(0, index.n, size=chip_smoke.B_READS).astype(np.int32),
    }
    inputs = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    want_locate = {k: index.locate_rows(v) for k, v in inputs.items()}
    S, nw, _ = index._fused.shape
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    P, I = ctypes.c_void_p, ctypes.c_int
    for threads, k4, planes in itertools.product(
        [int(v) for v in args.threads.split(",")], args.k4.split(","), [int(v) for v in args.planes.split(",")]
    ):
        so = build(variant_source(source, threads, k4, planes), f"t{threads}_{k4}_l{planes}")
        lib = ctypes.CDLL(str(so))
        lib.fm_backward_search.argtypes = [P] * 5 + [I] * 4 + [P] * 5
        lib.fm_locate.argtypes = [P, P, P, I, P, P, P, I, P, I, I, I, I, P, P]
        regs = chip_smoke.kernel_registers(so, r"(fm_search_kernel|fm_locate_kernel)")
        variant = {"threads": threads, "k4": k4, "planes": planes, "registers": regs}
        outs = [torch.empty_like(t) for t in want_search]

        def search():
            rc = lib.fm_backward_search(
                index._fused.data_ptr(), index._less256.data_ptr(), index.sym_of.data_ptr(), pats.data_ptr(),
                plens.data_ptr(), len(pats_np), chip_smoke.QLEN, nw, index.n, *(o.data_ptr() for o in outs), stream(),
            )
            assert rc == 0, rc

        search()
        torch.cuda.synchronize()
        print(json.dumps({
            "kernel": "fm_backward_search", **variant, "queries": len(pats_np),
            "ms": chip_smoke.cuda_ms(torch, search, args.reps), "queued_ms": chip_smoke.queued_ms(torch, search, args.reps),
            "equal": all(torch.equal(o, w) for o, w in zip(outs, want_search)), "card": card,
        }), flush=True)
        for name, rows in inputs.items():
            out = torch.empty_like(rows)

            def loc(rows=rows, out=out):
                rc = lib.fm_locate(
                    index._fused.data_ptr(), index.bwt_sym.data_ptr(), index.less_sym.data_ptr(), S,
                    index.sa_sample.data_ptr(), index.sent_rows.data_ptr(), index.sent_vals.data_ptr(),
                    index.sent_rows.numel(), rows.data_ptr(), rows.numel(), nw, index.n, index.s, out.data_ptr(), stream(),
                )
                assert rc == 0, rc

            loc()
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": "fm_locate", **variant, "input": name, "rows": rows.numel(),
                "ms": chip_smoke.cuda_ms(torch, loc, args.reps), "queued_ms": chip_smoke.queued_ms(torch, loc, args.reps),
                "equal": torch.equal(out, want_locate[name]), "card": card,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
