"""Port kernels K8 (local-mode walk) and K10 (custom-clip walk), plain,
against the JAX package's Pallas walks (interpret mode) on synthetic 16-bit
traceback cells with every layer code (``test_torch_cuda._clip_inputs``),
prolog, sweep and epilog; and their launch geometry
(``walk.clip_walk_geometry``) against csrc/walk_sweep.cu. Exact comparison
(tolerance 0)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.ops.walk_pallas import sweep_walk_custom as jax_sweep_walk_custom
from rust_bio_tpu.ops.walk_pallas import sweep_walk_local as jax_sweep_walk_local
from rust_bio_tpu_torch.ops import walk
from test_torch_cuda import _clip_inputs, _poisoned_view


def _jax(fn, inputs):
    return [np.asarray(v) for v in fn(*(jnp.asarray(t.numpy()) for t in inputs))]


@pytest.mark.parametrize("N,X,B", [(70, 203, 80), (40, 41, 21), (1, 1, 10), (0, 9, 8)])
def test_clip_walk_plain_on_synthetic_cells_matches_jax(N, X, B):
    """The plain K8 and K10 (``sweep_walk_local_plain``,
    ``sweep_walk_custom_plain``: prolog, sweep, epilog) on ``_clip_inputs``
    against the JAX ``sweep_walk_local`` / ``sweep_walk_custom``, every
    output, on the contiguous tb and on a pair-major view with poisoned
    padding rows: Xclip-suffix entries at row mlens, Xclip-prefix exits with
    Del / Yclip-prefix / Start posts, Yclip-prefix exits, Ins runs past 32
    rows and the nibble's cap, diagonals and Del rows past 32 columns, fixed
    columns whose Ins run reaches row 0, x-suffix jumps to negative rows,
    more than four prolog emits, lanes with mlens = 0 or nlens = 0."""
    inputs = _clip_inputs(np.random.default_rng(N + 3 * X + B), N, X, B, "cpu")
    tb = inputs[0]
    for jax_fn, plain in ((jax_sweep_walk_custom, walk.sweep_walk_custom_plain), (jax_sweep_walk_local, walk.sweep_walk_local_plain)):
        want = _jax(jax_fn, inputs)
        for t in (tb, _poisoned_view(tb)):
            got = plain(t, *inputs[1:])
            assert len(got) == len(want)
            for k, (g, w) in enumerate(zip(got, want)):
                assert g.shape == w.shape, (plain.__name__, k)
                np.testing.assert_array_equal(g.to(torch.int32).numpy(), w.astype(np.int32), err_msg=f"{plain.__name__} {k}")
    if X > 200:
        custom = walk.sweep_walk_custom_plain(*inputs)
        pre, ins, exit_op, _, post, fix_codes = (o.to(torch.int32) for o in custom[:6])
        assert int(ins.max()) > 32 and int(pre.max()) > 0  # a long Ins run, an x-suffix jump
        assert {2, 7, 0} <= set(post[exit_op == 5].tolist())  # Xclip-prefix posts: Del, Yclip-prefix, Start
        assert bool((exit_op == 7).any())  # a Yclip-prefix exit
        assert bool((fix_codes != 0).all(dim=1).any())  # a lane filling all four prolog slots


@pytest.mark.parametrize("N", [0, 1, 150, 457, 1000, 1300])
def test_clip_walk_geometry_mirrors_the_source(N):
    """K8's and K10's launch (``walk.clip_walk_geometry``) against
    csrc/walk_sweep.cu: K2's warps a block and lanes, the outputs each
    stages (K8 two, K10 five (N+1, B) uint16) and the stage limit; the grid
    covers every pair once; a block stages its column outputs exactly while
    they fit the limit, above 48 KB by opting in, within the 227 KB a block
    may take."""
    text = (Path(walk.__file__).parent / "csrc" / "walk_sweep.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    limit = int(re.search(r"constexpr int CLIP_STAGE_MAX_BYTES = (\d+) \* 1024;", text).group(1)) * 1024
    assert limit == walk.CLIP_STAGE_MAX_BYTES <= 227 * 1024
    assert re.search(r"cudaFuncAttributeMaxDynamicSharedMemorySize", text)
    for custom, outputs in ((False, 2), (True, 5)):
        assert outputs == (consts["CUSTOM_OUTPUTS"] if custom else consts["LOCAL_OUTPUTS"])
        for B in (0, 1, 15, 16, 17, 8192, 8193):
            g = walk.clip_walk_geometry(B, N, custom)
            assert (g["warps"], g["lanes"], g["outputs"]) == (consts["WARPS"], consts["LANES"], outputs)
            assert g["threads"] == g["warps"] * g["lanes"] <= 1024
            assert (g["blocks"] - 1) * g["warps"] < B <= g["blocks"] * g["warps"] or B == g["blocks"] == 0
            stage = 2 * outputs * g["warps"] * (N + 1)
            assert g["staged"] == (stage <= limit)
            assert g["shared_bytes"] == (stage if g["staged"] else 0)
            assert g["opt_in"] == (g["shared_bytes"] > 48 * 1024)
    # K10 at 150 bp stages without opting in; on the homolog view (N = 457) by opting in
    assert walk.clip_walk_geometry(8192, 150, True)["shared_bytes"] == 24_160
    assert walk.clip_walk_geometry(8192, 457, True)["opt_in"]
