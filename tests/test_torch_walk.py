"""Port kernel K2 (global column-sweep traceback walk) against the JAX
package's Pallas walk, run in interpret mode on the CPU, on traceback
tensors of the JAX scan, on the pair-major view of K1's tb (the port's CPU
scan, padding rows poisoned) at 150 bp, and on synthetic cells whose runs
cross the card kernel's round edges; K1's launch geometry at every x
length below ``T_ROWS``, and K2's and K6's (``walk.sweep_walk_geometry``)
against csrc/walk_sweep.cu. Exact comparison (tolerance 0)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_bio_tpu.ops.sw_pallas import scan_global_pallas_mp
from rust_bio_tpu.ops.walk_pallas import sweep_walk_global as jax_sweep_walk_global
from rust_bio_tpu_torch.alignment.pairwise.batched import T_ROWS
from rust_bio_tpu_torch.alignment.pairwise.scoring import MIN_SCORE
from rust_bio_tpu_torch.ops import sw
from rust_bio_tpu_torch.ops import walk
from rust_bio_tpu_torch.ops.walk import sweep_walk_global, sweep_walk_global_plain
from test_torch_cuda import _poisoned_view, _sweep_inputs



def _jax_tb(xb, yb, mlens, nlens, go, ge):
    pens8 = np.array([go, ge, MIN_SCORE, MIN_SCORE, MIN_SCORE, MIN_SCORE, 2, -2], np.int32)
    _, tb, _ = scan_global_pallas_mp(
        *(jnp.asarray(a) for a in (xb, yb, mlens, nlens, pens8)), runs="ins"
    )
    return np.asarray(tb)


def _check(xb, yb, mlens, nlens, go, ge):
    N = yb.shape[1]
    jtb = _jax_tb(xb, yb, mlens, nlens, go, ge)
    want = [np.asarray(v) for v in jax_sweep_walk_global(jnp.asarray(jtb), jnp.asarray(mlens), jnp.asarray(nlens))]
    got = sweep_walk_global(
        torch.from_numpy(np.ascontiguousarray(jtb[:N])),
        torch.from_numpy(mlens),
        torch.from_numpy(nlens),
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.uint16
    np.testing.assert_array_equal(got[0].numpy(), want[0][:N])
    np.testing.assert_array_equal(got[1].numpy(), want[1][:N])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    return got


@pytest.mark.parametrize("go,ge", [(-5, -1), (-2, -2), (-1, -1)])
def test_walk_matches_jax(go, ge):
    rng = np.random.default_rng(11 + abs(go))
    B, M, N = 24, 31, 34
    xb = rng.choice(list(b"ACGT"), size=(B, M)).astype(np.uint8)
    yb = rng.choice(list(b"ACGT"), size=(B, N)).astype(np.uint8)
    mlens = rng.integers(0, M + 1, size=B).astype(np.int32)
    nlens = rng.integers(0, N + 1, size=B).astype(np.int32)
    _check(xb, yb, mlens, nlens, go, ge)


def test_walk_long_insertion_runs_and_short_lanes():
    """x much longer than y forces vertical Ins runs past the 15-cap of the
    run nibble; lanes of length 0 and 1 end in column 0 or at once."""
    rng = np.random.default_rng(3)
    B, M, N = 16, 64, 5
    xb = rng.choice(list(b"ACGT"), size=(B, M)).astype(np.uint8)
    yb = rng.choice(list(b"ACGT"), size=(B, N)).astype(np.uint8)
    mlens = np.full(B, M, np.int32)
    nlens = rng.integers(1, N + 1, size=B).astype(np.int32)
    mlens[:6] = [0, 1, 0, 1, 40, 17]
    nlens[:6] = [0, 0, 1, 1, 0, 1]
    ins_cnt, _, ins0 = _check(xb, yb, mlens, nlens, -5, -1)
    assert int(ins_cnt.to(torch.int32).max()) > 15  # the re-gather chain ran
    assert int(ins0.to(torch.int32).max()) > 15


@pytest.mark.parametrize("go,ge", [(-5, -1), (-2, -2)])
def test_walk_on_k1_pair_major_view_matches_jax(go, ge):
    """K2's plain walk on the pair-major view of K1's tb (the port's CPU
    scan, as K1 returns it on the card: padding rows holding 0x0ABC, a cell
    no walk may read) equals the JAX walk on the JAX scan's tb, on 150 bp
    pairs, random and at 2% divergence, with mlens = 0 and nlens = 0 lanes."""
    rng = np.random.default_rng(21 - go)
    B, L = 8, 150
    xb = rng.choice(list(b"ACGT"), size=(B, L)).astype(np.uint8)
    yb = rng.choice(list(b"ACGT"), size=(B, L)).astype(np.uint8)
    yb[4:] = xb[4:]
    mut = rng.random(size=(4, L)) < 0.02
    yb[4:][mut] = rng.choice(list(b"ACGT"), size=int(mut.sum())).astype(np.uint8)
    mlens = np.full(B, L, np.int32)
    nlens = np.full(B, L, np.int32)
    mlens[:3], nlens[:3] = [0, L, 0], [L, 0, 0]
    jtb = _jax_tb(xb, yb, mlens, nlens, go, ge)
    want = [np.asarray(v) for v in jax_sweep_walk_global(jnp.asarray(jtb), jnp.asarray(mlens), jnp.asarray(nlens))]
    args = [torch.from_numpy(a) for a in (xb, yb, mlens, nlens)]
    _, tb, _ = sw.scan_global(*args, go, ge, 2, -2)
    view = _poisoned_view(tb)
    assert view.stride()[1] == 1 and not view.is_contiguous()
    got = sweep_walk_global(view, args[2], args[3])
    np.testing.assert_array_equal(got[0].numpy(), want[0][:L])
    np.testing.assert_array_equal(got[1].numpy(), want[1][:L])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    for g, c in zip(got, sweep_walk_global(tb, args[2], args[3])):
        assert torch.equal(g, c)


def test_k1_warp_geometry_keeps_its_state_on_chip():
    """K1's launch (``warp_geometry(M, GLOBAL_WARP_LAYERS)``) at every M with
    M + 1 < ``T_ROWS``: its three layers in shared memory, R the least
    multiple of 8 with 32 R >= M + 1, the 32 lane stripes covering rows
    0..M once each."""
    for m in range(T_ROWS - 1):
        R, placement, smem = sw.warp_geometry(m, sw.GLOBAL_WARP_LAYERS)
        assert placement == "shared" and smem == R * 32 + 3 * R * 32 * 4 <= sw.WARP_SHARED_MAX, m
        assert R % 8 == 0 and 32 * R >= m + 1 > 32 * (R - 8), m
        owners = np.concatenate([np.arange(t * R, t * R + R) for t in range(32)])
        assert (np.bincount(owners, minlength=m + 1)[: m + 1] == 1).all(), m


@pytest.mark.parametrize("N,X,B", [(70, 203, 29), (40, 100, 6), (1, 1, 5)])
def test_walk_plain_on_synthetic_runs_matches_jax(N, X, B):
    """The plain K2 on ``_sweep_cells`` (every layer code; Ins runs of 15 to
    150 rows across 32- and 96-row edges and past the nibble's cap,
    diagonals past 32 columns, Del runs; X not a multiple of 8, B not a
    multiple of K2's warps a block) against the JAX walk, on the contiguous
    tb and on a pair-major view with poisoned padding rows."""
    tb, _, ml, nl = _sweep_inputs(np.random.default_rng(N + X), N, X, B, "cpu")
    want = [np.asarray(v) for v in jax_sweep_walk_global(jnp.asarray(tb.numpy()), jnp.asarray(ml.numpy()), jnp.asarray(nl.numpy()))]
    for t in (tb, _poisoned_view(tb)):
        got = sweep_walk_global_plain(t, ml, nl)
        for g, w in zip(got, want):
            assert g.dtype == torch.uint16
            np.testing.assert_array_equal(g.to(torch.int32).numpy(), w.astype(np.int32))
    if X > 200:
        ins = got[0].to(torch.int32)
        assert int(ins.max()) > 96  # an Ins run across three 32-row rounds
        mm = ((got[1].to(torch.int32) - 3).abs() <= 1) & (ins == 0)  # Match/Subst exits with no Ins
        longest = max(max((len(r) for r in "".join("1" if v else "0" for v in col).split("0")), default=0) for col in mm.T.tolist())
        assert longest > 32  # a diagonal across a 32-column edge


@pytest.mark.parametrize("N", [0, 1, 150, 457, 768, 769, 4096])
def test_sweep_walk_geometry_mirrors_the_source(N):
    """K2's and K6's launch (``walk.sweep_walk_geometry``) against
    csrc/walk_sweep.cu: its warps a block, lanes and stage limit; the grid
    covers every pair once; a block stages its column outputs exactly while
    they fit the limit, and its shared bytes fit the 48 KB a block takes
    without opting in (227 KB with)."""
    text = (Path(walk.__file__).parent / "csrc" / "walk_sweep.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+)(?: \* 1024)?;", text)}
    limit = int(re.search(r"constexpr int STAGE_MAX_BYTES = (\d+) \* 1024;", text).group(1)) * 1024
    assert limit == walk.SWEEP_STAGE_MAX_BYTES
    for B in (0, 1, 3, 15, 16, 17, 8191, 8192, 8193):
        g = walk.sweep_walk_geometry(B, N)
        assert (g["warps"], g["lanes"]) == (consts["WARPS"], consts["LANES"])
        assert g["threads"] == g["warps"] * g["lanes"] <= 1024
        assert (g["blocks"] - 1) * g["warps"] < B <= g["blocks"] * g["warps"] or B == g["blocks"] == 0
        assert g["staged"] == (4 * g["warps"] * N <= limit)
        assert g["shared_bytes"] == (4 * g["warps"] * N if g["staged"] else 0) <= 48 * 1024 <= 227 * 1024
    # a staged column of a block's pairs fills one 32-byte sector of each output
    assert 2 * walk.SWEEP_WARPS == 32
