"""K17-log's, K17-homopoly's, K17-exact's and K17's launch geometry
(``ops/pairhmm.py`` ``pairhmm_log_geometry``, ``pairhmm_exact_geometry``
and ``pairhmm_scaled_geometry``, which ``ops/csrc/pairhmm_log.cu``,
``pairhmm_homopoly.cu``, ``pairhmm_exact.cu`` and ``pairhmm_scaled.cu``
take from the wrapper): one warp a pair, lane t over the columns [t * C +
1, t * C + C] of y; the state (3 or 14 values a column; K17-exact 3, or 7
banded) in registers or in the device scratch; warps a block; K17-exact's
and K17's constants against their sources. Pure Python:
the kernels themselves run in ``test_torch_cuda.py``, their plain versions
against the JAX package in ``test_torch_pairhmm.py``.
"""

import re
from pathlib import Path

import pytest
import torch

from rust_bio_tpu_torch.ops import pairhmm

DTYPES = [torch.float32, torch.float64]


def _stripes(C):
    return [range(t * C + 1, t * C + C + 1) for t in range(32)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 54, 64, 65, 150, 300, 500, 512, 513, 1024, 1536, 2048])
def test_geometry_covers_every_column_once(n, dtype):
    """The 32 stripes cover columns 1..N, each once; C is the least power
    of two that does in registers (a lane's three values a column within
    ``LOG_REG_BYTES``: 16 columns of f32, 8 of f64), the least C in the
    scratch."""
    C, warps, placement = pairhmm.pairhmm_log_geometry(n, 64, dtype)
    cols = [j for stripe in _stripes(C) for j in stripe]
    assert len(cols) == len(set(cols)) and set(range(1, n + 1)) <= set(cols)
    least = max(1, -(-n // 32))
    reg_max = 16 if dtype == torch.float32 else 8
    if placement == "registers":
        assert C <= reg_max and C & (C - 1) == 0 and C // 2 < least <= C
    else:
        assert placement == "scratch" and C == least > reg_max
    assert warps == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_geometry_covers_every_column_for_every_width(dtype):
    reg_max = 16 if dtype == torch.float32 else 8
    for n in range(0, 2049):
        C, warps, placement = pairhmm.pairhmm_log_geometry(n, 64, dtype)
        assert 32 * C >= n and (n == 0 or 32 * (C - 1) < n or placement == "registers")
        assert placement == ("registers" if n <= 32 * reg_max else "scratch") and warps == 1


def test_geometry_of_the_main_path():
    """The 64 read-as-x pairs (y up to 500) on 132 SMs: C = 16, one warp a
    block, so that they spread over 64 SMs, in registers in f32 and in the
    scratch in f64; the 4096 bench pairs (y 54): C = 2, one warp a block;
    8192 pairs: two."""
    assert pairhmm.pairhmm_log_geometry(500, 64, torch.float32, 132) == (16, 1, "registers")
    assert pairhmm.pairhmm_log_geometry(500, 64, torch.float64, 132) == (16, 1, "scratch")
    assert pairhmm.pairhmm_log_geometry(256, 64, torch.float64, 132) == (8, 1, "registers")
    assert pairhmm.pairhmm_log_geometry(257, 64, torch.float64, 132) == (9, 1, "scratch")
    assert pairhmm.pairhmm_log_geometry(54, 4096, torch.float32, 132) == (2, 1, "registers")
    assert pairhmm.pairhmm_log_geometry(54, 8192, torch.float32, 132) == (2, 2, "registers")
    assert pairhmm.pairhmm_log_geometry(54, 10**6, torch.float32, 132)[1] == 8


@pytest.mark.parametrize("dtype", DTYPES)
def test_placement_moves_to_the_scratch_as_n_grows(dtype):
    last_reg = 512 if dtype == torch.float32 else 256
    assert pairhmm.pairhmm_log_geometry(last_reg, 64, dtype) == (last_reg // 32, 1, "registers")
    assert pairhmm.pairhmm_log_geometry(last_reg + 1, 64, dtype) == (last_reg // 32 + 1, 1, "scratch")
    assert pairhmm.pairhmm_log_geometry(20_000, 6, dtype) == (625, 1, "scratch")
    # more pairs than the card holds at one warp a block: warps a block
    # grow, up to 8, wherever the state lives
    assert pairhmm.pairhmm_log_geometry(last_reg, 32 * 132 + 1, dtype)[1] == 2
    assert pairhmm.pairhmm_log_geometry(last_reg + 1, 10**6, dtype)[1] == 8


def test_lowered_budget_moves_the_placement_early(monkeypatch):
    monkeypatch.setattr(pairhmm, "LOG_REG_BYTES", 3 * 4 * 4)
    assert pairhmm.pairhmm_log_geometry(128, 64, torch.float32) == (4, 1, "registers")
    assert pairhmm.pairhmm_log_geometry(129, 64, torch.float32) == (5, 1, "scratch")
    assert pairhmm.pairhmm_log_geometry(128, 64, torch.float64) == (4, 1, "scratch")
    monkeypatch.setattr(pairhmm, "LOG_REG_BYTES", 0)
    assert pairhmm.pairhmm_log_geometry(54, 64, torch.float32) == (2, 1, "scratch")
    assert pairhmm.pairhmm_log_geometry(0, 64, torch.float32) == (1, 1, "scratch")


# ---- K17-homopoly: 14 states a column ----

HOMOPOLY = pairhmm.HOMOPOLY_STATES


@pytest.mark.parametrize("dtype", DTYPES)
def test_homopoly_geometry_covers_every_column_for_every_width(dtype):
    """N = 1-5,000: the 32 stripes own each column 1..N once; registers up
    to C = 4 in f32 (14 * 4 * 4 = 224 bytes) and C = 2 in f64 (224 bytes),
    the least C in the scratch beyond."""
    reg_c = 4 if dtype == torch.float32 else 2
    for n in range(1, 5001):
        C, warps, placement = pairhmm.pairhmm_log_geometry(n, 64, dtype, 132, HOMOPOLY)
        owned = [0] * (32 * C + 1)
        for stripe in _stripes(C):
            for j in stripe:
                owned[j] += 1
        assert all(owned[j] == 1 for j in range(1, n + 1)), n
        assert placement == ("registers" if n <= 32 * reg_c else "scratch"), n
        assert C == (1 << (C - 1).bit_length() if placement == "registers" else -(-n // 32))
        assert HOMOPOLY * C * dtype.itemsize <= pairhmm.HOMOPOLY_REG_BYTES or placement == "scratch"
        assert warps == 1


def test_homopoly_geometry_of_the_main_path():
    """The 2048 bench pairs (y 54): C = 2, one warp a block, in registers in
    f32 (112 bytes a lane) and in f64 (224 bytes: the budget, which the
    placement trial set above K17-log's 192); N = 4,200 in the scratch at
    C = 132."""
    assert pairhmm.pairhmm_log_geometry(54, 2048, torch.float32, 132, HOMOPOLY) == (2, 1, "registers")
    assert pairhmm.pairhmm_log_geometry(54, 2048, torch.float64, 132, HOMOPOLY) == (2, 1, "registers")
    assert pairhmm.pairhmm_log_geometry(65, 2048, torch.float64, 132, HOMOPOLY) == (3, 1, "scratch")
    assert pairhmm.pairhmm_log_geometry(4200, 4, torch.float32, 132, HOMOPOLY) == (132, 1, "scratch")
    assert pairhmm.pairhmm_log_geometry(54, 10**6, torch.float32, 132, HOMOPOLY)[1] == 8


def test_homopoly_lowered_budget_moves_the_placement_early(monkeypatch):
    """A budget of one f32 column (56 bytes) keeps C = 1 in registers and
    moves N = 33 to the scratch; at 0 every width goes there; a raised one
    keeps C = 4 in registers (the kernel's largest register stripe) and no
    more. K17-log's budget is its own."""
    monkeypatch.setattr(pairhmm, "HOMOPOLY_REG_BYTES", HOMOPOLY * 4)
    assert pairhmm.pairhmm_log_geometry(32, 64, torch.float32, 132, HOMOPOLY) == (1, 1, "registers")
    assert pairhmm.pairhmm_log_geometry(33, 64, torch.float32, 132, HOMOPOLY) == (2, 1, "scratch")
    assert pairhmm.pairhmm_log_geometry(32, 64, torch.float64, 132, HOMOPOLY) == (1, 1, "scratch")
    assert pairhmm.pairhmm_log_geometry(128, 64, torch.float32) == (4, 1, "registers")
    monkeypatch.setattr(pairhmm, "HOMOPOLY_REG_BYTES", 0)
    assert pairhmm.pairhmm_log_geometry(54, 64, torch.float32, 132, HOMOPOLY) == (2, 1, "scratch")
    monkeypatch.setattr(pairhmm, "HOMOPOLY_REG_BYTES", 10**6)
    assert pairhmm.pairhmm_log_geometry(128, 64, torch.float64, 132, HOMOPOLY) == (4, 1, "registers")
    assert pairhmm.pairhmm_log_geometry(129, 64, torch.float64, 132, HOMOPOLY) == (5, 1, "scratch")


# ---- K17-exact (ops/csrc/pairhmm_exact.cu, ``pairhmm_exact_geometry``) ----

CSRC = Path(pairhmm.__file__).resolve().parent / "csrc"


def _exact_constants() -> dict:
    text = (CSRC / "pairhmm_exact.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_exact_mirrors_match_the_source():
    """The register budget, the values a column keeps (unbanded and
    banded), the lanes and the warps a block of the CUDA source are the
    wrapper's; the source instantiates the register stripes 1, 2, 4 and 8
    that the geometry can pick."""
    c = _exact_constants()
    assert c["REG_BYTES"] == pairhmm.EXACT_REG_BYTES
    assert (c["SLOTS"], c["BANDED_SLOTS"]) == (pairhmm.EXACT_SLOTS, pairhmm.EXACT_BANDED_SLOTS)
    assert (c["LANES"], c["MAX_WARPS"]) == (32, pairhmm._LOG_WARPS_MAX)
    text = (CSRC / "pairhmm_exact.cu").read_text()
    regs = {int(v) for v in re.findall(r"pairhmm_exact_warp_kernel<BANDED, (\d+)>", text)} - {0}
    assert regs == {1, 2, 4, 8}
    # the budget's largest power-of-two stripes, unbanded and banded, are instantiated
    assert {1 << (pairhmm.EXACT_REG_BYTES // (8 * s)).bit_length() - 1 for s in (c["SLOTS"], c["BANDED_SLOTS"])} <= regs


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 54, 64, 65, 96, 97, 150, 256, 257, 500, 5000])
def test_exact_geometry_covers_every_column_once(n, banded):
    """The 32 stripes cover columns 1..N, each once; in registers C is the
    least power of two that does, its columns' values within
    ``EXACT_REG_BYTES`` (8 columns of 3 values unbanded, 2 of 7 banded); in
    the scratch the least C."""
    C, warps, placement = pairhmm.pairhmm_exact_geometry(n, 64, banded)
    cols = [j for stripe in _stripes(C) for j in stripe]
    assert len(cols) == len(set(cols)) and set(range(1, n + 1)) <= set(cols)
    least = max(1, -(-n // 32))
    reg_max = 2 if banded else 8
    slots = pairhmm.EXACT_BANDED_SLOTS if banded else pairhmm.EXACT_SLOTS
    if placement == "registers":
        assert C <= reg_max and C & (C - 1) == 0 and C // 2 < least <= C
        assert slots * C * 8 <= pairhmm.EXACT_REG_BYTES
    else:
        assert placement == "scratch" and C == least > reg_max
    assert warps == 1


def test_exact_geometry_of_the_main_path():
    """The 1024 exact bench pairs (y 54): C = 2 in registers, unbanded and
    at ``max_edit_dist`` 4, one warp a block (1024 warps on 132 SMs, where
    the one-thread kernel ran 32); N = 5,000 in the scratch at C = 157;
    more pairs than 32 blocks an SM hold: more warps a block, up to 8."""
    for banded in (False, True):
        assert pairhmm.pairhmm_exact_geometry(54, 1024, banded, 132) == (2, 1, "registers")
        assert pairhmm.pairhmm_exact_geometry(5000, 4, banded, 132) == (157, 1, "scratch")
        assert pairhmm.pairhmm_exact_geometry(54, 32 * 132 + 1, banded, 132)[1] == 2
        assert pairhmm.pairhmm_exact_geometry(54, 10**6, banded, 132)[1] == 8
    assert pairhmm.pairhmm_exact_geometry(256, 64, False) == (8, 1, "registers")
    assert pairhmm.pairhmm_exact_geometry(257, 64, False) == (9, 1, "scratch")
    assert pairhmm.pairhmm_exact_geometry(64, 64, True) == (2, 1, "registers")
    assert pairhmm.pairhmm_exact_geometry(65, 64, True) == (3, 1, "scratch")


def test_exact_lowered_budget_moves_the_placement_early(monkeypatch):
    """A budget of one banded column (56 bytes) keeps C = 1 in registers
    banded and C = 2 unbanded; at 0 every width goes to the scratch (the
    card tests' scratch placement)."""
    monkeypatch.setattr(pairhmm, "EXACT_REG_BYTES", 56)
    assert pairhmm.pairhmm_exact_geometry(32, 64, True) == (1, 1, "registers")
    assert pairhmm.pairhmm_exact_geometry(33, 64, True) == (2, 1, "scratch")
    assert pairhmm.pairhmm_exact_geometry(64, 64, False) == (2, 1, "registers")
    assert pairhmm.pairhmm_exact_geometry(65, 64, False) == (3, 1, "scratch")
    monkeypatch.setattr(pairhmm, "EXACT_REG_BYTES", 0)
    assert pairhmm.pairhmm_exact_geometry(54, 64, False) == (2, 1, "scratch")
    assert pairhmm.pairhmm_exact_geometry(1, 64, True) == (1, 1, "scratch")


# ---- K17 (ops/csrc/pairhmm_scaled.cu, ``pairhmm_scaled_geometry``) ----


def _scaled_constants() -> dict:
    text = (CSRC / "pairhmm_scaled.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


@pytest.mark.parametrize("lo,hi", [(0, 100), (100, 200), (200, 300), (300, 400), (400, 500), (500, 601), (19_400, 19_401)])
def test_scaled_geometry_covers_every_column_once(lo, hi):
    """N = 0-600 and 19,400: the 32 stripes own each column 1..N once; in
    registers C is the least power of two that does, its three f32 values a
    column within ``SCALED_REG_BYTES`` (16 columns, N <= 512), in the
    scratch the least C."""
    for n in range(lo, hi):
        C, warps, placement = pairhmm.pairhmm_scaled_geometry(n, 64)
        owned = [0] * (32 * C + 1)
        for stripe in _stripes(C):
            for j in stripe:
                owned[j] += 1
        assert all(owned[j] == 1 for j in range(1, n + 1)), n
        least = max(1, -(-n // 32))
        if placement == "registers":
            assert C <= 16 and C & (C - 1) == 0 and C // 2 < least <= C and 3 * C * 4 <= pairhmm.SCALED_REG_BYTES
        else:
            assert placement == "scratch" and C == least > 16, n
        assert placement == ("registers" if n <= 512 else "scratch") and warps == 1


def test_scaled_geometry_of_the_main_path():
    """chip_smoke.py's K17 inputs on 132 SMs: the 4096 bench pairs (y 54):
    C = 2, one warp a block; the 8192 GATK-like pairs (y, the read, 150):
    C = 8, two warps a block; the read-as-x lanes (y, the haplotype, up to
    500): C = 16; y of 207: C = 8; all in registers."""
    assert pairhmm.pairhmm_scaled_geometry(54, 4096, 132) == (2, 1, "registers")
    assert pairhmm.pairhmm_scaled_geometry(150, 8192, 132) == (8, 2, "registers")
    assert pairhmm.pairhmm_scaled_geometry(500, 64, 132) == (16, 1, "registers")
    assert pairhmm.pairhmm_scaled_geometry(207, 4096, 132) == (8, 1, "registers")
    assert pairhmm.pairhmm_scaled_geometry(54, 10**6, 132)[1] == 8


def test_scaled_placement_moves_to_the_scratch_as_n_grows(monkeypatch):
    """Registers up to N = 512, the scratch from 513 (C = 17) and at N =
    19,400 (C = 607, the card test's long rows); a lowered budget moves the
    placement early, 0 sends every width to the scratch (the card tests'
    scratch placement); a raised one keeps C = 16, the kernel's largest
    register stripe."""
    assert pairhmm.pairhmm_scaled_geometry(512, 64) == (16, 1, "registers")
    assert pairhmm.pairhmm_scaled_geometry(513, 64) == (17, 1, "scratch")
    assert pairhmm.pairhmm_scaled_geometry(19_400, 6) == (607, 1, "scratch")
    assert pairhmm.pairhmm_scaled_geometry(513, 32 * 132 + 1)[1] == 2
    monkeypatch.setattr(pairhmm, "SCALED_REG_BYTES", 3 * 4 * 4)
    assert pairhmm.pairhmm_scaled_geometry(128, 64) == (4, 1, "registers")
    assert pairhmm.pairhmm_scaled_geometry(129, 64) == (5, 1, "scratch")
    monkeypatch.setattr(pairhmm, "SCALED_REG_BYTES", 0)
    assert pairhmm.pairhmm_scaled_geometry(54, 64) == (2, 1, "scratch")
    assert pairhmm.pairhmm_scaled_geometry(150, 64) == (5, 1, "scratch")
    assert pairhmm.pairhmm_scaled_geometry(0, 64) == (1, 1, "scratch")
    monkeypatch.setattr(pairhmm, "SCALED_REG_BYTES", 10**6)
    assert pairhmm.pairhmm_scaled_geometry(512, 64) == (16, 1, "registers")
    assert pairhmm.pairhmm_scaled_geometry(513, 64) == (17, 1, "scratch")


def test_scaled_mirrors_match_the_source():
    """The register budget, the lanes and the warps a block of the CUDA
    source are the wrapper's; the source instantiates the register stripes
    1, 2, 4, 8 and 16 that the geometry can pick, and its C entry point
    takes C and warps from the wrapper."""
    c = _scaled_constants()
    assert c["REG_BYTES"] == pairhmm.SCALED_REG_BYTES
    assert (c["LANES"], c["MAX_WARPS"]) == (32, pairhmm._LOG_WARPS_MAX)
    text = (CSRC / "pairhmm_scaled.cu").read_text()
    regs = {int(v) for v in re.findall(r"pairhmm_scaled_warp_kernel<SEMI, (\d+)>", text)} - {0}
    assert regs == {1, 2, 4, 8, 16}
    assert max(regs) == 1 << (pairhmm.SCALED_REG_BYTES // (3 * 4)).bit_length() - 1
    assert {C for n in range(0, 513) for C in [pairhmm.pairhmm_scaled_geometry(n, 1)[0]]} == regs
    assert "int semiglobal, int C, int warps, void* out, void* scratch" in text
