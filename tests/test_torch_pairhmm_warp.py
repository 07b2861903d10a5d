"""K17-log's launch geometry (``ops/pairhmm.py`` ``pairhmm_log_geometry``,
which ``ops/csrc/pairhmm_log.cu`` takes from the wrapper): one warp a pair,
lane t over the columns [t * C + 1, t * C + C] of y; the state in
registers or in the device scratch; warps a block. Pure Python: the kernel itself runs in ``test_torch_cuda.py``, its
plain version against the JAX package in ``test_torch_pairhmm.py``.
"""

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
