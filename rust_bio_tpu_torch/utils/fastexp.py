"""Bit-exact copy of the reference's fast exp approximation.

Reference parity: src/utils/fastexp.rs (Kopczynski 2017 polynomial +
exponent-bit construction). The reference's ``LogProb`` arithmetic
(``ln_sum_exp`` etc.) uses this approximation, so log-likelihood parity
requires reproducing it exactly: the truncation toward zero of
``x as i64`` and the coefficient values.

Two variants, both vectorized and bit-identical for f64: a numpy one (the
host oracles) and a torch one (the plain version of the exact PairHMM
forward). Both clamp the argument to ``_MIN_VAL`` before the integer
cast, so ``-inf`` never reaches it, and return 0 for arguments at or below
``_MIN_VAL`` (``csrc/pairhmm_exact.cu`` does the same).
"""

from __future__ import annotations

import numpy as np
import torch

_COEFF_0 = 1.0
_COEFF_1 = 4.831_794_110
_COEFF_2 = 0.143_440_676
_COEFF_3 = 0.019_890_581
_COEFF_4 = 0.006_935_931
_ONEBYLOG2 = 1.442_695_041
_OFFSET_F64 = 1023
_FRACTION_F64 = 52
_MIN_VAL = -500.0


def fastexp(v):
    """Vectorized numpy fastexp, bit-identical to the reference for f64."""
    v = np.asarray(v, dtype=np.float64)
    x = _ONEBYLOG2 * np.where(v > _MIN_VAL, v, _MIN_VAL)  # -inf masked below
    # Rust `x as i64` truncates toward zero.
    bits = np.trunc(x).astype(np.int64)
    x = x - bits.astype(np.float64)
    f2 = x.copy()
    x_tmp = x.copy()

    bits = (bits + _OFFSET_F64) << _FRACTION_F64

    f2 = f2 * _COEFF_4
    x_tmp = x_tmp + _COEFF_1
    f2 = f2 + _COEFF_3
    x_tmp = x_tmp * x
    f2 = f2 * x
    f2 = f2 + _COEFF_2
    f2 = f2 * x_tmp
    f2 = f2 + _COEFF_0

    pow2 = bits.view(np.uint64).view(np.float64)
    out = pow2 * f2
    return np.where(v > _MIN_VAL, out, 0.0)


def fastexp_torch(v: torch.Tensor) -> torch.Tensor:
    """The same function on a float64 tensor (any device), bit-identical
    to :func:`fastexp`."""
    v = v.to(torch.float64)
    keep = v > _MIN_VAL
    x = _ONEBYLOG2 * torch.where(keep, v, torch.full_like(v, _MIN_VAL))
    bits = torch.trunc(x).to(torch.int64)
    x = x - bits.to(torch.float64)
    f2 = x
    x_tmp = x

    bits = (bits + _OFFSET_F64) << _FRACTION_F64

    f2 = f2 * _COEFF_4
    x_tmp = x_tmp + _COEFF_1
    f2 = f2 + _COEFF_3
    x_tmp = x_tmp * x
    f2 = f2 * x
    f2 = f2 + _COEFF_2
    f2 = f2 * x_tmp
    f2 = f2 + _COEFF_0

    out = bits.view(torch.float64) * f2
    return torch.where(keep, out, torch.zeros_like(out))
