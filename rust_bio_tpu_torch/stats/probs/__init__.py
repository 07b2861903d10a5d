"""Log-space probability newtypes and numerically stable arithmetic.

Reference parity: src/stats/probs/mod.rs — ``Prob``/``LogProb``/``PHREDProb``
newtypes (:78,129,161), PHRED conversion factors (:29-32), ``ln_1m_exp``
log1mexp trick (:36-43), ``cap_numerical_overshoot`` (:196), max-shifted
``ln_sum_exp`` over ``FastExp`` (:218-251), ``ln_add_exp``/``ln_sub_exp``
(:254,274), ``ln_cumsum_exp`` (:298) and log-space trapezoidal/Simpson
integration (:305-368).

The newtypes are float subclasses (scalar oracle, bit-exact with the
reference's fastexp-based arithmetic); ``vec`` holds vectorized numpy
equivalents for array pipelines.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, List, Sequence

import numpy as np

from rust_bio_tpu_torch.utils.fastexp import fastexp

LOG_TO_PHRED_FACTOR = -4.342_944_819_032_517_5  # -10 / ln(10)
PHRED_TO_LOG_FACTOR = -0.230_258_509_299_404_56  # ln(10) / -10

_NEG_INF = float("-inf")


def _fastexp(x: float) -> float:
    return float(fastexp(np.float64(x)))


def ln_1m_exp(p: float) -> float:
    """log(1 - e^p) for p <= 0 (log1mexp; probs/mod.rs:36-43)."""
    assert p <= 0.0
    if p < -0.693:
        return math.log1p(-_fastexp(p))
    return math.log(-math.expm1(p))


class Prob(float):
    """Linear-scale probability newtype."""

    def __new__(cls, p: float = 0.0):
        return super().__new__(cls, p)

    @classmethod
    def checked(cls, p: float) -> "Prob":
        if not (0.0 <= p <= 1.0):
            raise ValueError(f"invalid probability {p}")
        return cls(p)

    @classmethod
    def from_logprob(cls, p: "LogProb") -> "Prob":
        return cls(_fastexp(float(p)))

    @classmethod
    def from_phred(cls, p: "PHREDProb") -> "Prob":
        return cls(10.0 ** (-float(p) / 10.0))


class LogProb(float):
    """Natural-log-scale probability newtype."""

    def __new__(cls, p: float = _NEG_INF):
        return super().__new__(cls, p)

    # ---- constructors ----
    @classmethod
    def ln_zero(cls) -> "LogProb":
        return cls(_NEG_INF)

    @classmethod
    def ln_one(cls) -> "LogProb":
        return cls(0.0)

    @classmethod
    def from_prob(cls, p: float) -> "LogProb":
        return cls(math.log(p) if p > 0 else _NEG_INF)

    @classmethod
    def from_phred(cls, p: "PHREDProb") -> "LogProb":
        return cls(float(p) * PHRED_TO_LOG_FACTOR)

    # ---- predicates ----
    def is_valid(self) -> bool:
        return not math.isnan(self) and self <= 0.0

    # ---- arithmetic (probs/mod.rs:196-298) ----
    def cap_numerical_overshoot(self, epsilon: float) -> "LogProb":
        if self <= 0.0:
            return self
        capped = float(self) - epsilon
        if capped <= 0.0:
            return LogProb.ln_one()
        raise ValueError(
            f"Cannot correct LogProb {float(self)} -- not within given "
            f"epsilon of 0.0 ({epsilon})"
        )

    def ln_one_minus_exp(self) -> "LogProb":
        return LogProb(ln_1m_exp(float(self)))

    @staticmethod
    def ln_sum_exp(probs: Sequence[float]) -> "LogProb":
        if len(probs) == 0:
            return LogProb.ln_zero()
        pmax = probs[0]
        imax = 0
        for i in range(1, len(probs)):
            if probs[i] > pmax:
                pmax = probs[i]
                imax = i
        if pmax == _NEG_INF:
            return LogProb.ln_zero()
        if pmax == float("inf"):
            return LogProb(float("inf"))
        s = 0.0
        for i, p in enumerate(probs):
            if i == imax or p == _NEG_INF:
                continue
            s += _fastexp(p - pmax)
        return LogProb(pmax + math.log1p(s))

    def ln_add_exp(self, other: float) -> "LogProb":
        if other == _NEG_INF:
            return LogProb(self)
        p0, p1 = float(self), float(other)
        if p1 > p0:
            p0, p1 = p1, p0
        if p0 == _NEG_INF:
            return LogProb.ln_zero()
        if p0 == float("inf"):
            return LogProb(float("inf"))
        return LogProb(p0 + math.log1p(_fastexp(p1 - p0)))

    def ln_sub_exp(self, other: float) -> "LogProb":
        if other == _NEG_INF:
            return LogProb(self)
        p0, p1 = float(self), float(other)
        assert p0 >= p1, (
            "Subtraction would lead to negative probability, which is "
            "undefined in log space."
        )
        if p1 == _NEG_INF:
            return LogProb(p0)
        if math.isclose(p0, p1, rel_tol=1e-9) or p0 == _NEG_INF:
            return LogProb.ln_zero()
        if p0 == float("inf"):
            return LogProb(float("inf"))
        return LogProb(p0 + ln_1m_exp(p1 - p0))

    @staticmethod
    def ln_cumsum_exp(probs: Iterable[float]) -> Iterator["LogProb"]:
        acc = LogProb.ln_zero()
        for p in probs:
            acc = acc.ln_add_exp(p)
            yield acc

    # ---- integration (probs/mod.rs:305-368) ----
    @staticmethod
    def ln_trapezoidal_integrate_exp(density, a: float, b: float, n: int) -> "LogProb":
        grid = np.linspace(a, b, n)
        probs: List[float] = [
            float(density(i, float(v))) + math.log(2.0)
            for i, v in enumerate(grid)
            if 0 < i < n - 1
        ]
        probs.append(float(density(0, a)))
        probs.append(float(density(n, b)))
        width = float(b - a)
        return LogProb(
            float(LogProb.ln_sum_exp(probs))
            + math.log(width)
            - math.log(2.0 * (n - 1))
        )

    @staticmethod
    def ln_simpsons_integrate_exp(density, a: float, b: float, n: int) -> "LogProb":
        assert n % 2 == 1, "n must be odd"
        grid = np.linspace(a, b, n)
        probs: List[float] = [
            float(density(i, float(v))) + math.log(2.0 + (i % 2) * 2.0)
            for i, v in enumerate(grid)
            if 0 < i < n - 1
        ]
        probs.append(float(density(0, a)))
        probs.append(float(density(n, b)))
        width = float(b - a)
        return LogProb(
            float(LogProb.ln_sum_exp(probs))
            + math.log(width)
            - math.log(n - 1)
            - math.log(3.0)
        )

    @staticmethod
    def ln_trapezoidal_integrate_grid_exp(density, grid: Sequence[float]) -> "LogProb":
        probs: List[float] = []
        for i in range(1, len(grid)):
            p = LogProb(float(density(i - 1, grid[i - 1]))).ln_add_exp(
                float(density(i, grid[i]))
            )
            probs.append(
                float(p) - math.log(2.0) + math.log(float(grid[i] - grid[i - 1]))
            )
        return LogProb.ln_sum_exp(probs)


class PHREDProb(float):
    """PHRED-scale probability newtype."""

    def __new__(cls, p: float = 0.0):
        return super().__new__(cls, p)

    @classmethod
    def from_prob(cls, p: float) -> "PHREDProb":
        return cls(-10.0 * math.log10(p) if p > 0 else float("inf"))

    @classmethod
    def from_logprob(cls, p: float) -> "PHREDProb":
        return cls(float(p) * LOG_TO_PHRED_FACTOR)


class vec:
    """Vectorized numpy equivalents for array pipelines."""

    NEG_INF = _NEG_INF

    @staticmethod
    def ln_sum_exp(arr: np.ndarray, axis: int = -1) -> np.ndarray:
        """Max-shifted log-sum-exp with the reference's fastexp (approx)."""
        arr = np.asarray(arr, dtype=np.float64)
        pmax = np.max(arr, axis=axis, keepdims=True)
        safe = np.where(np.isneginf(pmax), 0.0, pmax)
        # the max element is excluded from the fastexp sum (log1p form)
        shifted = arr - safe
        is_max = arr == pmax
        # exclude exactly one occurrence of the max
        first_max = np.cumsum(is_max, axis=axis) == 1
        exclude = is_max & first_max
        terms = np.where(
            exclude | np.isneginf(arr), 0.0, fastexp(shifted)
        )
        out = np.squeeze(safe, axis) + np.log1p(np.sum(terms, axis=axis))
        return np.where(
            np.squeeze(np.isneginf(pmax), axis), _NEG_INF, out
        )

    @staticmethod
    def ln_add_exp(a, b) -> np.ndarray:
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        hi = np.maximum(a, b)
        lo = np.minimum(a, b)
        out = hi + np.log1p(fastexp(lo - hi))
        return np.where(np.isneginf(hi), _NEG_INF, out)
