"""Stats counters used by the example agents.

Counterpart of the reference's ``examples/common/__init__.py:9-152``:
``StatMean``/``StatSum`` accumulators whose *deltas* can be allreduced
cohort-wide (see ``GlobalStatsAccumulator`` in ``examples/common``),
and ``RunningMeanStd`` for reward normalization.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class StatSum:
    """A monotonically accumulating sum whose delta-since-last-reduce syncs."""

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def result(self) -> float:
        return self.value

    def __iadd__(self, other):
        self.value += float(other)
        return self

    def __isub__(self, other):
        self.value -= float(other)
        return self

    def __repr__(self):
        return f"StatSum({self.value})"

    # delta protocol used by GlobalStatsAccumulator -----------------------
    def delta(self, prev: "StatSum") -> float:
        return self.value - prev.value

    def apply_delta(self, d: float) -> None:
        self.value += d

    def snapshot(self) -> "StatSum":
        return StatSum(self.value)


class StatMean:
    """Windowed mean: (sum, count) pairs; optional exponential cutoff."""

    def __init__(self, sum_: float = 0.0, count: float = 0.0, cumulative: bool = False):
        self.sum = float(sum_)
        self.count = float(count)
        self.cumulative = cumulative

    def result(self) -> Optional[float]:
        if self.count == 0:
            return None
        return self.sum / self.count

    def reset(self) -> None:
        if not self.cumulative:
            self.sum = 0.0
            self.count = 0.0

    def __iadd__(self, other):
        if isinstance(other, StatMean):
            self.sum += other.sum
            self.count += other.count
        else:
            self.sum += float(other)
            self.count += 1
        return self

    def __repr__(self):
        return f"StatMean(sum={self.sum}, count={self.count})"

    # delta protocol -------------------------------------------------------
    def delta(self, prev: "StatMean"):
        return (self.sum - prev.sum, self.count - prev.count)

    def apply_delta(self, d) -> None:
        self.sum += d[0]
        self.count += d[1]

    def snapshot(self) -> "StatMean":
        return StatMean(self.sum, self.count, self.cumulative)


class RunningMeanStd:
    """Welford-style running mean/std over arrays (reference :138-152)."""

    def __init__(self, epsilon: float = 1e-4, shape=()):
        self.mean = np.zeros(shape, dtype=np.float64)
        self.var = np.ones(shape, dtype=np.float64)
        self.count = epsilon

    def update(self, x) -> None:
        x = np.asarray(x, dtype=np.float64)
        batch_mean = x.mean(axis=0)
        batch_var = x.var(axis=0)
        batch_count = x.shape[0]
        self._update_from_moments(batch_mean, batch_var, batch_count)

    def _update_from_moments(self, batch_mean, batch_var, batch_count) -> None:
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + np.square(delta) * self.count * batch_count / tot
        self.mean = new_mean
        self.var = m2 / tot
        self.count = tot

    @property
    def std(self):
        return np.sqrt(self.var)


def ema(old: Optional[float], new: float, alpha: float = 0.1) -> float:
    """Exponential moving average helper."""
    if old is None or math.isnan(old):
        return new
    return (1 - alpha) * old + alpha * new
