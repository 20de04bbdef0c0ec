"""The arithmetic of the end-to-end numbers: a percentile of every sample
of the window, a rate over the window's whole wall time, and the
quartile spread that sets a bound."""
from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (1 <= q <= 99) by `statistics.quantiles`
    (method 'inclusive': linear between the order statistics)."""
    if len(values) < 2:
        raise ValueError("a percentile needs two samples or more")
    return statistics.quantiles(values, n=100, method='inclusive')[q - 1]


def rate(count: int, seconds: float) -> float:
    """Work done over the wall time it took."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, the quartiles of
    `statistics.quantiles(values, n=4)` (its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
