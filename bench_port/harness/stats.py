"""Arithmetic of the end-to-end metrics and of the bounds' spreads."""

from __future__ import annotations

import math
import statistics


def rate(steps: int, seconds: float) -> float:
    """Work per second over a whole window."""
    if seconds <= 0:
        raise ValueError(f"rate: window of {seconds} s")
    return steps / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of all values, by linear
    interpolation between the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Distance between the first and the third quartile as a share of the
    median, with the quartiles of ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
