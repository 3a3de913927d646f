"""The arithmetic of the end-to-end metrics and of the spread."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q percent of all values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def rate(work: float, seconds: float) -> float:
    """All work completed in the window over all of the window's time."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return work / seconds


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (Python's ``statistics.quantiles``, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
