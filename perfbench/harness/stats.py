"""The metric arithmetic. A rate is all the work of a window over all of its
time; a percentile is over every sample, never a median of chunks; a spread
is the distance between the first and third quartiles, as
`statistics.quantiles(values, n=4)` gives them, as a share of the median."""
from __future__ import annotations

import math
import statistics


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile of all the values, linear between the two closest
    ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """(third quartile - first quartile) / median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_seconds(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, t in sorted(intervals):
        if t <= end:
            continue
        total += t - max(s, end)
        end = t
    return total
