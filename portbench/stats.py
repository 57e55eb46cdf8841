"""Percentiles and interval arithmetic over all samples of a run."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) of every sample, linearly interpolated
    between the two nearest ranks (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[Interval] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(end - start for start, end in union(intervals))


def intersect(a: Iterable[Interval], b: Iterable[Interval]) -> List[Interval]:
    """The parts of union(a) that lie inside union(b)."""
    a, b = union(a), union(b)
    out, j = [], 0
    for start, end in a:
        while j < len(b) and b[j][1] <= start:
            j += 1
        k = j
        while k < len(b) and b[k][0] < end:
            lo, hi = max(start, b[k][0]), min(end, b[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out


def idle_share(busy: Iterable[Interval], window: Iterable[Interval]) -> float:
    """Share of ``window`` (a union of intervals) in which no ``busy``
    interval runs."""
    total = length(window)
    if total <= 0:
        raise ValueError("idle share of an empty window")
    return 1.0 - length(intersect(busy, window)) / total


def gaps(busy: Iterable[Interval], window: Interval) -> List[Interval]:
    """The stretches of ``window`` in which nothing of ``busy`` runs."""
    out, cursor = [], window[0]
    for start, end in union(busy):
        if end <= window[0] or start >= window[1]:
            continue
        if start > cursor:
            out.append((cursor, start))
        cursor = max(cursor, end)
    if cursor < window[1]:
        out.append((cursor, window[1]))
    return out
