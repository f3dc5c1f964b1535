"""Arithmetic shared by the generators and the metric readers: whole-batch
rate windows, the tail of every gap and merged device intervals."""
import math
from typing import Iterable, List, Optional, Sequence, Tuple


class RateWindow:
    """A window of whole units of work on the host's clock.

    ``begin()`` opens it at the first request; ``done(count, at)`` records
    a unit (a batch or a step) of ``count`` items that completed on the
    device at ``at``.  ``full()`` is true once the window holds at least
    ``seconds`` of whole units, so the caller stops taking more; the rate
    is the items of every unit over the time from the first request to
    the last completion."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.start: Optional[float] = None
        self.completions: List[float] = []
        self.items = 0

    def begin(self, at: float):
        self.start = at

    def done(self, count: int, at: float):
        self.items += int(count)
        self.completions.append(at)

    @property
    def elapsed(self) -> float:
        if self.start is None or not self.completions:
            return 0.0
        return self.completions[-1] - self.start

    def full(self) -> bool:
        return self.elapsed >= self.seconds

    def rate(self) -> float:
        if self.elapsed <= 0:
            raise ValueError('the window holds no completed unit')
        return self.items / self.elapsed

    def gaps(self) -> List[float]:
        """Every interval between consecutive completions; the first runs
        from the window's start."""
        edges = [self.start] + self.completions
        return [b - a for a, b in zip(edges, edges[1:])]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, interpolated
    linearly between the two nearest ranks (numpy's default rule)."""
    if not values:
        raise ValueError('no values')
    ordered = sorted(values)
    rank = (len(ordered) - 1) * q / 100.0
    lo = math.floor(rank)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (rank - lo)


def merge_intervals(
        intervals: Iterable[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """The union of ``(begin, end)`` intervals as disjoint sorted ones."""
    merged: List[List[float]] = []
    for begin, end in sorted(intervals):
        if merged and begin <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([begin, end])
    return [(b, e) for b, e in merged]


def busy_and_gaps(intervals) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length of the union of ``intervals``, the idle gaps between
    its pieces as (begin, end))."""
    merged = merge_intervals(intervals)
    busy = sum(e - b for b, e in merged)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    return busy, gaps
