"""Interval arithmetic over a traced run's trace for the readers of the
program's own spans (``mass.*`` annotations, ``mass.<layer>.<part>``):
the traced ticks' window, the card's idle stretches in it (the window
less the union of kernel, copy and memset intervals, as ``idle_share``
counts it), the union of spans chosen by name, and the measure of their
overlaps.  Times are microseconds on the trace's clock; a reader's value
is per traced tick, and None where the trace holds no span it reads (a
program that opens none)."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from portbench.reference import trace

PREFIX = "mass."
WINDOW = "portbench.ticks"

Intervals = List[Tuple[float, float]]


def window(data) -> Tuple[float, float]:
    """The traced ticks' annotation (the last, as the run reads it)."""
    return trace.spans(data, WINDOW)[-1]


def union(intervals, lo: float, hi: float) -> Intervals:
    """The merged union of ``intervals`` inside ``[lo, hi]``."""
    return [(a, b) for a, b in trace.merged(
        (max(a, lo), min(b, hi)) for a, b in intervals
        if a < hi and b > lo)]


def measure(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in intervals)


def intersect(x: Intervals, y: Intervals) -> Intervals:
    """The overlap of two merged, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def complement(intervals: Intervals, lo: float, hi: float) -> Intervals:
    """``[lo, hi]`` less a merged, sorted interval list inside it."""
    edges = [lo] + [t for a, b in intervals for t in (a, b)] + [hi]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]


def idle(data, lo: float, hi: float) -> Intervals:
    """The stretches of ``[lo, hi]`` with no device work."""
    busy = union(((e["ts"], e["ts"] + e["dur"])
                  for e in trace.complete(data, trace.DEVICE)), lo, hi)
    return complement(busy, lo, hi)


def spans(data, keep: Callable[[str], bool], lo: float,
          hi: float) -> Tuple[int, Intervals]:
    """How many of the program's spans whose name ``keep`` passes start
    inside ``[lo, hi]``, and their union there."""
    chosen = [(e["ts"], e["ts"] + e["dur"])
              for e in trace.complete(data, ("user_annotation",))
              if e["name"].startswith(PREFIX) and keep(e["name"])]
    count = sum(lo <= a < hi for a, _ in chosen)
    return count, union(chosen, lo, hi)


def per_tick_ms(run, us: float) -> float:
    return us * 1e-3 / run.traced_ticks


def idle_inside(run, keep: Callable[[str], bool]) -> Optional[float]:
    """ms a tick the card idles inside the union of the spans ``keep``
    passes."""
    if run.trace is None:
        return None
    lo, hi = window(run.trace)
    count, covered = spans(run.trace, keep, lo, hi)
    if not count:
        return None
    return per_tick_ms(run, measure(intersect(idle(run.trace, lo, hi),
                                              covered)))
