"""Arithmetic over device intervals: the union of kernel and copy spans, the
idle share of a window, and the gaps between busy intervals.

Copied from the port's bench (`union_ns`, `idle_share`); the profiler's
raw events are read in slambench/spans.py.
"""

from __future__ import annotations

from typing import List, Tuple


def merged(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) spans as disjoint sorted intervals."""
    out: List[List[int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_ns(spans: List[Tuple[int, int]]) -> int:
    """Nanoseconds covered by the union of [start, end) spans."""
    return sum(b - a for a, b in merged(spans))


def idle_share(busy_ns: int, window_ns: int) -> float:
    """1 - busy / window: the share of the window in which the device ran
    nothing."""
    return 1.0 - busy_ns / window_ns


def gaps(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The idle intervals between the union's busy intervals."""
    m = merged(spans)
    return [(m[i][1], m[i + 1][0]) for i in range(len(m) - 1)
            if m[i + 1][0] > m[i][1]]
