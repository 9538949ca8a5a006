"""The program's own spans in a traced window, for the per-layer metrics
that read them.

``nhans_tpu_torch.utils.spans`` records spans and counts at the layer
boundaries of the serving engine and the train step while the profiler
runs, which it does over every traced window, on the trace's clock
(``time.time_ns()``).  A program without that recorder, or one that
recorded none of the names asked for, gives None, and so does each metric
that reads it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def recorded(trace, *names: str) -> Optional[list]:
    """The program's spans of ``names`` that lie within the traced window,
    by start, or None where it recorded none."""
    try:
        from nhans_tpu_torch.utils import spans
    except ImportError:
        return None
    found = [s for s in spans.between(trace.start_ns, trace.end_ns)
             if s.name in names]
    return found or None


def overlap_ns(a: Sequence[Tuple[int, int]],
               b: Sequence[Tuple[int, int]]) -> int:
    """Nanoseconds that two lists of intervals share, each list sorted by
    start and its intervals disjoint."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_pct(trace, found: List) -> float:
    """The part of the trace's idle gaps that falls inside the spans
    ``found`` (of one name, so disjoint), as a share of the traced
    window."""
    inside = overlap_ns(trace.gaps(), [(s.start_ns, s.end_ns) for s in found])
    return 100.0 * inside / (trace.end_ns - trace.start_ns)
