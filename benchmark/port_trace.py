"""What the readers of the program's own spans share.

The program (``wavenet_vocoder_tpu_torch.utils.profiling``) times its phases
in spans: always as per-name aggregates of count and seconds over the
process (``totals()``), and while a profiler records also as intervals
(``intervals()``: name, start and end ns on ``time.time_ns()``'s clock, the
clock the profiler stamps its events with). A program without that store
gives nothing to read: the readers return None and the metric is left out of
the result line.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark import readers, tracing


def _store():
    """The program's tracing store, or None where it has none."""
    try:
        from wavenet_vocoder_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "intervals") and hasattr(profiling, "totals")):
        return None
    return profiling


def _overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Nanoseconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_span_pct(ctx, name: str) -> Optional[float]:
    """The share of the traced window (%) in which no device op ran and the
    host was inside the program's span ``name``: the part of ``idle_pct``
    (the same window and union of ops) spent in that span."""
    tr, store = ctx["trace"], _store()
    idle = readers.idle_pct(ctx)
    if store is None or idle is None:
        return None
    lo, hi = tr["window"]
    busy = tracing._union([(max(a, lo), min(b, hi)) for _, a, b in tr["ops"]
                           if b > lo and a < hi])
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    spans = tracing._union([(max(a, lo), min(b, hi))
                            for n, a, b in store.intervals()
                            if n == name and b > lo and a < hi])
    gap_ns = sum(b - a for a, b in gaps)
    if gap_ns <= 0:
        return 0.0
    # a part of idle_pct by construction: idle_pct times the span's share
    # of the gaps (a ratio of at most 1, so never above idle_pct)
    return idle * (_overlap_ns(gaps, spans) / gap_ns)


def span_seconds(name: str) -> Optional[float]:
    """The program's total seconds in span ``name`` over the process (0.0
    where the span never ran); None without the store."""
    store = _store()
    if store is None:
        return None
    return float(store.totals().get(name, (0, 0.0))[1])
