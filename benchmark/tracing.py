"""The traced window: torch.profiler over the CPU and the card, reduced to
device intervals, the benchmark's host spans and idle gaps.

Only ``--trace 1`` runs start it. Device time is every operation the
profiler saw on the card (kernels, copies, fills). The window is the host's
``bench::traced`` range, on the profiler's own clock; an idle gap is a stretch
of it in which no operation ran on the card, labelled with the innermost
benchmark span (``bench::<name>``) open on the host when the gap began.

The profiler records every host op and so slows a host-bound loop: what
follows ``stop()`` in the window runs untraced, and the host's metrics are
read there (``stopped_at``). The events are reduced only after the window
has closed (``reduce``), so their processing never lands in it.
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _annotation(ev) -> bool:
    try:
        return bool(ev.is_user_annotation()) or "annotation" in str(
            ev.activity_type())
    except AttributeError:
        return False


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespace and
    arguments: ``(anonymous namespace)::bwd_dz_tc<128>(TrainArgs)`` ->
    ``bwd_dz_tc<128>``."""
    name = re.sub(r"^void\s+", "", name.strip())
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip() or name


class Trace:
    """Start and stop the profiler around whole units of work."""

    def __init__(self, spans, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.spans = spans
        self.device = device
        self.active = False
        self._rf = None
        self.stopped_at: Optional[float] = None   # perf_counter seconds
        self.result: Optional[dict] = None

    def start(self) -> None:
        self.prof.start()
        self.spans.profiling = True
        self._rf = torch.profiler.record_function("bench::traced")
        self._rf.__enter__()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self._rf.__exit__(None, None, None)
        self.spans.profiling = False
        self.prof.stop()
        self.active = False
        self.stopped_at = time.perf_counter()

    def reduce(self) -> dict:
        """The reduced trace (``reduce``); call once the window has closed."""
        self.stop()
        if self.result is None:
            self.result = reduce(self.prof.profiler.kineto_results.events())
        return self.result


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events) -> dict:
    """Device ops, host spans and the window from the profiler's events.

    Returns ``window`` (start, end ns), ``window_s``, ``busy_s`` (the union
    of device intervals inside the window), ``ops`` [(short name, start,
    end)], ``spans`` [(name, start, end)] of the benchmark's ranges,
    ``device_ops`` and ``idle_gaps`` (each the top 10 [name, seconds])."""
    ops, spans, window = [], [], None
    for ev in events:
        name = ev.name()
        a = _ns(ev, "start")
        b = a + _ns(ev, "duration")
        if str(ev.device_type()).endswith("CUDA"):
            # the device-side copies of host ranges are not device work
            if not _annotation(ev) and not name.startswith("bench::"):
                ops.append((short_name(name), a, b))
        elif name == "bench::traced":
            window = (a, b)
        elif name.startswith("bench::"):
            spans.append((name[len("bench::"):], a, b))
    if window is None:
        window = (min([o[1] for o in ops] or [0]),
                  max([o[2] for o in ops] or [0]))
    lo, hi = window
    clipped = [(max(a, lo), min(b, hi)) for _, a, b in ops if b > lo and a < hi]
    busy = _union(clipped)
    busy_ns = sum(b - a for a, b in busy)
    by_name: Dict[str, int] = defaultdict(int)
    for n, a, b in ops:
        by_name[n] += b - a
    # idle stretches between busy intervals, labelled with the innermost
    # span open when each began
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    spans_sorted = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans_sorted]
    by_label: Dict[str, int] = defaultdict(int)
    for a, b in gaps:
        label = "outside spans"
        i = bisect.bisect_right(starts, a) - 1
        # spans nest a few deep: the enclosing one is among the last few
        for i in range(i, max(i - 8, -1), -1):
            if spans_sorted[i][2] > a:
                label = spans_sorted[i][0]
                break
        by_label[label] += b - a
    top = lambda d: [[k[:160], v / 1e9] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window": window, "window_s": (hi - lo) / 1e9,
            "busy_s": busy_ns / 1e9, "ops": ops, "spans": spans,
            "device_ops": top(by_name), "idle_gaps": top(by_label)}


def device_time(trace: dict, names, within: Optional[Tuple[int, int]] = None
                ) -> float:
    """Summed device seconds of ops whose short name starts with any of
    ``names`` (optionally only those starting inside ``within``)."""
    total = 0
    for n, a, b in trace["ops"]:
        if any(n.startswith(p) for p in names):
            if within is None or within[0] <= a < within[1]:
                total += b - a
    return total / 1e9
