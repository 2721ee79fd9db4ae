"""What the per-layer metric readers share. A reader takes the run's context
(``ctx``: the cell, the configuration's keys, the kind's run with its units
of work, host spans, the window, the reduced trace or None, the untraced
rest of the window or None, the card's peak table or None) and returns a
number, or None when it finds nothing to read; the metric is then left out
of the result line.

The profiler slows the host, so the host's metrics (rates, host spans) are
read over the untraced rest of the window (``ctx["untraced"]``: its start
on the perf_counter clock and its seconds), and the device's (rooflines,
idle) over the traced part."""
from __future__ import annotations

from typing import Optional

from benchmark import harness, tracing, yardstick

GENERATE = ("generate_kernel",)
TRAIN_FWD = ("fwd_tc", "fwd_layer")
TRAIN_BWD = ("bwd_dz", "bwd_wgrad", "bwd_finish", "bwd_dx")


def idle_pct(ctx) -> Optional[float]:
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu_pct(ctx, flops_per_sample: int) -> Optional[float]:
    """Analytic FLOPs of the samples served in the untraced rest of the
    window over its seconds and the bf16 peak."""
    peaks, rest = ctx["peaks"], ctx["untraced"]
    if peaks is None or rest is None:
        return None
    samples = sum(r * t for r, t in ctx["run"].units("untraced"))
    if not samples:
        return None
    return 100.0 * flops_per_sample * samples / rest["seconds"] / peaks["bf16"]


def untraced(ctx, t: float) -> bool:
    """Whether a host time (perf_counter seconds) lies in the untraced
    rest of the window."""
    rest = ctx["untraced"]
    return rest is not None and t >= rest["from"]


def generate_roofline_pct(ctx) -> Optional[float]:
    """The traced batches' launches at their bound (256-step launches of
    the real rows and steps) over generate_kernel's device time."""
    tr, peaks, keys = ctx["trace"], ctx["peaks"], ctx["keys"]
    if tr is None or peaks is None:
        return None
    took = tracing.device_time(tr, GENERATE)
    if took <= 0:
        return None
    chunk, bound = 256, 0.0
    for rows, T in ctx["run"].units("traced"):
        for t0 in range(0, T, chunk):
            work = yardstick.generate_launch(keys, rows, min(chunk, T - t0))
            bound += yardstick.bound_seconds(work, peaks)
    return 100.0 * bound / took


def train_kernel_roofline_pct(ctx, names, work_fn) -> Optional[float]:
    tr, peaks, keys = ctx["trace"], ctx["peaks"], ctx["keys"]
    if tr is None or peaks is None:
        return None
    took = tracing.device_time(tr, names)
    if took <= 0:
        return None
    bound = sum(yardstick.bound_seconds(work_fn(keys, rows, crop), peaks)
                for rows, crop in ctx["run"].units("traced"))
    return 100.0 * bound / took


def mean_span_ms(ctx, name: str) -> Optional[float]:
    """Mean ms of the host span ``name`` over the untraced rest."""
    d = [t1 - t0 for n, t0, t1 in ctx["spans"].items
         if n == name and untraced(ctx, t0)]
    return 1e3 * sum(d) / len(d) if d else None


def median(values) -> Optional[float]:
    return harness.median(values) if values else None
