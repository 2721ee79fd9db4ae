"""The port's tracing store (spans and counters), and profiling helpers.

``span(name)`` times a phase of the port's work. Every span adds its
elapsed time to a per-name aggregate of count and total nanoseconds
(``totals``), always. While recording is on it also keeps the span's
``(name, start_ns, end_ns)`` in a bounded buffer (``intervals``) and opens
the profiler range ``wavenet::<name>``, so a Chrome trace shows the port's
phases. Recording is on while a torch profiler records, or after
``recording(True)``. Interval times are ``time.time_ns()``, the clock the
profiler stamps its events with, so the port's intervals line up with the
trace's device ops. ``count(name, n)`` adds to a named counter
(``counters``); the kernel wrappers count their launches there
(``generate.launches``, ``generate.chunked_launches`` for those that
stream their weights through the chunk ring,
``generate.split_head_launches`` for those that split a categorical head
over the cluster, ``generate.wide_cluster_launches`` for those whose
clusters own more than 16 streams, ``generate.gaussian_launches`` for
those whose head is a single Gaussian, ``train_fwd.launches``,
``train_fwd.tc_launches``,
``train_fwd.fma_launches``, the same three of ``train_bwd``,
``mel.launches``), and batched synthesis its segments (``synth.segments``,
and ``synth.overlapped_segments`` for those decoded while a later segment
was queued on the card). ``reset()`` empties the store. The store is shared by
all threads of a process.

``trace(logdir)`` records a ``torch.profiler`` trace of the CPU and the card
into ``logdir`` (a Chrome trace: chrome://tracing or Perfetto); ``sync``
waits for a tensor's device. ``gpu_name_and_limit`` is the card's name and
power limit as ``nvidia-smi`` reports them, which every measurement is
stated beside.
"""
from __future__ import annotations

import collections
import contextlib
import os
import subprocess
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch

# intervals kept while recording; the oldest go first
INTERVALS = 1 << 16

_lock = threading.Lock()
_totals: Dict[str, List[int]] = {}          # name -> [count, total ns]
_counters: Dict[str, int] = {}
_intervals: Deque[Tuple[str, int, int]] = collections.deque(maxlen=INTERVALS)
_forced = False
_profiler_enabled = torch._C._autograd._profiler_enabled


def recording(on: Optional[bool] = None) -> bool:
    """Turn the recording of intervals on or off (``None`` leaves it);
    whether spans record now, which they also do while a torch profiler
    records."""
    global _forced
    if on is not None:
        _forced = bool(on)
    return _forced or _profiler_enabled()


class span:
    """``with span("synth.decode"): ...`` times the block (see the module
    docstring); spans nest."""
    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._range = None
        if _forced or _profiler_enabled():
            self._range = torch.profiler.record_function(
                "wavenet::" + self.name)
        self._t0 = time.time_ns()
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
        t1 = time.time_ns()
        with _lock:
            agg = _totals.get(self.name)
            if agg is None:
                _totals[self.name] = [1, t1 - self._t0]
            else:
                agg[0] += 1
                agg[1] += t1 - self._t0
            if self._range is not None:
                _intervals.append((self.name, self._t0, t1))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's value, by name."""
    with _lock:
        return dict(_counters)


def totals() -> Dict[str, Tuple[int, float]]:
    """Every span's (count, total seconds), by name."""
    with _lock:
        return {k: (c, ns / 1e9) for k, (c, ns) in _totals.items()}


def intervals() -> List[Tuple[str, int, int]]:
    """The recorded spans, (name, start ns, end ns) on ``time.time_ns()``'s
    clock, oldest first; at most ``INTERVALS``."""
    with _lock:
        return list(_intervals)


def reset() -> None:
    """Empty the aggregates, the counters and the intervals."""
    with _lock:
        _totals.clear()
        _counters.clear()
        _intervals.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU and CUDA activities) and write its Chrome
    trace to ``logdir/trace.json``; yields the profiler, whose
    ``key_averages()`` sums the time by kernel. The port's spans show as
    ``wavenet::<name>`` ranges."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def sync(x=None) -> None:
    """Wait for the work queued on the card: on the device of ``x`` when it
    is a CUDA tensor, else on the current CUDA device if there is one;
    nothing on a host without a card."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()


def gpu_name_and_limit() -> str:
    """The first card's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi: no output"


def power_limit() -> Optional[str]:
    """The power limit field of :func:`gpu_name_and_limit`, e.g.
    "700.00 W"; None where nvidia-smi gives none."""
    parts = gpu_name_and_limit().rsplit(",", 1)
    return parts[1].strip() if len(parts) == 2 else None
