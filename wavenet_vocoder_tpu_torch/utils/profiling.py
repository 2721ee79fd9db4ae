"""Profiling and timing helpers.

The port's counterpart of ``wavenet_vocoder_tpu/utils/profiling.py``:
``trace(logdir)`` records a ``torch.profiler`` trace of the CPU and the card
into ``logdir`` (a Chrome trace: chrome://tracing or Perfetto); ``sync``
waits for a tensor's device; ``StepTimer`` gives wall-time statistics with
the same summary keys as the JAX package's. ``gpu_name_and_limit`` is the
card's name and power limit as ``nvidia-smi`` reports them, which every
measurement is stated beside.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU and CUDA activities) and write its Chrome
    trace to ``logdir/trace.json``; yields the profiler, whose
    ``key_averages()`` sums the time by kernel."""
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


class StepTimer:
    """Accumulates per-step wall times; ``summary()`` -> mean/p50/p90."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            sync(result)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "steps_per_s": float(1.0 / arr.mean()),
            "n": int(arr.size),
        }


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
