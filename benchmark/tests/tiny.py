"""Tiny stand-ins of the cells for CPU tests: the same files, the program's
plain versions on the CPU, a few-channel model and short utterances."""
from __future__ import annotations

import dataclasses
import time

import torch

from benchmark import harness, yardstick
from benchmark.run import run_cell

KEYS = {"layers": 4, "stacks": 2, "residual_channels": 8, "gate_channels": 16,
        "skip_out_channels": 8, "cin_channels": 8, "num_mels": 8,
        "max_time_steps": 1024, "batch_size": 2, "num_workers": 1,
        # f32 training: the limits are set for 24 layers' bf16 sums, which a
        # kind of 4 leaves at bf16 can cross by chance
        "compute_dtype": ""}
# the profiler stays on for a part of the window, so a traced run has an
# untraced rest to read the host's metrics over
TRAFFIC = {"synth_batch": {"lengths_s": [0.01, 0.02], "trace_seconds": 0.1},
           "stream_segments": {"lengths_s": [0.03, 0.05],
                               "trace_seconds": 0.1},
           "train_dump": {"utterances": 8, "lengths_s": [0.12, 0.2],
                          "trace_seconds": 0.1}}
SECONDS = {"synth_batch": 3.0, "stream_segments": 6.0, "train_dump": 2.0}
# a kind not named in these tables keeps its own traffic and runs this long
DEFAULT_SECONDS = 3.0


def spec(root=harness.ROOT) -> dict:
    """BENCHMARK.json with the cells of ``dormant.json`` beside its own:
    cells whose files the benchmark holds but does not run (PERF.md §7),
    entered as BENCHMARK.json would enter them."""
    bench = harness.load_json(root / "BENCHMARK.json")
    dormant = harness.load_json(root / "benchmark" / "tests" / "dormant.json")
    return {k: v + dormant.get(k, []) if isinstance(v, list) else v
            for k, v in bench.items()}


CELLS = [w["name"] for w in spec()["workloads"]]


def load_cell(name: str, root=harness.ROOT):
    return harness.load_cell(name, root, spec(root))


def cell(name: str, root=harness.ROOT):
    """(cell with tiny traffic, tiny configuration keys)."""
    c = load_cell(name, root)
    kind = c.traffic["kind"]
    traffic = dict(c.traffic, **TRAFFIC.get(kind, {}))
    if "batch" in traffic:
        traffic["batch"] = min(traffic["batch"], 3)
    return dataclasses.replace(c, traffic=traffic), dict(c.model_keys(), **KEYS)


def run(name: str, seed: int = 2 ** 31 + 5, trace: bool = False,
        root=harness.ROOT, **kw) -> dict:
    c, keys = cell(name, root)
    # the profiler slows a CPU run several times over: a traced run gets
    # twice the window, so that an untraced rest follows the trace
    seconds = SECONDS.get(c.traffic["kind"], DEFAULT_SECONDS) * (
        2 if trace else 1)
    return run_cell(c, seed, seconds, trace,
                    torch.device("cpu"), time.time(), keys=keys,
                    peaks=yardstick.H100_SXM, **kw)
