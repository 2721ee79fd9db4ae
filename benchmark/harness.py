"""What every cell shares: finding a cell's files by name, the weights made
from the seed, host spans and the check for JAX.

A cell is an entry of ``workloads`` in BENCHMARK.json. Its files:

- ``benchmark/configs/<config>.json``: the configuration as it is run (the
  program's ``Config`` keys) with ``source``, ``reduced``, ``assumed`` and
  ``precision`` beside them;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters; its ``kind``
  names the generator in ``benchmark/kinds/<kind>.py`` that reads them;
- ``benchmark/limits/<workload>.json``: each compared number's limit;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wavenet_vocoder_tpu")
CONFIG_META = ("source", "reduced", "assumed", "precision", "deployment")


def process_start_time() -> float:
    """The wall-clock time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared as whole names."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload with its configuration, traffic and limits."""
    workload: dict
    config: dict            # the configuration file, meta keys included
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT

    @property
    def name(self) -> str:
        return self.workload["name"]

    def model_keys(self) -> dict:
        """The configuration without its meta keys."""
        return {k: v for k, v in self.config.items() if k not in CONFIG_META}

    def metrics_for(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: end-to-end ones without a trace,
        per-layer ones with it (those listing it, or listing no cells)."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str, root: Path = ROOT, bench: dict = None) -> Cell:
    """Cell ``name`` of ``bench`` (by default ``BENCHMARK.json``)."""
    bench = bench or load_json(root / "BENCHMARK.json")
    try:
        wl = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json") from None
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    here = root / "benchmark"
    return Cell(workload=wl, config=load_json(root / conf["file"]),
                traffic=load_json(here / "traffic" / f"{wl['traffic']}.json"),
                limits=load_json(here / "limits" / f"{name}.json"),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                root=root)


def load_kind(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


def load_reader(metric: str, root: Path = ROOT):
    """``benchmark/metrics/<metric>.py``'s ``read`` (names may hold dots)."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(keys: dict):
    """The program's Config from a configuration file's keys."""
    from wavenet_vocoder_tpu_torch.config import Config
    return Config().override_from_dict(keys)


# ----------------------------------------------------------------------
# weights from the seed
# ----------------------------------------------------------------------
def make_weights(keys: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Random f32 weights for every parameter, drawn in one call on
    ``device`` from ``seed``: kernels with He-normal spread (the published
    init), weight-norm gains at the kernel's norm times exp(0.1 n), biases
    0.05 n, the upsampler's smoothing kernels at 1/(2s+1) times (1 + 0.1 n),
    with n standard normal."""
    from benchmark.reference.wavenet import param_shapes
    shapes = param_shapes(keys)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat[off:off + n].view(shape)
        off += n
    for name, shape in shapes.items():
        if not name.endswith(".weight_v"):
            continue
        base = name[:-len(".weight_v")]
        v = out[name]
        if "up_layers" in name:
            v = (1.0 + 0.1 * v) / shape[-1]
        else:
            v = v * math.sqrt(2.0 / (shape[1] * shape[2]))
        norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())),
                                    keepdim=True))
        out[name] = v
        out[base + ".weight_g"] = norm * torch.exp(0.1 * out[base + ".weight_g"])
        if base + ".bias" in out:
            out[base + ".bias"] = 0.05 * out[base + ".bias"]
    return {k: v.contiguous() for k, v in out.items()}


def build_model(cfg, weights: Dict[str, torch.Tensor], device):
    """The program's WaveNet holding ``weights`` (copied), on ``device``;
    built on the meta device, so nothing is drawn on the host."""
    from wavenet_vocoder_tpu_torch.models.wavenet import (WaveNet,
                                                          spec_from_config)
    with torch.device("meta"):
        model = WaveNet(spec_from_config(cfg))
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.clone() for k, v in weights.items()},
                          strict=True)
    return model


def cpu_generator(seed: int, *tags: int) -> torch.Generator:
    """A CPU generator keyed on (seed, tags)."""
    import numpy as np
    s = int(np.random.SeedSequence([seed % 2 ** 63, *tags]
                                   ).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator().manual_seed(s)


def drawn_seed(generator: torch.Generator) -> int:
    """The sampling seed a served request draws from the generator it is
    handed: one integer in [0, 2^31 - 1) (``synthesis._seed_from``)."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device))


def device_generator(seed: int, device, *tags: int) -> torch.Generator:
    s = int(torch.randint(0, 2 ** 62, (1,),
                          generator=cpu_generator(seed, *tags)))
    return torch.Generator(device=device).manual_seed(s)


def permutation(seed: int, n: int, tag: int) -> List[int]:
    return torch.randperm(n, generator=cpu_generator(seed, tag)).tolist()


# ----------------------------------------------------------------------
# host spans
# ----------------------------------------------------------------------
class Spans:
    """Host spans (name, start, end in perf_counter seconds), kept in
    memory; under a trace each span is also a profiler range, so idle gaps
    on the device can be labelled with the span the host was in."""

    def __init__(self):
        self.items: List[tuple] = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.profiling:
            rf = torch.profiler.record_function("bench::" + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.items.append((name, t0, t1))


def quantile(values, q: float) -> float:
    """The q-quantile with linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> float:
    return quantile(values, 0.5)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
