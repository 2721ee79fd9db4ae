"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload synth.flagship.b256 --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout. The cell's configuration, traffic, limits and
metric readers are found by name (``benchmark/harness.py``). The run builds
the program (``wavenet_vocoder_tpu_torch``) with weights and inputs made from
``--seed``, warms every shape, measures for ``--seconds``, then frees the
program's state and holds what the window produced against the plain
reference (``benchmark/reference``). With ``--trace 1`` the profiler records
part of the window and the per-layer metrics are read from it; with
``--trace 0`` the end-to-end metrics are reported.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each compared number with its limit);
the compared numbers are also the last lines of standard error. Without a
card, or with fewer cards than the cell asks for, or with a JAX module
loaded once the window has closed, the run prints no result and exits
non-zero.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

START = harness.process_start_time()

import torch  # noqa: E402

from benchmark import tracing, yardstick  # noqa: E402


def quiet_host() -> None:
    """One intra-op thread for the host's torch work: the host drives the
    card from one thread, and load from one process with few threads keeps
    the runs comparable. It does not cure the spread of host-bound runs,
    which follows the host CPU's own speed; with torch's default pool of
    eight threads the recipe loader's wait per step at B=8 rose from 3-4
    to 5-8.5 ms (H100 machine, 8 cores)."""
    torch.set_num_threads(1)


def cache_dirs(root: Path) -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the
    port's own nvcc builds go to ``build/kernels/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "bench_cache" / sub)


def device_info(device, count: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def judge(numbers: dict, limits: dict):
    """Each compared number beside its limit, and whether all hold."""
    checks = {k: {"value": float(numbers[k]), "limit": float(v)}
              for k, v in limits.items()}
    return checks, all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values())


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             start: float, keys=None, peaks=None, controls=()) -> dict:
    """Set up, measure, check; the result as a dict (not printed).

    ``keys`` replaces the configuration's keys and ``peaks`` the card's peak
    table (tests at small sizes). Each of ``controls`` (``benchmark/
    control.py``) runs the check once more with a stand-in in the
    program's place, judged as the program is; its numbers and verdict go
    under ``controls``."""
    import time
    kind = harness.load_kind(cell.traffic["kind"])
    spans = harness.Spans()
    run = kind.Run(cell, seed, device, spans, keys=keys)
    run.setup()
    harness.sync(device)
    setup_s = time.time() - start
    tr = tracing.Trace(spans, device) if trace else None
    win = run.window(seconds, tr)
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"JAX modules loaded in the run: {found}")
    dev = device_info(device, cell.workload["chips"])
    dev_name = dev["kind"]
    metrics = {}
    untraced = None
    if tr is not None and tr.stopped_at is not None \
            and tr.stopped_at < win["end"]:
        untraced = {"from": tr.stopped_at, "seconds": win["end"] - tr.stopped_at}
    ctx = {"cell": cell, "keys": run.keys, "run": run, "spans": spans,
           "window_s": win["window_s"], "device": dev_name,
           "trace": None if tr is None else tr.reduce(),
           "untraced": untraced,
           "peaks": peaks if peaks is not None else yardstick.peaks(dev_name)}
    for m in cell.metrics_for(trace):
        if trace:
            value = harness.load_reader(m["name"], cell.root)(ctx)
            if value is None:
                continue
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            value = win["e2e"][m["name"]]
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": False, "attempted": win["attempted"], "failed": 0,
           "metrics": metrics, "device": dev}
    if tr is not None:
        out["device"]["busy_s"] = tr.result["busy_s"]
        out["device"]["window_s"] = tr.result["window_s"]
        out["breakdown"] = {"device_ops": tr.result["device_ops"],
                            "idle_gaps": tr.result["idle_gaps"]}
    run.release()
    del tr, ctx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    numbers = run.check()
    if controls:
        out["controls"] = {}
        for c in controls:
            ctl = run.control(c)
            out["controls"][c] = {"correct": judge(ctl, cell.limits)[1],
                                  "numbers": ctl}
    out["checks"], out["correct"] = judge(numbers, cell.limits)
    out["check_all"] = numbers
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = Path.cwd()
    cell = harness.load_cell(args.workload, root)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cache_dirs(root)
    quiet_host()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), START)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX modules loaded in the run: {found}", file=sys.stderr)
        return 2
    extra = out.pop("check_all")
    print(f"# other numbers of the check: {json.dumps(extra)}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
