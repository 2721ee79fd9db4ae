"""Readings that set the limits of ``correct``: the program's numbers and the
control's on many seeds, in one process (the kernels are built once).

    python3 -m benchmark.control --workload synth.flagship.b256 \
        --seeds 11,12,13 --seconds 10 --controls fp8 --out build/controls.jsonl

For each seed the cell runs as ``benchmark.run`` does (set-up, a window of
``--seconds``, the check) and then checks again with each control in the
program's place: ``fp8``, the reference at float8 (the precision below the
configuration's bf16); for training also ``half_batch``, the reference with
half of each batch left out. Each control is judged against the cell's
limits as the program is (``correct``, which has to come out false). One
JSON line a seed. The benchmark's own runs never run a control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import harness
from benchmark.run import cache_dirs, quiet_host, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", default="fp8")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    cache_dirs(root)
    quiet_host()
    cell = harness.load_cell(args.workload, root)
    controls = tuple(c for c in args.controls.split(",") if c)
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                       t0, controls=controls)
        rec = {"workload": cell.name, "seed": seed, "correct": out["correct"],
               "check": out["check_all"], "controls": out.get("controls", {}),
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "seconds": time.time() - t0}
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
