"""Where the PyTorch port's training-loop step goes, on one GPU.

    python scripts/torch_loop_breakdown.py [--out breakdown.json] [--steps 30]

Runs the flagship ``Config(fused_train=True)`` step (bf16, B=8, crop 10240)
fed in several ways, from the same synthetic dump that ``chip_smoke.py``
phase 11 writes (under build/), each way twice, in turns (the list, then
the list reversed):

  device_batches             6 collated batches already on the card
  host_batches_prefetch      the same batches as numpy, through
                             ``prefetch_to_device(depth=2)``
  host_batches_direct        the same numpy batches straight into
                             ``train_step`` (a pageable copy in the step)
  loader{0,1,2}_prefetch     ``DataLoader`` with 0 (collate inline), 1 or 2
                             threads, through ``prefetch_to_device``
  loader{0,2}_direct         the loader straight into ``train_step``
  loader2_prefetch_switch50ms  as loader2_prefetch, with the interpreter's
                             thread switch interval at 50 ms (default 5 ms)
  phase7_method_device_batches  ``chip_smoke.py`` phase 7's timing of one
                             device batch: synchronise, events around a step

Each step's time is the interval between CUDA events recorded after
consecutive steps (host waits count), steps 5-N of each run; beside it the
host time of the ``train_step`` call. Also the host time of one collate
(0 threads, main thread alone). Prints ``[breakdown]`` lines with the card's
name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from wavenet_vocoder_tpu_torch.config import Config  # noqa: E402
from wavenet_vocoder_tpu_torch.data.prefetch import prefetch_to_device  # noqa: E402
from wavenet_vocoder_tpu_torch.training.loop import get_data_loaders  # noqa: E402
from wavenet_vocoder_tpu_torch.training.train_state import (  # noqa: E402
    create_train_state,
    make_train_step,
)


def _cycle(xs):
    while True:
        yield from xs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the times as JSON")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_loop_breakdown: no CUDA device", file=sys.stderr)
        return 3
    cs.phase_build({})
    cfg = Config(fused_train=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dump = os.path.join(root, "build", "loop_breakdown", "dump")
    for split, (n, seed) in cs.LOOP_UTTS.items():
        cs.make_synthetic_dump(os.path.join(dump, split), cfg, n, seed)
    state = create_train_state(cfg)
    step, _ = make_train_step(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    loaders = {w: get_data_loaders(dump, cfg.replace(num_workers=w))
               ["train_no_dev"] for w in (0, 1, 2)}
    host = list(loaders[0])
    t0, n = time.perf_counter(), 0
    for _ in range(3):
        for _b in loaders[0]:
            n += 1
    collate_ms = (time.perf_counter() - t0) / n * 1e3
    dev = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
           for b in host]
    feeds = {
        "device_batches": lambda: _cycle(dev),
        "host_batches_prefetch": lambda: prefetch_to_device(_cycle(host),
                                                            depth=2),
        "host_batches_direct": lambda: _cycle(host),
        "loader2_prefetch": lambda: prefetch_to_device(
            cs._forever(loaders[2]), depth=2),
        "loader2_direct": lambda: cs._forever(loaders[2]),
        "loader1_prefetch": lambda: prefetch_to_device(
            cs._forever(loaders[1]), depth=2),
        "loader0_prefetch": lambda: prefetch_to_device(
            cs._forever(loaders[0]), depth=2),
        "loader0_direct": lambda: cs._forever(loaders[0]),
        "loader2_prefetch_switch50ms": lambda: prefetch_to_device(
            cs._forever(loaders[2]), depth=2),
        "phase7_method_device_batches": None,
    }
    res = {k: {"ms": [], "host_ms": []} for k in feeds}
    for name in list(feeds) + list(feeds)[::-1]:
        if feeds[name] is None:
            ms = cs._step_times(lambda st, b: step(st, b, gen), state, dev[0],
                                args.steps)
            res[name]["ms"] += ms[3:]
            continue
        sys.setswitchinterval(0.05 if name.endswith("switch50ms") else 0.005)
        it = feeds[name]()
        events, host_ms = [], []
        try:
            for _ in range(args.steps):
                b = next(it)
                h0 = time.perf_counter()
                step(state, b, gen)
                host_ms.append((time.perf_counter() - h0) * 1e3)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            torch.cuda.synchronize()
        finally:
            sys.setswitchinterval(0.005)
            del it
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        res[name]["ms"] += ms[3:]
        res[name]["host_ms"] += host_ms[4:]
    gpu = cs.gpu_name_and_limit()
    print(f"[breakdown] {gpu}; B={cfg.batch_size} T={cfg.max_time_steps} "
          f"bf16; host collate (0 threads, main thread alone) "
          f"{collate_ms:.2f} ms a batch")
    for k, r in res.items():
        host = (f"{np.median(r['host_ms']):.1f} ms" if r["host_ms"]
                else "not measured")
        print(f"[breakdown] {k:29s} step median {np.median(r['ms']):6.1f} ms "
              f"(q25 {np.percentile(r['ms'], 25):6.1f}, q75 "
              f"{np.percentile(r['ms'], 75):6.1f}, max {max(r['ms']):6.1f});"
              f" train_step host call median {host}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(gpu=gpu, collate_ms=collate_ms, runs=res), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
