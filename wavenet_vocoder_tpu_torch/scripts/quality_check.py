"""One-command audio-quality regression net of the port for ALL THREE heads.

The port's counterpart of the repository's ``scripts/quality_check.py``:
runs ``synthetic_e2e`` (train a mid-size WaveNet on synthetic harmonic tones
with fixed seeds on the training kernels, then free-run the generation
kernel from a held-out mel) for the categorical mu-law-256, discretized-MoL
and single-Gaussian heads, in one process, and requires every head to pass
its loss-drop, F0-tracking and log-mel checks.

    python -m wavenet_vocoder_tpu_torch.scripts.quality_check [--heads mol]
    python -m wavenet_vocoder_tpu_torch.scripts.quality_check \\
        --heads mol --fault bwd_mask_tshift       # must FAIL

Exit code 0 iff every head passes.
"""
from __future__ import annotations

import argparse
import sys
import time

from wavenet_vocoder_tpu_torch.scripts import synthetic_e2e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--heads", default=",".join(synthetic_e2e.HEADS))
    ap.add_argument("--fault", default="none",
                    help="build the training backward with a deliberate "
                         "gradient bug (synthetic_e2e --fault); the run "
                         "must then FAIL")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--out-dir", default=None,
                    help="where each head's best rollout goes")
    args = ap.parse_args(argv)

    results = {}
    for head in args.heads.split(","):
        print(f"\n===== head: {head} =====", flush=True)
        t0 = time.time()
        extra = [] if args.device is None else ["--device", args.device]
        extra += [] if args.out_dir is None else ["--out-dir", args.out_dir]
        rc = synthetic_e2e.main(["--head", head, "--steps", str(args.steps),
                                 "--fault", args.fault] + extra)
        results[head] = (rc, time.time() - t0)

    print("\n===== quality summary =====")
    for head, (rc, dt) in results.items():
        print(f"{head}: {'PASS' if rc == 0 else 'FAIL'} ({dt:.0f}s)")
    return 0 if all(rc == 0 for rc, _ in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
