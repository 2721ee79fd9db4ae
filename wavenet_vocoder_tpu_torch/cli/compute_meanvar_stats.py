"""Streaming mean/var stats CLI (reference: compute-meanvar-stats.py).

    python -m wavenet_vocoder_tpu_torch.cli.compute_meanvar_stats LIST_OR_DIR OUT_NPZ

The port's counterpart of ``wavenet_vocoder_tpu/cli/compute_meanvar_stats.py``, with the
same arguments and outputs.
"""
from __future__ import annotations

import argparse
import os
from glob import glob

from wavenet_vocoder_tpu_torch.data.normalize import compute_meanvar_stats


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("source", help="directory of *-feats.npy, or a text file "
                                  "listing feature paths")
    p.add_argument("out_path", help="output .npz scaler path")
    args = p.parse_args(argv)
    if os.path.isdir(args.source):
        files = sorted(glob(os.path.join(args.source, "*-feats.npy")))
    else:
        with open(args.source) as f:
            files = [line.strip() for line in f if line.strip()]
    if not files:
        raise SystemExit(f"No feature files found from {args.source}")
    scaler = compute_meanvar_stats(files, args.out_path)
    print(f"fitted over {scaler.n} frames -> {args.out_path}")


if __name__ == "__main__":
    main()
