"""Apply (inverse) feature normalization CLI (reference: preprocess_normalize.py).

    python -m wavenet_vocoder_tpu_torch.cli.preprocess_normalize IN_DIR OUT_DIR SCALER \
        [--inverse] [--num-workers N]

The port's counterpart of ``wavenet_vocoder_tpu/cli/preprocess_normalize.py``, with the
same arguments and outputs.
"""
from __future__ import annotations

import argparse

from wavenet_vocoder_tpu_torch.data.normalize import normalize_dir


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("scaler", help="meanvar .npz from compute_meanvar_stats")
    p.add_argument("--inverse", action="store_true")
    p.add_argument("--num-workers", type=int, default=4)
    args = p.parse_args(argv)
    normalize_dir(args.in_dir, args.out_dir, args.scaler,
                  inverse=args.inverse, num_workers=args.num_workers)


if __name__ == "__main__":
    main()
