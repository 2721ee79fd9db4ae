"""Subset/split CLI (reference: mksubset.py docopt usage).

    python -m wavenet_vocoder_tpu_torch.cli.mksubset IN_DIR OUT_DIR \
        [--limit HOURS] [--dev-size N] [--test-size N] [--target-sr SR]

The port's counterpart of ``wavenet_vocoder_tpu/cli/mksubset.py``, with the
same arguments and outputs.
"""
from __future__ import annotations

import argparse

from wavenet_vocoder_tpu_torch.data.mksubset import mksubset


def _num(s: str):
    f = float(s)
    return f if f < 1 else int(f)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("--limit", type=float, default=None, help="max hours")
    p.add_argument("--dev-size", type=_num, default=0.1)
    p.add_argument("--test-size", type=_num, default=0.1)
    p.add_argument("--target-sr", type=int, default=None)
    p.add_argument("--raw-sr", type=int, default=24000)
    p.add_argument("--random-state", type=int, default=1234,
                   help="split seed (reference: mksubset.py:14)")
    p.add_argument("--train-dev-test-split", action="store_true",
                   help="emit {train_no_dev,dev,eval} subdirs; without it, "
                        "copy kept utterances flat into OUT_DIR "
                        "(reference: mksubset.py:8, 69-73)")
    args = p.parse_args(argv)
    mksubset(args.in_dir, args.out_dir, limit_hours=args.limit,
             dev_size=args.dev_size, test_size=args.test_size,
             target_sr=args.target_sr, raw_sr=args.raw_sr,
             seed=args.random_state,
             train_dev_test_split=args.train_dev_test_split)


if __name__ == "__main__":
    main()
