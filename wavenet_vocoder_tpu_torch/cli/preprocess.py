"""Feature-extraction CLI (reference: preprocess.py docopt usage).

    python -m wavenet_vocoder_tpu_torch.cli.preprocess NAME IN_DIR OUT_DIR \
        [--preset JSON] [--hparams "k=v"] [--num-workers N]
"""
from __future__ import annotations

import argparse

from wavenet_vocoder_tpu_torch.config import load_config
from wavenet_vocoder_tpu_torch.data.preprocess import preprocess


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("name", help="dataset plugin name (e.g. wavallin)")
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("--preset", default=None)
    p.add_argument("--hparams", default="")
    p.add_argument("--num-workers", type=int, default=4)
    args = p.parse_args(argv)
    cfg = load_config(args.preset, args.hparams)
    preprocess(args.name, args.in_dir, args.out_dir, cfg,
               num_workers=args.num_workers)


if __name__ == "__main__":
    main()
