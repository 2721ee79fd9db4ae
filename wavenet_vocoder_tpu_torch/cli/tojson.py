"""Dump effective config as JSON (reference: tojson.py).

    python -m wavenet_vocoder_tpu_torch.cli.tojson OUT_JSON [--preset J] [--hparams "k=v"]

The port's counterpart of ``wavenet_vocoder_tpu/cli/tojson.py``, with the
same arguments and outputs.
"""
from __future__ import annotations

import argparse

from wavenet_vocoder_tpu_torch.config import load_config


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_json")
    p.add_argument("--preset", default=None)
    p.add_argument("--hparams", default="")
    args = p.parse_args(argv)
    cfg = load_config(args.preset, args.hparams)
    with open(args.out_json, "w") as f:
        f.write(cfg.to_json(indent=2, sort_keys=True))
    print(f"Wrote {args.out_json}")


if __name__ == "__main__":
    main()
