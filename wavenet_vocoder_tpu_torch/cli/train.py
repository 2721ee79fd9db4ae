"""Training CLI (reference: train.py:1-16 docopt usage).

    python -m wavenet_vocoder_tpu_torch.cli.train --dump-root DIR \
        --checkpoint-dir DIR [--preset JSON] [--hparams "k=v,..."] \
        [--checkpoint PATH] [--restore-parts PATH] [--reset-optimizer] \
        [--speaker-id N] [--log-event-path DIR] [--max-train-steps N] \
        [--device DEVICE] [--no-mesh] [--distributed] \
        [--coordinator-address HOST:PORT --num-processes N --process-id I] \
        [--local-device-ids I] [--dist-backend nccl|gloo]

The port's counterpart of ``wavenet_vocoder_tpu/cli/train.py``, with the
same flags plus ``--device``, ``--local-device-ids`` and ``--dist-backend``.
It trains on the GPU unless ``--device`` names another device.

Data parallelism runs one process per GPU. Under torchrun,
``torchrun --nproc-per-node N -m wavenet_vocoder_tpu_torch.cli.train
--distributed ...`` joins the ranks from torchrun's environment; elsewhere
give every process ``--coordinator-address`` (rank 0's host:port),
``--num-processes`` and its ``--process-id``. Without a process group and
with several GPUs, the loop spawns one rank per GPU itself unless
``--no-mesh``. At the end it prints one ``[train] trace {...}`` line: the
run's counters (the kernel launches) and, for every span of the port (the
train step's phases, the loader's collate, the eval audio's generator), its
count and mean ms (``utils.profiling``).
"""
from __future__ import annotations

import argparse
import json

import torch.distributed as dist

from wavenet_vocoder_tpu_torch.config import config_debug_string, load_config
from wavenet_vocoder_tpu_torch.parallel.distributed import (
    add_cli_flags,
    initialize_from_args,
)
from wavenet_vocoder_tpu_torch.training.loop import train_loop
from wavenet_vocoder_tpu_torch.utils import profiling


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dump-root", "--data-root", dest="dump_root",
                   required=True, help="directory with train_no_dev/ dev/ dumps")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--preset", default=None, help="preset JSON path")
    p.add_argument("--hparams", default="", help='"k=v,..." overrides')
    p.add_argument("--checkpoint", default=None, help="resume checkpoint")
    p.add_argument("--restore-parts", default=None,
                   help="partial restore for fine-tuning")
    p.add_argument("--reset-optimizer", action="store_true")
    p.add_argument("--speaker-id", type=int, default=None)
    p.add_argument("--log-event-path", default=None)
    p.add_argument("--max-train-steps", type=int, default=None)
    p.add_argument("--no-mesh", action="store_true",
                   help="disable multi-device data parallelism")
    add_cli_flags(p)
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda; fails "
                        "without a GPU)")
    return p


def trace_summary() -> dict:
    """The process's counters, and every span's count and mean ms."""
    spans = {name: {"count": n, "mean_ms": 1e3 * s / n}
             for name, (n, s) in sorted(profiling.totals().items())}
    return {"counters": dict(sorted(profiling.counters().items())),
            "spans": spans}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    initialize_from_args(args)
    cfg = load_config(args.preset, args.hparams)
    print(config_debug_string(cfg))
    try:
        train_loop(
            cfg, args.dump_root, args.checkpoint_dir,
            log_event_path=args.log_event_path,
            restore_checkpoint=args.checkpoint,
            restore_parts_path=args.restore_parts,
            reset_optimizer=args.reset_optimizer,
            speaker_id=args.speaker_id,
            max_steps_override=args.max_train_steps,
            use_mesh=not args.no_mesh,
            device=args.device,
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print("[train] trace " + json.dumps(trace_summary()))


if __name__ == "__main__":
    main()
