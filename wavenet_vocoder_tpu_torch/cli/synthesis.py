"""Single-utterance synthesis CLI (reference: synthesis.py docopt usage).

    python -m wavenet_vocoder_tpu_torch.cli.synthesis CHECKPOINT DST_WAV \
        [--conditional MEL_NPY] [--length T] [--initial-value V] \
        [--preset JSON] [--hparams "k=v"] [--speaker-id N] [--seed N] \
        [--engine auto|scan|cuda] [--device DEVICE]

The port's counterpart of ``wavenet_vocoder_tpu/cli/synthesis.py``, with the
same arguments and outputs. It runs on the GPU unless ``--device`` names
another device. Unconditional generation (no mel) follows the reference's
--length / --initial-value semantics (reference: synthesis.py:10-12,
148-162).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.config import discover_preset, load_config
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
from wavenet_vocoder_tpu_torch.synthesis import resolve_device, wavegen
from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt_lib

ENGINE_CHOICES = ("auto", "scan", "cuda")


def resolve_engine(engine: str) -> str:
    """``auto`` is the fused kernel: the entry points run on the card."""
    return "cuda" if engine == "auto" else engine


def load_params_and_config(checkpoint_path: str, preset, hparams_str):
    """Load checkpoint weights + config, auto-discovering hparams.json next
    to the checkpoint when no preset is given (reference:
    evaluate.py:116-127). Returns (model on the CPU, cfg, global step).

    Reads the port's checkpoints and the JAX package's npz checkpoints.
    Tensors the configured model has no use for are ignored (so e.g. a
    ``cin_channels=-1`` override simply leaves the conditioning weights
    unused, like the reference's strict=False-style loading)."""
    preset = discover_preset(checkpoint_path, preset)
    cfg = load_config(preset, hparams_str)
    model, counters = ckpt_lib.load_model(checkpoint_path,
                                          spec_from_config(cfg))
    return model, cfg, counters["global_step"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint")
    p.add_argument("dst_wav")
    p.add_argument("--conditional", "--mel", dest="mel", default=None,
                   help="(T, D) mel-spectrogram .npy; omit for "
                        "unconditional generation")
    p.add_argument("--length", type=int, default=32000,
                   help="steps to generate when unconditional "
                        "(reference: synthesis.py:10)")
    p.add_argument("--initial-value", type=float, default=None,
                   help="initial decoder input (raw float, or mu-law code "
                        "for categorical models; reference: "
                        "synthesis.py:148-162)")
    p.add_argument("--preset", default=None)
    p.add_argument("--hparams", default="")
    p.add_argument("--speaker-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--file-name-suffix", default="",
                   help="appended to the wav name when DST_WAV is a "
                        "directory (reference: synthesis.py:203, 240)")
    p.add_argument("--output-html", action="store_true",
                   help="print an <audio> html snippet for the generated wav "
                        "(reference: synthesis.py:204)")
    p.add_argument("--engine", default="auto", choices=ENGINE_CHOICES,
                   help="decoder engine: auto = cuda (the fused kernel), "
                        "scan = the eager step loop")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; fails "
                        "without a GPU)")
    args = p.parse_args(argv)
    engine = resolve_engine(args.engine)

    model, cfg, step = load_params_and_config(
        args.checkpoint, args.preset, args.hparams)
    c = None if args.mel is None else np.load(args.mel)
    what = ("unconditional" if c is None
            else f"{c.shape[0]} mel frames")
    print(f"Synthesizing {what} with step-{step} model...")
    wav = wavegen(model, cfg, c=c, g=args.speaker_id,
                  length=None if c is not None else args.length,
                  initial_value=args.initial_value,
                  generator=torch.Generator(
                      device=resolve_device(args.device)).manual_seed(args.seed),
                  engine=engine, device=args.device)
    dst = args.dst_wav
    if os.path.isdir(dst):
        # directory destination: name after the checkpoint, like the
        # reference's dst_dir mode (reference: synthesis.py:240)
        name = os.path.splitext(os.path.basename(args.checkpoint))[0]
        dst = os.path.join(dst, f"{name}{args.file_name_suffix}.wav")
    audio.save_wav(wav, dst, cfg.sample_rate)
    print(f"Wrote {dst} ({len(wav) / cfg.sample_rate:.2f}s)")
    if args.output_html:
        print(f'<audio controls="controls"><source src="{dst}"/></audio>')


if __name__ == "__main__":
    main()
