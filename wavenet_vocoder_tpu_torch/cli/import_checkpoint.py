"""Convert a reference PyTorch checkpoint to the shared npz format.

    python -m wavenet_vocoder_tpu_torch.cli.import_checkpoint TORCH_CKPT \
        OUT_DIR [--preset JSON] [--hparams "k=v,..."]

The port's counterpart of ``wavenet_vocoder_tpu/cli/import_checkpoint.py``,
with the same arguments and outputs. It reads a reference
``checkpoint_step*.pth`` (reference: train.py:852-884) and loads its
state_dict through ``WaveNet.load_state_dict``: the port keeps the
reference's parameter names and layouts, so no converter is needed beyond
dropping a ``module.`` prefix and unfolding weights saved after
``make_generation_fast_()`` (a plain ``weight`` becomes ``weight_v`` with
``weight_g`` its norm). It writes ``checkpoint_step{N:09d}.npz`` +
``checkpoint_latest.npz`` in OUT_DIR with the step/epoch counters kept; the
reference's averaged-weights twin (``..._ema.pth``) beside the input is
imported as the EMA twin. The effective config goes to ``hparams.json``
beside the checkpoints (train.py:1065-1067), so ``cli.evaluate`` /
``cli.synthesis`` find it.

The torch optimizer state is not converted, as in the JAX package: training
resumes with a fresh optimizer, the reference's ``--reset-optimizer``
semantics. The file is read with ``torch.load(weights_only=True)``: unlike
the JAX package, the port does not fall back to unpickling arbitrary
objects.
"""
from __future__ import annotations

import argparse
import os
import pickle
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch

from wavenet_vocoder_tpu_torch.config import discover_preset, load_config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
from wavenet_vocoder_tpu_torch.training.checkpoint import (
    checkpoint_path,
    save_checkpoint,
)


def _unfold(sd: Dict[str, torch.Tensor], model: WaveNet
            ) -> Dict[str, torch.Tensor]:
    """A ``module.``-prefixed or folded state dict under the model's names."""
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    own = model.state_dict()
    out = {}
    for k, v in sd.items():
        base = k[:-len(".weight")] if k.endswith(".weight") else None
        if base is not None and f"{base}.weight_v" in own:
            v = v.float()
            dims = tuple(range(1, v.dim()))
            out[f"{base}.weight_v"] = v
            out[f"{base}.weight_g"] = torch.sqrt(
                torch.sum(v * v, dim=dims, keepdim=True))
        else:
            out[k] = v
    return out


def load_torch_checkpoint(path: str, model: WaveNet) -> Dict[str, int]:
    """Load a reference ``.pth`` (the training checkpoint dict or a bare
    state_dict) into ``model``; returns its counters. Raises when the
    checkpoint holds weights the model has no slot for, or misses some."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        # unpickling arbitrary objects can run code: not for a file this
        # program did not write
        raise ValueError(
            f"{path} holds objects other than tensors and plain values; the "
            "port loads such checkpoints only as weights (re-save its "
            "state_dict with torch.save in a trusted environment)") from e
    counters = {"global_step": 0, "global_epoch": 0, "global_test_step": 0}
    sd = payload
    if isinstance(payload, dict) and "state_dict" in payload:
        sd = payload["state_dict"]
        counters = {k: int(payload.get(k, 0) or 0) for k in counters}
    try:
        model.load_state_dict(_unfold(dict(sd), model))
    except RuntimeError as e:
        raise ValueError(f"{path} does not fit the configured model (wrong "
                         f"preset?): {e}") from e
    return counters


def ema_twin_path(path: str) -> Optional[str]:
    """checkpoint_stepX.pth -> checkpoint_stepX_ema.pth if it exists
    (the reference's averaged-weights twin stream, train.py:871-884)."""
    base, ext = os.path.splitext(path)
    if base.endswith("_ema"):
        return None
    cand = base + "_ema" + ext
    return cand if os.path.exists(cand) else None


def import_checkpoint(torch_ckpt: str, cfg
                      ) -> Tuple[WaveNet, Optional[Dict[str, Any]],
                                 Dict[str, int]]:
    """(model with the checkpoint's weights, EMA state dict or None,
    counters), on the CPU."""
    spec = spec_from_config(cfg)
    gen = torch.Generator().manual_seed(0)
    model = WaveNet(spec, generator=gen)
    counters = load_torch_checkpoint(torch_ckpt, model)
    twin = ema_twin_path(torch_ckpt)
    ema = None
    if twin is not None:
        ema_net = WaveNet(spec, generator=gen)
        load_torch_checkpoint(twin, ema_net)
        ema = ema_net.state_dict()
    return model, ema, counters


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("torch_ckpt", help="reference checkpoint_step*.pth")
    p.add_argument("out_dir", help="output checkpoint directory")
    p.add_argument("--preset", default=None,
                   help="preset JSON matching the checkpoint's model "
                        "(defaults to hparams.json beside the input)")
    p.add_argument("--hparams", default="", help='"k=v,..." overrides')
    args = p.parse_args(argv)

    preset = discover_preset(args.torch_ckpt, args.preset)
    if preset is not None and args.preset is None:
        print(f"Using config discovered next to checkpoint: {preset}")
    cfg = load_config(preset, args.hparams)

    model, ema, counters = import_checkpoint(args.torch_ckpt, cfg)
    step = counters["global_step"]
    print(f"Imported {args.torch_ckpt}: step={step} "
          f"epoch={counters['global_epoch']}")

    # save_checkpoint writes the _ema twin stream itself whenever the state
    # has an EMA shadow
    state = SimpleNamespace(model=model, optimizer=None, ema=ema)
    out = save_checkpoint(
        args.out_dir, state, global_step=step,
        global_epoch=counters["global_epoch"],
        global_test_step=counters["global_test_step"],
        save_optimizer_state=False)
    print(f"Wrote {out}")
    if ema is not None:
        print(f"Wrote EMA twin {checkpoint_path(args.out_dir, step, ema=True)}"
              f" (from {ema_twin_path(args.torch_ckpt)})")

    hp_out = os.path.join(args.out_dir, "hparams.json")
    with open(hp_out, "w") as f:
        f.write(cfg.to_json(indent=2, sort_keys=True))
    print(f"Wrote {hp_out}")


if __name__ == "__main__":
    main()
