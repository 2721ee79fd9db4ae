"""JAX-package params (numpy arrays) -> the port's state dict.

The reverse of ``wavenet_vocoder_tpu/compat/torch_import.py``: the JAX
package keeps conv kernels as ``{v: (K, In, Out), g: (Out,), b: (Out,)}``
(2D upsample convs as ``v: (time, freq, 1, 1)``), the port as torch's
``weight_v (Out, In, K)`` / ``(1, 1, freq, time)``, ``weight_g`` with unit
trailing axes, and ``bias``. Both layouts map by a full axis reversal.

The params must be numpy arrays (``jax.tree.map(np.asarray, params)``):
this module imports nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.models.wavenet import WaveNetSpec


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _conv(sd: Dict[str, torch.Tensor], prefix: str, p: Dict[str, Any]) -> None:
    """One conv node -> ``prefix.weight_v/.weight_g[/.bias]``. A folded node
    ``{w}`` becomes ``v = w`` with ``g = ||w||``, whose fold is ``w``."""
    v = np.asarray(p["v"] if "v" in p else p["w"], np.float32)
    v_t = v.T                                        # (Out, In, K[, ...])
    if "g" in p:
        g = np.asarray(p["g"], np.float32)
    else:
        g = np.sqrt(np.sum(v_t * v_t, axis=tuple(range(1, v_t.ndim))))
    sd[f"{prefix}.weight_v"] = _t(v_t)
    sd[f"{prefix}.weight_g"] = _t(g.reshape((-1,) + (1,) * (v_t.ndim - 1)))
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _upsample(sd, prefix: str, p: Dict[str, Any], spec: WaveNetSpec) -> None:
    # up_layers interleave Stretch2d, Conv2d [, activation] per scale
    per_scale = 2 if spec.upsample_activation == "none" else 3
    for j, cp in enumerate(p["convs"]):
        _conv(sd, f"{prefix}.up_layers.{j * per_scale + 1}", cp)


def state_dict_from_jax(params: Dict[str, Any], spec: WaveNetSpec
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``init_wavenet`` params (numpy leaves) -> ``WaveNet.state_dict()``
    keys and layouts, ready for ``load_state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "first_conv", params["first_conv"])
    names = {"conv": "conv", "cond_c": "conv1x1c", "cond_g": "conv1x1g",
             "out": "conv1x1_out", "skip": "conv1x1_skip"}
    for i, bp in enumerate(params["blocks"]):
        for k, name in names.items():
            if k in bp:
                _conv(sd, f"conv_layers.{i}.{name}", bp[k])
    _conv(sd, "last_conv_layers.1", params["last_conv1"])
    _conv(sd, "last_conv_layers.3", params["last_conv2"])
    if "embed_speakers" in params:
        sd["embed_speakers.weight"] = _t(params["embed_speakers"]["table"])
    if "upsample_net" in params:
        up = params["upsample_net"]
        if spec.upsample_net == "ConvInUpsampleNetwork":
            _conv(sd, "upsample_net.conv_in", up["conv_in"])
            _upsample(sd, "upsample_net.upsample", up["upsample"], spec)
        else:
            _upsample(sd, "upsample_net", up, spec)
    return sd
