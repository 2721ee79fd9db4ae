"""Eager autoregressive decoder: a Python step loop with per-layer ring
buffers.

The port's counterpart of ``wavenet_vocoder_tpu/ops/generate.py``. It is the
readable reference the fused path (``ops/cuda_generate.py``) is held against,
and the ``"scan"`` engine of ``synthesis.py``. Every step launches a few
hundred small torch ops, so it is slow on a GPU; serving uses the kernel.

Ring buffers (per residual block, kernel k, dilation d): length L = (k-1)*d,
slot i mod L <- x_i. At step t the taps x[t-j*d] (j=1..k-1) sit at slots
(t-j*d) mod L; they are read before x_t is written to slot t mod L (which
evicts x[t-L]). Unwritten slots are zero, i.e. causal left-padding.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from wavenet_vocoder_tpu_torch.models.layers import conv1x1
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
from wavenet_vocoder_tpu_torch.ops.mixture import (
    sample_from_discretized_mix_logistic,
    sample_from_mix_gaussian,
)


def init_buffers(spec: WaveNetSpec, batch: int, *, device=None,
                 dtype=torch.float32) -> List[torch.Tensor]:
    """Zeroed ring buffers, one per residual block: (B, (k-1)*d, R)."""
    k, r = spec.kernel_size, spec.residual_channels
    return [torch.zeros(batch, (k - 1) * d, r, device=device, dtype=dtype)
            for d in spec.dilations]


def default_initial_input(spec: WaveNetSpec, batch: int, *,
                          device=None) -> torch.Tensor:
    """Zero scalar, or mu-law one-hot at code 127 (reference: wavenet.py:281-289)."""
    if spec.scalar_input:
        return torch.zeros(batch, 1, device=device)
    x0 = torch.zeros(batch, spec.out_channels, device=device)
    x0[:, 127] = 1.0
    return x0


def _sample_next(spec: WaveNetSpec, out: torch.Tensor, *,
                 log_scale_min: float, deterministic: bool,
                 generator: Optional[torch.Generator]):
    """Head output (B, C) f32 -> (next_input (B, C_in), emitted (B, C_emit)).

    The categorical head samples softmax(out) and feeds back the one-hot
    (reference: wavenet.py:322-335, softmax=True, quantize=True).

    deterministic=True feeds back the argmax-component mean (mixtures), the
    mean (single Gaussian) or the argmax code (categorical).
    """
    if deterministic:
        if spec.scalar_input:
            if out.shape[-1] == 2:
                s = out[:, 0].clamp(-1.0, 1.0)[:, None]
                return s, s
            nr_mix = out.shape[-1] // 3
            sel = torch.argmax(out[:, :nr_mix], dim=-1, keepdim=True)
            mean = torch.gather(out[:, nr_mix:2 * nr_mix], 1, sel)
            s = mean.clamp(-1.0, 1.0)
            return s, s
        one_hot = F.one_hot(torch.argmax(out, dim=-1),
                            spec.out_channels).to(out.dtype)
        return one_hot, one_hot
    if spec.scalar_input:
        if spec.output_distribution == "Logistic":
            s = sample_from_discretized_mix_logistic(
                out, generator, log_scale_min=log_scale_min)
        elif spec.output_distribution == "Normal":
            s = sample_from_mix_gaussian(out, generator,
                                         log_scale_min=log_scale_min)
        else:
            raise ValueError(spec.output_distribution)
        s = s[:, None]
        return s, s
    idx = torch.multinomial(torch.softmax(out, dim=-1), 1,
                            generator=generator)[:, 0]
    one_hot = F.one_hot(idx, spec.out_channels).to(out.dtype)
    return one_hot, one_hot


@torch.no_grad()
def generate(model: WaveNet, *, T: Optional[int] = None,
             c: Optional[torch.Tensor] = None,
             c_up: Optional[torch.Tensor] = None,
             g: Optional[torch.Tensor] = None,
             initial_input: Optional[torch.Tensor] = None,
             test_inputs: Optional[torch.Tensor] = None,
             log_scale_min: float = -50.0,
             output: str = "samples",
             deterministic: bool = False,
             generator: Optional[torch.Generator] = None,
             state: Optional[Tuple] = None,
             return_state: bool = False) -> Dict[str, torch.Tensor]:
    """Autoregressive generation on the model's device
    (reference: wavenet.py:215-343).

    c: (B, T_mel, C) with an upsample net, else (B, T, C); c_up, instead
    of c: (B, T, C) conditioning already at the sample rate (the upsample
    net is not applied); g: ids or
    (B, gin) floats; test_inputs: (B, T_test, C_in) teacher-forcing inputs
    seen while t < T_test. state: (x_in, buffers, t_offset) from an earlier
    call's returned state — resumes generation mid-stream: the ring indices
    key off the absolute step and ``generator`` carries on where it stood,
    so chunked calls equal one long call (see
    ``streaming.StreamingSynthesizer``). The given state is not modified;
    a resumed call takes no test_inputs.
    Returns {"samples": (B, T, C_emit)} and/or {"logits": (B, T,
    out_channels)}, and with ``return_state`` {"state": (x_in, buffers,
    t_offset + T)}.
    """
    spec = model.spec
    device = model.first_conv.effective_weight().device
    to_dev = lambda a: None if a is None else torch.as_tensor(a, device=device)
    if c is not None and c_up is not None:
        raise ValueError("give c or c_up, not both")
    c, g, test_inputs = to_dev(c), to_dev(g), to_dev(test_inputs)
    t_off = 0
    if state is not None:
        if test_inputs is not None:
            raise ValueError("test_inputs are indexed from the first step; "
                             "they cannot be combined with a resumed state")
        initial_input, buffers0, t_off = state
    if test_inputs is not None:
        B = test_inputs.shape[0]
        T = test_inputs.shape[1] if T is None else max(T, test_inputs.shape[1])
    elif c is not None or c_up is not None:
        B = (c if c is not None else c_up).shape[0]
    elif initial_input is not None:
        B = initial_input.shape[0]
    else:
        B = 1
    if c_up is not None:
        c_up = to_dev(c_up).float()
    else:
        c_up = model.upsample_conditioning(None if c is None else c.float())
    if c_up is not None:
        T = c_up.shape[1] if T is None else T
        if c_up.shape[1] != T:
            raise ValueError(f"conditioning covers {c_up.shape[1]} samples, "
                             f"T is {T}")
    if T is None:
        raise ValueError("T must be given when no conditioning/test inputs")

    g_vec = model.embed_global(g)
    # time-invariant global-conditioning projections, computed once
    g_gate = (None if g_vec is None else
              [conv1x1(blk.conv1x1g, g_vec.float()) for blk in model.conv_layers])
    if initial_input is None:
        x_in = default_initial_input(spec, B, device=device)
    else:
        x_in = to_dev(initial_input).reshape(B, -1).float()

    k = spec.kernel_size
    if state is None:
        buffers = init_buffers(spec, B, device=device)
    else:
        buffers = [to_dev(b).float().clone() for b in buffers0]
    samples, logits = [], []
    for i in range(T):
        t = t_off + i                       # absolute step
        if test_inputs is not None and i < test_inputs.shape[1]:
            x_in = test_inputs[:, i].float()
        ct = None if c_up is None else c_up[:, i]
        x = conv1x1(model.first_conv, x_in)
        skips = 0.0
        for li, (blk, d) in enumerate(zip(model.conv_layers, spec.dilations)):
            buf = buffers[li]
            L = (k - 1) * d
            taps = [buf[:, (t - j * d) % L] for j in range(k - 1, 0, -1)]
            taps = torch.stack(taps + [x], dim=1)          # (B, k, R)
            buf[:, t % L] = x                                # after the reads
            x, s = blk.step(taps, ct, None if g_gate is None else g_gate[li])
            skips = skips + s
        out = model.head(skips).float()
        x_in, emitted = _sample_next(
            spec, out, log_scale_min=log_scale_min,
            deterministic=deterministic, generator=generator)
        samples.append(emitted)
        logits.append(out)
    res: Dict[str, torch.Tensor] = {}
    if output in ("samples", "both"):
        res["samples"] = torch.stack(samples, dim=1)
    if output in ("logits", "both"):
        res["logits"] = torch.stack(logits, dim=1)
    if return_state:
        res["state"] = (x_in.float(), buffers, t_off + T)
    return res

