"""Mel-to-sample-rate upsampling networks for local conditioning.

The port's counterpart of ``wavenet_vocoder_tpu/models/upsample.py``
(reference: wavenet_vocoder/upsample.py). Module and parameter names follow
the reference so that the state dict reads as a reference checkpoint:

  * ``UpsampleNetwork.up_layers`` interleaves, per scale s, a parameter-free
    ``Stretch2d`` (nearest-neighbour x s along time), a weight-normed
    single-channel ``Conv2d`` with kernel (freq_axis_kernel_size, 2s+1),
    averaging init and no bias, and an optional activation;
  * ``ConvInUpsampleNetwork`` prepends ``conv_in``, an unpadded Conv1d with
    kernel 2*cin_pad+1 over mel frames, so the inner upsampler trims nothing.

Public forwards take and return channels-last ``(B, T, C_mel)``; inside,
the 2D conv runs on torch's ``(B, 1, C_mel, T)`` (H=freq, W=time).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavenet_vocoder_tpu_torch.models.layers import WNConv1d, _WeightNormMixin

_ACTIVATIONS = {
    "ReLU": nn.ReLU,
    "LeakyReLU": nn.LeakyReLU,
    "Tanh": nn.Tanh,
    "Sigmoid": nn.Sigmoid,
}


class Stretch2d(nn.Module):
    """Nearest-neighbour repeat along time (the last axis)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = int(scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(x, self.scale, dim=-1)


class _SmoothingConv2d(torch.autograd.Function):
    """``F.conv2d`` of a (B, 1, H, W) input by a (1, 1, kf, kt) filter, whose
    filter gradient is summed tap by tap with torch's reductions: for this
    shape cuDNN's deterministic filter-gradient algorithm is slow (11 ms a
    layer at the flagship's B=8 crop on an H100), and its others add in an
    order that changes from run to run. The input gradient is cuDNN's."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return F.conv2d(x, w, None, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w, dy,
                                            padding=ctx.padding)
        if ctx.needs_input_grad[1]:
            (pf, pt), (kf, kt), (H, W) = ctx.padding, w.shape[2:], dy.shape[2:]
            xp = F.pad(x, (pt, pt, pf, pf))
            dw = torch.stack([(xp[:, :, i:i + H, j:j + W] * dy).sum()
                              for i in range(kf) for j in range(kt)])
            dw = dw.view_as(w)
        return dx, dw, None


class WNConv2d(_WeightNormMixin, nn.Module):
    """Weight-normed, bias-free single-channel smoothing conv, filled with
    1/prod(kernel) (reference: upsample.py:42-44)."""

    def __init__(self, freq_k: int, time_k: int):
        super().__init__()
        w = torch.full((1, 1, freq_k, time_k), 1.0 / (freq_k * time_k))
        self.weight_norm_init(w)
        self.padding = ((freq_k - 1) // 2, (time_k - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _SmoothingConv2d.apply(x, self.effective_weight(), self.padding)


class UpsampleNetwork(nn.Module):
    """c: (B, T_mel, C) -> (B, T_mel * prod(scales) - 2*indent, C)."""

    def __init__(self, upsample_scales: Sequence[int], *,
                 upsample_activation: str = "none",
                 freq_axis_kernel_size: int = 1, cin_pad: int = 0):
        super().__init__()
        self.indent = int(cin_pad) * int(np.prod(upsample_scales))
        layers = []
        for s in upsample_scales:
            layers.append(Stretch2d(s))
            layers.append(WNConv2d(int(freq_axis_kernel_size), 2 * int(s) + 1))
            if upsample_activation != "none":
                layers.append(_ACTIVATIONS[upsample_activation]())
        self.up_layers = nn.ModuleList(layers)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        x = c.transpose(1, 2).unsqueeze(1)      # (B, 1, C, T)
        for f in self.up_layers:
            x = f(x)
        x = x.squeeze(1).transpose(1, 2)        # (B, T, C)
        if self.indent > 0:
            x = x[:, self.indent:-self.indent]
        return x


class ConvInUpsampleNetwork(nn.Module):
    """c: (B, T_mel, C) -> (B, (T_mel - 2*cin_pad) * prod(scales), C)."""

    def __init__(self, upsample_scales: Sequence[int], *,
                 upsample_activation: str = "none",
                 freq_axis_kernel_size: int = 1, cin_pad: int = 0,
                 cin_channels: int = 80,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_in = WNConv1d(cin_channels, cin_channels, 2 * int(cin_pad) + 1,
                                bias=False, generator=generator)
        self.upsample = UpsampleNetwork(
            upsample_scales, upsample_activation=upsample_activation,
            freq_axis_kernel_size=freq_axis_kernel_size, cin_pad=0)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(c.transpose(1, 2)).transpose(1, 2)
        return self.upsample(x)
