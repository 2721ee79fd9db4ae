"""Weight-normed conv modules and the gated residual block, channels-last.

The port's counterpart of ``wavenet_vocoder_tpu/models/layers.py``. Modules
keep the reference torch model's parameter names and layouts:

  * ``weight_v (Out, In, K)`` (Conv1d) or ``(Out, In, H, W)`` (Conv2d),
    ``weight_g`` with ones in every axis but the first, ``bias (Out,)``;
  * after :func:`remove_weight_norm`, a plain ``weight`` of the same layout.

The effective weight is ``g * v / sqrt(sum(v**2) + 1e-12)``, the norm taken
per output channel over all other axes — the JAX package's ``conv_kernel``
with its ``+1e-12`` (layers.py:67-76), which torch's ``weight_norm(dim=0)``
equals up to that epsilon.

Public functions take and return channels-last ``(B, T, C)`` tensors; the
modules transpose to torch's ``(B, C, T)`` internally.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_SQRT_HALF = math.sqrt(0.5)


def _norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, v.dim()))
    return torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12)


class _WeightNormMixin:
    """Folds ``weight_g * weight_v / ||weight_v||`` on demand."""

    def weight_norm_init(self, w: torch.Tensor) -> None:
        self.weight_v = nn.Parameter(w)
        g = torch.sqrt(torch.sum(w * w, dim=tuple(range(1, w.dim())),
                                 keepdim=True))
        self.weight_g = nn.Parameter(g)

    def effective_weight(self) -> torch.Tensor:
        if "weight" in self._parameters:
            return self.weight
        return self.weight_v * (self.weight_g / _norm_except_dim0(self.weight_v))


class WNConv1d(_WeightNormMixin, nn.Module):
    """Weight-normed Conv1d with kaiming-normal init (relu gain), zero bias
    and ``g`` set to the kernel norm (reference: modules.py:13-18)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, *,
                 bias: bool = True, dilation: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.out_channels = in_ch, out_ch
        self.kernel_size, self.dilation = kernel_size, dilation
        std = math.sqrt(2.0 / (in_ch * kernel_size))
        w = std * torch.randn(out_ch, in_ch, kernel_size, generator=generator)
        self.weight_norm_init(w)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        """x: (B, C, T) torch layout. ``causal`` left-pads (K-1)*dilation.
        The weight and bias follow x's dtype (f32 masters, cast on the fly
        for bf16 compute, as the JAX package's ``causal_conv``)."""
        if causal:
            x = F.pad(x, ((self.kernel_size - 1) * self.dilation, 0))
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv1d(x, self.effective_weight().to(x.dtype), bias,
                        dilation=self.dilation)


def conv1x1(conv: WNConv1d, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv as a product over the last axis: (..., In) -> (..., Out).
    The weight and bias follow x's dtype."""
    w = conv.effective_weight()[:, :, 0].to(x.dtype)   # (Out, In)
    y = x @ w.t()
    return y if conv.bias is None else y + conv.bias.to(x.dtype)


def causal_conv(conv: WNConv1d, x: torch.Tensor) -> torch.Tensor:
    """Causal dilated conv, channels-last: (B, T, In) -> (B, T, Out)."""
    return conv(x.transpose(1, 2), causal=True).transpose(1, 2)


def conv_step(conv: WNConv1d, taps: torch.Tensor) -> torch.Tensor:
    """Single-step dilated conv as one product (the incremental path).

    taps: (B, K, In), oldest..newest, i.e. taps[:, j] = x[t-(K-1-j)*d].
    """
    w = conv.effective_weight()                    # (Out, In, K)
    b, k, cin = taps.shape
    w_flat = w.permute(2, 1, 0).reshape(k * cin, -1)   # (K*In, Out)
    y = taps.reshape(b, k * cin) @ w_flat
    return y if conv.bias is None else y + conv.bias


def remove_weight_norm(module: nn.Module) -> nn.Module:
    """Fold ``(weight_g, weight_v)`` into a plain ``weight`` in every
    weight-normed submodule, in place (reference: wavenet.py:355-361)."""
    for m in module.modules():
        if isinstance(m, _WeightNormMixin) and "weight_v" in m._parameters:
            w = m.effective_weight().detach()
            del m._parameters["weight_v"]
            del m._parameters["weight_g"]
            m.weight = nn.Parameter(w)
    return module


class ResidualConv1dGLU(nn.Module):
    """Gated residual block (reference: modules.py:71-163): causal dilated
    conv -> (+ 1x1 local / global conditioning) -> tanh(a)*sigmoid(b) ->
    1x1 skip and 1x1 residual-out, residual scaled by sqrt(1/2)."""

    def __init__(self, residual_channels: int, gate_channels: int,
                 kernel_size: int, skip_out_channels: int, *,
                 cin_channels: int = -1, gin_channels: int = -1,
                 dilation: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g2 = gate_channels // 2
        self.conv = WNConv1d(residual_channels, gate_channels, kernel_size,
                             dilation=dilation, generator=generator)
        self.conv1x1c = (WNConv1d(cin_channels, gate_channels, bias=False,
                                  generator=generator)
                         if cin_channels > 0 else None)
        self.conv1x1g = (WNConv1d(gin_channels, gate_channels, bias=False,
                                  generator=generator)
                         if gin_channels > 0 else None)
        self.conv1x1_out = WNConv1d(g2, residual_channels, generator=generator)
        self.conv1x1_skip = WNConv1d(g2, skip_out_channels,
                                     generator=generator)

    def gated(self, z: torch.Tensor, c: Optional[torch.Tensor],
              g_proj: Optional[torch.Tensor]) -> torch.Tensor:
        """z: (..., G) conv output; c: (..., cin) or None; g_proj: the
        global-conditioning projection ``conv1x1g(g)``, (..., G) or None."""
        if c is not None:
            z = z + conv1x1(self.conv1x1c, c)
        if g_proj is not None:
            z = z + g_proj
        a, b = z.chunk(2, dim=-1)
        return torch.tanh(a) * torch.sigmoid(b)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None, *, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """Batch mode. x: (B, T, R) -> (residual_out, skip), channels-last.

        ``dropout > 0`` drops the conv input (not the residual passthrough)
        with a Bernoulli mask drawn from ``generator``, scaling kept values
        by 1/keep (reference: modules.py:126-128)."""
        g_proj = None if g is None else conv1x1(self.conv1x1g, g)
        x_in = x
        if dropout > 0.0:
            keep = 1.0 - dropout
            u = torch.rand(x.shape, generator=generator, device=x.device)
            x_in = torch.where(u < keep, x / keep, torch.zeros_like(x))
        h = self.gated(causal_conv(self.conv, x_in), c, g_proj)
        s = conv1x1(self.conv1x1_skip, h)
        out = (conv1x1(self.conv1x1_out, h) + x) * _SQRT_HALF
        return out, s

    def step(self, taps: torch.Tensor, ct: Optional[torch.Tensor] = None,
             g_proj: Optional[torch.Tensor] = None):
        """One AR step. taps: (B, K, R), taps[:, -1] is x_t; g_proj is the
        time-invariant ``conv1x1g(g)``, computed once per generation."""
        h = self.gated(conv_step(self.conv, taps), ct, g_proj)
        s = conv1x1(self.conv1x1_skip, h)
        out = (conv1x1(self.conv1x1_out, h) + taps[:, -1]) * _SQRT_HALF
        return out, s
