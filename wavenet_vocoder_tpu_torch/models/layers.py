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

Gate-channel tensor parallelism (``parallel/sharding.shard_params_tp``)
cuts a block's convolutions over a model group of processes: ``conv``,
``conv1x1c`` and ``conv1x1g`` column-parallel (rank r holds gate channels
[r G/2m, (r+1) G/2m) of each GLU half, so GLU stays local), ``conv1x1_out``
and ``conv1x1_skip`` row-parallel over the same G/2 slice. The collectives
are Megatron's f and g operators as autograd Functions: what a
column-parallel product reads is copied in (identity forward, all-reduce
backward), the out/skip partial sums are reduced out (all-reduce forward,
identity backward) before their biases are added once. The row-parallel
weight norm sums its partial squared norms over the group (both ways).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

_SQRT_HALF = math.sqrt(0.5)

# how a convolution is cut under tensor parallelism: its output channels in
# GLU pairs (weight_v, weight_g, bias), or its input channels (weight_v)
COLUMN, ROW = "column", "row"


# ----------------------------------------------------------------------
# collectives over the model group, with their gradients
# ----------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """f: identity forward; the gradient summed over the group (each rank
    holds the part that went through its slice of the gate channels)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ReduceFromModel(torch.autograd.Function):
    """g: the partial sums summed over the group; the gradient passes as
    it is (what follows is replicated, so every rank holds all of it)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def shard_slice(t: torch.Tensor, kind: str, rank: int, size: int
                ) -> torch.Tensor:
    """Rank ``rank``'s slice of a whole tensor: COLUMN takes channels
    [r n, (r+1) n) of each half of axis 0 (n = half / size), ROW the r-th
    contiguous part of axis 1."""
    if kind == COLUMN:
        a, b = t.chunk(2, dim=0)
        return torch.cat([a.chunk(size, 0)[rank], b.chunk(size, 0)[rank]])
    return t.chunk(size, dim=1)[rank]


def gather_slices(parts, kind: str) -> torch.Tensor:
    """The whole tensor from every rank's slice, in rank order (the
    inverse of :func:`shard_slice`)."""
    if kind == COLUMN:
        halves = [p.chunk(2, dim=0) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves])
    return torch.cat(parts, dim=1)


def all_gather_slices(x: torch.Tensor, kind: str, group) -> torch.Tensor:
    """The whole tensor from every rank's slice ``x``. An all-reduce of
    zeros holding each rank's slice in its place, not an all-gather: gloo
    reduces tensors on a GPU but does not gather them (adding zeros is
    exact)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    buf = x.new_zeros((size,) + tuple(x.shape))
    buf[rank] = x
    dist.all_reduce(buf, group=group)
    return gather_slices(list(buf.unbind(0)), kind)


class _GatherFromModel(torch.autograd.Function):
    """The whole tensor from the ranks' slices; the gradient is this
    rank's slice of the whole tensor's gradient (every rank computes all
    of it from the same inputs, so nothing is summed)."""

    @staticmethod
    def forward(ctx, x, kind, group):
        ctx.kind, ctx.rank = kind, dist.get_rank(group)
        ctx.size = dist.get_world_size(group)
        return all_gather_slices(x, kind, group)

    @staticmethod
    def backward(ctx, dy):
        return shard_slice(dy, ctx.kind, ctx.rank, ctx.size).contiguous(), \
            None, None


def copy_to_model(x, group):
    return x if group is None or x is None else _CopyToModel.apply(x, group)


def _norm_except_dim0(v: torch.Tensor, group=None) -> torch.Tensor:
    dims = tuple(range(1, v.dim()))
    sq = torch.sum(v * v, dim=dims, keepdim=True)
    if group is not None:
        # a row-parallel kernel's squared norm: its addends and its sum are
        # both used by cut products, so it is summed both ways
        sq = _ReduceFromModel.apply(copy_to_model(sq, group), group)
    return torch.sqrt(sq + 1e-12)


class _WeightNormMixin:
    """Folds ``weight_g * weight_v / ||weight_v||`` on demand. Under tensor
    parallelism ``tp`` is (COLUMN or ROW, the model group) and the
    parameters hold this rank's slice."""

    tp = None

    def weight_norm_init(self, w: torch.Tensor) -> None:
        self.weight_v = nn.Parameter(w)
        g = torch.sqrt(torch.sum(w * w, dim=tuple(range(1, w.dim())),
                                 keepdim=True))
        self.weight_g = nn.Parameter(g)

    def effective_weight(self) -> torch.Tensor:
        """This rank's slice of the folded weight (all of it without tensor
        parallelism); a row-parallel slice's norm is the whole kernel's."""
        if "weight" in self._parameters:
            return self.weight
        if self.tp is None or self.tp[0] == COLUMN:
            return self.weight_v * (self.weight_g
                                    / _norm_except_dim0(self.weight_v))
        # row-parallel: g is whole, but each rank's slice of the kernel
        # gives only its part of g's gradient
        group = self.tp[1]
        return self.weight_v * (copy_to_model(self.weight_g, group)
                                / _norm_except_dim0(self.weight_v, group))

    def full_weight(self) -> torch.Tensor:
        """The whole folded weight: under tensor parallelism gathered from
        the model group (v and a column-parallel g, the norm then taken
        over all of v), with a gradient that is this rank's slice."""
        if self.tp is None:
            return self.effective_weight()
        kind, group = self.tp
        v = _GatherFromModel.apply(self.weight_v, kind, group)
        g = (_GatherFromModel.apply(self.weight_g, kind, group)
             if kind == COLUMN else self.weight_g)
        return v * (g / _norm_except_dim0(v))

    def full_bias(self) -> Optional[torch.Tensor]:
        if self.tp is None or self.tp[0] == ROW or self.bias is None:
            return self.bias
        return _GatherFromModel.apply(self.bias, self.tp[0], self.tp[1])


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
    w = conv.effective_weight().to(taps.dtype)     # (Out, In, K)
    b, k, cin = taps.shape
    w_flat = w.permute(2, 1, 0).reshape(k * cin, -1)   # (K*In, Out)
    y = taps.reshape(b, k * cin) @ w_flat
    return y if conv.bias is None else y + conv.bias.to(taps.dtype)


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
                keep_mask: Optional[torch.Tensor] = None):
        """Batch mode. x: (B, T, R) -> (residual_out, skip), channels-last.

        ``dropout > 0`` drops the conv input (not the residual passthrough)
        where ``keep_mask`` (a {0, 1} tensor shaped like x) is 0, scaling
        kept values by 1/keep (reference: modules.py:126-128)."""
        g_proj = None if g is None else conv1x1(self.conv1x1g, g)
        x_in = x
        if dropout > 0.0:
            keep = 1.0 - dropout
            x_in = torch.where(keep_mask > 0, x / keep, torch.zeros_like(x))
        if self.conv.tp is None:
            h = self.gated(causal_conv(self.conv, x_in), c, g_proj)
            return self._out_skip(h, x)
        # tensor parallel: c and g come copied in by the model
        group = self.conv.tp[1]
        h = self.gated(causal_conv(self.conv, copy_to_model(x_in, group)),
                       c, g_proj)
        return self._out_skip(h, x)

    def _out_skip(self, h: torch.Tensor, x: torch.Tensor):
        """(residual out, skip) from the GLU output h and the block input
        x. Under tensor parallelism h is this rank's slice of the gate
        channels: the joined out|skip product's partial sums are reduced
        over the model group once, then each bias is added once."""
        if self.conv.tp is None:
            s = conv1x1(self.conv1x1_skip, h)
            out = (conv1x1(self.conv1x1_out, h) + x) * _SQRT_HALF
            return out, s
        R = self.conv1x1_out.out_channels
        w = torch.cat([self.conv1x1_out.effective_weight()[:, :, 0],
                       self.conv1x1_skip.effective_weight()[:, :, 0]])
        y = _ReduceFromModel.apply(h @ w.t().to(h.dtype), self.conv.tp[1])
        out = (y[..., :R] + self.conv1x1_out.bias.to(h.dtype) + x) * _SQRT_HALF
        s = y[..., R:] + self.conv1x1_skip.bias.to(h.dtype)
        return out, s

    def step(self, taps: torch.Tensor, ct: Optional[torch.Tensor] = None,
             g_proj: Optional[torch.Tensor] = None):
        """One AR step. taps: (B, K, R), taps[:, -1] is x_t; g_proj is the
        time-invariant ``conv1x1g(g)``, computed once per generation. A
        block cut by tensor parallelism runs the forward's collectives, so
        every rank of the model group computes the whole block."""
        if self.conv.tp is not None:
            taps = copy_to_model(taps, self.conv.tp[1])
        h = self.gated(conv_step(self.conv, taps), ct, g_proj)
        return self._out_skip(h, taps[:, -1])
