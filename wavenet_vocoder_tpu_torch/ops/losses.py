"""Masked sequence losses (reference: train.py:307-405).

The port's counterpart of ``wavenet_vocoder_tpu/ops/losses.py``. All losses
are mask-normalised means over valid time steps, computed in float32.
Layout: channels-last, y_hat (B, T, C), targets (B, T) int or (B, T, 1)
float, mask (B, T, 1).

``group``: under data parallelism each rank holds some rows of the global
batch. Its loss is then its local sum over the mask divided by the global
mask count (all-reduced over the process group), so that the ranks' losses
sum to the JAX package's mean over the global batch, and so do their
gradients.
"""
from __future__ import annotations

from typing import Optional

import torch

from wavenet_vocoder_tpu_torch.ops.mixture import (
    discretized_mix_logistic_loss,
    mix_gaussian_loss,
)


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len, 1) f32 mask
    (reference: train.py:307-317)."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()[..., None]


def _masked_mean(losses: torch.Tensor, mask: Optional[torch.Tensor],
                 group=None) -> torch.Tensor:
    if group is None:
        if mask is None:
            return torch.mean(losses)
        mask = mask.float()
        return torch.sum(losses * mask) / torch.sum(mask)
    import torch.distributed as dist
    if mask is None:
        total = torch.sum(losses)
        count = torch.tensor(float(losses.numel()), device=losses.device)
    else:
        mask = mask.float()
        total = torch.sum(losses * mask)
        count = torch.sum(mask).detach()
    dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
    return total / count


def masked_cross_entropy(y_hat: torch.Tensor, y: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, *,
                         group=None) -> torch.Tensor:
    """Per-element CE, mask-normalised mean (reference: train.py:346-362).
    y_hat: (B, T, C) logits; y: (B, T) int class ids (or (B, T, 1))."""
    if y.dim() == 3:
        y = y[..., 0]
    logp = torch.log_softmax(y_hat.float(), dim=-1)
    nll = -torch.gather(logp, -1, y[..., None].long())      # (B, T, 1)
    return _masked_mean(nll, mask, group)


def masked_mol_loss(y_hat: torch.Tensor, y: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    num_classes: int = 65536,
                    log_scale_min: float = -16.0,
                    group=None) -> torch.Tensor:
    """Masked discretized MoL NLL (reference: train.py:365-384)."""
    losses = discretized_mix_logistic_loss(
        y_hat, y, num_classes=num_classes, log_scale_min=log_scale_min,
        reduce=False)
    return _masked_mean(losses, mask, group)


def masked_gaussian_loss(y_hat: torch.Tensor, y: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, *,
                         log_scale_min: float = -16.0,
                         group=None) -> torch.Tensor:
    """Masked (mixture of) Gaussian NLL (reference: train.py:387-405)."""
    losses = mix_gaussian_loss(y_hat, y, log_scale_min=log_scale_min,
                               reduce=False)
    return _masked_mean(losses, mask, group)
