"""Output-head samplers: discretized mixture of logistics (MoL) and
(mixture of) Gaussians.

The port's counterpart of the samplers in
``wavenet_vocoder_tpu/ops/mixture.py`` (reference: mixture.py:138-155,
221-270). Random numbers come from an explicit ``torch.Generator``; the
losses belong to the training slice and are not here yet.

Parameter packing along the last axis: ``[logit_probs, means, log_scales]``
each of width nr_mix; the 2-channel single Gaussian packs
``[mean, log_scale]``.
"""
from __future__ import annotations

from typing import Optional

import torch

_LO = 1e-5


def _uniform(shape, like: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=like.device,
                   dtype=torch.float32)
    return u.clamp(_LO, 1.0 - _LO)


def _gumbel_select(logit_probs: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    u = _uniform(logit_probs.shape, logit_probs, generator)
    return torch.argmax(logit_probs - torch.log(-torch.log(u)), dim=-1)


def _pick(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, idx[..., None])[..., 0]


def sample_from_discretized_mix_logistic(
        y: torch.Tensor, generator: Optional[torch.Generator] = None,
        log_scale_min: float = -7.0) -> torch.Tensor:
    """y: (..., 3*nr_mix) -> sample in [-1, 1] of shape (...,).

    Gumbel-max component choice, then the logistic inverse CDF. As in the
    JAX package's default, ``log_scale_min`` is accepted and not applied.
    """
    C = y.shape[-1]
    assert C % 3 == 0
    nr_mix = C // 3
    y = y.float()
    sel = _gumbel_select(y[..., :nr_mix], generator)
    means = _pick(y[..., nr_mix:2 * nr_mix], sel)
    log_scales = _pick(y[..., 2 * nr_mix:3 * nr_mix], sel)
    u = _uniform(means.shape, means, generator)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))
    return x.clamp(-1.0, 1.0)


def sample_from_mix_gaussian(y: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             log_scale_min: float = -7.0) -> torch.Tensor:
    """y: (..., C), C == 2 single Gaussian else 3*nr_mix -> sample in [-1, 1]."""
    C = y.shape[-1]
    y = y.float()
    if C == 2:
        means, log_scales = y[..., 0], y[..., 1]
    elif C == 3:
        means, log_scales = y[..., 1], y[..., 2]
    else:
        assert C % 3 == 0
        nr_mix = C // 3
        sel = _gumbel_select(y[..., :nr_mix], generator)
        means = _pick(y[..., nr_mix:2 * nr_mix], sel)
        log_scales = _pick(y[..., 2 * nr_mix:3 * nr_mix], sel)
    z = torch.randn(means.shape, generator=generator, device=y.device)
    return (means + torch.exp(log_scales) * z).clamp(-1.0, 1.0)
