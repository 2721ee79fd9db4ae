"""Output-head distributions: discretized mixture of logistics (MoL) and
(mixture of) Gaussians — losses and samplers.

The port's counterpart of ``wavenet_vocoder_tpu/ops/mixture.py``
(reference: mixture.py). Losses run in float32 whatever the compute dtype of
the network, with the reference's edge cases: the +/-0.999 end bins, the
``cdf_delta > 1e-5`` midpoint fallback and the ``log_scale_min`` clamp.
Samplers take an explicit ``torch.Generator``.

Parameter packing along the last axis: ``[logit_probs, means, log_scales]``
each of width nr_mix; the 2-channel single Gaussian packs
``[mean, log_scale]``.
"""
from __future__ import annotations

from typing import Optional

import math

import torch
import torch.nn.functional as F

_LO = 1e-5
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def log_sum_exp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Numerically stable logsumexp (reference: mixture.py:17-23)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    return m.squeeze(dim) + torch.log(torch.sum(torch.exp(x - m), dim=dim))


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable log-softmax; the shift carries no gradient."""
    shifted = x - torch.amax(x, dim=dim, keepdim=True).detach()
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=dim,
                                         keepdim=True))


def discretized_mix_logistic_loss(y_hat: torch.Tensor, y: torch.Tensor,
                                  num_classes: int = 256,
                                  log_scale_min: float = -7.0,
                                  reduce: bool = True) -> torch.Tensor:
    """Discretized MoL negative log-likelihood (reference: mixture.py:40-106).

    y_hat: (B, T, 3*nr_mix) parameters; y: (B, T, 1) target in [-1, 1].
    Returns the sum, or per element (B, T, 1) when ``reduce`` is False.
    """
    C = y_hat.shape[-1]
    assert C % 3 == 0
    nr_mix = C // 3
    y_hat = y_hat.float()
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp(y_hat[..., 2 * nr_mix:3 * nr_mix],
                             min=log_scale_min)
    y = y.float().expand_as(means)

    centered_y = y - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = 1.0 / (num_classes - 1)
    plus_in = inv_stdv * (centered_y + half_bin)
    min_in = inv_stdv * (centered_y - half_bin)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - F.softplus(plus_in)      # y = lowest bin
    log_one_minus_cdf_min = -F.softplus(min_in)       # y = highest bin
    mid_in = inv_stdv * centered_y
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    log_probs = torch.where(
        y < -0.999, log_cdf_plus,
        torch.where(
            y > 0.999, log_one_minus_cdf_min,
            torch.where(cdf_delta > 1e-5,
                        torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid - math.log((num_classes - 1) / 2.0))))
    log_probs = log_probs + log_softmax(logit_probs, dim=-1)
    nll = -log_sum_exp(log_probs, dim=-1)
    return torch.sum(nll) if reduce else nll[..., None]


def mix_gaussian_loss(y_hat: torch.Tensor, y: torch.Tensor,
                      log_scale_min: float = -7.0,
                      reduce: bool = True) -> torch.Tensor:
    """(Mixture of) Gaussian negative log-likelihood
    (reference: mixture.py:161-218). C == 2 is one Gaussian
    ``[mean, log_scale]``; otherwise C = 3*nr_mix packed like MoL."""
    C = y_hat.shape[-1]
    y_hat = y_hat.float()
    if C == 2:
        nr_mix, logit_probs = 1, None
        means = y_hat[..., 0:1]
        log_scales = torch.clamp(y_hat[..., 1:2], min=log_scale_min)
    else:
        assert C % 3 == 0
        nr_mix = C // 3
        logit_probs = y_hat[..., :nr_mix]
        means = y_hat[..., nr_mix:2 * nr_mix]
        log_scales = torch.clamp(y_hat[..., 2 * nr_mix:3 * nr_mix],
                                 min=log_scale_min)
    centered_y = y.float().expand_as(means) - means
    log_probs = (-0.5 * torch.exp(-2.0 * log_scales) * centered_y ** 2
                 - log_scales - _HALF_LOG_2PI)
    if nr_mix > 1:
        log_probs = log_probs + log_softmax(logit_probs, dim=-1)
        nll = -log_sum_exp(log_probs, dim=-1)[..., None]
    else:
        nll = -log_probs
    return torch.sum(nll) if reduce else nll


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
