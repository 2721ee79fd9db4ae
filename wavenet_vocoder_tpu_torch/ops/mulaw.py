"""Mu-law companding for numpy arrays and torch tensors.

The port's counterpart of ``wavenet_vocoder_tpu/ops/mulaw.py``; the
convention is the same (``mu = quantize_channels - 1``):

    mulaw(x, mu)          : [-1, 1] -> [-1, 1],  F(x) = sign(x) ln(1+mu|x|)/ln(1+mu)
    mulaw_quantize(x, mu) : [-1, 1] -> {0..mu}   (mu+1 classes)
    inverses accordingly.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _xp(x):
    """torch for tensors, numpy for everything else."""
    return torch if isinstance(x, torch.Tensor) else np


def mulaw(x, mu: int = 255):
    """Mu-law companding: [-1, 1] -> [-1, 1]."""
    xp = _xp(x)
    return xp.sign(x) * xp.log1p(mu * xp.abs(x)) / np.log1p(float(mu))


def inv_mulaw(y, mu: int = 255):
    """Inverse mu-law companding: [-1, 1] -> [-1, 1]."""
    xp = _xp(y)
    return xp.sign(y) * (1.0 / mu) * ((1.0 + mu) ** xp.abs(y) - 1.0)


def mulaw_quantize(x, mu: int = 255):
    """Mu-law companding + quantize: [-1, 1] -> {0 .. mu} (mu+1 classes)."""
    y = (mulaw(x, mu) + 1) / 2 * mu
    if isinstance(y, torch.Tensor):
        return y.to(torch.int32)
    return np.asarray(y).astype(np.int32)


def inv_mulaw_quantize(y, mu: int = 255):
    """Inverse of :func:`mulaw_quantize`: {0 .. mu} -> [-1, 1]."""
    if isinstance(y, torch.Tensor):
        y = y.to(torch.float32)
    else:
        y = np.asarray(y, dtype=np.float32)
    return inv_mulaw(2.0 * y / mu - 1.0, mu)


@functools.lru_cache(maxsize=None)
def _inv_mulaw_table(mu: int) -> np.ndarray:
    table = np.asarray(inv_mulaw_quantize(np.arange(mu + 1), mu), np.float64)
    table.flags.writeable = False
    return table


def inv_mulaw_codes(codes: np.ndarray, mu: int = 255) -> np.ndarray:
    """:func:`inv_mulaw_quantize` of host integer codes, as float64: a lookup
    in its table of the mu + 1 codes (the same values, with no power taken a
    sample, which dominated a host's decode of batched mu-law synthesis)."""
    return _inv_mulaw_table(int(mu))[codes]
