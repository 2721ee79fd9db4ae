"""FLOP accounting and the card's peak rates (MFU and roofline bounds).

The port's counterpart of ``wavenet_vocoder_tpu/utils/flops.py``.
``forward_flops_per_sample`` is the analytic matmul-dominated count for one
generated or trained sample, the same integers as the JAX package's for the
same spec. MFU = achieved FLOP/s over the card's peak.

The JAX package's ``xla_cost_analysis`` and ``xla_cost_flops`` have no
counterpart here: they read the compiled XLA executable's own count, and
nothing in torch sees inside the port's ctypes kernels. The bench uses the
analytic count, which is what the JAX bench itself falls back to on its fused
path.

Peaks are NVIDIA's data-sheet dense rates (no sparsity), looked up by the
name ``torch.cuda.get_device_name`` gives; an unknown name gives None. The
rates assume the card's full power limit (700 W for the SXM part).
"""
from __future__ import annotations

from typing import Optional


def forward_flops_per_sample(spec) -> int:
    """Analytic forward FLOPs (2 x MACs) per output sample of the WaveNet
    stack (excludes the tiny conditioning upsampler, <1% for the flagship).
    Reference cost structure: wavenet.py:164-213 forward.
    """
    k = spec.kernel_size
    R = spec.residual_channels
    G = spec.gate_channels
    G2 = G // 2
    S = spec.skip_out_channels
    total = 2 * spec.in_channels * R
    per_layer = 2 * k * R * G + 2 * G2 * R + 2 * G2 * S
    if spec.has_local_conditioning:
        per_layer += 2 * spec.cin_channels * G
    if spec.has_global_conditioning:
        per_layer += 2 * spec.gin_channels * G
    total += spec.layers * per_layer
    total += 2 * S * S + 2 * S * spec.out_channels
    return total


def train_flops_per_sample(spec) -> int:
    """Forward + backward ~ 3x forward (each matmul has two grad matmuls)."""
    return 3 * forward_flops_per_sample(spec)


# (name substring, dense rates) from NVIDIA's H100 data sheet; the SXM part
# (HBM3) first, then PCIe. FLOP/s for bf16 and TF32 on the tensor cores and
# f32 outside them; device-memory bytes/s.
_H100_SXM = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "hbm": 3.35e12}
_H100_PCIE = {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "hbm": 2.0e12}
_DEVICES = (
    ("h100 80gb hbm3", _H100_SXM), ("h100 sxm", _H100_SXM),
    ("h100 pcie", _H100_PCIE),
)
# the rates chip_smoke.py states its bounds against: the SXM part's
H100_SXM = dict(_H100_SXM)


def _name(device) -> str:
    """The card's name, lower case: ``device`` itself when it is a string,
    else the name of that CUDA device (None: the current one); "" when no
    card is present."""
    if isinstance(device, str):
        return device.lower()
    import torch
    if device is None and not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(device).lower()


def device_peaks(device=None) -> Optional[dict]:
    """{"bf16", "tf32", "fp32": FLOP/s, "hbm": bytes/s} of a card, by the
    name ``torch.cuda.get_device_name`` gives (``device``: that name, a CUDA
    device or index, or None for the current one); None for an unknown
    card or none at all."""
    name = _name(device)
    for sub, peaks in _DEVICES:
        if sub in name:
            return dict(peaks)
    return None


def device_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 tensor-core peak FLOP/s; None for an unknown card."""
    peaks = device_peaks(device)
    return None if peaks is None else peaks["bf16"]


def device_peak_hbm_bw(device=None) -> Optional[float]:
    """Device-memory bytes/s; None for an unknown card."""
    peaks = device_peaks(device)
    return None if peaks is None else peaks["hbm"]
