"""The benchmark's frozen yardstick: analytic operation and byte counts of the
WaveNet's products, and the card's published peaks.

Counts are functions of a configuration's sizes alone (a dict of the
configuration file's keys), so no change to the program can move them.
A FLOP is one multiply or one add (2 per multiply-accumulate).

- ``forward_flops_per_sample``: every product of the network for one
  sample: the first 1x1 conv, per layer the dilated conv, the conditioning
  1x1, the residual-out and skip 1x1s, and the two head 1x1s. The mel
  upsampler is left out (under 1% of the flagship's count).
- ``stack_forward_products``: the residual layers' products alone, which is
  what the fused training stack's forward computes.
- The backward of a product is two products of the same size (the input's
  and the weight's gradient), so a training step is 3x the forward and the
  stack's backward 2x its forward. A recompute an implementation chooses is
  not counted.
- Bytes count each input read once and each output written once.

Peaks: NVIDIA's H100 SXM data sheet, dense (no sparsity), at the full power
limit of 700 W.
"""
from __future__ import annotations

from typing import Dict, Optional

H100_SXM = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "hbm": 3.35e12}
H100_SXM_POWER_W = 700.0
# names torch.cuda.get_device_name gives for the SXM part
_SXM_NAMES = ("h100 80gb hbm3", "h100 sxm")

BF16, F32 = 2, 4


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The peak table of a card by its name; None for any other card."""
    name = device_name.lower()
    return dict(H100_SXM) if any(s in name for s in _SXM_NAMES) else None


def _in_channels(cfg: dict) -> int:
    scalar = cfg["input_type"] in ("raw", "mulaw")
    return 1 if scalar else cfg["quantize_channels"]


def layer_products_per_sample(cfg: dict) -> int:
    k, R, G = cfg["kernel_size"], cfg["residual_channels"], cfg["gate_channels"]
    S, G2 = cfg["skip_out_channels"], cfg["gate_channels"] // 2
    n = 2 * k * R * G + 2 * G2 * R + 2 * G2 * S
    if cfg["cin_channels"] > 0:
        n += 2 * cfg["cin_channels"] * G
    if cfg.get("gin_channels", -1) > 0:
        n += 2 * cfg["gin_channels"] * G
    return n


def stack_forward_products(cfg: dict) -> int:
    """FLOPs of the residual layers for one sample."""
    return cfg["layers"] * layer_products_per_sample(cfg)


def forward_flops_per_sample(cfg: dict) -> int:
    R, S, out = (cfg["residual_channels"], cfg["skip_out_channels"],
                 cfg["out_channels"])
    return (2 * _in_channels(cfg) * R + stack_forward_products(cfg)
            + 2 * S * S + 2 * S * out)


def train_flops_per_sample(cfg: dict) -> int:
    return 3 * forward_flops_per_sample(cfg)


def weight_count(cfg: dict) -> int:
    """Weights of the products (biases excluded)."""
    return forward_flops_per_sample(cfg) // 2


def bias_count(cfg: dict) -> int:
    R, G, S = (cfg["residual_channels"], cfg["gate_channels"],
               cfg["skip_out_channels"])
    return R + cfg["layers"] * (G + R + S) + S + cfg["out_channels"]


def ring_rows(cfg: dict) -> int:
    """Past inputs a step-by-step decoder keeps: (k - 1) * dilation a layer."""
    per_stack = cfg["layers"] // cfg["stacks"]
    return sum((cfg["kernel_size"] - 1) * 2 ** (i % per_stack)
               for i in range(cfg["layers"]))


def generate_launch(cfg: dict, rows: int, steps: int) -> Dict[str, float]:
    """FLOPs and bytes that ``steps`` decoder steps of ``rows`` streams need
    with bf16 weights and state: weights, biases, the conditioning slice and
    the ring read once, the ring and the samples written once."""
    flops = forward_flops_per_sample(cfg) * rows * steps
    R, cin = cfg["residual_channels"], cfg["cin_channels"]
    nbytes = (weight_count(cfg) * BF16 + bias_count(cfg) * F32
              + rows * steps * cin * BF16
              + 2 * ring_rows(cfg) * rows * R * BF16
              + rows * steps * F32)
    return {"flops": float(flops), "bytes": float(nbytes)}


def stack_forward_step(cfg: dict, batch: int, steps: int) -> Dict[str, float]:
    """The training stack's forward over (batch, steps) in bf16: per layer
    its input, the conditioning and the weights read, its output and skip
    written."""
    n = batch * steps
    R, S, cin, L = (cfg["residual_channels"], cfg["skip_out_channels"],
                    cfg["cin_channels"], cfg["layers"])
    per_layer_w = layer_products_per_sample(cfg) // 2
    nbytes = L * (n * (R + cin) * BF16 + per_layer_w * BF16
                  + n * R * BF16 + n * S * F32)
    return {"flops": float(stack_forward_products(cfg) * n),
            "bytes": float(nbytes)}


def stack_backward_step(cfg: dict, batch: int, steps: int) -> Dict[str, float]:
    """The stack's backward: 2x the forward products; per layer the saved
    input, conditioning and output gradient read, the input gradient and
    the weight gradients written."""
    n = batch * steps
    R, S, cin, L = (cfg["residual_channels"], cfg["skip_out_channels"],
                    cfg["cin_channels"], cfg["layers"])
    per_layer_w = layer_products_per_sample(cfg) // 2
    nbytes = L * (n * (R + cin) * BF16 + n * (R + S) * F32
                  + per_layer_w * BF16 + n * R * F32 + per_layer_w * F32)
    return {"flops": float(2 * stack_forward_products(cfg) * n),
            "bytes": float(nbytes)}


def bound_seconds(work: Dict[str, float], peak: Dict[str, float],
                  dtype: str = "bf16") -> float:
    """The least time the card could take: the larger of operations over the
    product peak and bytes over the memory peak."""
    return max(work["flops"] / peak[dtype], work["bytes"] / peak["hbm"])
