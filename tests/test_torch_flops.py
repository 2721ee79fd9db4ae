"""The port's FLOP accounting (utils/flops.py) against the JAX package's.

The analytic counts must be the JAX package's integers for the same config
(the bench's three models and the demo presets), and must account for the
matmul core of the port's plain forward as torch's FlopCounterMode counts it
(the bounds of tests/test_flops.py: analytic <= 1.05x and >= 0.5x of the
counted total). The peaks are NVIDIA's data-sheet dense rates by card name.
"""
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.config import load_config as jax_load_config
from wavenet_vocoder_tpu.models.wavenet import (
    spec_from_config as jax_spec_from_config,
)
from wavenet_vocoder_tpu.utils import flops as jfl

from wavenet_vocoder_tpu_torch.bench import MODELS
from wavenet_vocoder_tpu_torch.config import Config, load_config
from wavenet_vocoder_tpu_torch.models.wavenet import (
    WaveNet,
    WaveNetSpec,
    spec_from_config,
)
from wavenet_vocoder_tpu_torch.utils import flops as fl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = [os.path.join(ROOT, "egs", name, "conf", f"{name}_wavenet_demo.json")
         for name in ("mol", "gaussian", "mulaw256")]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_counts_equal_jax_for_the_bench_models(model):
    spec = spec_from_config(Config(**MODELS[model]))
    jspec = jax_spec_from_config(JaxConfig(**MODELS[model]))
    assert fl.forward_flops_per_sample(spec) == \
        jfl.forward_flops_per_sample(jspec)
    assert fl.train_flops_per_sample(spec) == \
        jfl.train_flops_per_sample(jspec)


@pytest.mark.parametrize("path", DEMOS, ids=os.path.basename)
def test_counts_equal_jax_for_the_demo_presets(path):
    spec = spec_from_config(load_config(path))
    jspec = jax_spec_from_config(jax_load_config(path))
    assert fl.forward_flops_per_sample(spec) == \
        jfl.forward_flops_per_sample(jspec)
    assert fl.train_flops_per_sample(spec) == \
        jfl.train_flops_per_sample(jspec)


def test_flagship_counts():
    spec = spec_from_config(Config())
    assert fl.forward_flops_per_sample(spec) == 7_315_200
    assert fl.train_flops_per_sample(spec) == 3 * 7_315_200


def test_analytic_matches_counted_forward():
    """The analytic count against FlopCounterMode over the plain forward
    (the same small spec and bounds as tests/test_flops.py)."""
    spec = WaveNetSpec(out_channels=64, layers=4, stacks=2,
                       residual_channels=16, gate_channels=32,
                       skip_out_channels=16, cin_channels=8,
                       scalar_input=False,
                       upsample_conditional_features=False)
    model = WaveNet(spec, generator=torch.Generator().manual_seed(0)).eval()
    B, T = 2, 256
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(B, T, spec.in_channels).astype(np.float32))
    c = torch.as_tensor(rs.randn(B, T, 8).astype(np.float32))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, c)
    counted = counter.get_total_flops()
    analytic = fl.forward_flops_per_sample(spec) * B * T
    assert counted > 0
    assert analytic <= counted * 1.05, (analytic, counted)
    assert analytic >= 0.5 * counted, (analytic, counted)


@pytest.mark.parametrize("name,bf16,hbm", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
    ("NVIDIA H100 SXM5 80GB", 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
])
def test_h100_peaks(name, bf16, hbm):
    assert fl.device_peak_flops(name) == bf16
    assert fl.device_peak_hbm_bw(name) == hbm
    peaks = fl.device_peaks(name)
    assert peaks["bf16"] == bf16 and peaks["hbm"] == hbm
    assert peaks["tf32"] == pytest.approx(bf16 / 2, rel=0.01)  # half bf16
    assert 0 < peaks["fp32"] < peaks["tf32"]


def test_unknown_card_is_none():
    assert fl.device_peaks("Quantum Abacus 9000") is None
    assert fl.device_peak_flops("Quantum Abacus 9000") is None
    assert fl.device_peak_hbm_bw("Quantum Abacus 9000") is None


def test_sxm_table_is_chip_smokes():
    """chip_smoke.py states its bounds against the SXM part's rates."""
    assert fl.H100_SXM == fl.device_peaks("NVIDIA H100 80GB HBM3")
    assert fl.H100_SXM == {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12,
                           "hbm": 3.35e12}
