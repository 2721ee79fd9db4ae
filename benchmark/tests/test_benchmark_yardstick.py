"""The frozen yardstick equals the program's own FLOP counts and peak table
today, for both configurations."""
import json

import pytest

from benchmark import harness, yardstick
from benchmark.tests import tiny
from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
from wavenet_vocoder_tpu_torch.utils import flops


@pytest.mark.parametrize("config,per_sample", [("flagship", 7_315_200),
                                               ("512ch", 49_299_456)])
def test_counts_equal_the_programs(config, per_sample):
    keys = {k: v for k, v in
            json.load(open(harness.ROOT / f"benchmark/configs/{config}.json")
                      ).items() if k not in harness.CONFIG_META}
    spec = spec_from_config(harness.port_config(keys))
    assert yardstick.forward_flops_per_sample(keys) == per_sample
    assert yardstick.forward_flops_per_sample(keys) == \
        flops.forward_flops_per_sample(spec)
    assert yardstick.train_flops_per_sample(keys) == \
        flops.train_flops_per_sample(spec)


def test_training_bounds_count_no_recompute():
    keys = tiny.load_cell("train.flagship.b32").model_keys()
    fwd = yardstick.stack_forward_step(keys, 8, 10240)["flops"]
    bwd = yardstick.stack_backward_step(keys, 8, 10240)["flops"]
    assert round(fwd / 1e12, 3) == 0.596 and bwd == 2 * fwd


def test_peaks_equal_the_programs():
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB"):
        assert yardstick.peaks(name) == flops.device_peaks(name)
    assert yardstick.peaks("NVIDIA H100 PCIe") is None
    assert yardstick.H100_SXM_POWER_W == 700.0


def test_generate_launch_bound_is_the_products():
    keys = harness.load_cell("synth.flagship.b256").model_keys()
    work = yardstick.generate_launch(keys, 256, 256)
    t = yardstick.bound_seconds(work, yardstick.H100_SXM)
    assert abs(t * 1e3 - 0.4847) < 1e-3          # 479.4 GFLOP at 989 TFLOP/s
