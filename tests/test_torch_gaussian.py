"""r9y9's Gaussian recipe (``egs/gaussian/conf/gaussian_wavenet.json``) on
the port, on the CPU: the plain version of the generation kernel, through
``FusedGenerator`` with the mel upsampled by the model's own net, against
the benchmark's plain reference at the recipe's structure, and its sampler
(the clipped mean when greedy, Box-Muller's draw when sampled) against the
reference's ``gaussian_candidates``.

The kernel itself (its 2-column head, the Box-Muller draw in every CTA)
runs on a GPU: ``tests/test_torch_kernels.py``.
"""
import json
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.reference import wavenet as ref
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg

torch.set_num_threads(1)

EGS = Path(__file__).resolve().parent.parent / "egs"
RECIPE = json.loads((EGS / "gaussian/conf/gaussian_wavenet.json").read_text())
# the recipe's structure (24 layers in 4 stacks, 80 mels through the 4x4x4x4
# upsample net, a [mean, log_std] head) at residual/gate/skip widths cut for
# the CPU
KEYS = dict(RECIPE, residual_channels=8, gate_channels=16, skip_out_channels=8)
SEED = 2 ** 31 + 77          # the sampler's seed: past 32 bits, masked
# f32 on both sides. The port folds weight norm once, packs [taps | cond]
# into one product and sums in its own order; the reference convolves layer
# by layer, and the two upsample nets round their convolutions apart. Over
# 24 layers that is ~1e-6 on head outputs up to ~3 here (at most 1.9e-6
# over four seeds, greedy and sampled); bf16 products, the precision below
# the packs', move them by 7e-3 to 2.5e-2 (the last test holds that this
# tolerance sees them).
HEAD_ATOL = 2e-5


def _model_and_mel(seed):
    weights = harness.make_weights(KEYS, seed, "cpu")
    model = harness.build_model(harness.port_config(KEYS), weights, "cpu")
    spec = model.spec
    assert (spec.layers, spec.stacks, spec.in_channels, spec.out_channels,
            spec.cin_channels, spec.output_distribution) == (
                24, 4, 1, 2, 80, "Normal")
    assert cg.head_code(spec) == 2 and not cg.split_head(spec)
    # two frames a row, with cin_pad context frames on each side: 512 steps,
    # past the 505-sample receptive field
    mel = torch.randn(2, 2 + 2 * KEYS["cin_pad"], 80,
                      generator=torch.Generator().manual_seed(seed + 1))
    return weights, model, mel


def _served(monkeypatch, model, mel, deterministic, dtype=torch.float32):
    """(samples (B, T), head outputs (B, T, 2)) of one ``FusedGenerator``
    call on the CPU (the kernel's plain version), the head's outputs kept
    as the sampler received them."""
    outs, sample = [], cg._sample

    def keep(spec, o, keys, det):
        outs.append(o.clone())
        return sample(spec, o, keys, det)

    monkeypatch.setattr(cg, "_sample", keep)
    gen = cg.FusedGenerator(model, weight_dtype=dtype, chunk=64)
    x = gen(c=mel, deterministic=deterministic, seed=SEED)
    return x, torch.stack(outs, dim=1)


def _reference(weights, mel, x):
    """The reference's head outputs teacher-forced over the served samples
    (the input before step 0 is 0, ``default_initial_input``)."""
    c = ref.conditioning(weights, KEYS, mel)
    assert c.shape[1] == x.shape[1]
    prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return ref.forward(weights, KEYS, prev[..., None], c)


@pytest.mark.parametrize("deterministic", [True, False],
                         ids=["greedy", "sampled"])
def test_plain_path_holds_against_the_reference_at_the_recipes_structure(
        monkeypatch, deterministic):
    """At every step of a greedy or a sampled call, the head's mean and
    log-std equal the reference's teacher-forced forward over the samples
    the call served, within ``HEAD_ATOL``; greedy serves the clipped mean."""
    weights, model, mel = _model_and_mel(20261)
    x, o = _served(monkeypatch, model, mel, deterministic)
    assert x.shape == (2, 512) and o.shape == (2, 512, 2)
    o_ref = _reference(weights, mel, x)
    torch.testing.assert_close(o[..., 0], o_ref[..., 0], rtol=0,
                               atol=HEAD_ATOL)          # mean
    torch.testing.assert_close(o[..., 1], o_ref[..., 1], rtol=0,
                               atol=HEAD_ATOL)          # log-std
    assert float(o[..., 0].std()) > 0.05           # not one stuck output
    if deterministic:
        assert torch.equal(x, o[..., 0].clamp(-1.0, 1.0))
        torch.testing.assert_close(
            x, ref.gaussian_candidates(o_ref)[1][..., 0], rtol=0,
            atol=HEAD_ATOL)


def test_served_draw_is_the_references_clipped_draw(monkeypatch):
    """Given the head's outputs and the same step keys (the request's seed,
    the stream row, the step), the served sample is the reference's
    Box-Muller draw clip(mean + exp(log_std) z), draws 0 and 1 of the
    counter hash: the two agree to 1e-6 (f32 transcendentals of two
    libraries' orders); some steps are inside (-1, 1), so the clip does not
    decide every step."""
    _, model, mel = _model_and_mel(20262)
    x, o = _served(monkeypatch, model, mel, False)
    B, T = x.shape
    assert ref.draws(KEYS) == 2
    u = torch.stack([ref.counter_uniforms(SEED, r, 0, T, 2)
                     for r in range(B)])
    score, value = ref.gaussian_candidates(o, u)
    assert value.shape == (B, T, 1) and score.shape == (B, T, 1)
    torch.testing.assert_close(x, value[..., 0], rtol=0, atol=1e-6)
    inside = (x.abs() < 1.0).float().mean()
    assert 0.05 < float(inside)
    # the draw is not the mean: the sampled steps moved off it
    assert float((x - o[..., 0].clamp(-1.0, 1.0)).abs().max()) > 0.1


def test_bf16_products_fail_the_tolerance(monkeypatch):
    """The same comparison with bf16 packs (products' inputs rounded to
    bf16, as the kernel's bf16 instance rounds them) leaves ``HEAD_ATOL``
    far behind: the tolerance sees a precision below the configuration's
    f32 reference."""
    weights, model, mel = _model_and_mel(20261)
    x, o = _served(monkeypatch, model, mel, True, dtype=torch.bfloat16)
    o_ref = _reference(weights, mel, x)
    gap = float((o - o_ref).abs().max())
    assert gap > 10 * HEAD_ATOL, gap
