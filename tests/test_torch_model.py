"""PyTorch port vs the JAX package: config/spec, weight conversion, upsample
nets and the non-fused batch forward.

Weights are made by the JAX package's ``init_wavenet`` from a seed and move
to the port through ``compat.from_jax.state_dict_from_jax``; inputs are numpy
arrays from a seeded RandomState. Both sides run in f32 on the CPU, so the
tolerance is f32 rounding over a few layers (atol 1e-5).
"""
import dataclasses
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wavenet_vocoder_tpu import config as jcfg
from wavenet_vocoder_tpu.compat.torch_import import params_from_state_dict
from wavenet_vocoder_tpu.models.wavenet import (
    WaveNetSpec as JaxSpec,
    apply_wavenet,
    init_wavenet,
    spec_from_config as jax_spec_from_config,
    upsample_conditioning,
)
from wavenet_vocoder_tpu.ops import mulaw as jmulaw

from wavenet_vocoder_tpu_torch import config as tcfg
from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
from wavenet_vocoder_tpu_torch.models.layers import remove_weight_norm
from wavenet_vocoder_tpu_torch.models.upsample import (
    ConvInUpsampleNetwork,
    UpsampleNetwork,
)
from wavenet_vocoder_tpu_torch.models.wavenet import (
    WaveNet,
    WaveNetSpec,
    spec_from_config,
)
from wavenet_vocoder_tpu_torch.ops import mulaw as tmulaw
from wavenet_vocoder_tpu_torch.ops.generate import generate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(glob.glob(os.path.join(ROOT, "egs", "*", "conf", "*.json")))
ATOL = 1e-5


def _pair(seed=0, **kw):
    """(JAX params as numpy, JAX spec, port model) on the same weights."""
    base = dict(out_channels=30, layers=4, stacks=2, residual_channels=8,
                gate_channels=16, skip_out_channels=8, cin_channels=4,
                scalar_input=True)
    base.update(kw)
    jspec, tspec = JaxSpec(**base), WaveNetSpec(**base)
    params = jax.tree.map(np.asarray, init_wavenet(jax.random.PRNGKey(seed), jspec))
    model = WaveNet(tspec)
    model.load_state_dict(state_dict_from_jax(params, tspec))
    return params, jspec, model.eval()


@pytest.mark.parametrize("preset", [None] + PRESETS,
                         ids=lambda p: "flagship" if p is None
                         else os.path.basename(p))
def test_spec_and_config_parity(preset):
    cj = jcfg.load_config(preset)
    ct = tcfg.load_config(preset)
    assert cj.values() == ct.values()
    sj, st = jax_spec_from_config(cj), spec_from_config(ct)
    # the port's spec drops the JAX package's remat knobs
    jax_fields = dataclasses.asdict(sj)
    for knob in ("remat", "remat_policy"):
        del jax_fields[knob]
    assert jax_fields == dataclasses.asdict(st)
    assert sj.dilations == st.dilations
    assert sj.receptive_field == st.receptive_field


def test_override_syntax_parity():
    overrides = "layers=6,stacks=3,upsample_params={'upsample_scales': [2, 8]}"
    cj = jcfg.load_config(overrides=overrides)
    ct = tcfg.load_config(overrides=overrides)
    assert cj.values() == ct.values()
    assert ct.upsample_scales == (2, 8)
    with pytest.raises(ValueError, match="Unknown config key"):
        tcfg.load_config(overrides="no_such_key=1")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(out_channels=256, scalar_input=False),
    dict(gin_channels=3, n_speakers=5, use_speaker_embedding=True),
    dict(upsample_conditional_features=True, upsample_scales=(2, 2), cin_pad=1),
    dict(upsample_conditional_features=True, upsample_net="UpsampleNetwork",
         upsample_scales=(2, 3), upsample_activation="LeakyReLU"),
], ids=["plain", "categorical", "speaker", "convin_upsample", "upsample_act"])
def test_state_dict_round_trip(kw):
    """port state_dict -> the JAX package's torch importer -> the JAX params."""
    params, jspec, model = _pair(**kw)
    back = params_from_state_dict(dict(model.state_dict()), jspec)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("net", ["ConvInUpsampleNetwork", "UpsampleNetwork"])
def test_upsample_parity(net):
    base = dict(cin_channels=5, upsample_conditional_features=True,
                upsample_net=net, upsample_scales=(2, 3),
                freq_axis_kernel_size=3, cin_pad=1)
    jspec, tspec = JaxSpec(**base), WaveNetSpec(**base)
    rs = np.random.RandomState(0)
    params = jax.tree.map(np.asarray, init_wavenet(jax.random.PRNGKey(1), jspec))
    # perturb the averaging init so the test sees the kernel layout
    params["upsample_net"] = jax.tree.map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32),
        params["upsample_net"])
    model = WaveNet(tspec)
    model.load_state_dict(state_dict_from_jax(params, tspec))
    assert isinstance(model.upsample_net, {
        "ConvInUpsampleNetwork": ConvInUpsampleNetwork,
        "UpsampleNetwork": UpsampleNetwork}[net])
    c = rs.randn(2, 7, 5).astype(np.float32)
    y_jax = np.asarray(upsample_conditioning(params, jspec, jnp.asarray(c)))
    with torch.no_grad():
        y = model.upsample_conditioning(torch.from_numpy(c)).numpy()
    assert y.shape == y_jax.shape
    np.testing.assert_allclose(y, y_jax, atol=ATOL)


FORWARD_CASES = {
    "no_cond": dict(cin_channels=-1),
    "local": dict(),
    "local_global": dict(gin_channels=3, n_speakers=5, use_speaker_embedding=True),
    "categorical": dict(out_channels=256, scalar_input=False),
    "upsampled": dict(upsample_conditional_features=True, upsample_scales=(2, 2),
                      cin_pad=1),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_parity(case):
    kw = FORWARD_CASES[case]
    params, jspec, model = _pair(seed=2, **kw)
    rs = np.random.RandomState(3)
    B, T = 2, 24
    if jspec.scalar_input:
        x = rs.uniform(-1, 1, (B, T, 1)).astype(np.float32)
    else:
        x = np.eye(jspec.out_channels, dtype=np.float32)[rs.randint(0, 256, (B, T))]
    c = None
    if jspec.has_local_conditioning:
        T_c = (T // 4 + 2) if jspec.upsample_conditional_features else T
        c = rs.randn(B, T_c, jspec.cin_channels).astype(np.float32)
    g = np.array([1, 4], np.int32) if jspec.has_global_conditioning else None
    y_jax = np.asarray(apply_wavenet(params, jspec, jnp.asarray(x),
                                     None if c is None else jnp.asarray(c),
                                     None if g is None else jnp.asarray(g)))
    with torch.no_grad():
        y = model(torch.from_numpy(x), None if c is None else torch.from_numpy(c),
                  None if g is None else torch.from_numpy(g)).numpy()
    assert y.shape == y_jax.shape == (B, T, jspec.out_channels)
    np.testing.assert_allclose(y, y_jax, atol=ATOL)


@pytest.mark.parametrize("case", ["local", "local_global", "categorical"])
def test_teacher_forced_step_equals_forward(case):
    """The eager decoder fed the true inputs equals the batch forward."""
    _, jspec, model = _pair(seed=4, **FORWARD_CASES[case])
    rs = np.random.RandomState(5)
    B, T = 2, 20
    if jspec.scalar_input:
        x = torch.from_numpy(rs.uniform(-1, 1, (B, T, 1)).astype(np.float32))
    else:
        x = torch.eye(256)[torch.from_numpy(rs.randint(0, 256, (B, T)))]
    c = torch.from_numpy(rs.randn(B, T, jspec.cin_channels).astype(np.float32))
    g = torch.tensor([0, 3]) if jspec.has_global_conditioning else None
    # step t sees input x[t-1]; the first step sees the default input
    shifted = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    if not jspec.scalar_input:
        shifted[:, 0, 127] = 1.0
    logits = generate(model, c=c, g=g, test_inputs=shifted,
                      output="logits")["logits"]
    with torch.no_grad():
        y = model(shifted, c, g)
    assert logits.shape == y.shape == (B, T, jspec.out_channels)
    np.testing.assert_allclose(logits.numpy(), y.numpy(), atol=1e-4)


def test_remove_weight_norm_keeps_forward():
    _, _, model = _pair(seed=6)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.uniform(-1, 1, (1, 16, 1)).astype(np.float32))
    c = torch.from_numpy(rs.randn(1, 16, 4).astype(np.float32))
    with torch.no_grad():
        before = model(x, c)
        remove_weight_norm(model)
        after = model(x, c)
    assert "first_conv.weight" in model.state_dict()
    assert "first_conv.weight_v" not in model.state_dict()
    np.testing.assert_allclose(after.numpy(), before.numpy(), atol=1e-6)


def test_mulaw_parity():
    x = np.linspace(-1, 1, 101).astype(np.float32)
    for mu in (255, 65535):
        np.testing.assert_allclose(tmulaw.mulaw(x, mu), jmulaw.mulaw(x, mu), atol=1e-6)
        q = tmulaw.mulaw_quantize(x, mu)
        np.testing.assert_array_equal(q, jmulaw.mulaw_quantize(x, mu))
        np.testing.assert_allclose(tmulaw.inv_mulaw_quantize(q, mu),
                                   jmulaw.inv_mulaw_quantize(q, mu), atol=1e-6)
        # the torch path computes the same values as the numpy path
        qt = tmulaw.mulaw_quantize(torch.from_numpy(x), mu)
        np.testing.assert_array_equal(qt.numpy(), q)
        np.testing.assert_allclose(
            tmulaw.inv_mulaw(torch.from_numpy(x), mu).numpy(),
            tmulaw.inv_mulaw(x, mu), atol=1e-6)
