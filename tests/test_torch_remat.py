"""Remat in the port's plain layer loop (``WaveNetSpec.remat`` /
``remat_policy``, models/wavenet.py), on the CPU.

* With remat on (whole recompute, and "dots") and dropout 0.3, the loss is
  bitwise the loss without it and every gradient agrees within 1e-6 of its
  largest value: the dropout mask is a counter hash of (seed, row, time,
  layer, channel), so the recomputation draws it again.
* "dots" keeps the products' outputs: counted by a ``TorchDispatchMode``,
  the backward of a whole recompute runs every block's dilated
  convolution (``aten.convolution``) again, the backward under "dots" and
  without remat runs none.
* The fused path ignores remat, as the JAX package returns before its loop.
* Against the JAX package's ``jax.checkpoint`` loop at dropout 0: loss
  within 1e-5 relative and gradients within 1e-4 of their largest value
  (one-hot input).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.models.wavenet import (
    apply_wavenet,
    init_wavenet,
    spec_from_config as jax_spec_from_config,
)

from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config

torch.set_num_threads(1)

SMALL = dict(input_type="raw", out_channels=30, layers=4, stacks=2,
             residual_channels=16, gate_channels=32, skip_out_channels=24,
             cin_channels=8, upsample_conditional_features=False,
             dropout=0.3)


def _inputs(B=2, T=80, seed=0):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.uniform(-0.5, 0.5, (B, T, 1))
                             .astype(np.float32)),
            torch.from_numpy(rs.randn(B, T, 8).astype(np.float32)))


def _loss_and_grads(spec, x, c, seed=1234, train=True):
    model = WaveNet(spec, generator=torch.Generator().manual_seed(0))
    y = model(x, c, train=train, seed=seed)
    loss = (y * y).mean()
    loss.backward()
    # the last block's residual output reaches nothing: no gradient
    return loss.detach(), {n: torch.zeros_like(p) if p.grad is None
                           else p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["", "dots"])
def test_remat_equals_no_remat_with_dropout(policy):
    spec = spec_from_config(Config(**SMALL))
    x, c = _inputs()
    ref_loss, ref = _loss_and_grads(spec, x, c)
    loss, got = _loss_and_grads(
        dataclasses.replace(spec, remat=True, remat_policy=policy), x, c)
    assert torch.equal(loss, ref_loss)
    for n, g in ref.items():
        scale = float(g.abs().max())
        assert float((got[n] - g).abs().max()) <= 1e-6 * max(scale, 1e-30), n
    # the dropout was on: another seed gives another loss
    other, _ = _loss_and_grads(spec, x, c, seed=99)
    assert not torch.equal(other, ref_loss)


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat,policy,want", [
    (False, "", 0), (True, "", 4), (True, "dots", 0)])
def test_dots_policy_does_not_rerun_the_products(remat, policy, want):
    spec = dataclasses.replace(spec_from_config(Config(**SMALL)), remat=remat,
                               remat_policy=policy)
    model = WaveNet(spec, generator=torch.Generator().manual_seed(0))
    x, c = _inputs()
    counter = _CountConvs()
    with counter:
        y = model(x, c, train=True, seed=7)
    assert counter.n == spec.layers       # one dilated conv per block
    loss = (y * y).mean()
    counter = _CountConvs()
    with counter:
        loss.backward()
    assert counter.n == want


def test_fused_path_ignores_remat():
    spec = spec_from_config(Config(**SMALL, fused_train=True))
    x, c = _inputs()
    ref_loss, ref = _loss_and_grads(spec, x, c)
    loss, got = _loss_and_grads(dataclasses.replace(spec, remat=True), x, c)
    assert torch.equal(loss, ref_loss)
    for n, g in ref.items():
        assert torch.equal(got[n], g), n


@pytest.mark.parametrize("policy", ["", "dots"])
def test_remat_matches_jax_checkpoint(policy):
    # one-hot input: a scalar input's first_conv.weight_v has one element
    # an output channel, whose gradient weight norm projects out (rounding
    # noise, ~1e-9, on either side)
    kw = dict(SMALL, dropout=0.0, remat=True, remat_policy=policy,
              input_type="mulaw-quantize", quantize_channels=64,
              out_channels=64)
    jspec = jax_spec_from_config(JaxConfig(**kw))
    params = init_wavenet(jax.random.PRNGKey(0), jspec)
    _, c = _inputs()
    ids = np.random.RandomState(5).randint(0, 64, (2, 80))
    x = torch.from_numpy(np.eye(64, dtype=np.float32)[ids])

    def jloss(p):
        y = apply_wavenet(p, jspec, jnp.asarray(x.numpy()),
                          c=jnp.asarray(c.numpy()), train=True)
        return jnp.mean(y * y)

    want_loss, jgrads = jax.value_and_grad(jloss)(params)
    spec = spec_from_config(Config(**kw))
    model = WaveNet(spec)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), spec))
    y = model(x, c, train=True)
    loss = (y * y).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads), spec)
    for n, p in model.named_parameters():
        w = want[n].numpy()
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.abs(got - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), n
