"""The port's optax optimizers (training/optimizers.py, through
``make_optimizer``) against optax itself, through the JAX package's
``make_optimizer`` (its name table and the clip), on the CPU.

The same gradients (numpy, from a seed) go to both sides for 3 steps, at a
learning rate of 0.05, so that the parameters move by ~1e-2 a step; every
parameter must agree within 1e-6 of its largest value (f32). The tensors
cover what the updates treat apart:

* ``conv`` (256, 128, 3) in the port's layout, (3, 128, 256) in JAX's: the
  two largest axes are both at least 128, so Adafactor factors it, and the
  port must pick JAX's axes through the transpose;
* ``sq`` (128, 128, 1): factored with a tie, broken by JAX's axis order;
* ``embed`` (128, 128): a speaker embedding, in the same order in both
  packages, factored with the tie broken the other way round;
* ``small`` (6, 4, 3) with ``weight_g`` and ``bias``: not factored;
* ``zero``: a bias whose gradient is 0 (Lamb's trust ratio falls back to
  1, Adagrad's accumulator keeps its start, Adafactor's update is 0).

Variants per optimizer: weight decay 0.01 with a clip of 0.5 (Adamax,
NAdam and RAdam ignore the decay in the JAX table, RMSprop and Adagrad
chain it before the core, Lamb applies it inside; Adafactor ignores it),
and neither; RMSprop also centered with momentum. A resume test runs 2
steps, a checkpoint through ``training/checkpoint.py`` and 2 more, against
4 steps without one, bit for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from torch import nn

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.training.train_state import (
    make_optimizer as jax_make_optimizer,
)

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.training import optimizers
from wavenet_vocoder_tpu_torch.training.train_state import (
    clip_by_global_norm,
    make_optimizer,
)

torch.set_num_threads(1)

NEW = ("Adamax", "NAdam", "RAdam", "RMSprop", "Adagrad", "Lamb", "Adafactor")
STEPS = 3


class _Params(nn.Module):
    """The tensors of the module docstring, in the port's layouts."""

    def __init__(self, rs):
        super().__init__()
        mk = lambda *s: nn.Parameter(torch.from_numpy(
            rs.randn(*s).astype(np.float32)))
        self.conv_v = mk(256, 128, 3)
        self.sq_v = mk(128, 128, 1)
        self.embed = nn.Embedding(128, 128)
        with torch.no_grad():
            self.embed.weight.copy_(mk(128, 128))
        self.small_v = mk(6, 4, 3)
        self.small_g = mk(6, 1, 1)
        self.small_b = mk(6)
        self.zero_b = mk(5)


def _to_jax(name, a):
    """Port layout -> JAX layout (conv kernels reversed, g squeezed)."""
    if name.endswith("_v"):
        return a.T
    if name.endswith("_g"):
        return a.reshape(-1)
    return a


def _from_jax(name, a, shape):
    return (a.T if name.endswith("_v") else a).reshape(shape)


def _grads(module, rs):
    out = {}
    for n, p in module.named_parameters():
        g = rs.randn(*p.shape).astype(np.float32) * rs.uniform(0.01, 1.0)
        out[n] = np.zeros_like(g) if n == "zero_b" else g
    return out


CASES = {}
for _name in NEW:
    CASES[f"{_name}-plain"] = dict(optimizer=_name, clip_thresh=0.0,
                                   optimizer_params={"lr": 0.05})
    CASES[f"{_name}-decay-clip"] = dict(
        optimizer=_name, clip_thresh=0.5,
        optimizer_params={"lr": 0.05, "weight_decay": 0.01})
CASES["RMSprop-centered-momentum"] = dict(
    optimizer="RMSprop", clip_thresh=0.0,
    optimizer_params={"lr": 0.05, "centered": True, "momentum": 0.9,
                      "alpha": 0.9, "eps": 1e-6})


def _run_port(kw, module, grads_by_step):
    cfg = Config(lr_schedule="", **kw)
    opt, schedule = make_optimizer(cfg, module)
    params = [p for g in opt.param_groups for p in g["params"]]
    names = {id(p): n for n, p in module.named_parameters()}
    for i, grads in enumerate(grads_by_step):
        for p in params:
            p.grad = torch.from_numpy(grads[names[id(p)]].copy())
        clip_by_global_norm([p.grad for p in params], cfg.clip_thresh)
        for g in opt.param_groups:
            g["lr"] = schedule(i)
        opt.step()
    return opt


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax(case):
    kw = CASES[case]
    rs = np.random.RandomState(0)
    module = _Params(rs)
    init = {n: p.detach().numpy().copy() for n, p in module.named_parameters()}
    grads_by_step = [_grads(module, rs) for _ in range(STEPS)]
    tx, _ = jax_make_optimizer(JaxConfig(lr_schedule="", **kw))
    jparams = {n: jnp.asarray(_to_jax(n, a)) for n, a in init.items()}
    jstate = tx.init(jparams)
    for grads in grads_by_step:
        jg = {n: jnp.asarray(_to_jax(n, a)) for n, a in grads.items()}
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    opt = _run_port(kw, module, grads_by_step)
    assert type(opt).__name__ == kw["optimizer"]
    moved = 0.0
    for n, p in module.named_parameters():
        want = _from_jax(n, np.asarray(jparams[n]), p.shape)
        got = p.detach().numpy()
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= 1e-6 * scale, (n, err, scale)
        if n != "zero_b":
            assert np.abs(want - init[n]).max() > 0, n
            moved = max(moved, np.abs(want - init[n]).max())
    assert moved > 1e-4


@pytest.mark.parametrize("shape,same,dims", [
    ((256, 128, 3), False, (1, 0)), ((128, 128, 1), False, (1, 0)),
    ((128, 128), True, (0, 1)), ((128, 128), False, (1, 0)),
    ((6, 4, 3), False, None), ((300, 127, 1), False, None),
    ((256,), False, None)])
def test_factored_dims_follow_the_jax_layout(shape, same, dims):
    """Port axes of optax's (second largest, largest) JAX axes."""
    assert optimizers.factored_dims(shape, same) == dims
    if dims is not None:
        jax_shape = shape if same else shape[::-1]
        order = np.argsort(jax_shape)
        n = len(shape)
        want = tuple(int(a) if same else n - 1 - int(a) for a in order[-2:])
        assert dims == want


def test_flagship_conv_and_cond_weights_are_factored():
    """At the flagship widths every weight_v of a residual block but the
    80-channel cond_c (the dilated conv (256, 128, 3), out and skip
    (128, 128, 1)) is factored; weight_g and biases are not."""
    from wavenet_vocoder_tpu_torch.models.wavenet import (
        WaveNet, spec_from_config)
    model = WaveNet(spec_from_config(Config()))
    blk = model.conv_layers[0]
    f = lambda p: optimizers.factored_dims(p.shape, False)
    assert f(blk.conv.weight_v) == (1, 0)
    assert f(blk.conv1x1_out.weight_v) == (1, 0)
    assert f(blk.conv1x1_skip.weight_v) == (1, 0)
    assert f(blk.conv1x1c.weight_v) is None
    assert f(blk.conv.weight_g) is None and f(blk.conv.bias) is None


@pytest.mark.parametrize("name", NEW)
def test_optimizer_resumes_from_a_checkpoint_exactly(name, tmp_path):
    """2 steps, save_checkpoint, a fresh state of another init loads it, 2
    more steps: every parameter and the optimizer's state equal 4 steps
    taken without the checkpoint, bit for bit."""
    from wavenet_vocoder_tpu_torch.models.wavenet import (
        WaveNet, spec_from_config)
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    cfg = Config(input_type="mulaw-quantize", quantize_channels=64,
                 out_channels=64, layers=2, stacks=1, residual_channels=8,
                 gate_channels=16, skip_out_channels=8, cin_channels=-1,
                 upsample_conditional_features=False, dropout=0.0,
                 compute_dtype="", lr_schedule="", optimizer=name,
                 clip_thresh=1.0,
                 optimizer_params={"lr": 1e-2, "weight_decay": 1e-3})
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 64, (2, 40))
    batch = {"x": np.eye(64, dtype=np.float32)[ids], "y": ids.astype(np.int32),
             "input_lengths": np.asarray([40, 33], np.int32)}
    spec = spec_from_config(cfg)
    fresh = lambda seed: create_train_state(cfg, model=WaveNet(
        spec, generator=torch.Generator().manual_seed(seed)), device="cpu")
    step, _ = make_train_step(cfg)
    straight = fresh(0)
    for _ in range(4):
        step(straight, batch)
    resumed = fresh(0)
    for _ in range(2):
        step(resumed, batch)
    ckpt.save_checkpoint(str(tmp_path), resumed, global_step=2)
    resumed = fresh(1)
    ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path)), resumed)
    assert resumed.step == 2
    for _ in range(2):
        step(resumed, batch)
    for (n, a), b in zip(straight.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(a, b), n
    sa = straight.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    assert sorted(sa) == sorted(sb)
    for i in sa:
        assert sorted(sa[i]) == sorted(sb[i])
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]),
                               torch.as_tensor(sb[i][k])), (i, k)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        make_optimizer(Config(optimizer="Rprop"),
                       [nn.Parameter(torch.zeros(2))])
