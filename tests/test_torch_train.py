"""PyTorch port vs the JAX package: losses, the fused training stack and the
train step, on the CPU.

Inputs come from seeded numpy RandomStates and go to both packages; weights
are made by the JAX package's ``init_wavenet`` and move to the port through
``compat.from_jax.state_dict_from_jax``. On the CPU the port's fused stack
runs its plain PyTorch forward and backward; the JAX side runs its Pallas
kernels in interpret mode, as tests/test_pallas_train.py does. Both sides
compute in f32, so the tolerances are f32 summation-order noise:
  * losses: rtol 1e-5 (atol 1e-5 on per-element values);
  * the stack: skips atol 2e-5 / rtol 1e-5, gradients atol 3e-4 / rtol 2e-4
    (the tolerances of tests/test_pallas_train.py);
  * the train step: loss rtol 1e-5, parameters and EMA atol 4e-4 (Adam
    divides by sqrt(nu) + eps, which amplifies summation-order noise).
The dropout mask is compared bit for bit.

The CUDA kernels themselves run only on a GPU: tests/test_torch_kernels.py
holds them against the plain versions there.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.models.wavenet import (
    WaveNetSpec as JaxSpec,
    apply_wavenet,
    init_wavenet,
    make_generation_fast as jax_make_generation_fast,
)
from wavenet_vocoder_tpu.ops import losses as jlosses
from wavenet_vocoder_tpu.ops import mixture as jmix
from wavenet_vocoder_tpu.ops import pallas_train as pt
from wavenet_vocoder_tpu.training import lrschedule as jlr
from wavenet_vocoder_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)

from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.layers import remove_weight_norm
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
from wavenet_vocoder_tpu_torch.ops import fused_train as ft
from wavenet_vocoder_tpu_torch.ops import losses as tlosses
from wavenet_vocoder_tpu_torch.ops import mixture as tmix
from wavenet_vocoder_tpu_torch.training import lrschedule as tlr
from wavenet_vocoder_tpu_torch.training.train_state import (
    _UNMAPPED,
    create_train_state,
    make_optimizer,
    make_train_step,
)

torch.set_num_threads(1)

STACK = dict(out_channels=64, layers=4, stacks=2, residual_channels=16,
             gate_channels=32, skip_out_channels=24, cin_channels=8,
             scalar_input=True, output_distribution="Logistic")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------
def _mol_inputs(nr_mix=10, B=2, T=64, seed=0):
    rs = np.random.RandomState(seed)
    y_hat = rs.randn(B, T, 3 * nr_mix).astype(np.float32) * 2.0
    # log scales down to -20: below the -16 and -7 floors, so the clamp acts
    y_hat[..., 2 * nr_mix:] = rs.uniform(-20.0, 1.0, (B, T, nr_mix))
    y = rs.uniform(-1.0, 1.0, (B, T, 1)).astype(np.float32)
    y[0, :4, 0] = [-1.0, 1.0, -0.9995, 0.9995]      # the end bins
    y[1, :8, 0] = y_hat[1, :8, nr_mix]              # at a mean: cdf_delta path
    mask = (rs.rand(B, T, 1) > 0.2).astype(np.float32)
    return y_hat, y, mask


@pytest.mark.parametrize("log_scale_min", [-16.0, -7.0])
@pytest.mark.parametrize("num_classes", [256, 65536])
def test_mol_loss_matches_jax(num_classes, log_scale_min):
    y_hat, y, mask = _mol_inputs()
    want = jmix.discretized_mix_logistic_loss(
        jnp.asarray(y_hat), jnp.asarray(y), num_classes=num_classes,
        log_scale_min=log_scale_min, reduce=False)
    got = tmix.discretized_mix_logistic_loss(
        _t(y_hat), _t(y), num_classes=num_classes,
        log_scale_min=log_scale_min, reduce=False)
    assert got.shape == want.shape
    _close(got, want, 1e-5, 1e-5)
    _close(tlosses.masked_mol_loss(_t(y_hat), _t(y), _t(mask),
                                   num_classes=num_classes,
                                   log_scale_min=log_scale_min),
           jlosses.masked_mol_loss(jnp.asarray(y_hat), jnp.asarray(y),
                                   jnp.asarray(mask), num_classes=num_classes,
                                   log_scale_min=log_scale_min), 1e-5, 0)


def test_mol_loss_gradient_matches_jax():
    y_hat, y, mask = _mol_inputs(seed=1)
    want = jax.grad(lambda a: jlosses.masked_mol_loss(
        a, jnp.asarray(y), jnp.asarray(mask)))(jnp.asarray(y_hat))
    yt = _t(y_hat).requires_grad_()
    tlosses.masked_mol_loss(yt, _t(y), _t(mask)).backward()
    # at 65536 classes cdf_delta is a difference of two close sigmoids, so
    # f32 noise in it reaches ~1e-4 of the largest gradient
    _close(yt.grad, want, 1e-3, 5e-5)


@pytest.mark.parametrize("C", [2, 30])
def test_gaussian_loss_matches_jax(C):
    rs = np.random.RandomState(C)
    y_hat = rs.randn(2, 48, C).astype(np.float32)
    y_hat[..., -1] -= 3.0                   # some log scales below -7
    y = rs.uniform(-1, 1, (2, 48, 1)).astype(np.float32)
    mask = (rs.rand(2, 48, 1) > 0.3).astype(np.float32)
    want = jmix.mix_gaussian_loss(jnp.asarray(y_hat), jnp.asarray(y),
                                  log_scale_min=-7.0, reduce=False)
    got = tmix.mix_gaussian_loss(_t(y_hat), _t(y), log_scale_min=-7.0,
                                 reduce=False)
    assert got.shape == want.shape
    _close(got, want, 1e-5, 1e-5)
    _close(tlosses.masked_gaussian_loss(_t(y_hat), _t(y), _t(mask)),
           jlosses.masked_gaussian_loss(jnp.asarray(y_hat), jnp.asarray(y),
                                        jnp.asarray(mask)), 1e-5, 0)


@pytest.mark.parametrize("with_mask", [True, False])
def test_cross_entropy_matches_jax(with_mask):
    rs = np.random.RandomState(5)
    logits = rs.randn(2, 40, 256).astype(np.float32) * 3
    y = rs.randint(0, 256, (2, 40))
    mask = (rs.rand(2, 40, 1) > 0.25).astype(np.float32)
    jm = jnp.asarray(mask) if with_mask else None
    tm = _t(mask) if with_mask else None
    _close(tlosses.masked_cross_entropy(_t(logits), torch.from_numpy(y), tm),
           jlosses.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(y),
                                        jm), 1e-5, 0)


def test_sequence_mask_matches_jax():
    lengths = np.array([0, 5, 17, 20])
    _close(tlosses.sequence_mask(torch.from_numpy(lengths), 20),
           jlosses.sequence_mask(jnp.asarray(lengths), 20), 0, 0)


# ----------------------------------------------------------------------
# the dropout mask
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1234, -1, -2 ** 31, 2 ** 31 - 1, -987654])
def test_dropout_mask_bits_match_jax(seed):
    for b0, t0, l, keep in ((0, 0, 0, 0.7), (3, 504, 5, 0.95),
                            (1, 10000, 23, 0.5)):
        want = pt.dropout_mask(jnp.asarray(seed, jnp.int32), Bt=3, E=40,
                               R=16, L=24, l=l, b0=b0, t0=t0, keep=keep)
        got = ft.dropout_mask(seed, B=3, T=40, R=16, L=24, l=l, b0=b0,
                              t0=t0, keep=keep)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0.0 < float(got.mean()) < 1.0


# ----------------------------------------------------------------------
# the fused stack: plain version vs the JAX kernels (interpret mode)
# ----------------------------------------------------------------------
def _stack_setup(*, cond, glob, T, seed=0):
    kw = dict(STACK)
    if not cond:
        kw["cin_channels"] = -1
    if glob:
        kw.update(gin_channels=6, use_speaker_embedding=False)
    jspec, tspec = JaxSpec(**kw), WaveNetSpec(**kw)
    params = jax.tree.map(np.asarray,
                          init_wavenet(jax.random.PRNGKey(seed), jspec))
    model = WaveNet(tspec)
    model.load_state_dict(state_dict_from_jax(params, tspec))
    remove_weight_norm(model)          # gradients w.r.t. the folded weights
    blocks = jax_make_generation_fast(jax.tree.map(jnp.asarray, params))["blocks"]
    rs = np.random.RandomState(seed + 1)
    B = 2
    x0 = rs.randn(B, T, 16).astype(np.float32)
    c = rs.randn(B, T, 8).astype(np.float32) if cond else None
    g = rs.randn(B, 6).astype(np.float32) if glob else None
    w = rs.randn(B, T, 24).astype(np.float32)
    return jspec, tspec, model, blocks, x0, c, g, w


STACK_CASES = [  # (local cond, global cond, dropout, T)
    (True, False, 0.0, 96), (True, False, 0.3, 100), (False, False, 0.0, 100),
    (False, True, 0.3, 96), (True, True, 0.0, 100), (True, True, 0.3, 96)]


@pytest.mark.parametrize("cond,glob,drop,T", STACK_CASES)
def test_fused_stack_matches_jax(cond, glob, drop, T):
    """Skips and the gradients of sum(skips * w) w.r.t. x0, c, g and every
    block weight: the port's plain forward/backward through FusedResStack
    against pt.fused_res_stack(interpret=True)."""
    jspec, tspec, model, blocks, x0, c, g, w = _stack_setup(
        cond=cond, glob=glob, T=T)
    seed = 1234
    jseed = jnp.full((1, 1), seed, jnp.int32)

    def jloss(blocks, x0, c, g):
        s = pt.fused_res_stack(x0, c, blocks, jspec, g=g, dtype=jnp.float32,
                               Bt=2, Tt=32, interpret=True, dropout=drop,
                               seed=jseed if drop else None)
        return jnp.sum(s * w), s

    jin = (blocks, jnp.asarray(x0), None if c is None else jnp.asarray(c),
           None if g is None else jnp.asarray(g))
    (_, jskips), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                         has_aux=True)(*jin)

    tx0 = _t(x0).requires_grad_()
    tc = None if c is None else _t(c).requires_grad_()
    tg = None if g is None else _t(g).requires_grad_()
    skips = ft.fused_res_stack(tx0, tc, model.conv_layers, tspec, g=tg,
                               dtype=torch.float32, dropout=drop,
                               seed=seed if drop else None)
    _close(skips.detach(), jskips, 1e-5, 2e-5, "skips")
    torch.sum(skips * _t(w)).backward()

    gtol = dict(rtol=2e-4, atol=3e-4)
    jblocks, jx0, jc, jgg = jg
    _close(tx0.grad, jx0, what="dx0", **gtol)
    if cond:
        _close(tc.grad, jc, what="dc", **gtol)
    if glob:
        _close(tg.grad, jgg, what="dg", **gtol)
    names = {"conv": "conv", "cond_c": "conv1x1c", "cond_g": "conv1x1g",
             "out": "conv1x1_out", "skip": "conv1x1_skip"}
    for i, (jb, blk) in enumerate(zip(jblocks, model.conv_layers)):
        for key, name in names.items():
            if key not in jb:
                continue
            conv = getattr(blk, name)
            _close(conv.weight.grad.permute(2, 1, 0), jb[key]["w"],
                   what=f"block {i} {key} w", **gtol)
            if "b" in jb[key]:
                _close(conv.bias.grad, jb[key]["b"],
                       what=f"block {i} {key} b", **gtol)


@pytest.mark.parametrize("drop", [0.0, 0.3])
@pytest.mark.parametrize("glob", [False, True])
def test_plain_backward_matches_autograd(glob, drop):
    """The written-out backward equals autograd of the plain forward (f32,
    where the rounding points are identities)."""
    rs = np.random.RandomState(3)
    L, k, R, G, S, cin, B, T = 4, 3, 16, 32, 24, 8, 2, 50
    dils = (1, 2, 1, 2)
    t = lambda *shape: _t(rs.randn(*shape) * 0.3).requires_grad_()
    x0, c = t(B, T, R), t(B, T, cin)
    gb = t(L, B, G) if glob else None
    w_in, b_in, w_cond = t(L, k * R, G), t(L, G), t(L, cin, G)
    w_og, b_og = t(L, G // 2, R + S), t(L, R + S)
    w = _t(rs.randn(B, T, S))
    inputs = (x0, c, gb, w_in, b_in, w_cond, w_og, b_og)
    skips, xs = ft.fused_res_stack_fwd_plain(*inputs, dils=dils, k=k,
                                             drop=drop, seed=77)
    torch.sum(skips * w).backward()
    got = ft.fused_res_stack_bwd_plain(
        w, xs.detach(), c.detach(), None if gb is None else gb.detach(),
        w_in.detach(), b_in.detach(), w_cond.detach(), w_og.detach(),
        b_og.detach(), dils=dils, k=k, drop=drop, seed=77)
    for name, a, g in zip(("dx0", "dc", "dgb", "dw_in", "db_in", "dw_cond",
                           "dw_og", "db_og"), inputs, got):
        if a is None:
            assert g is None
            continue
        _close(g, a.grad, 1e-4, 1e-5, name)


# ----------------------------------------------------------------------
# the model and the train step
# ----------------------------------------------------------------------
def test_wavenet_fused_matches_non_fused():
    kw = dict(STACK, gin_channels=6, use_speaker_embedding=False)
    spec = WaveNetSpec(**kw)
    gen = torch.Generator().manual_seed(0)
    model = WaveNet(spec, generator=gen)
    fused = WaveNet(WaveNetSpec(**kw, fused_train=True))
    fused.load_state_dict(model.state_dict())
    rs = np.random.RandomState(2)
    x = _t(rs.uniform(-0.5, 0.5, (2, 80, 1)))
    c, g = _t(rs.randn(2, 80, 8)), _t(rs.randn(2, 6))
    with torch.no_grad():
        _close(fused(x, c, g), model(x, c, g), 1e-5, 1e-5)


# 256 classes, not 65536: at 65536 the MoL loss's cdf_delta is a difference
# of two nearly equal sigmoids, and the two frameworks' ulp-level sigmoid
# differences become ~1e-3 relative differences in the gradients.
# Adam's eps is 1e-5 here, not 1e-8: some gradients of weight_v are ~1e-7
# (weight norm projects out the component along v), where f32 noise between
# the frameworks flips their sign, and with eps = 1e-8 Adam turns that into a
# full +/- lr step. With 1e-5 such elements move by at most ~lr/100, while
# gradients above 1e-4 still step by ~lr.
TRAIN = dict(input_type="raw", quantize_channels=256, out_channels=30,
             layers=4, stacks=2, residual_channels=16, gate_channels=32,
             skip_out_channels=24, cin_channels=8,
             upsample_conditional_features=False, dropout=0.0,
             compute_dtype="", lr_schedule="",
             optimizer_params={"lr": 1e-3, "eps": 1e-5, "weight_decay": 0.0})


def _batch(B=2, T=96, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    return {"x": x, "y": x.copy(),
            "c": rs.randn(B, T, 8).astype(np.float32),
            "input_lengths": np.asarray([T, T - 7], np.int32)}


def _state_pair(kw):
    jcfg, tcfg = JaxConfig(**kw), Config(**kw)
    jstate = jax_create_train_state(jcfg)
    params = jax.tree.map(np.asarray, jstate.params)
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    spec = spec_from_config(tcfg)
    model = WaveNet(spec)
    model.load_state_dict(state_dict_from_jax(params, spec))
    return jcfg, tcfg, jstate, create_train_state(tcfg, model=model,
                                                  device="cpu")


def _check_states(jstate, tstate, spec_cfg):
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    spec = spec_from_config(spec_cfg)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), spec)
    got = tstate.model.state_dict()
    for name, a in want.items():
        _close(got[name], a, 0, 4e-4, name)
    if jstate.ema_params is not None:
        want = state_dict_from_jax(jax.tree.map(np.asarray,
                                                jstate.ema_params), spec)
        for name, a in want.items():
            _close(tstate.ema[name], a, 0, 4e-4, "ema " + name)


TRAIN_CASES = {
    "fused-constant": dict(fused_train=True),
    "fused-noam": dict(fused_train=True,
                       lr_schedule="noam_learning_rate_decay",
                       lr_schedule_kwargs={"warmup_steps": 2}),
    "layers-constant": dict(),
    "adamw-clip": dict(optimizer="Adam", clip_thresh=0.05,
                       optimizer_params={"lr": 1e-3, "eps": 1e-5,
                                         "weight_decay": 0.01}),
    "sgd-momentum": dict(optimizer="SGD",
                         optimizer_params={"lr": 1e-2, "momentum": 0.9,
                                           "weight_decay": 1e-3}),
    "adadelta": dict(optimizer="Adadelta",
                     optimizer_params={"lr": 1.0, "eps": 1e-6}),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(case):
    """Two steps from the same weights and batch: loss, grad norm, lr, the
    parameters and the EMA shadow agree with the JAX package's step."""
    kw = {**TRAIN, **TRAIN_CASES[case]}
    jcfg, tcfg, jstate, tstate = _state_pair(kw)
    jstep, _ = jax_make_train_step(jcfg)
    tstep, _ = make_train_step(tcfg)
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    rng = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        jstate, jm = jstep(jstate, jbatch, rng)
        tm = tstep(tstate, batch, gen)
        _close(tm["loss"], jm["loss"], 1e-5, 0, f"loss, step {i}")
        # the second step's gradient inherits the first update's noise
        _close(tm["grad_norm"], jm["grad_norm"], 1e-4, 0, f"norm, step {i}")
        _close(tm["lr"], jm["lr"], 1e-6, 0, f"lr, step {i}")
    assert tstate.step == 2
    _check_states(jstate, tstate, tcfg)


# At the default decay 0.9999 the shadow moves by ~3e-7 over two steps, a
# few f32 ulps of the weights, so neither its value (atol 4e-4 above) nor its
# change can show a wrong or skipped update. At decay 0.9 and 0.3 it moves by
# ~1e-4 and ~1e-3 per step; the decays are not 0.5, where swapping decay and
# 1 - decay would change nothing.
@pytest.mark.parametrize("decay", [0.9, 0.3])
def test_ema_update_matches_jax(decay):
    """What two steps change in the EMA shadow equals JAX's change, per
    leaf: max |d_port - d_jax| <= 1e-2 * max |d_jax| + 1e-7 (1e-7 covers
    leaves whose JAX change is 0, such as first_conv.weight_v, whose
    gradient weight norm projects out; there the port's Adam moves by its
    f32 noise, ~3e-8)."""
    kw = {**TRAIN, "fused_train": True, "ema_decay": decay}
    jcfg, tcfg, jstate, tstate = _state_pair(kw)
    init = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    jstep, _ = jax_make_train_step(jcfg)
    tstep, _ = make_train_step(tcfg)
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        jstate, _ = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        tstep(tstate, batch, gen)
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.ema_params),
                               spec_from_config(tcfg))
    moved = 0.0
    for name, a in want.items():
        d_jax = np.asarray(a, np.float64) - init[name].double().numpy()
        d_port = (tstate.ema[name].double() - init[name].double()).numpy()
        err, scale = np.abs(d_port - d_jax).max(), np.abs(d_jax).max()
        assert err <= 1e-2 * scale + 1e-7, (name, err, scale)
        moved = max(moved, scale)
    assert moved > 100 * 1e-7   # the check above is not all floor


@pytest.mark.parametrize("fused", [False, True])
def test_eval_step_matches_jax(fused):
    """eval_step runs dropout off: equal to the JAX eval step on a config
    whose dropout is on."""
    kw = {**TRAIN, "dropout": 0.3, "fused_train": fused}
    jcfg, tcfg, jstate, tstate = _state_pair(kw)
    _, jeval = jax_make_train_step(jcfg)
    _, teval = make_train_step(tcfg)
    batch = _batch(seed=4)
    want = jeval(jstate, jax.tree.map(jnp.asarray, batch),
                 jax.random.PRNGKey(1))["loss"]
    _close(teval(tstate, batch)["loss"], want, 1e-5, 0)
    _close(teval(tstate, batch)["loss"], want, 1e-5, 0)


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_dropout_draws_seed(fused):
    """With dropout on, the step draws its seed from the generator: the
    same generator state gives the same loss, another gives another."""
    kw = {**TRAIN, "dropout": 0.3, "fused_train": fused}
    losses = []
    for s in (0, 0, 1):
        _, tcfg, _, tstate = _state_pair(kw)
        tstep, _ = make_train_step(tcfg)
        m = tstep(tstate, _batch(), torch.Generator().manual_seed(s))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]


def test_train_step_dropout_needs_generator():
    """With dropout on, a step without a generator raises: the seed comes
    from no hidden source."""
    _, tcfg, _, tstate = _state_pair({**TRAIN, "dropout": 0.3,
                                      "fused_train": True})
    tstep, _ = make_train_step(tcfg)
    with pytest.raises(ValueError, match="Generator"):
        tstep(tstate, _batch())
    assert tstate.step == 0


@pytest.mark.parametrize("name", ["noam_learning_rate_decay",
                                  "step_learning_rate_decay",
                                  "cyclic_cosine_annealing", ""])
def test_lr_schedules_match_jax(name):
    kwargs = {"noam_learning_rate_decay": {"warmup_steps": 40},
              "step_learning_rate_decay": {"anneal_rate": 0.5,
                                           "anneal_interval": 7},
              "cyclic_cosine_annealing": {"T": 100, "M": 4},
              "": {}}[name]
    js = jlr.make_schedule(name, 2e-3, kwargs)
    ts = tlr.make_schedule(name, 2e-3, kwargs)
    for step in (0, 1, 6, 7, 39, 40, 41, 300):   # JAX computes in f32
        _close(ts(step), js(step), 1e-5, 0, f"step {step}")


@pytest.mark.parametrize("name", sorted(_UNMAPPED))
def test_unmapped_optimizer_raises(name):
    cfg = Config(optimizer=name)
    with pytest.raises(ValueError, match="not mapped"):
        make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])


def test_apply_wavenet_bf16_fused_close_to_jax():
    """The bf16 fused forward with the JAX casts stays near the JAX bf16
    fused forward (both round at the same points; bf16 ulps differ)."""
    kw = dict(STACK)
    jspec, tspec = JaxSpec(**kw, fused_train=True), WaveNetSpec(**kw, fused_train=True)
    params = init_wavenet(jax.random.PRNGKey(0), jspec)
    model = WaveNet(tspec)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params),
                                              tspec))
    rs = np.random.RandomState(9)
    x = rs.uniform(-0.5, 0.5, (2, 64, 1)).astype(np.float32)
    c = rs.randn(2, 64, 8).astype(np.float32)
    want = apply_wavenet(params, jspec, jnp.asarray(x), jnp.asarray(c),
                         dtype=jnp.bfloat16)
    got = model(_t(x), _t(c), dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    scale = float(np.abs(np.asarray(want)).max())
    _close(got.detach(), want, 0, 3e-2 * scale)


# ----------------------------------------------------------------------
# the kernels' wrappers, as far as the CPU reaches them
# ----------------------------------------------------------------------
def test_train_args_mirror_the_c_struct():
    """ops/cuda_train.TrainArgs lists the fields of struct TrainArgs in
    csrc/train_common.cuh in the same order and with the same kinds."""
    import re
    from pathlib import Path

    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    src = (Path(ct.__file__).resolve().parent.parent / "csrc"
           / "train_common.cuh").read_text()
    body = re.search(r"struct TrainArgs \{(.*?)\n\};", src, re.S).group(1)
    c_fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = ("ptr" if "*" in decl else "uint" if "unsigned" in decl
                else "float" if decl.startswith("float") else "int")
        words = re.sub(r"\b(const|unsigned)\b|\*", " ", decl).split(None, 1)
        c_fields += [(n.strip(), kind) for n in words[1].split(",")]
    kinds = {ctypes_t: k for ctypes_t, k in (
        (ct.ctypes.c_void_p, "ptr"), (ct.ctypes.c_int, "int"),
        (ct.ctypes.c_uint, "uint"), (ct.ctypes.c_float, "float"))}
    py_fields = [(n, kinds[t]) for n, t in ct.TrainArgs._fields_]
    assert py_fields == c_fields


def test_train_wrappers_refuse_cpu_tensors():
    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    x0 = torch.zeros(1, 8, 4)
    w = lambda *s: torch.zeros(*s)
    with pytest.raises(ValueError, match="CUDA"):
        ct.train_fwd(x0, None, None, w(2, 12, 8), w(2, 8), None, w(2, 4, 6),
                     w(2, 6), dils=(1, 2), k=3)


def test_fused_stack_on_cpu_runs_plain_versions():
    """On CPU tensors FusedResStack uses the plain versions: no kernel
    launch is counted."""
    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    _, tspec, model, _, x0, c, _, w = _stack_setup(cond=True, glob=False,
                                                   T=40)
    before = ct.train_fwd.launches, ct.train_bwd.launches
    skips = ft.fused_res_stack(_t(x0).requires_grad_(), _t(c),
                               model.conv_layers, tspec, dtype=torch.float32)
    (skips * _t(w)).sum().backward()
    assert (ct.train_fwd.launches, ct.train_bwd.launches) == before


@pytest.mark.parametrize("case", ["c-without-cin", "cin-without-c",
                                  "g-without-gin", "gin-without-g",
                                  "cin-width"])
def test_sanity_check_rejects_mismatched_batches(case):
    """The same conditioning mismatches the JAX package's sanity_check
    rejects (reference: train.py:72-87)."""
    from wavenet_vocoder_tpu.training.train_state import (
        sanity_check as jax_sanity_check)
    from wavenet_vocoder_tpu_torch.training.train_state import sanity_check
    kw, batch = dict(STACK), {"c": np.zeros((1, 4, 8), np.float32)}
    if case == "c-without-cin":
        kw["cin_channels"] = -1
    elif case == "cin-without-c":
        batch = {}
    elif case == "g-without-gin":
        batch["g"] = np.zeros((1,), np.int32)
    elif case == "gin-without-g":
        kw["gin_channels"] = 4
    else:
        batch["c"] = np.zeros((1, 4, 5), np.float32)
    for check, spec in ((jax_sanity_check, JaxSpec(**kw)),
                        (sanity_check, WaveNetSpec(**kw))):
        with pytest.raises(ValueError):
            check(spec, batch)
    ok = dict(STACK)
    sanity_check(WaveNetSpec(**ok), {"c": np.zeros((1, 4, 8), np.float32)})
