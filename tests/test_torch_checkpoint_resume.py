"""PyTorch port: optimizer state carried across the packages by checkpoint.

One package trains two steps from a shared init and saves; the other loads
the file and takes step 3, which must equal the saving package's own,
uninterrupted step 3 within the train-step parity limits of
``tests/test_torch_train.py`` (loss rtol 1e-5, parameters and EMA atol
4e-4). Both directions, for every optimizer whose state maps one to one on
optax's (``training/checkpoint.py:_optax_layout``). A resume of Adam with
a fresh optimizer misses JAX's step 3 by more than those limits, so the
comparison sees the carried state.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.training import checkpoint as jax_ckpt
from wavenet_vocoder_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)

from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
from wavenet_vocoder_tpu_torch.training.train_state import (
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

# tests/test_torch_train.py's parity model (256 classes, Adam eps 1e-5),
# with an EMA shadow at a decay that moves it
TRAIN = dict(input_type="raw", quantize_channels=256, out_channels=30,
             layers=4, stacks=2, residual_channels=16, gate_channels=32,
             skip_out_channels=24, cin_channels=8,
             upsample_conditional_features=False, dropout=0.0,
             compute_dtype="", lr_schedule="",
             exponential_moving_average=True, ema_decay=0.9,
             optimizer_params={"lr": 1e-3, "eps": 1e-5, "weight_decay": 0.0})
ONEHOT = dict(input_type="mulaw-quantize", quantize_channels=64,
              out_channels=64)
CASES = {
    "adam": dict(),
    "adam-fused-clip": dict(fused_train=True, clip_thresh=0.05),
    "adamw": dict(optimizer="AdamW",
                  optimizer_params={"lr": 1e-3, "eps": 1e-5,
                                    "weight_decay": 0.01}),
    "sgd-momentum": dict(optimizer="SGD",
                         optimizer_params={"lr": 1e-2, "momentum": 0.9,
                                           "weight_decay": 1e-3}),
    "adadelta": dict(optimizer="Adadelta",
                     optimizer_params={"lr": 1.0, "eps": 1e-6}),
    "adamax": dict(optimizer="Adamax"),
    "nadam": dict(optimizer="NAdam"),
    "radam": dict(optimizer="RAdam"),
    "rmsprop-centered-momentum": dict(
        optimizer="RMSprop", optimizer_params={
            "lr": 1e-3, "eps": 1e-5, "alpha": 0.9, "momentum": 0.5,
            "centered": True}),
    "rmsprop-momentum": dict(
        optimizer="RMSprop", optimizer_params={
            "lr": 1e-3, "eps": 1e-5, "alpha": 0.9, "momentum": 0.5}),
    "adagrad": dict(optimizer="Adagrad", optimizer_params={"lr": 1e-2}),
    # one-hot input, as tests/test_torch_train.py runs Lamb
    "lamb": dict(ONEHOT, optimizer="Lamb",
                 optimizer_params={"lr": 1e-3, "eps": 1e-5}),
}
LOSS_RTOL, PARAM_ATOL = 1e-5, 4e-4


def _batch(kw, seed):
    rs = np.random.RandomState(seed)
    B, T = 2, 96
    x = rs.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    batch = {"x": x, "y": x.copy(),
             "c": rs.randn(B, T, 8).astype(np.float32),
             "input_lengths": np.asarray([T, T - 7], np.int32)}
    if "quantize" in kw["input_type"]:
        C = kw["out_channels"]
        ids = rs.randint(0, C, (B, T))
        batch.update(x=np.eye(C, dtype=np.float32)[ids],
                     y=ids.astype(np.int32))
    return batch


def _jax_step(jstep, jstate, batch):
    return jstep(jstate, jax.tree.map(jnp.asarray, batch),
                 jax.random.PRNGKey(0))


def _shared_init(kw):
    """The JAX state from its init, and a port state with those weights."""
    jcfg, tcfg = JaxConfig(**kw), Config(**kw)
    jstate = jax_create_train_state(jcfg)
    spec = spec_from_config(tcfg)
    model = WaveNet(spec)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), spec))
    return jcfg, tcfg, jstate, create_train_state(tcfg, model=model,
                                                  device="cpu")


def _max_param_diff(jstate, tstate, tcfg):
    spec = spec_from_config(tcfg)
    worst = 0.0
    for tree, got in ((jstate.params, tstate.model.state_dict()),
                      (jstate.ema_params, tstate.ema)):
        want = state_dict_from_jax(jax.tree.map(np.asarray, tree), spec)
        worst = max(worst, max(float((got[n] - w).abs().max())
                               for n, w in want.items()))
    return worst


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_run_resumes_in_the_port(tmp_path, capsys, case):
    """JAX trains two steps and saves; the port loads the file into a
    fresh state and takes step 3: it equals JAX's step 3."""
    kw = {**TRAIN, **CASES[case]}
    jcfg, tcfg = JaxConfig(**kw), Config(**kw)
    jstate = jax_create_train_state(jcfg)
    jstep, _ = jax_make_train_step(jcfg)
    for i in range(2):
        jstate, _ = _jax_step(jstep, jstate, _batch(kw, i))
    jax_ckpt.save_checkpoint(str(tmp_path), jstate, global_step=2)
    jstate, jm = _jax_step(jstep, jstate, _batch(kw, 2))

    tstep, _ = make_train_step(tcfg)
    tstate = create_train_state(tcfg, device="cpu")
    ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path)), tstate)
    assert "NOTE" not in capsys.readouterr().out
    tm = tstep(tstate, _batch(kw, 2))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert _max_param_diff(jstate, tstate, tcfg) <= PARAM_ATOL
    if case == "adam":
        # the same resume with the optimizer started afresh misses
        fresh = create_train_state(tcfg, device="cpu")
        ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path)), fresh,
                             reset_optimizer=True)
        tstep(fresh, _batch(kw, 2))
        assert _max_param_diff(jstate, fresh, tcfg) > 2 * PARAM_ATOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_run_resumes_in_jax(tmp_path, case):
    """The port trains two steps and saves; the JAX package loads the file
    into a fresh state and takes step 3: it equals the port's step 3."""
    kw = {**TRAIN, **CASES[case]}
    jcfg, tcfg, _, tstate = _shared_init(kw)
    tstep, _ = make_train_step(tcfg)
    for i in range(2):
        tstep(tstate, _batch(kw, i))
    ckpt.save_checkpoint(str(tmp_path), tstate, global_step=2)
    tm = tstep(tstate, _batch(kw, 2))

    jstep, _ = jax_make_train_step(jcfg)
    jstate, counters = jax_ckpt.load_checkpoint(
        jax_ckpt.latest_path(str(tmp_path)), jax_create_train_state(jcfg))
    assert counters["global_step"] == 2
    jstate, jm = _jax_step(jstep, jstate, _batch(kw, 2))
    np.testing.assert_allclose(float(jm["loss"]), float(tm["loss"]),
                               rtol=LOSS_RTOL)
    assert _max_param_diff(jstate, tstate, tcfg) <= PARAM_ATOL
