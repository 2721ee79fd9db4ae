"""The port's initialisation and early training against the JAX package's,
on the CPU: the quality net's open lead (ROADMAP Queue C 3) pinned down.

A single init is not evidence: the step-0 loss of the quality net's
gaussian head spreads over 0.5-3.5 across init seeds on either side. So
the three checks below compare distributions or carry one init across:

* **Init statistics.** For the quality net's three heads and the flagship
  ``Config()``, 4 seeds a side: every parameter of at least 4096 elements
  has the same empirical std within 5% (pooled over the 4 seeds; the
  worst measured is 2.2%), every ``weight_g`` equals ``||weight_v||`` per
  output channel within 1e-6 relative, and every bias is zero.
* **Step-0 loss distribution.** On one batch of the gaussian and mol
  corpora (f32, eval mode, the plain path), 8 seeds a side: each side's
  median lies inside the other side's [min, max].
* **Many-step trajectory.** JAX weights carried to the port through
  ``compat/from_jax.py``; the quality configs at dropout 0 on the plain
  path, the crop cut to T=1024 and B=2 (from 4096 and 8) to keep the test
  short; 20 Adam steps on the same batches, with the parameters, the
  optimizer state and the batches in float64 on both sides (the losses
  stay f32: both packages cast the network's output to f32). The losses
  agree within 1e-4 relative at every step (measured: gaussian 3e-6, mol
  6e-5; mol's 65536-class cdf differences carry f32 noise into its
  gradients). In f32 the gaussian head's losses drift apart (1e-5 at step
  1, ~1e-2 by step 19) although its step-0 gradients agree leaf by leaf
  within 3e-5: Adam (eps 1e-8) turns f32 summation-order noise into
  different steps. That drift is rounding, not a difference of the two
  implementations, so the test holds the float64 run.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.models.wavenet import (
    init_wavenet,
    spec_from_config as jax_spec_from_config,
)
from wavenet_vocoder_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)

from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
from wavenet_vocoder_tpu_torch.scripts import synthetic_e2e as se
from wavenet_vocoder_tpu_torch.training.train_state import (
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)


def _jax_config(cfg: Config) -> JaxConfig:
    return JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(JaxConfig)})


def _port_init(spec, seed):
    return WaveNet(spec, generator=torch.Generator().manual_seed(seed))


CONFIGS = {"mulaw256": lambda: se.make_config("mulaw256"),
           "mol": lambda: se.make_config("mol"),
           "gaussian": lambda: se.make_config("gaussian"),
           "flagship": Config}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_statistics_match_jax(name):
    cfg = CONFIGS[name]()
    spec, jspec = spec_from_config(cfg), jax_spec_from_config(_jax_config(cfg))
    jax_sds = [state_dict_from_jax(jax.tree.map(
        np.asarray, init_wavenet(jax.random.PRNGKey(s), jspec)), spec)
        for s in range(4)]
    port_sds = [_port_init(spec, s).state_dict() for s in range(4)]
    assert sorted(jax_sds[0]) == sorted(port_sds[0])
    checked = 0
    for k, v in port_sds[0].items():
        if v.numel() < 4096:
            continue
        sj = np.concatenate([sd[k].numpy().ravel() for sd in jax_sds]).std()
        sp = np.concatenate([sd[k].numpy().ravel() for sd in port_sds]).std()
        assert abs(sp / sj - 1.0) <= 0.05, (k, sp, sj)
        checked += 1
    assert checked >= 2 * cfg.layers
    for side, sds in (("jax", jax_sds), ("port", port_sds)):
        for sd in sds:
            for k, v in sd.items():
                if k.endswith("weight_g"):
                    w = sd[k[:-len("g")] + "v"].double()
                    norm = w.reshape(w.shape[0], -1).norm(dim=1)
                    err = (v.double().reshape(-1) - norm).abs() / norm
                    assert float(err.max()) <= 1e-6, (side, k)
                elif k.endswith("bias"):
                    assert not v.any(), (side, k)


def _corpus_batch(cfg):
    train_data, _, _ = se.build_corpus(cfg)
    return se.sample_batch(cfg, train_data, np.random.RandomState(1))


@pytest.mark.parametrize("head", ["gaussian", "mol"])
def test_step0_loss_distributions_overlap(head):
    cfg = dataclasses.replace(se.make_config(head, xla=True),
                              compute_dtype="")
    jcfg = _jax_config(cfg)
    batch = _corpus_batch(cfg)
    jbatch = jax.tree.map(jnp.asarray, batch)
    _, jeval = jax_make_train_step(jcfg)
    _, teval = make_train_step(cfg)
    spec = spec_from_config(cfg)
    jl, tl = [], []
    for s in range(8):
        jstate = jax_create_train_state(jcfg, rng=jax.random.PRNGKey(s))
        jl.append(float(jeval(jstate, jbatch, jax.random.PRNGKey(0))["loss"]))
        tstate = create_train_state(cfg, model=_port_init(spec, s),
                                    device="cpu")
        tl.append(float(teval(tstate, batch)["loss"]))
    print(f"{head} step-0 losses over 8 init seeds: JAX "
          f"{np.round(jl, 4).tolist()} (median {np.median(jl):.4f}); port "
          f"{np.round(tl, 4).tolist()} (median {np.median(tl):.4f})")
    assert min(jl) <= np.median(tl) <= max(jl)
    assert min(tl) <= np.median(jl) <= max(tl)


def _trajectory_f64(head):
    """20 Adam steps of both packages from one JAX init, in float64: the
    losses."""
    cfg = dataclasses.replace(se.make_config(head, xla=True), dropout=0.0,
                              compute_dtype="", max_time_steps=1024,
                              batch_size=2)
    jcfg = _jax_config(cfg)
    train_data, _, _ = se.build_corpus(cfg)
    srs = np.random.RandomState(1)
    batches = [se.sample_batch(cfg, train_data, srs) for _ in range(20)]
    batches = [{k: v.astype(np.float64) if v.dtype == np.float32 else v
                for k, v in b.items()} for b in batches]
    jstate = jax_create_train_state(jcfg)
    spec = spec_from_config(cfg)
    model = WaveNet(spec)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), spec))
    params = jax.tree.map(lambda a: a.astype(jnp.float64), jstate.params)
    tx, _ = jax_make_optimizer(jcfg)
    jstate = jstate.replace(params=params, opt_state=tx.init(params))
    tstate = create_train_state(cfg, model=model.double(), device="cpu")
    jstep, _ = jax_make_train_step(jcfg)
    tstep, _ = make_train_step(cfg)
    jl, tl = [], []
    for b in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b),
                           jax.random.PRNGKey(0))
        tl.append(float(tstep(tstate, b)["loss"]))
        jl.append(float(jm["loss"]))
    return np.asarray(jl), np.asarray(tl)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("head", ["gaussian", "mol"])
def test_twenty_adam_steps_match_jax_in_f64(head, x64):
    jl, tl = _trajectory_f64(head)
    rel = np.abs(tl - jl) / np.abs(jl)
    print(f"{head} f64: loss rel by step {np.array2string(rel, precision=1)}")
    assert (rel <= 1e-4).all(), rel

