"""PyTorch port: checkpoints (``training/checkpoint.py``), also against the
JAX package.

Round trip with optimizer state and counters, the EMA twin, atomic writes,
the corrupt-latest fall-back, ``restore_parts``, and weights carried across
the packages: a checkpoint written by the JAX package's ``save_checkpoint``
and loaded by the port gives the JAX forward's output within 1e-5 (f32 on
both sides; the converter moves the numbers unchanged, the two forwards sum
in another order).
"""
import json
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.models.wavenet import (
    apply_wavenet,
    spec_from_config as jax_spec_from_config,
)
from wavenet_vocoder_tpu.training import checkpoint as jax_ckpt
from wavenet_vocoder_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
from wavenet_vocoder_tpu_torch.training.train_state import (
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

TINY = dict(input_type="mulaw-quantize", quantize_channels=256,
            out_channels=256, layers=2, stacks=1, residual_channels=16,
            gate_channels=16, skip_out_channels=16, cin_channels=-1,
            upsample_conditional_features=False, compute_dtype="",
            exponential_moving_average=True, ema_decay=0.9,
            optimizer_params={"lr": 5e-3, "eps": 1e-8, "weight_decay": 0.0},
            lr_schedule="")
COND = dict(TINY, cin_channels=4, num_mels=4, hop_size=4, cin_pad=1,
            upsample_conditional_features=True,
            upsample_params={"upsample_scales": [2, 2]})


def _batch(B=2, T=64, C=256, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, C, (B, T))
    return {"x": np.eye(C, dtype=np.float32)[ids], "y": ids.astype(np.int64),
            "input_lengths": np.asarray([T, T - 10], np.int32)}


def _trained_state(cfg, steps=2):
    state = create_train_state(cfg, device="cpu")
    train_step, _ = make_train_step(cfg)
    for i in range(steps):
        train_step(state, _batch(seed=i))
    return state


def _trained_state_cond(cfg):
    state = create_train_state(cfg, device="cpu")
    train_step, _ = make_train_step(cfg)
    b = _batch(seed=0)
    b["c"] = np.random.RandomState(1).randn(2, 64 // 4 + 2, 4).astype(np.float32)
    train_step(state, b)
    return state


def _assert_same_params(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_npz_format_names_and_no_pickle(tmp_path):
    cfg = Config(**TINY)
    state = _trained_state(cfg)
    path = ckpt.save_checkpoint(str(tmp_path), state, global_step=2)
    assert os.path.basename(path) == "checkpoint_step000000002.npz"
    for name in ("checkpoint_latest.npz", "checkpoint_step000000002_ema.npz",
                 "checkpoint_latest_ema.npz"):
        assert (tmp_path / name).exists()
    with np.load(path, allow_pickle=False) as z:
        names = set(z.files)
        manifest = json.loads(bytes(z["manifest"]).decode())
    assert "param_0" in names and "opt_0" in names
    assert manifest["format"] == "wavenet-tpu-ckpt" and manifest["version"] == 1
    assert manifest["param_paths"] == list(state.model.state_dict())


def test_round_trip_resumes_training_exactly(tmp_path):
    """Params, Adam moments, EMA shadow and counters all come back: a
    resumed run takes the same next step as the run that was saved."""
    cfg = Config(**TINY)
    state = _trained_state(cfg, steps=2)
    ckpt.save_checkpoint(str(tmp_path), state, global_step=2, global_epoch=1,
                         global_test_step=5)
    fresh = create_train_state(cfg, device="cpu")
    restored, counters = ckpt.load_checkpoint(
        ckpt.latest_path(str(tmp_path)), fresh)
    assert restored is fresh
    assert counters == {"global_step": 2, "global_epoch": 1,
                        "global_test_step": 5}
    assert fresh.step == 2
    _assert_same_params(fresh.model, state.model)
    named = dict(fresh.model.named_parameters())
    for k in state.ema:
        assert torch.equal(fresh.ema[k], state.ema[k])
    # the shadow came from the twin file, not from the params
    assert any(not torch.equal(fresh.ema[k], named[k]) for k in named)
    train_step, _ = make_train_step(cfg)
    m_a = train_step(state, _batch(seed=7))
    m_b = train_step(fresh, _batch(seed=7))
    assert float(m_a["loss"]) == float(m_b["loss"])
    _assert_same_params(fresh.model, state.model)


def test_reset_optimizer_and_missing_ema_twin(tmp_path):
    cfg = Config(**TINY)
    state = _trained_state(cfg, steps=2)
    ckpt.save_checkpoint(str(tmp_path), state, global_step=2)
    os.remove(ckpt.checkpoint_path(str(tmp_path), 2, ema=True))
    fresh = create_train_state(cfg, device="cpu")
    ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path), 2), fresh,
                         reset_optimizer=True)
    assert not fresh.optimizer.state_dict()["state"]     # still fresh
    # no twin file: the shadow is re-seeded from the restored params
    for k, p in fresh.model.named_parameters():
        assert torch.equal(fresh.ema[k], p)
    # without the optimizer state in the file
    ckpt.save_checkpoint(str(tmp_path / "noopt"), state, global_step=2,
                         save_optimizer_state=False)
    with np.load(ckpt.latest_path(str(tmp_path / "noopt"))) as z:
        assert "opt_0" not in z.files


def test_ema_twin_holds_the_averaged_weights(tmp_path):
    cfg = Config(**TINY)
    state = _trained_state(cfg, steps=2)
    ckpt.save_checkpoint(str(tmp_path), state, global_step=2)
    spec = spec_from_config(cfg)
    sd, _ = ckpt.load_params(ckpt.latest_path(str(tmp_path), ema=True), spec)
    for k, v in state.ema.items():
        assert torch.equal(sd[k], v)
    plain, _ = ckpt.load_params(ckpt.latest_path(str(tmp_path)), spec)
    assert any(not torch.equal(sd[k], plain[k]) for k in state.ema)


def test_failed_save_leaves_previous_checkpoint_intact(tmp_path, monkeypatch):
    cfg = Config(**TINY)
    state = _trained_state(cfg, steps=1)
    ckpt.save_checkpoint(str(tmp_path), state, global_step=1)
    latest = ckpt.latest_path(str(tmp_path))
    before = open(latest, "rb").read()
    state2 = _trained_state(cfg, steps=2)
    real_replace = os.replace

    def exploding_replace(src, dst):
        if dst == latest:
            raise OSError("simulated crash mid-save")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", exploding_replace)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(str(tmp_path), state2, global_step=2)
    monkeypatch.undo()
    assert open(latest, "rb").read() == before
    fresh = create_train_state(cfg, device="cpu")
    _, counters = ckpt.load_checkpoint(latest, fresh)
    assert counters["global_step"] == 1
    _assert_same_params(fresh.model, state.model)


def test_corrupt_latest_falls_back_to_newest_step_file(tmp_path, capsys):
    cfg = Config(**TINY)
    ckpt.save_checkpoint(str(tmp_path), _trained_state(cfg, 1), global_step=1)
    state2 = _trained_state(cfg, steps=2)
    ckpt.save_checkpoint(str(tmp_path), state2, global_step=2)
    latest = ckpt.latest_path(str(tmp_path))
    data = open(latest, "rb").read()
    with open(latest, "wb") as f:
        f.write(data[: len(data) // 2])
    fresh = create_train_state(cfg, device="cpu")
    _, counters = ckpt.load_checkpoint(latest, fresh)
    assert counters["global_step"] == 2       # newest intact step file wins
    assert "falling back" in capsys.readouterr().out
    _assert_same_params(fresh.model, state2.model)
    # a corrupted STEP file (explicit user path) still raises
    step_path = ckpt.checkpoint_path(str(tmp_path), 2)
    with open(step_path, "wb") as f:
        f.write(b"garbage")
    with pytest.raises(Exception):
        ckpt.load_checkpoint(step_path, fresh)


def test_wrong_architecture_raises(tmp_path):
    state = _trained_state(Config(**TINY), steps=1)
    path = ckpt.save_checkpoint(str(tmp_path), state, global_step=1)
    other = create_train_state(Config(**dict(TINY, layers=4, stacks=2)),
                               device="cpu")
    with pytest.raises(ValueError, match="wrong architecture"):
        ckpt.load_checkpoint(path, other)


def test_restore_parts_copies_what_matches(tmp_path, capsys):
    state = _trained_state(Config(**TINY), steps=1)
    path = ckpt.save_checkpoint(str(tmp_path), state, global_step=1)
    # a wider head: every tensor but the last conv's matches
    cfg2 = Config(**dict(TINY, layers=4, stacks=1))
    model = WaveNet(spec_from_config(cfg2),
                    generator=torch.Generator().manual_seed(5))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n = ckpt.restore_parts(path, model)
    src = state.model.state_dict()
    after = model.state_dict()
    assert n == len(src) and f"restored {n} tensors" in capsys.readouterr().out
    for k in after:
        if k in src:
            assert torch.equal(after[k], src[k])
        else:
            assert torch.equal(after[k], before[k])     # fresh init kept
    # a mismatching shape is skipped, not forced
    cfg3 = Config(**dict(TINY, skip_out_channels=8))
    model3 = WaveNet(spec_from_config(cfg3))
    assert 0 < ckpt.restore_parts(path, model3) < len(src)


def test_legacy_pickle_is_refused_with_the_reason(tmp_path):
    path = tmp_path / "checkpoint_step000000001.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": {}}, f)
    with pytest.raises(ValueError, match="pickle"):
        ckpt.load_params(str(path), spec_from_config(Config(**TINY)))


# ----------------------------------------------------------------------
# weights carried across the packages
# ----------------------------------------------------------------------
def _jax_trained(jcfg, steps=2):
    state = jax_create_train_state(jcfg)
    train_step, _ = jax_make_train_step(jcfg)
    rs = np.random.RandomState(0)
    T = 64
    hop = jcfg.hop_size
    for i in range(steps):
        b = _batch(seed=i)
        batch = {"x": jnp.asarray(b["x"]),
                 "y": jnp.asarray(b["y"], jnp.int32),
                 "input_lengths": jnp.asarray(b["input_lengths"])}
        if jcfg.cin_channels > 0:
            batch["c"] = jnp.asarray(rs.randn(
                2, T // hop + 2 * jcfg.cin_pad, jcfg.cin_channels
            ).astype(np.float32))
        state, _ = train_step(state, batch, jax.random.PRNGKey(i))
    return state


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema_twin"])
def test_jax_written_checkpoint_gives_the_jax_forward(tmp_path, ema):
    jcfg, cfg = JaxConfig(**COND), Config(**COND)
    state = _jax_trained(jcfg)
    jax_ckpt.save_checkpoint(str(tmp_path), state, global_step=2)
    path = ckpt.latest_path(str(tmp_path), ema=ema)
    assert path == jax_ckpt.latest_path(str(tmp_path), ema=ema)

    model, counters = ckpt.load_model(path, spec_from_config(cfg))
    assert counters["global_step"] == 2
    b = _batch(seed=3)
    c = np.random.RandomState(4).randn(2, 64 // 4 + 2, 4).astype(np.float32)
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(b["x"]),
                            torch.from_numpy(c)).numpy()
    params = state.ema_params if ema else state.params
    ref = np.asarray(apply_wavenet(params, jax_spec_from_config(jcfg),
                                   jnp.asarray(b["x"]), c=jnp.asarray(c)))
    assert ours.shape == ref.shape
    assert float(np.max(np.abs(ours - ref))) < 1e-5


def test_jax_written_checkpoint_into_a_train_state(tmp_path, capsys):
    """``load_checkpoint`` on a JAX checkpoint restores params, the EMA twin
    and the counters, keeps the fresh optimizer and says so."""
    jcfg, cfg = JaxConfig(**COND), Config(**COND)
    jstate = _jax_trained(jcfg)
    jax_ckpt.save_checkpoint(str(tmp_path), jstate, global_step=2)
    state = create_train_state(cfg, device="cpu")
    _, counters = ckpt.load_checkpoint(ckpt.latest_path(str(tmp_path)), state)
    assert counters["global_step"] == 2 and state.step == 2
    assert "optimizer starts fresh" in capsys.readouterr().out
    assert not state.optimizer.state_dict()["state"]
    want, _ = ckpt.load_params(ckpt.latest_path(str(tmp_path)),
                               state.model.spec)
    want_ema, _ = ckpt.load_params(ckpt.latest_path(str(tmp_path), ema=True),
                                   state.model.spec)
    for k, p in state.model.named_parameters():
        assert torch.equal(p, want[k])
        assert torch.equal(state.ema[k], want_ema[k])
    assert any(not torch.equal(want[k], want_ema[k]) for k in want)


def test_port_written_checkpoint_reads_back_through_the_jax_importer(tmp_path):
    """The port's ``state_dict()`` names are the reference's, so the JAX
    package's torch importer maps a port checkpoint's tensors onto JAX
    params that give the port's forward."""
    from wavenet_vocoder_tpu.compat.torch_import import params_from_state_dict
    jcfg, cfg = JaxConfig(**COND), Config(**COND)
    state = _trained_state_cond(cfg)
    ckpt.save_checkpoint(str(tmp_path), state, global_step=1)
    sd, _ = ckpt.load_params(ckpt.latest_path(str(tmp_path)),
                             state.model.spec)
    jspec = jax_spec_from_config(jcfg)
    params = params_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                    jspec)
    b = _batch(seed=5)
    c = np.random.RandomState(6).randn(2, 64 // 4 + 2, 4).astype(np.float32)
    with torch.no_grad():
        ours = state.model.eval()(torch.from_numpy(b["x"]),
                                  torch.from_numpy(c)).numpy()
    ref = np.asarray(apply_wavenet(params, jspec, jnp.asarray(b["x"]),
                                   c=jnp.asarray(c)))
    assert float(np.max(np.abs(ours - ref))) < 1e-5
