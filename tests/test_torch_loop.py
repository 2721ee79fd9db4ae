"""PyTorch port vs the JAX package: the training loop from a dump on disk
(``training/loop.py``), on the CPU.

Both loops restore one checkpoint written by the JAX package (with
``reset_optimizer``) and train 3 steps on the same dump with a dev split,
logging every step. The preset is the train-step parity test's
(tests/test_torch_train.py: 256 classes, Adam eps 1e-5, f32, dropout 0), so
the loops' logged losses are held to its limits: rtol 1e-5. Each package then
loads the other's final checkpoint, and the forwards agree within 1e-4.
Eval and teacher-forced audio is sampled on different random streams in the
two packages, so only its existence and length are checked.
"""
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.models.wavenet import (
    apply_wavenet,
    spec_from_config as jax_spec_from_config,
)
from wavenet_vocoder_tpu.training import checkpoint as jax_ckpt
from wavenet_vocoder_tpu.training.loop import train_loop as jax_train_loop
from wavenet_vocoder_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
)

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.data import DataLoader, WaveNetDataset
from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
from wavenet_vocoder_tpu_torch.training import loop
from wavenet_vocoder_tpu_torch.training.train_state import (
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

HOP = 32
LOOP = dict(input_type="raw", quantize_channels=256, out_channels=30,
            layers=4, stacks=2, residual_channels=16, gate_channels=32,
            skip_out_channels=24, cin_channels=8, num_mels=8, hop_size=HOP,
            upsample_params={"upsample_scales": [4, 8]}, dropout=0.0,
            compute_dtype="", lr_schedule="", fused_train=True,
            optimizer_params={"lr": 1e-3, "eps": 1e-5, "weight_decay": 0.0},
            max_time_steps=320, batch_size=2, num_workers=0,
            checkpoint_interval=2, train_eval_interval=3,
            test_eval_epoch_interval=1, seed=7)
STEPS = 3


def make_dump(root, n_train=4, n_dev=2, seed=0, num_mels=8):
    """*-wave.npy / *-feats.npy per split, lengths drawn from a seed."""
    rs = np.random.RandomState(seed)
    for split, n in (("train_no_dev", n_train), ("dev", n_dev)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            frames = 16 + rs.randint(0, 10)
            np.save(os.path.join(d, f"u{i:02d}-wave.npy"),
                    rs.uniform(-0.5, 0.5, frames * HOP).astype(np.float32))
            np.save(os.path.join(d, f"u{i:02d}-feats.npy"),
                    rs.randn(frames, num_mels).astype(np.float32))
    return root


def _metrics(ckpt_dir):
    out = {}
    with open(os.path.join(ckpt_dir, "log", "metrics.jsonl")) as f:
        for line in f:
            m = json.loads(line)
            out.setdefault(m["tag"], {})[m["step"]] = m["value"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    dump = make_dump(str(root / "dump"))
    jcfg, cfg = JaxConfig(**LOOP), Config(**LOOP)
    init = str(root / "init")
    jax_ckpt.save_checkpoint(init, jax_create_train_state(jcfg),
                             global_step=0)
    start = jax_ckpt.latest_path(init)
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jax_train_loop(jcfg, dump, jax_dir, restore_checkpoint=start,
                   reset_optimizer=True, max_steps_override=STEPS,
                   use_mesh=False, log_interval=1)
    state = loop.train_loop(cfg, dump, port_dir, restore_checkpoint=start,
                            reset_optimizer=True, max_steps_override=STEPS,
                            log_interval=1, device="cpu")
    return dict(root=root, dump=dump, jcfg=jcfg, cfg=cfg, jax=jax_dir,
                port=port_dir, state=state)


def test_logged_losses_match_jax(runs):
    jm, pm = _metrics(runs["jax"]), _metrics(runs["port"])
    assert sorted(pm["train/loss"]) == list(range(1, STEPS + 1))
    assert sorted(jm["train/loss"]) == sorted(pm["train/loss"])
    for step, want in jm["train/loss"].items():
        np.testing.assert_allclose(pm["train/loss"][step], want, rtol=1e-5,
                                   err_msg=f"train/loss step {step}")
    assert pm["dev/loss"] and sorted(pm["dev/loss"]) == sorted(jm["dev/loss"])
    for step, want in jm["dev/loss"].items():
        np.testing.assert_allclose(pm["dev/loss"][step], want, rtol=1e-5,
                                   err_msg=f"dev/loss step {step}")
    assert runs["state"].step == STEPS


def test_checkpoints_counters_and_hparams(runs):
    d = runs["port"]
    for step in (2, STEPS):
        for ema in (False, True):
            assert os.path.exists(ckpt.checkpoint_path(d, step, ema=ema))
    _, counters = ckpt.load_params(ckpt.latest_path(d),
                                   spec_from_config(runs["cfg"]))
    jc = jax_ckpt.load_params(jax_ckpt.latest_path(runs["jax"])).counters
    assert counters == jc
    assert counters["global_step"] == STEPS
    hp = json.load(open(os.path.join(d, "hparams.json")))
    assert hp["hop_size"] == HOP and hp["seed"] == LOOP["seed"]


def _forward_inputs(seed=11, T=96):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-0.5, 0.5, (2, T, 1)).astype(np.float32)
    c = rs.randn(2, T // HOP + 4, 8).astype(np.float32)   # cin_pad 2
    return x, c


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema"])
def test_each_package_loads_the_others_final_checkpoint(runs, ema):
    """The port reads the JAX loop's final checkpoint, the JAX package's
    importer reads the port loop's; each forward equals the writer's own
    forward of the same weights within 1e-4."""
    from wavenet_vocoder_tpu.compat.torch_import import params_from_state_dict
    jspec = jax_spec_from_config(runs["jcfg"])
    spec = spec_from_config(runs["cfg"])
    x, c = _forward_inputs()
    # JAX wrote, the port reads
    jpayload = jax_ckpt.load_params(jax_ckpt.latest_path(runs["jax"], ema=ema))
    jref = jax_create_train_state(runs["jcfg"]).params
    jparams = jax_ckpt.params_like(jref, jpayload)
    want = np.asarray(apply_wavenet(jparams, jspec, jnp.asarray(x),
                                    c=jnp.asarray(c)))
    model, _ = ckpt.load_model(jax_ckpt.latest_path(runs["jax"], ema=ema),
                               spec)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the port wrote, the JAX package reads
    sd, _ = ckpt.load_params(ckpt.latest_path(runs["port"], ema=ema), spec)
    model, _ = ckpt.load_model(ckpt.latest_path(runs["port"], ema=ema), spec)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    params = params_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                    jspec)
    got = np.asarray(apply_wavenet(params, jspec, jnp.asarray(x),
                                   c=jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # and the two loops' final weights agree as their losses do
    model_j, _ = ckpt.load_model(jax_ckpt.latest_path(runs["jax"], ema=ema),
                                 spec)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), model_j.state_dict()[k].numpy(),
                                   rtol=0, atol=4e-4, err_msg=k)


def test_eval_artifacts_exist_with_the_crop_length(runs):
    from scipy.io import wavfile
    T = LOOP["max_time_steps"]
    inter = os.path.join(runs["port"], "intermediate")
    want = {"train_no_dev_eval": ["step000000003_predicted.wav",
                                  "step000000003_target.wav",
                                  "step000000003_teacher_forced.wav"],
            # dev generation of epoch 0 runs after train step 2
            "dev_eval": ["step000000002_predicted.wav",
                         "step000000002_target.wav"]}
    for sub, names in want.items():
        for name in names:
            sr, w = wavfile.read(os.path.join(inter, sub, name))
            assert sr == LOOP.get("sample_rate", 22050)
            assert len(w) == T, (sub, name, len(w))
        # the JAX loop wrote the same files
        assert set(names) <= set(os.listdir(os.path.join(runs["jax"],
                                                         "intermediate", sub)))


def test_interrupted_run_writes_its_final_checkpoint(runs, tmp_path,
                                                     monkeypatch):
    cfg = runs["cfg"]
    real = loop.make_train_step

    def interrupting(c, **kw):
        step, ev = real(c, **kw)
        calls = []

        def train_step(state, batch, gen=None):
            calls.append(1)
            if len(calls) == 2:
                raise KeyboardInterrupt
            return step(state, batch, gen)
        return train_step, ev

    monkeypatch.setattr(loop, "make_train_step", interrupting)
    out = str(tmp_path / "exp")
    state = loop.train_loop(cfg, runs["dump"], out, max_steps_override=10,
                            device="cpu")
    assert state.step == 1
    assert os.path.exists(ckpt.checkpoint_path(out, 1))
    assert os.path.exists(ckpt.checkpoint_path(out, 1, ema=True))
    _, counters = ckpt.load_params(ckpt.latest_path(out), state.model.spec)
    assert counters["global_step"] == 1
    # the metric file was closed with step 1's scalars in it
    assert 1 in _metrics(out)["train/loss"]


def test_restore_parts_seeds_the_ema_from_the_restored_weights(runs, tmp_path):
    """After a partial restore the EMA shadow is the restored weights (the
    reference registers its EMA after restoring), so at decay 1.0 the
    final EMA twin equals the restored checkpoint."""
    cfg = runs["cfg"].replace(ema_decay=1.0)
    src = ckpt.latest_path(runs["port"])
    out = str(tmp_path / "parts")
    loop.train_loop(cfg, runs["dump"], out, restore_parts_path=src,
                    max_steps_override=1, device="cpu")
    spec = spec_from_config(cfg)
    want, _ = ckpt.load_params(src, spec)
    got, _ = ckpt.load_params(ckpt.latest_path(out, ema=True), spec)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_loop_raises_without_a_gpu_unless_given_a_device(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train_loop(runs["cfg"], runs["dump"], str(tmp_path / "x"),
                        max_steps_override=1)


def test_batches_on_the_device_pass_through_the_step_without_a_copy(runs):
    """``train_step`` takes tensors already where the model is as they are:
    same storage, no copy."""
    from wavenet_vocoder_tpu_torch.data.prefetch import prefetch_to_device
    from wavenet_vocoder_tpu_torch.training import train_state as ts
    cfg = runs["cfg"]
    loader = DataLoader(WaveNetDataset(os.path.join(runs["dump"],
                                                    "train_no_dev"), cfg),
                        cfg, seed=cfg.seed)
    batch = next(iter(prefetch_to_device(loader, device="cpu")))
    moved = ts._on(batch, torch.device("cpu"))
    for k, v in batch.items():
        assert moved[k] is v or moved[k].data_ptr() == v.data_ptr(), k
    state = create_train_state(cfg, device="cpu")
    train_step, _ = make_train_step(cfg)
    assert np.isfinite(float(train_step(state, batch)["loss"]))
