"""Utterance-sharded synthesis: ``FusedGenerator(mesh=)`` and
``batch_wavegen(mesh=)``, the counterparts of the six tests of
tests/test_pallas_sharded.py.

The mesh records here list the CPU several times (one shard per entry), so
the generator's plain version runs each shard; on the card the same
dispatch launches the kernel once per shard and chunk. Invariant: sharded ==
unsharded == the eager decoder, elementwise, in deterministic mode; sampled
shard i draws with the base seed + i.
"""
import os

import numpy as np
import pytest
import torch

import jax

from wavenet_vocoder_tpu.models.wavenet import WaveNetSpec as JaxSpec
from wavenet_vocoder_tpu.models.wavenet import init_wavenet
from wavenet_vocoder_tpu.ops.generate import generate as jax_generate
from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
from wavenet_vocoder_tpu_torch.ops.generate import generate
from wavenet_vocoder_tpu_torch.parallel import Mesh


def _spec_kw(**kw):
    base = dict(out_channels=256, layers=4, stacks=2, residual_channels=8,
                gate_channels=16, skip_out_channels=8, cin_channels=4,
                scalar_input=False)
    base.update(kw)
    return base


def _model(seed=0, **kw):
    kw = _spec_kw(**kw)
    jspec = JaxSpec(**kw)
    params = jax.tree.map(np.asarray,
                          init_wavenet(jax.random.PRNGKey(seed), jspec))
    model = WaveNet(WaveNetSpec(**kw))
    model.load_state_dict(state_dict_from_jax(params, model.spec))
    return params, jspec, model.eval()


def cpu_mesh(n):
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device("cpu")] * n
    return Mesh(("data",), devs)


def _c(B, T, C=4, seed=1):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(B, T, C).astype(np.float32))


def test_sharded_categorical_matches_single_device():
    params, jspec, model = _model()
    B, T = 8, 64
    c = _c(B, T)
    single = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16)(
        c=c, deterministic=True).numpy()
    sharded = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16,
                                mesh=cpu_mesh(8))(
        c=c, deterministic=True).numpy()
    np.testing.assert_array_equal(single, sharded)
    # and both agree with the eager decoder and the JAX package's
    eager = generate(model, c=c, deterministic=True)["samples"].argmax(-1)
    np.testing.assert_array_equal(eager.numpy(), sharded)
    ref = np.asarray(jax_generate(params, jspec, jax.random.PRNGKey(2),
                                  c=c.numpy(), deterministic=True)["samples"])
    np.testing.assert_array_equal(ref.argmax(-1), sharded)


def test_sharded_mol_with_global_cond_matches_single_device():
    _, _, model = _model(3, out_channels=30, scalar_input=True,
                         output_distribution="Logistic", gin_channels=8,
                         use_speaker_embedding=True, n_speakers=3)
    B, T = 8, 32
    c = _c(B, T)
    g = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1])
    single = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16)(
        c=c, g=g, deterministic=True).numpy()
    sharded = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16,
                                mesh=cpu_mesh(8))(
        c=c, g=g, deterministic=True).numpy()
    np.testing.assert_allclose(single, sharded, atol=1e-5)


def test_sharded_partial_data_axis():
    """A data axis of 4 over the first 4 of 8 listed devices."""
    _, _, model = _model()
    B, T = 4, 32
    c = _c(B, T)
    devs = cpu_mesh(8).devices[:4]
    mesh = Mesh(("data",), devs)
    single = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16)(
        c=c, deterministic=True).numpy()
    sharded = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16,
                                mesh=mesh)(c=c, deterministic=True).numpy()
    np.testing.assert_array_equal(single, sharded)


def test_sharded_batch_not_divisible_raises():
    _, _, model = _model()
    gen = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16,
                            mesh=cpu_mesh(8))
    with pytest.raises(ValueError, match="not divisible"):
        gen(c=_c(3, 32), deterministic=True)
    with pytest.raises(ValueError, match="single-device"):
        gen(c=_c(8, 32), return_state=True)


def test_sharded_seeds_fold_in_axis_index(monkeypatch):
    """Sampling must not reuse one stream on every device: shard i gets the
    seed base + i (a stub kernel echoes the seed it was given)."""
    _, _, model = _model()
    B, T = 8, 32
    c = _c(B, T)

    def echo_seed(packed, spec, ring, x_cur, out, cond, g_gate, *, seed,
                  **kw):
        out.fill_(seed)

    gen = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16,
                            mesh=cpu_mesh(8))
    monkeypatch.setattr(cg, "generate_steps", echo_seed)
    seeds = gen(c=c, seed=1000).numpy()[:, 0]
    np.testing.assert_array_equal(seeds, 1000 + np.arange(B))
    two = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16,
                            mesh=cpu_mesh(2))
    np.testing.assert_array_equal(two(c=c, seed=7).numpy()[:, 0],
                                  [7] * 4 + [8] * 4)


def test_sharded_sampling_equals_each_shard_run_alone():
    """In sampling mode shard i equals an unsharded run of its rows with
    seed + i."""
    _, _, model = _model(5, out_channels=30, scalar_input=True,
                         output_distribution="Logistic")
    B, T = 8, 32
    c = _c(B, T)
    gen = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16)
    sharded = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16,
                                mesh=cpu_mesh(2))(c=c, seed=11)
    for i in range(2):
        alone = gen(c=c[4 * i:4 * i + 4], seed=11 + i)
        assert torch.equal(sharded[4 * i:4 * i + 4], alone)
    assert not torch.equal(sharded[:4], gen(c=c[:4], seed=12))


@pytest.mark.parametrize("engine", ["cuda", "scan"])
def test_batch_wavegen_mesh(engine):
    """The synthesis-layer entry point: batch_wavegen(mesh=) matches the
    meshless call, on both engines."""
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.synthesis import batch_wavegen
    cfg = Config(input_type="mulaw-quantize", quantize_channels=256,
                 out_channels=256, layers=4, stacks=2, residual_channels=8,
                 gate_channels=16, skip_out_channels=8, cin_channels=4,
                 upsample_conditional_features=False, cin_pad=0)
    _, _, model = _model()
    B, T = 8, 32
    c = _c(B, T).numpy()
    kw = dict(weight_dtype=torch.float32, chunk=16) if engine == "cuda" else {}
    single = batch_wavegen(model, cfg, c=c, T=T, engine=engine,
                           device="cpu", deterministic=True, **kw)
    sharded = batch_wavegen(model, cfg, c=c, T=T, engine=engine,
                            mesh=cpu_mesh(2), deterministic=True, **kw)
    np.testing.assert_array_equal(single, sharded)


def test_evaluate_cli_mesh_pads_and_matches_one_device(tmp_path, monkeypatch):
    """cli.evaluate --mesh on a two-shard mesh record (the CPU listed
    twice, in place of the local GPUs): a batch of 3 is padded to 4 with
    the last utterance, and the audio equals the run without --mesh."""
    import json

    from scipy.io import wavfile

    from wavenet_vocoder_tpu_torch import parallel
    from wavenet_vocoder_tpu_torch.cli.evaluate import main as evaluate
    from wavenet_vocoder_tpu_torch.config import load_config
    from wavenet_vocoder_tpu_torch.training.checkpoint import save_checkpoint
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state)
    preset = dict(input_type="mulaw-quantize", quantize_channels=256,
                  out_channels=256, hop_size=128, num_mels=8, cin_channels=8,
                  cin_pad=0, upsample_conditional_features=True,
                  upsample_params={"upsample_scales": [4, 4, 8]}, layers=2,
                  stacks=1, residual_channels=8, gate_channels=8,
                  skip_out_channels=8, compute_dtype="", lr_schedule="")
    (tmp_path / "preset.json").write_text(json.dumps(preset))
    cfg = load_config(str(tmp_path / "preset.json"), "")
    ckpt = save_checkpoint(str(tmp_path / "ckpt"),
                           create_train_state(cfg, device="cpu"),
                           global_step=0)
    dump = tmp_path / "dump"
    dump.mkdir()
    rs = np.random.RandomState(0)
    for i in range(3):
        np.save(dump / f"u{i}-feats.npy", rs.randn(4, 8).astype(np.float32))
    meshes = []

    def two_cpus(axes=None, devices=None):
        meshes.append(cpu_mesh(2))
        return meshes[-1]

    monkeypatch.setattr(parallel, "make_mesh", two_cpus)
    common = ["--preset", str(tmp_path / "preset.json"), "--batch-size", "3",
              "--deterministic"]
    evaluate([str(dump), ckpt, str(tmp_path / "mesh"), "--mesh"] + common)
    evaluate([str(dump), ckpt, str(tmp_path / "one"), "--device", "cpu"]
             + common)
    assert len(meshes) == 1
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "mesh"))
    assert sum(n.endswith("_gen.wav") for n in names) == 3
    for n in names:
        if n.endswith(".wav"):
            np.testing.assert_array_equal(
                wavfile.read(tmp_path / "mesh" / n)[1],
                wavfile.read(tmp_path / "one" / n)[1])
