"""PyTorch port: the training-side CLIs against the JAX package's, on the
CPU (``--device cpu``), mirroring tests/test_cli.py.

  * ``cli.train``: a run writes hparams.json, checkpoints with the EMA twin
    and metrics; a resume with ``--checkpoint`` carries ``global_step`` on;
    the multi-device flags raise; without ``--device`` it needs a GPU.
  * ``cli.compute_meanvar_stats``, ``cli.preprocess_normalize``,
    ``cli.mksubset`` and ``cli.tojson`` write what the JAX package's write,
    compared array for array and byte for byte.
  * ``cli.import_checkpoint`` on a reference-layout ``.pth`` made in the test
    from the port's own ``state_dict()`` (the layout the JAX package's
    ``load_torch_checkpoint`` reads): both packages import it, and the two
    imported checkpoints give the same forward within 1e-4 (f32 on both
    sides, summed in another order).
  * ``egs/run_common_torch.sh`` runs stages 0-3 on a tiny corpus from
    ``scripts/make_speech_corpus.py`` with a demo preset and ``--device
    cpu``, two training steps.
"""
import json
import os
import subprocess
import sys
from glob import glob

import numpy as np
import pytest
import torch

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    from scipy.io import wavfile
    sr = 16000
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rs = np.random.RandomState(0)
    for i in range(4):
        t = np.arange(sr + i * 1000) / sr
        x = 0.5 * np.sin(2 * np.pi * (200 + 50 * i) * t)
        x += 0.01 * rs.randn(len(t))
        wavfile.write(str(wav_dir / f"utt{i}.wav"), sr,
                      (x * 18000).astype(np.int16))
    preset = {
        "name": "wavenet_vocoder",
        "input_type": "mulaw-quantize", "quantize_channels": 256,
        "out_channels": 256, "sample_rate": sr, "fft_size": 512,
        "hop_size": 128, "win_length": 512, "num_mels": 20, "fmin": 60,
        "fmax": 7600, "cin_channels": 20, "cin_pad": 2,
        "max_time_steps": 1280, "upsample_conditional_features": True,
        "upsample_params": {"upsample_scales": [4, 4, 8]},
        "layers": 2, "stacks": 1, "residual_channels": 8,
        "gate_channels": 8, "skip_out_channels": 8, "batch_size": 2,
        "compute_dtype": "", "lr_schedule": "",
        "checkpoint_interval": 1000, "train_eval_interval": 1000,
        "num_workers": 0,
    }
    preset_path = root / "preset.json"
    preset_path.write_text(json.dumps(preset))

    from wavenet_vocoder_tpu_torch.cli.compute_meanvar_stats import main as mv
    from wavenet_vocoder_tpu_torch.cli.preprocess import main as pp
    from wavenet_vocoder_tpu_torch.cli.preprocess_normalize import main as norm
    dump = str(root / "dump" / "train_no_dev")
    pp(["wavallin", str(wav_dir), dump, "--preset", str(preset_path),
        "--num-workers", "1"])
    scaler = str(root / "meanvar.npz")
    mv([dump, scaler])
    norm([dump, str(root / "norm" / "train_no_dev"), scaler,
          "--num-workers", "1"])
    return {"root": root, "wav_dir": str(wav_dir), "dump": dump,
            "scaler": scaler, "preset": str(preset_path), "sr": sr}


def _files(d):
    return sorted(os.path.relpath(p, d) for p in glob(os.path.join(d, "**"),
                                                      recursive=True)
                  if os.path.isfile(p))


def _same_npy_dirs(a, b):
    assert _files(a) == _files(b)
    for name in _files(a):
        if name.endswith(".npy"):
            x, y = np.load(os.path.join(a, name)), np.load(os.path.join(b, name))
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert open(os.path.join(a, name), "rb").read() == open(
                os.path.join(b, name), "rb").read(), name


def test_meanvar_and_normalize_equal_jax(workdir, tmp_path):
    from wavenet_vocoder_tpu.cli.compute_meanvar_stats import main as jmv
    from wavenet_vocoder_tpu.cli.preprocess_normalize import main as jnorm
    from wavenet_vocoder_tpu_torch.cli.preprocess_normalize import main as norm
    jscaler = str(tmp_path / "jax_meanvar.npz")
    jmv([workdir["dump"], jscaler])
    with np.load(workdir["scaler"]) as t, np.load(jscaler) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # a list file as the source, and the inverse transform
    lst = tmp_path / "feats.txt"
    lst.write_text("\n".join(sorted(glob(os.path.join(workdir["dump"],
                                                      "*-feats.npy")))))
    from wavenet_vocoder_tpu_torch.cli.compute_meanvar_stats import main as mv
    mv([str(lst), str(tmp_path / "from_list.npz")])
    with np.load(tmp_path / "from_list.npz") as t, np.load(jscaler) as j:
        np.testing.assert_array_equal(t["mean"], j["mean"])
    jnorm([workdir["dump"], str(tmp_path / "jax_norm"), jscaler,
           "--num-workers", "1"])
    _same_npy_dirs(str(workdir["root"] / "norm" / "train_no_dev"),
                   str(tmp_path / "jax_norm"))
    # the port's pool spawns its workers; the JAX package's forks, which is
    # unsafe in a process that runs JAX's threads, so it gets one worker
    for pkg, fn, workers in (("port", norm, "2"), ("jax", jnorm, "1")):
        fn([str(tmp_path / "jax_norm"), str(tmp_path / f"{pkg}_inv"),
            jscaler, "--inverse", "--num-workers", workers])
    _same_npy_dirs(str(tmp_path / "port_inv"), str(tmp_path / "jax_inv"))
    assert os.path.exists(tmp_path / "port_inv" / "train.txt")


@pytest.mark.parametrize("args", [
    ["--dev-size", "1", "--test-size", "1", "--train-dev-test-split"],
    ["--dev-size", "0.25", "--test-size", "0.25", "--train-dev-test-split",
     "--target-sr", "8000", "--random-state", "3"],
    ["--limit", "0.0005"],
], ids=["counts", "fractions_resampled", "flat_limit"])
def test_mksubset_equals_jax(workdir, tmp_path, args):
    from wavenet_vocoder_tpu.cli.mksubset import main as jmain
    from wavenet_vocoder_tpu_torch.cli.mksubset import main
    main([workdir["wav_dir"], str(tmp_path / "port")] + args)
    jmain([workdir["wav_dir"], str(tmp_path / "jax")] + args)
    _same_npy_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert _files(str(tmp_path / "port"))


def test_tojson_equals_jax(workdir, tmp_path):
    from wavenet_vocoder_tpu.cli.tojson import main as jmain
    from wavenet_vocoder_tpu_torch.cli.tojson import main
    for args in ([], ["--preset", workdir["preset"],
                      "--hparams", "layers=6,stacks=2"]):
        main([str(tmp_path / "port.json")] + args)
        jmain([str(tmp_path / "jax.json")] + args)
        assert (tmp_path / "port.json").read_text() == (
            tmp_path / "jax.json").read_text()
    d = json.loads((tmp_path / "port.json").read_text())
    assert d["layers"] == 6 and d["name"] == "wavenet_vocoder"


@pytest.fixture(scope="module")
def trained(workdir):
    from wavenet_vocoder_tpu_torch.cli.train import main
    ckpt_dir = str(workdir["root"] / "exp")
    main(["--dump-root", str(workdir["root"] / "norm"),
          "--checkpoint-dir", ckpt_dir, "--preset", workdir["preset"],
          "--max-train-steps", "3", "--no-mesh", "--device", "cpu"])
    return ckpt_dir


def test_train_cli(trained, capsys):
    assert os.path.exists(os.path.join(trained, "hparams.json"))
    assert os.path.exists(os.path.join(trained, "checkpoint_latest.npz"))
    assert os.path.exists(os.path.join(trained, "checkpoint_latest_ema.npz"))
    assert os.path.exists(os.path.join(trained,
                                       "checkpoint_step000000003.npz"))
    logdir = os.path.join(trained, "log")
    assert "metrics.jsonl" in os.listdir(logdir)
    tags = {json.loads(line)["tag"]
            for line in open(os.path.join(logdir, "metrics.jsonl"))}
    assert {"train/loss", "train/grad_norm", "train/lr"} <= tags


def test_train_cli_resume(workdir, trained):
    from wavenet_vocoder_tpu_torch.cli.train import main
    from wavenet_vocoder_tpu_torch.config import load_config
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    latest = os.path.join(trained, "checkpoint_latest.npz")
    main(["--dump-root", str(workdir["root"] / "norm"),
          "--checkpoint-dir", trained, "--preset", workdir["preset"],
          "--checkpoint", latest, "--max-train-steps", "5",
          "--device", "cpu"])
    spec = spec_from_config(load_config(workdir["preset"]))
    _, counters = ckpt.load_params(latest, spec)
    assert counters["global_step"] == 5
    assert counters["global_epoch"] > 0


@pytest.mark.parametrize("flag", [
    ["--distributed"], ["--coordinator-address", "localhost:1"],
    ["--num-processes", "2"], ["--process-id", "0"]])
def test_train_cli_multi_device_flags_raise(workdir, tmp_path, flag,
                                            monkeypatch):
    """A process group needs its address, size and rank, from the flags or
    torchrun's environment: with only some of them the CLI raises, naming
    what is missing, before it writes anything."""
    from wavenet_vocoder_tpu_torch.cli.train import main
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        main(["--dump-root", str(workdir["root"] / "norm"),
              "--checkpoint-dir", str(tmp_path), "--device", "cpu"] + flag)
    assert os.listdir(tmp_path) == []


def test_train_cli_needs_a_gpu_without_device(workdir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from wavenet_vocoder_tpu_torch.cli.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dump-root", str(workdir["root"] / "norm"),
              "--checkpoint-dir", str(tmp_path), "--preset",
              workdir["preset"], "--max-train-steps", "1"])


# ----------------------------------------------------------------------
# import_checkpoint
# ----------------------------------------------------------------------
IMPORT = dict(input_type="raw", out_channels=30, layers=4, stacks=2,
              residual_channels=8, gate_channels=16, skip_out_channels=8,
              cin_channels=6, num_mels=6, hop_size=16, cin_pad=1,
              upsample_params={"upsample_scales": [4, 4]}, compute_dtype="")


def _reference_pth(tmp_path, folded=False, prefix="", ema=True):
    """A reference-format training checkpoint (and its _ema twin) from the
    port's own state_dict(): the reference's names and layouts."""
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import (
        WaveNet, make_generation_fast, spec_from_config)
    cfg = Config(**IMPORT)
    (tmp_path / "hparams.json").write_text(cfg.to_json())
    path = tmp_path / "checkpoint_step000000700.pth"
    for seed, p in ((1, path), (2, tmp_path / (path.stem + "_ema.pth"))):
        if p != path and not ema:
            continue
        model = WaveNet(spec_from_config(cfg),
                        generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():     # non-trivial biases and gains
            for name, prm in model.named_parameters():
                if name.endswith("bias") or name.endswith("weight_g"):
                    prm.add_(0.05 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(len(name))))
        if folded:
            make_generation_fast(model)
        sd = {prefix + k: v for k, v in model.state_dict().items()}
        torch.save({"state_dict": sd, "optimizer": {}, "global_step": 700,
                    "global_epoch": 12, "global_test_step": 34}, str(p))
    return str(path), cfg


def _both_forwards(port_dir, jax_dir, cfg, ema):
    from wavenet_vocoder_tpu.config import Config as JaxConfig
    from wavenet_vocoder_tpu.models.wavenet import (
        apply_wavenet, spec_from_config as jax_spec)
    from wavenet_vocoder_tpu.training import checkpoint as jax_ckpt
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    rs = np.random.RandomState(9)
    x = rs.uniform(-0.5, 0.5, (2, 64, 1)).astype(np.float32)
    c = rs.randn(2, 64 // 16 + 2, 6).astype(np.float32)
    model, counters = ckpt.load_model(ckpt.latest_path(port_dir, ema=ema),
                                      spec_from_config(cfg))
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    jcfg = JaxConfig(**IMPORT)
    payload = jax_ckpt.load_params(jax_ckpt.latest_path(jax_dir, ema=ema))
    # the tree as saved: a folded import keeps plain kernels ("w" leaves)
    params = jax_ckpt.params_tree(payload)
    ref = np.asarray(apply_wavenet(params, jax_spec(jcfg), jnp.asarray(x),
                                   c=jnp.asarray(c)))
    return ours, ref, counters, payload.counters


@pytest.mark.parametrize("variant", ["weight_norm", "folded", "module_prefix"])
def test_import_checkpoint_both_packages_give_one_forward(tmp_path, variant):
    from wavenet_vocoder_tpu.cli.import_checkpoint import main as jmain
    from wavenet_vocoder_tpu_torch.cli.import_checkpoint import main
    src = tmp_path / "ref"
    src.mkdir()
    pth, cfg = _reference_pth(src, folded=variant == "folded",
                              prefix="module." if variant == "module_prefix"
                              else "")
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    main([pth, port_dir])          # hparams.json beside the .pth is found
    jmain([pth, jax_dir])
    for ema in (False, True):
        ours, ref, counters, jcounters = _both_forwards(port_dir, jax_dir,
                                                        cfg, ema)
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
        assert counters == jcounters == {"global_step": 700,
                                         "global_epoch": 12,
                                         "global_test_step": 34}
    p_ema = _both_forwards(port_dir, jax_dir, cfg, True)[0]
    p_raw = _both_forwards(port_dir, jax_dir, cfg, False)[0]
    assert not np.allclose(p_ema, p_raw)      # the twin is its own weights
    assert os.path.exists(os.path.join(port_dir,
                                       "checkpoint_step000000700_ema.npz"))
    assert json.load(open(os.path.join(port_dir, "hparams.json"))) == \
        json.load(open(os.path.join(jax_dir, "hparams.json")))


def test_import_checkpoint_without_twin_and_wrong_preset(tmp_path):
    from wavenet_vocoder_tpu_torch.cli.import_checkpoint import main
    src = tmp_path / "ref"
    src.mkdir()
    pth, _ = _reference_pth(src, ema=False)
    out = str(tmp_path / "out")
    main([pth, out])
    assert os.path.exists(os.path.join(out, "checkpoint_latest.npz"))
    assert not os.path.exists(os.path.join(out, "checkpoint_latest_ema.npz"))
    with pytest.raises(ValueError, match="wrong preset"):
        main([pth, str(tmp_path / "bad"), "--hparams", "layers=2,stacks=1"])
    # a file that pickles objects beyond tensors is refused, not unpickled
    payload = torch.load(pth, weights_only=True)
    payload["hparams"] = _Opaque()
    torch.save(payload, str(tmp_path / "opaque.pth"))
    with pytest.raises(ValueError, match="objects other than tensors"):
        main([str(tmp_path / "opaque.pth"), str(tmp_path / "opaque"),
              "--preset", str(src / "hparams.json")])


class _Opaque:
    pass


# ----------------------------------------------------------------------
# the recipe script
# ----------------------------------------------------------------------
def test_recipe_runs_stages_0_to_3_on_the_cpu(tmp_path):
    """egs/run_common_torch.sh: subset, features and normalisation, two
    training steps and evaluation synthesis, all through the port's CLIs
    with ``--device cpu``. The corpus's utterances are cut to 0.3 s so that
    evaluation synthesis on the CPU stays short."""
    from scipy.io import wavfile
    corpus = tmp_path / "corpus"
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "make_speech_corpus.py"),
                    str(corpus), "--n", "3"], check=True, capture_output=True)
    for p in sorted(corpus.glob("*.wav")):
        sr, x = wavfile.read(str(p))
        wavfile.write(str(p), sr, x[:int(0.3 * sr)])
    recipe = tmp_path / "recipe"
    (recipe / "conf").mkdir(parents=True)
    preset = json.load(open(os.path.join(REPO, "egs", "mol", "conf",
                                         "mol_wavenet_demo.json")))
    (recipe / "conf" / "demo.json").write_text(json.dumps(preset))
    env = dict(os.environ, PYTHONPATH=REPO, PYTHON=sys.executable,
               preset="conf/demo.json", train_args="--max-train-steps 2",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "egs", "run_common_torch.sh"),
         "--stage", "0", "--stop-stage", "3", "--db-root", str(corpus),
         "--dev-size", "1", "--test-size", "1", "--num-workers", "1",
         "--device", "cpu"],
        cwd=str(recipe), env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    exp = recipe / "exp" / "ljspeech_demo"
    assert (exp / "checkpoint_step000000002.npz").exists()
    assert (exp / "hparams.json").exists()
    for s in ("dev", "eval"):
        gens = list((exp / "generated" / s).glob("*_gen.wav"))
        assert len(gens) == 1, s
        feats = list((recipe / "dump" / "norm" / s).glob("*-feats.npy"))
        sr, w = wavfile.read(str(gens[0]))
        assert len(w) == np.load(str(feats[0])).shape[0] * preset["hop_size"]
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("[train] trace ")]
    assert line, proc.stdout[-3000:]
    trace = json.loads(line[-1][len("[train] trace "):])
    # the plain stack on the CPU: no kernel launched, every step's phases
    # and the loader's collates timed
    assert trace["counters"] == {}
    for name in ("train.forward", "train.backward", "train.clip",
                 "train.optimizer", "train.ema", "data.collate"):
        assert trace["spans"][name]["count"] >= 2, (name, trace)
