"""PyTorch port: the evaluation leg's CLIs on a tiny corpus, ``--device cpu``.

``cli.preprocess`` must write what the JAX package's CLI writes from the
same wavs (both run the same numpy pipeline, so the files are compared
bit for bit); ``cli.synthesis`` and ``cli.evaluate`` read a checkpoint the
port wrote (and one the JAX package wrote) with ``hparams.json`` beside it.
"""
import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (before torch, as the other parity tests do)
import torch
from scipy.io import wavfile

from wavenet_vocoder_tpu.cli.preprocess import main as jax_preprocess
from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.training import checkpoint as jax_ckpt
from wavenet_vocoder_tpu.training.train_state import (
    create_train_state as jax_create_train_state,
)

from wavenet_vocoder_tpu_torch.cli.evaluate import main as evaluate
from wavenet_vocoder_tpu_torch.cli.preprocess import main as preprocess
from wavenet_vocoder_tpu_torch.cli.synthesis import (
    load_params_and_config,
    main as synthesis,
)
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.data import parse_manifest
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
from wavenet_vocoder_tpu_torch.training.train_state import create_train_state

torch.set_num_threads(1)

SR = 16000
PRESET = {
    "name": "wavenet_vocoder",
    "input_type": "mulaw-quantize", "quantize_channels": 256,
    "out_channels": 256, "sample_rate": SR, "fft_size": 512,
    "hop_size": 128, "win_length": 512, "num_mels": 20, "fmin": 60,
    "fmax": 7600, "cin_channels": 20, "cin_pad": 2,
    "upsample_conditional_features": True,
    "upsample_params": {"upsample_scales": [4, 4, 8]},
    "layers": 2, "stacks": 1, "residual_channels": 8,
    "gate_channels": 8, "skip_out_channels": 8, "batch_size": 2,
    "compute_dtype": "", "lr_schedule": "",
}
UTT_LENGTHS = (3000, 2200, 2600)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rs = np.random.RandomState(0)
    for i, n in enumerate(UTT_LENGTHS):
        t = np.arange(n) / SR
        x = 0.5 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.01 * rs.randn(n)
        wavfile.write(str(wav_dir / f"utt{i}.wav"), SR,
                      (x * 18000).astype(np.int16))
    preset = root / "preset.json"
    preset.write_text(json.dumps(PRESET))
    dump = root / "dump"
    preprocess(["wavallin", str(wav_dir), str(dump), "--preset", str(preset),
                "--num-workers", "1"])
    # a checkpoint the port wrote, hparams.json beside it
    cfg = Config().parse_json(json.dumps(PRESET))
    state = create_train_state(cfg, device="cpu")
    exp = root / "exp"
    path = ckpt.save_checkpoint(str(exp), state, global_step=3)
    (exp / "hparams.json").write_text(cfg.to_json())
    return dict(root=root, wav_dir=str(wav_dir), preset=str(preset),
                dump=str(dump), ckpt=path, cfg=cfg, state=state)


def _read(path):
    sr, x = wavfile.read(path)
    assert sr == SR
    return x


def test_preprocess_writes_what_the_jax_cli_writes(work):
    ref = work["root"] / "dump_jax"
    jax_preprocess(["wavallin", work["wav_dir"], str(ref), "--preset",
                    work["preset"], "--num-workers", "1"])
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(work["dump"])) == names
    assert len(names) == 2 * len(UTT_LENGTHS) + 1
    for name in names:
        a = open(os.path.join(work["dump"], name), "rb").read()
        b = open(ref / name, "rb").read()
        assert a == b, name


def test_preprocess_outputs_and_manifest(work):
    utts = parse_manifest(os.path.join(work["dump"], "train.txt"))
    assert [u.wave_path for u in utts] == [
        f"utt{i}-wave.npy" for i in range(len(UTT_LENGTHS))]
    for u in utts:
        wave = np.load(os.path.join(work["dump"], u.wave_path))
        feats = np.load(os.path.join(work["dump"], u.feat_path))
        assert feats.shape == (u.n_frames, 20) and feats.dtype == np.float32
        assert wave.dtype == np.int16
        assert len(wave) == u.n_frames * 128 and u.speaker_id is None


def test_preprocess_with_workers_and_unknown_plugin(work, tmp_path):
    out = tmp_path / "dump2"
    preprocess(["wavallin", work["wav_dir"], str(out), "--preset",
                work["preset"], "--num-workers", "2"])
    for name in os.listdir(work["dump"]):
        assert open(out / name, "rb").read() == open(
            os.path.join(work["dump"], name), "rb").read()
    with pytest.raises(ValueError, match="Unknown dataset plugin"):
        preprocess(["no_such_plugin_xyz", work["wav_dir"], str(out)])
    with pytest.raises(ValueError, match="no longer supported"):
        preprocess(["ljspeech", work["wav_dir"], str(out)])


def test_load_params_and_config_discovers_hparams(work):
    model, cfg, step = load_params_and_config(work["ckpt"], None, "")
    assert step == 3 and cfg.num_mels == 20 and cfg.layers == 2
    want = work["state"].model.state_dict()
    got = model.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("engine", ["scan", "cuda", "auto"])
def test_synthesis_cli_conditional(work, tmp_path, engine, capsys):
    mel = os.path.join(work["dump"], "utt1-feats.npy")
    dst = str(tmp_path / "out.wav")
    synthesis([work["ckpt"], dst, "--conditional", mel, "--device", "cpu",
               "--engine", engine, "--output-html"])
    x = _read(dst)
    assert len(x) == np.load(mel).shape[0] * 128
    assert np.isfinite(x).all() and x.std() > 0
    out = capsys.readouterr().out
    assert "step-3 model" in out and "<audio" in out


def test_synthesis_cli_seed_and_engines(work, tmp_path):
    """Same seed, same audio; another seed, other audio. The cuda engine's
    plain version (f32 sums in another order than the eager decoder, and
    another random stream) is a different draw, not an equal one."""
    mel = os.path.join(work["dump"], "utt1-feats.npy")
    outs = {}
    for tag, extra in (("a", ["--seed", "1"]), ("b", ["--seed", "1"]),
                       ("c", ["--seed", "2"])):
        dst = str(tmp_path / f"{tag}.wav")
        synthesis([work["ckpt"], dst, "--mel", mel, "--device", "cpu"] + extra)
        outs[tag] = _read(dst)
    assert np.array_equal(outs["a"], outs["b"])
    assert not np.array_equal(outs["a"], outs["c"])


def test_synthesis_cli_unconditional_into_directory(work, tmp_path):
    synthesis([work["ckpt"], str(tmp_path), "--length", "640",
               "--initial-value", "127", "--hparams", "cin_channels=-1",
               "--device", "cpu", "--file-name-suffix", "_u"])
    x = _read(str(tmp_path / "checkpoint_step000000003_u.wav"))
    assert len(x) == 640 and np.isfinite(x).all()


def test_synthesis_cli_raises_without_gpu(work, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthesis([work["ckpt"], str(tmp_path / "x.wav"), "--length", "64",
                   "--hparams", "cin_channels=-1"])


def test_evaluate_cli_pairs_and_manifest(work, tmp_path):
    out = str(tmp_path / "eval")
    evaluate([work["dump"], work["ckpt"], out, "--batch-size", "2",
              "--device", "cpu"])
    names = sorted(os.listdir(out))
    want = sorted([f"utt{i}_{k}.wav" for i in range(3)
                   for k in ("gen", "ref")] + ["eval_manifest.txt"])
    assert names == want
    for i in range(3):
        n = np.load(os.path.join(work["dump"], f"utt{i}-feats.npy")).shape[0]
        gen, ref = (_read(os.path.join(out, f"utt{i}_{k}.wav"))
                    for k in ("gen", "ref"))
        assert len(gen) == len(ref) == n * 128
        assert np.isfinite(gen).all()
    # 3 utterances > batch size: sorted by length, shortest first
    order = open(os.path.join(out, "eval_manifest.txt")).read().split()
    assert order == ["utt1_gen.wav", "utt2_gen.wav", "utt0_gen.wav"]


def test_evaluate_cli_ref_is_the_decoded_target(work, tmp_path):
    out = str(tmp_path / "eval")
    evaluate([work["dump"], work["ckpt"], out, "--num-utterances", "1",
              "--device", "cpu", "--engine", "scan", "--no-length-sort"])
    assert sorted(os.listdir(out)) == ["eval_manifest.txt", "utt0_gen.wav",
                                       "utt0_ref.wav"]
    from wavenet_vocoder_tpu_torch.ops.mulaw import inv_mulaw_quantize
    y = np.load(os.path.join(work["dump"], "utt0-wave.npy"))
    want = str(tmp_path / "want.wav")
    audio.save_wav(np.asarray(inv_mulaw_quantize(y, 255)), want, SR)
    assert np.array_equal(_read(os.path.join(out, "utt0_ref.wav")),
                          _read(want))


def test_evaluate_cli_mel_only(work, tmp_path):
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    for i in range(2):
        src = os.path.join(work["dump"], f"utt{i}-feats.npy")
        np.save(mel_dir / f"utt{i}-feats.npy", np.load(src))
    out = str(tmp_path / "eval")
    evaluate([str(mel_dir), work["ckpt"], out, "--batch-size", "2",
              "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["eval_manifest.txt", "utt0_gen.wav",
                                       "utt1_gen.wav"]


def test_evaluate_cli_speaker_prefixed_names(work, tmp_path):
    dump = tmp_path / "dump_ms"
    dump.mkdir()
    lines = []
    for i in range(2):
        feats = np.load(os.path.join(work["dump"], f"utt{i}-feats.npy"))
        np.save(dump / f"utt{i}-feats.npy", feats)
        lines.append(f"utt{i}-wave.npy|utt{i}-feats.npy|{len(feats)}|dummy|{i}")
    (dump / "train.txt").write_text("\n".join(lines) + "\n")
    cfg = work["cfg"].replace(gin_channels=4, n_speakers=2)
    exp = tmp_path / "exp_ms"
    path = ckpt.save_checkpoint(str(exp), create_train_state(cfg, device="cpu"),
                                global_step=1)
    (exp / "hparams.json").write_text(cfg.to_json())
    out = str(tmp_path / "eval")
    evaluate([str(dump), path, out, "--device", "cpu"])
    assert sorted(os.listdir(out)) == [
        "eval_manifest.txt", "speaker0_utt0_gen.wav", "speaker1_utt1_gen.wav"]


@pytest.mark.parametrize("flag", [["--mesh"], ["--distributed"],
                                  ["--num-processes", "2"]],
                         ids=["mesh", "distributed", "num_processes"])
def test_evaluate_cli_multi_device_flags_raise(work, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        evaluate([work["dump"], work["ckpt"], str(tmp_path / "e"),
                  "--device", "cpu"] + flag)
    assert not (tmp_path / "e").exists()


def test_evaluate_cli_empty_dump_dir(work, tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="No \\*-feats.npy"):
        evaluate([str(tmp_path / "empty"), work["ckpt"], str(tmp_path / "e"),
                  "--device", "cpu"])


def test_clis_read_a_checkpoint_the_jax_package_wrote(work, tmp_path):
    jcfg = JaxConfig().parse_json(json.dumps(PRESET))
    exp = tmp_path / "exp_jax"
    jax_ckpt.save_checkpoint(str(exp), jax_create_train_state(jcfg),
                             global_step=5)
    (exp / "hparams.json").write_text(jcfg.to_json())
    path = jax_ckpt.latest_path(str(exp))
    mel = os.path.join(work["dump"], "utt1-feats.npy")
    dst = str(tmp_path / "out.wav")
    synthesis([path, dst, "--conditional", mel, "--device", "cpu"])
    assert len(_read(dst)) == np.load(mel).shape[0] * 128
    out = str(tmp_path / "eval")
    evaluate([work["dump"], path, out, "--num-utterances", "1",
              "--device", "cpu"])
    assert "utt0_gen.wav" in os.listdir(out)
