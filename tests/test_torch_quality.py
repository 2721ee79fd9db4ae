"""The port's sampled-audio quality net (wavenet_vocoder_tpu_torch/scripts/
synthetic_e2e.py, quality_check.py) against the JAX package's script
(scripts/synthetic_e2e.py), on the CPU.

* The tone maker and the two scorers equal the JAX script's functions on
  the same inputs (exactly: the same numpy arithmetic).
* Per head, the corpus and the pool of 24 training batches, and the order
  the training loop draws them in, equal the JAX script's bit for bit. The
  JAX side is the JAX script's own ``main`` run with its device transfer and
  training step replaced by recorders (they keep each batch's digest and
  stop it after the draws; nothing is trained or compiled), and its corpus
  is the JAX script's ``make_utterance`` through the JAX package's host
  log-mel and mu-law on the Config its ``main`` built.
* A clean 220 Hz tone passes the scorer and a decoy fails it.
* ``main`` runs end to end on the CPU (plain versions of the kernels) in
  well under a minute: 2 steps, the held-out utterance shortened to 0.25 s
  by monkeypatching (the script's defaults are untouched); it prints the
  JAX script's record keys, and fails the thresholds.
* ``quality_spread`` by seed and arm: one seed twice gives one record, two
  seeds two initial losses; its paired tests count the discordant seeds.

The kernels' fault builds run only on the card (tests/test_torch_kernels.py,
chip_smoke.py phase 14); here their plumbing is checked.
"""
import ast
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu.dsp import audio as jdsp
from wavenet_vocoder_tpu.ops.mulaw import mulaw_quantize as jax_mulaw_quantize

from wavenet_vocoder_tpu_torch.kernels import build
from wavenet_vocoder_tpu_torch.ops import cuda_train
from wavenet_vocoder_tpu_torch.scripts import quality_check, quality_spread
from wavenet_vocoder_tpu_torch.scripts import synthetic_e2e as se

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "scripts", "synthetic_e2e.py")
DRAWS = 40          # training-loop draws compared


@pytest.fixture
def js(monkeypatch, tmp_path):
    """The JAX script as a module; its compilation-cache default stays in
    the test's directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    spec = importlib.util.spec_from_file_location("jax_synthetic_e2e",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tone_maker_and_scorers_equal_jax(js):
    for f0, secs, seed in ((220.0, 1.5, 99), (147, 2.0, 0), (440, 0.3, 7)):
        a = se.make_utterance(f0, 16000, secs, np.random.RandomState(seed))
        b = js.make_utterance(f0, 16000, secs, np.random.RandomState(seed))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert se.dominant_f0(a, 16000) == js.dominant_f0(b, 16000)
    rs = np.random.RandomState(3)
    m1, m2 = rs.randn(50, 128), rs.randn(47, 128)
    assert se.mel_correlation(m1, m2) == js.mel_correlation(m1, m2)
    assert se.mel_correlation(m1, m1) == pytest.approx(1.0)


def _digest(batch):
    return {k: (str(np.asarray(v).dtype), np.asarray(v).shape,
                hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest())
            for k, v in batch.items()}


class _Stop(Exception):
    pass


def _jax_run(js, monkeypatch, head):
    """The JAX script's main up to DRAWS training draws: (its Config, the
    digests of its pool's batches, the pool indices it drew)."""
    import jax

    import wavenet_vocoder_tpu.training.train_state as jts
    rec = {"pool": [], "order": []}

    def put(x):
        if isinstance(x, dict):         # a batch: keep its digest only
            rec["pool"].append(_digest(x))
            return len(rec["pool"]) - 1
        return x

    def create_train_state(cfg):
        rec["cfg"] = cfg

    def make_train_step(cfg, spec=None):
        def step(state, batch_index, key):
            rec["order"].append(batch_index)
            if len(rec["order"]) == DRAWS:
                raise _Stop
            return state, {"loss": 1.0}
        return step, None

    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jax, "device_put", put)
    monkeypatch.setattr(jts, "create_train_state", create_train_state)
    monkeypatch.setattr(jts, "make_train_step", make_train_step)
    with pytest.raises(_Stop):
        js.main(["--head", head, "--steps", str(DRAWS + 5)])
    return rec["cfg"], rec["pool"], rec["order"]


@pytest.mark.parametrize("head", se.HEADS)
def test_corpus_and_pool_equal_jax(js, monkeypatch, head):
    jcfg, jpool, jorder = _jax_run(js, monkeypatch, head)
    cfg = se.make_config(head)
    for key in ("sample_rate", "fft_size", "hop_size", "win_length",
                "num_mels", "fmin", "fmax", "cin_pad", "layers", "stacks",
                "residual_channels", "gate_channels", "skip_out_channels",
                "max_time_steps", "batch_size", "input_type",
                "quantize_channels", "out_channels", "output_distribution",
                "log_scale_min", "dropout", "fused_train", "compute_dtype",
                "optimizer", "optimizer_params", "lr_schedule",
                "upsample_params", "upsample_conditional_features"):
        assert getattr(cfg, key) == getattr(jcfg, key), key

    # the corpus: the JAX script's featurization on its own Config
    train_data, test_wav, test_mel = se.build_corpus(cfg)
    rs = np.random.RandomState(0)
    for f0, (target, mel) in zip(se.TRAIN_F0S, train_data):
        wav = js.make_utterance(f0, 16000, 2.0, rs)
        jmel = jdsp.logmelspectrogram(wav, jcfg)
        jt = (np.clip(wav, -1, 1).astype(np.float32) if jcfg.is_scalar_input
              else jax_mulaw_quantize(np.clip(wav, -1, 1),
                                      jcfg.quantize_channels - 1))
        n = min(len(jt) // jcfg.hop_size, jmel.shape[0])
        assert target.dtype == jt.dtype and mel.dtype == jmel.dtype
        np.testing.assert_array_equal(target, jt[:n * jcfg.hop_size])
        np.testing.assert_array_equal(mel, jmel[:n])
    jtest = js.make_utterance(220.0, 16000, 1.5, np.random.RandomState(99))
    np.testing.assert_array_equal(test_wav, jtest)
    jtest_mel = jdsp.logmelspectrogram(jtest, jcfg)
    np.testing.assert_array_equal(test_mel, jtest_mel[:len(test_mel)])

    # the pool, batch by batch (one in memory at a time), then the draws
    srs = np.random.RandomState(1)
    assert len(jpool) == se.POOL_SIZE
    for i, want in enumerate(jpool):
        assert _digest(se.sample_batch(cfg, train_data, srs)) == want, i
    assert [srs.randint(se.POOL_SIZE) for _ in range(DRAWS)] == jorder
    if head == "mol":      # batch_pool is that same pool
        pool = se.batch_pool(cfg, train_data, np.random.RandomState(1))
        assert [_digest(b) for b in pool] == jpool


def test_scorer_passes_a_clean_tone_and_fails_a_decoy():
    sr = 16000
    test_wav = se.make_utterance(220.0, sr, 1.5, np.random.RandomState(99))
    clean = se.make_utterance(220.0, sr, 1.5, np.random.RandomState(5))
    decoy = se.make_utterance(330.0, sr, 1.5, np.random.RandomState(5))
    octave = se.make_utterance(440.0, sr, 1.5, np.random.RandomState(5))
    rolls, f0_ref = se.score([clean, decoy, octave], test_wav, sr, 128,
                             0.05, se.MEL_CORR_MIN["mol"])
    assert f0_ref == pytest.approx(220.0, abs=1.0)
    ok, corr, f0, margin, _ = rolls[0]
    assert ok and corr >= 0.9 and margin > 0 and abs(f0 - 220) < 11
    for ok, corr, f0, margin, _ in rolls[1:]:
        assert not ok and margin < 0


def test_loss_drop_rules_are_the_jax_scripts():
    assert se.loss_dropped("mol", 10.0, 7.9)
    assert not se.loss_dropped("mol", 10.0, 8.1)
    assert se.loss_dropped("gaussian", 1.0, -0.1)
    assert not se.loss_dropped("gaussian", 1.0, 0.1)
    assert se.loss_dropped("mulaw256", 4.0, 1.9)
    assert not se.loss_dropped("mulaw256", 4.0, 2.1)


def _jax_record_keys():
    tree = ast.parse(open(JAX_SCRIPT).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                getattr(k, "value", None) == "head" for k in node.keys):
            return {k.value for k in node.keys}
    raise AssertionError("no record in the JAX script")


def _record(out):
    lines = [x for x in out.splitlines() if x.startswith('{"head"')]
    assert len(lines) == 1, out
    return json.loads(lines[0])


def test_main_runs_end_to_end_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(se, "HELD_OUT_SECONDS", 0.25)
    rc = se.main(["--head", "mol", "--steps", "2", "--device", "cpu",
                  "--out-dir", str(tmp_path)])
    rec = _record(capsys.readouterr().out)
    assert _jax_record_keys() <= set(rec)
    assert rec["device"] == "cpu" and rec["engine"] == "cuda"
    assert rec["fault"] == "none" and len(rec["rollouts"]) == 3
    assert np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_final"])
    assert rc == 1      # two steps cannot pass the thresholds
    assert os.path.getsize(tmp_path / "synthetic_e2e_mol_gen.wav") > 0
    assert cuda_train.FAULT == "none"


def test_quality_check_runs_one_head_on_the_cpu(monkeypatch, tmp_path,
                                                capsys):
    monkeypatch.setattr(se, "HELD_OUT_SECONDS", 0.25)
    rc = quality_check.main(["--heads", "gaussian", "--steps", "1",
                             "--device", "cpu", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert _record(out)["head"] == "gaussian"
    assert "gaussian: FAIL" in out and rc == 1


def test_quality_spread_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    # one repetition of one head: trained on the fused path's plain versions
    # and on the plain layer loop, each rolled out by the generation
    # kernel's plain version and (repetition 0) the eager decoder
    monkeypatch.setattr(se, "HELD_OUT_SECONDS", 0.25)
    out = tmp_path / "spread.json"
    assert quality_spread.main(["--heads", "gaussian", "--reps", "1",
                                "--steps", "1", "--device", "cpu",
                                "--out", str(out)]) == 0
    runs = json.loads(out.read_text())["runs"]
    assert [r["train"] for r in runs] == ["kernels", "plain loop"]
    for r in runs:
        assert r["head"] == "gaussian" and r["rep"] == 0
        for engine in ("cuda", "scan"):
            assert len(r[engine]) == se.N_ROLLOUTS
            assert r[engine + "_pass"] is False    # one step cannot pass
    text = capsys.readouterr().out
    assert text.count("[spread] {") == 2
    assert "gaussian, trained on the plain loop, rolled out by scan: 0/1" in text


def test_quality_spread_seeds_repeat_and_differ(monkeypatch, tmp_path):
    # the plain loop at one step: seed 0 twice gives the same record (all
    # but its seconds), seeds 0 and 1 different initial losses
    monkeypatch.setattr(se, "HELD_OUT_SECONDS", 0.25)
    out = tmp_path / "spread.json"
    assert quality_spread.main(["--heads", "mol", "--seeds", "0,1,0",
                                "--arms", "loop", "--steps", "1",
                                "--scan-reps", "0", "--device", "cpu",
                                "--out", str(out)]) == 0
    runs = json.loads(out.read_text())["runs"]
    assert [(r["seed"], r["arm"], r["train"]) for r in runs] == [
        (0, "loop", "plain loop"), (1, "loop", "plain loop"),
        (0, "loop", "plain loop")]
    strip = lambda r: {k: v for k, v in r.items() if k != "train_s"}
    assert strip(runs[0]) == strip(runs[2])
    assert runs[0]["loss_first"] != runs[1]["loss_first"]
    assert "scan" not in runs[0] and len(runs[0]["cuda"]) == se.N_ROLLOUTS


def test_quality_spread_paired_tests():
    # five seeds: arm a passes where b does on seeds 0-1, fails where b
    # passes on 2-4; best corr lower on four seeds, equal on one
    def rec(arm, seed, ok, corr):
        return dict(head="mol", arm=arm, seed=seed, rep=0, cuda_pass=ok,
                    cuda=[[corr, 220.0, 0.1, ok], [corr - 0.1, 0.0, 0.0, False]])
    runs = []
    for seed, (a_ok, b_ok, a_c, b_c) in enumerate([
            (True, True, 0.93, 0.94), (False, False, 0.90, 0.91),
            (False, True, 0.91, 0.95), (False, True, 0.92, 0.93),
            (False, True, 0.92, 0.92)]):
        runs += [rec("kernels", seed, a_ok, a_c), rec("loop", seed, b_ok, b_c)]
    p = quality_spread.paired(runs, "mol", "kernels", "loop")
    assert p["seeds"] == 5
    assert (p["a_pass_b_fail"], p["a_fail_b_pass"]) == (0, 3)
    assert p["mcnemar_p"] == 1 / 8                   # 3 of 3 discordant
    assert (p["corr_lower"], p["corr_higher"]) == (4, 0)
    assert p["sign_p"] == 1 / 16                     # 4 of 4, one tie
    q = quality_spread.paired(runs, "mol", "loop", "kernels")
    assert q["mcnemar_p"] == 1.0 and q["sign_p"] == 1.0
    with pytest.raises(SystemExit):
        quality_spread.main(["--arms", "kernels,xla", "--device", "cpu"])


def test_fault_refusals():
    # the mask fault is a no-op at dropout 0 (mulaw256), as in JAX
    with pytest.raises(SystemExit, match="dropout>0"):
        se.main(["--head", "mulaw256", "--fault", "bwd_mask_tshift",
                 "--device", "cpu"])
    # the faults live in the backward kernel: not on the CPU, not with --xla
    with pytest.raises(SystemExit, match="backward kernel"):
        se.main(["--head", "mol", "--fault", "bwd_x_shift", "--device", "cpu"])
    with pytest.raises(SystemExit):
        se.main(["--head", "mol", "--fault", "bwd_bnd_roll", "--device", "cpu"])
    assert cuda_train.FAULT == "none"


def test_fault_builds_are_libraries_of_their_own():
    with pytest.raises(ValueError, match="fault"):
        cuda_train.set_fault("bwd_bnd_roll")
    assert set(cuda_train.FAULTS) == {"none", "bwd_mask_tshift",
                                      "bwd_x_shift"}
    libs = {build._target("train_bwd", d)[1]
            for d in cuda_train.FAULTS.values()}
    assert len(libs) == 3
    assert build._target("train_bwd", ())[1] in libs
    src = (build.CSRC / "train_bwd.cu").read_text()
    for defines in cuda_train.FAULTS.values():
        for d in defines:
            assert f"#ifdef {d}" in src
