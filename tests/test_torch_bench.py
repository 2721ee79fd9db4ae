"""The port's bench (wavenet_vocoder_tpu_torch/bench.py) against the JAX
package's root bench.py, on the CPU, and its profiling helpers
(utils/profiling.py) on the CPU.

Each mode runs with ``BENCH_DEVICE=cpu`` at a small model (the bench's
Config seam shrunk to 4 layers, 16/32/16, crop 1024) and must print one JSON
line whose keys are the JAX bench's (read from bench.py's source: every dict
with a "metric" key, its "detail" dict and the realtime-batch dict), plus the
power limit beside the device, with every timing field null and
``"device": "cpu"``. Without a card and without ``BENCH_DEVICE=cpu`` the
bench raises; the JAX bench's TPU options raise; the synthetic dump is the
JAX bench's byte for byte.
"""
import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu_torch import bench
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(layers=4, stacks=2, residual_channels=16, gate_channels=32,
             skip_out_channels=16, max_time_steps=1024)
# the port's additions to the JAX records: the power limit beside the card
ADDED = {"power_limit"}


def _jax_bench_records():
    """{(metric, has detail): (keys, detail keys)} and the realtime-batch
    dict's keys, from the JAX bench's source."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    records, rt_keys = {}, None

    def keys(d):
        return [k.value for k in d.keys if isinstance(k, ast.Constant)]

    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and "metric" in keys(node):
            ks = keys(node)
            metric = node.values[ks.index("metric")].value
            detail = (set(keys(node.values[ks.index("detail")]))
                      if "detail" in ks else None)
            records[(metric, detail is not None)] = (set(ks), detail)
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "rt_detail"
                        for t in node.targets)):
            rt_keys = set(keys(node.value))
    return records, rt_keys


JAX_RECORDS, JAX_RT_KEYS = _jax_bench_records()


@pytest.fixture
def small(monkeypatch, tmp_path):
    """BENCH_DEVICE=cpu at the small model; the BENCH_* variables cleared."""
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setattr(bench, "_config", lambda **o: Config(**{**SMALL, **o}))
    return monkeypatch


def _one_json_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def _assert_keys(rec, metric, detail=True):
    keys, dkeys = JAX_RECORDS[(metric, detail)]
    assert rec["metric"] == metric
    assert set(rec) == keys
    if detail:
        assert set(rec["detail"]) == dkeys | ADDED
        assert rec["detail"]["device"] == "cpu"
        assert rec["detail"]["power_limit"] is None


def test_jax_records_found():
    assert set(JAX_RECORDS) == {
        ("batched_synthesis_audio_sec_per_sec_per_chip", True),
        ("training_samples_per_sec_per_chip", True),
        ("training_samples_per_sec_per_chip", False),
        ("streaming_latency_per_stream_realtime_x", True)}
    assert JAX_RT_KEYS and "per_stream_realtime_x" in JAX_RT_KEYS


def test_synthesis_mode_cpu(small, capsys):
    small.setenv("BENCH_BATCH", "2")
    small.setenv("BENCH_RT_BATCH", "1")
    small.setenv("BENCH_SECONDS", "0.03")
    small.setenv("BENCH_ITERS", "1")
    small.setenv("BENCH_TRAIN_BATCH", "2")
    small.setenv("BENCH_TRAIN_ITERS", "1")
    small.setenv("BENCH_TRAIN_BLOCKS", "1")
    rec = bench.main()
    assert _one_json_line(capsys) == rec
    _assert_keys(rec, "batched_synthesis_audio_sec_per_sec_per_chip")
    d = rec["detail"]
    for k in ("samples_per_sec", "per_stream_realtime_x",
              "per_stream_realtime_x_best", "wall_s_per_iter", "wall_s_min",
              "wall_s_max"):
        assert d[k] is None, k
    assert rec["value"] is None and rec["vs_baseline"] is None
    assert d["batch"] == 2 and d["samples_per_utt"] == 512
    assert d["engine"] == "cuda" and d["model"] == "24L/4S MoL 128/256/128"
    rt = d["realtime_batch"]
    assert set(rt) == JAX_RT_KEYS and rt["batch"] == 1
    assert all(rt[k] is None for k in rt if k != "batch")
    tr = d["training"]
    assert "error" not in tr, tr
    keys, _ = JAX_RECORDS[("training_samples_per_sec_per_chip", False)]
    assert set(tr) == keys
    for k in ("value", "vs_baseline", "step_s", "step_s_min", "step_s_max",
              "mfu"):
        assert tr[k] is None, k
    assert np.isfinite(tr["loss"]) and tr["batch"] == 2 and tr["crop"] == 1024


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_train_mode_cpu(small, capsys, tmp_path, pipeline):
    small.setenv("BENCH_MODE", "train")
    small.setenv("BENCH_BATCH", "2")
    small.setenv("BENCH_ITERS", "1")
    small.setenv("BENCH_BLOCKS", "2")
    small.setenv("BENCH_PIPELINE", pipeline)
    small.setenv("BENCH_DATA_DIR", str(tmp_path / "dump"))
    rec = bench.main()
    assert _one_json_line(capsys) == rec
    _assert_keys(rec, "training_samples_per_sec_per_chip")
    d = rec["detail"]
    for k in ("step_s", "step_s_min", "step_s_max", "steps_per_s",
              "achieved_tflops_per_s", "mfu", "peak_tflops"):
        assert d[k] is None, k
    assert rec["value"] is None
    assert d["flops_source"] == "analytic_3x_forward"
    assert d["pipeline"] == ("real_dataloader" if pipeline == "1"
                             else "constant_batch")
    spec_flops = 3 * bench.flops_lib.forward_flops_per_sample(
        bench.spec_from_config(Config(**SMALL)))
    assert d["step_tflops"] == round(spec_flops * 2 * 1024 / 1e12, 3)
    assert np.isfinite(d["loss"]) and d["blocks"] == 2
    if pipeline == "1":
        assert os.path.exists(tmp_path / "dump" / "synth0047-wave.npy")


def test_latency_mode_cpu(small, capsys):
    small.setenv("BENCH_MODE", "latency")
    small.setenv("BENCH_SECONDS", "0.1")
    rec = bench.main()
    assert _one_json_line(capsys) == rec
    _assert_keys(rec, "streaming_latency_per_stream_realtime_x")
    d = rec["detail"]
    for k in ("first_audio_latency_ms", "wall_s", "aggregate_audio_sec_per_s"):
        assert d[k] is None, k
    assert rec["value"] is None
    assert d["streams"] == 1 and d["segment_samples"] == 1024
    # 8 frames of mel -> 8 * 256 samples
    assert d["total_audio_s"] == round(8 * 256 / 22050, 2)


def test_without_a_card_it_raises(small, monkeypatch):
    monkeypatch.delenv("BENCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    monkeypatch.setenv("BENCH_DEVICE", "tpu")
    with pytest.raises(ValueError, match="BENCH_DEVICE"):
        bench.main()


def test_module_entry_fails_without_a_card():
    """``python -m`` with no card: a non-zero exit and no record."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-m",
                           "wavenet_vocoder_tpu_torch.bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
    assert "jax" not in proc.stderr.lower()


@pytest.mark.parametrize("name,value", [
    ("BENCH_VARIANT", "split_taps"), ("BENCH_SPLIT_TAPS", "1"),
    ("BENCH_UNROLL", "2"), ("BENCH_VMEM_MB", "64")])
def test_unported_tpu_options_raise(small, name, value):
    small.setenv(name, value)
    with pytest.raises(NotImplementedError, match=name):
        bench.main()


def test_ported_defaults_of_those_options_pass(small):
    small.setenv("BENCH_VARIANT", "fused")
    small.setenv("BENCH_SPLIT_TAPS", "0")
    small.setenv("BENCH_UNROLL", "1")
    small.setenv("BENCH_REMAT", "0")
    bench.refuse_unported()


@pytest.mark.parametrize("policy", ["", "dots"])
def test_train_mode_remat_cpu(small, capsys, monkeypatch, policy):
    """BENCH_REMAT=1 (and BENCH_REMAT_POLICY) go to Config(remat=,
    remat_policy=), as the JAX bench passes them, and the train mode runs
    on the plain layer loop with them."""
    small.setenv("BENCH_MODE", "train")
    small.setenv("BENCH_BATCH", "2")
    small.setenv("BENCH_ITERS", "1")
    small.setenv("BENCH_BLOCKS", "1")
    small.setenv("BENCH_FUSED", "0")
    small.setenv("BENCH_REMAT", "1")
    small.setenv("BENCH_REMAT_POLICY", policy)
    seen = []
    monkeypatch.setattr(bench, "_config", lambda **o: seen.append(o) or
                        Config(**{**SMALL, **o}))
    rec = bench.main()
    assert _one_json_line(capsys) == rec
    assert np.isfinite(rec["detail"]["loss"])
    assert seen[0]["remat"] is True and seen[0]["remat_policy"] == policy
    assert seen[0]["fused_train"] is False


def test_unknown_model_and_engine_raise(small):
    small.setenv("BENCH_MODEL", "1024ch")
    with pytest.raises(ValueError, match="BENCH_MODEL"):
        bench.main()
    small.setenv("BENCH_MODEL", "flagship")
    small.setenv("BENCH_ENGINE", "pallas")
    with pytest.raises(ValueError, match="BENCH_ENGINE"):
        bench.main()


def test_bench_models_are_the_jax_benchs():
    """BENCH_MODEL's overrides and model names are the JAX bench's."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    found = [ast.literal_eval(n) for n in ast.walk(tree)
             if isinstance(n, ast.Dict) and [getattr(k, "value", None)
                                             for k in n.keys]
             == ["flagship", "30L3S", "512ch"]]
    assert bench.MODELS in found and bench.MODEL_NAMES in found


def _jax_bench_module(monkeypatch, tmp_path):
    # the JAX bench sets a compilation-cache default on import: keep it in
    # the test's directory and out of the environment afterwards
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_dump_equals_jax_benchs(monkeypatch, tmp_path):
    jb = _jax_bench_module(monkeypatch, tmp_path)
    cfg = Config(**SMALL)
    bench._make_synthetic_dump(str(tmp_path / "port"), cfg, n_utts=6, seed=3)
    jb._make_synthetic_dump(str(tmp_path / "jax"), cfg, n_utts=6, seed=3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 12
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


def test_trace_and_sync_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
        profiling.sync(y)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())
    profiling.sync(None)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and in a directory that holds it and nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(open(src, "rb").read())
        src, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, src], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode not in (0, None)
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
