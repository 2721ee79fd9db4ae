"""The port's tracing store (``utils/profiling.py``): spans and counters.

Aggregates count every span; intervals are kept only while recording is on
(a torch profiler records, or ``recording(True)``), on the profiler's own
clock, in a bounded buffer; spans nest and are counted from many threads,
the ``DataLoader``'s workers among them. On the card, a batch's copy of its
samples to the host lies inside the port's ``synth.fetch`` interval.
"""
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.data import dataset as tds
from wavenet_vocoder_tpu_torch.utils import profiling


@pytest.fixture
def off():
    """Recording switched off by the operator's switch, and left so."""
    profiling.recording(False)
    yield
    profiling.recording(False)


def _named(name):
    return [iv for iv in profiling.intervals() if iv[0] == name]


def test_aggregates_count_with_recording_off(off):
    assert not profiling.recording()
    before = profiling.totals().get("test.off", (0, 0.0))
    for _ in range(3):
        with profiling.span("test.off"):
            time.sleep(0.002)
    n, s = profiling.totals()["test.off"]
    assert n == before[0] + 3
    assert 0.006 <= s - before[1] < 1.0
    assert _named("test.off") == []


def test_intervals_only_while_recording(off):
    with profiling.span("test.switch"):
        pass
    t0 = time.time_ns()
    assert profiling.recording(True)
    with profiling.span("test.switch"):
        time.sleep(0.001)
    profiling.recording(False)
    with profiling.span("test.switch"):
        pass
    t1 = time.time_ns()
    got = _named("test.switch")
    assert len(got) == 1
    _, a, b = got[0]
    assert t0 <= a and a + 1_000_000 <= b <= t1
    assert profiling.totals()["test.switch"][0] >= 3
    # a profiler that records turns recording on, and only while it does
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        with profiling.span("test.switch"):
            pass
    assert not profiling.recording()
    assert len(_named("test.switch")) == 2


def test_interval_clock_is_the_profilers(off):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with profiling.span("test.clock"):
                torch.ones(64, 64).sum()
    ours = _named("test.clock")[-5:]
    theirs = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == "wavenet::test.clock")
    assert len(theirs) == len(ours) == 5
    for (_, a, b), (ka, kb) in zip(ours, theirs):
        assert abs(ka - a) < 1_000_000
        # the span's interval holds its profiler range
        assert a <= ka and kb <= b


def test_spans_nest(off):
    profiling.recording(True)
    with profiling.span("test.outer"):
        with profiling.span("test.inner"):
            time.sleep(0.001)
        with profiling.span("test.inner"):
            pass
    profiling.recording(False)
    (_, oa, ob), = _named("test.outer")[-1:]
    inner = _named("test.inner")[-2:]
    assert len(inner) == 2
    assert all(oa <= a <= b <= ob for _, a, b in inner)
    assert inner[0][2] <= inner[1][1]
    tot = profiling.totals()
    assert tot["test.outer"][1] >= tot["test.inner"][1] > 0


def test_spans_from_many_threads_are_all_counted():
    """More threads than cores, switching often: no update is lost."""
    before = profiling.totals().get("test.threads", (0, 0.0))[0]
    c0 = profiling.counters().get("test.threads", 0)
    workers = 2 * (os.cpu_count() or 4)

    def work(_):
        for _ in range(500):
            with profiling.span("test.threads"):
                pass
            profiling.count("test.threads", 2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(work, range(workers), timeout=60))
    finally:
        sys.setswitchinterval(interval)
    assert profiling.totals()["test.threads"][0] - before == workers * 500
    assert profiling.counters()["test.threads"] - c0 == workers * 500 * 2


def test_loader_workers_collates_are_all_counted(tmp_path):
    """Every batch the DataLoader's worker threads collate is one
    ``data.collate`` span."""
    hop = 64
    rs = np.random.RandomState(0)
    for i in range(12):
        frames = 12 + rs.randint(0, 20)
        np.save(tmp_path / f"u{i:02d}-wave.npy",
                rs.uniform(-0.7, 0.7, frames * hop).astype(np.float32))
        np.save(tmp_path / f"u{i:02d}-feats.npy",
                rs.randn(frames, 6).astype(np.float32))
    cfg = Config(sample_rate=16000, hop_size=hop, num_mels=6, cin_channels=6,
                 upsample_params={"upsample_scales": [4, 16]}, batch_size=2,
                 max_time_steps=640, cin_pad=2)
    loader = tds.DataLoader(tds.WaveNetDataset(str(tmp_path), cfg), cfg,
                            num_workers=3, seed=1)
    before = profiling.totals().get("data.collate", (0, 0.0))[0]
    batches = sum(1 for _ in range(2) for _ in loader)
    assert batches == 2 * len(loader) > 4
    assert profiling.totals()["data.collate"][0] - before == batches


def test_interval_buffer_is_bounded(off):
    profiling.recording(True)
    n = profiling.INTERVALS + 10
    for i in range(n):
        with profiling.span(f"test.bound.{i % 2}"):
            pass
    profiling.recording(False)
    kept = profiling.intervals()
    assert len(kept) == profiling.INTERVALS
    # the oldest went first
    assert kept[0][0] == "test.bound.0" and kept[-1][0] == "test.bound.1"
    assert all(a[1] <= b[1] for a, b in zip(kept, kept[1:]))


def test_counters_and_reset():
    profiling.count("test.counter")
    profiling.count("test.counter", 4)
    snap = profiling.counters()
    assert snap["test.counter"] >= 5
    snap["test.counter"] = -1        # a copy, not the store
    assert profiling.counters()["test.counter"] >= 5
    profiling.reset()
    assert profiling.counters() == {} and profiling.totals() == {}
    assert profiling.intervals() == []


def test_trace_line_reads_the_store():
    """``cli.train``'s closing line: every counter, and every span's count
    and mean ms."""
    from wavenet_vocoder_tpu_torch.cli.train import trace_summary
    with profiling.span("test.summary"):
        time.sleep(0.002)
    profiling.count("test.summary.launches", 3)
    out = trace_summary()
    assert out["counters"]["test.summary.launches"] >= 3
    s = out["spans"]["test.summary"]
    n, total = profiling.totals()["test.summary"]
    assert s["count"] == n and s["mean_ms"] == pytest.approx(1e3 * total / n)


@pytest.mark.cuda
def test_fetch_interval_holds_the_copy_to_the_host():
    """In one traced batch on the card, the copy of the samples to the host
    lies inside the port's ``synth.fetch`` interval."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wavenet_vocoder_tpu_torch.models.wavenet import (WaveNet,
                                                          spec_from_config)
    from wavenet_vocoder_tpu_torch.synthesis import Synthesizer
    cfg = Config(layers=4, stacks=2, residual_channels=8, gate_channels=16,
                 skip_out_channels=8, cin_channels=8, num_mels=8)
    torch.manual_seed(0)
    model = WaveNet(spec_from_config(cfg))
    synth = Synthesizer(model, cfg, engine="cuda")
    mel = torch.randn(4, 6, 8, device="cuda")
    synth(mel)                                   # built and warmed
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wav = synth(mel)
    assert wav.shape == (4, 6 * cfg.hop_size)
    copies = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if str(ev.device_type()).endswith("CUDA")
                    and "DtoH" in ev.name())
    (_, a, b), = _named("synth.fetch")[-1:]
    assert copies, "no copy to the host in the trace"
    ca, cb = copies[-1]
    assert a <= ca and cb <= b, (a, b, ca, cb)
