"""PyTorch port vs the JAX package: the data pipeline (``data/``), on the
CPU.

Dumps are made with numpy from a seed, one per kind the loader handles:
upsampled mel with cin_pad context (mu-law codes), sample-rate conditioning
with cin_pad > 0 (raw input), unconditional mu-law codes (silence trim), a
multi-speaker manifest, ``max_time_sec``, and a mu-law input. For each, the
port's ``DataLoader`` yields the same x, y, c, g and input_lengths as the JAX
package's, bit for bit, over two epochs at ``num_workers`` 0 and 1 (with more
workers both share one RandomState across threads, so the order of crop
draws depends on scheduling in both). Sampler permutations, the min-length
filter, ``shard``, the boundary-length crop and the native helpers are
compared the same way; ``prefetch_to_device`` on the CPU keeps order and
reads ``depth`` batches ahead, as the JAX package's does.
"""
import os

import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.data import dataset as jds
from wavenet_vocoder_tpu.data import native as jnative

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.data import dataset as tds
from wavenet_vocoder_tpu_torch.data import native as tnative
from wavenet_vocoder_tpu_torch.data.prefetch import prefetch_to_device

HOP = 64
BASE = dict(sample_rate=16000, hop_size=HOP, num_mels=6, cin_channels=6,
            upsample_params={"upsample_scales": [4, 16]}, batch_size=2,
            max_time_steps=640, num_workers=0, seed=5)
KINDS = {
    "upsample_mulaw_quantize": dict(
        input_type="mulaw-quantize", quantize_channels=256, out_channels=256,
        cin_pad=2),
    "sample_rate_cond_cin_pad": dict(
        upsample_conditional_features=False, cin_pad=2,
        silence_threshold=0),
    "unconditional_mulaw_quantize": dict(
        input_type="mulaw-quantize", quantize_channels=256, out_channels=256,
        cin_channels=-1),
    "multi_speaker": dict(gin_channels=4, n_speakers=3, cin_pad=1),
    "max_time_sec": dict(max_time_sec=0.05, max_time_steps=None, cin_pad=2),
    "mulaw_input": dict(input_type="mulaw", quantize_channels=256,
                        cin_pad=0),
}


def _write_dump(root, kw, n=7, seed=0):
    """n utterances of 6-30 frames (a few below the min-length filter),
    codes or floats by input type; a train.txt manifest for the
    multi-speaker kind, the glob layout otherwise."""
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n):
        frames = 6 + rs.randint(0, 25)
        if kw.get("input_type") == "mulaw-quantize":
            wave = rs.randint(0, 256, frames * HOP).astype(np.int16)
        else:
            wave = rs.uniform(-0.7, 0.7, frames * HOP).astype(np.float32)
        feats = rs.randn(frames, BASE["num_mels"]).astype(np.float32)
        np.save(os.path.join(root, f"u{i:02d}-wave.npy"), wave)
        np.save(os.path.join(root, f"u{i:02d}-feats.npy"), feats)
        lines.append(f"u{i:02d}-wave.npy|u{i:02d}-feats.npy|{frames}|text {i}"
                     f"|{i % 3}")
    if kw.get("gin_channels", -1) > 0:
        with open(os.path.join(root, "train.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    root = tmp_path_factory.mktemp("dumps")
    return {k: _write_dump(str(root / k), kw, seed=i)
            for i, (k, kw) in enumerate(sorted(KINDS.items()))}


def _cfgs(kind, **over):
    kw = {**BASE, **KINDS[kind], **over}
    return JaxConfig(**kw), Config(**kw)


def _assert_batches_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("workers", [0, 1])
@pytest.mark.parametrize("shuffle", [True, False], ids=["train", "dev"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_loader_yields_the_jax_batches(dumps, kind, shuffle, workers):
    jcfg, cfg = _cfgs(kind)
    jl = jds.DataLoader(jds.WaveNetDataset(dumps[kind], jcfg), jcfg,
                        shuffle=shuffle, num_workers=workers, seed=jcfg.seed)
    tl = tds.DataLoader(tds.WaveNetDataset(dumps[kind], cfg), cfg,
                        shuffle=shuffle, num_workers=workers, seed=cfg.seed)
    assert len(tl) == len(jl) > 0
    n = 0
    for epoch in range(2):
        for i, (tb, jb) in enumerate(zip(tl, jl)):
            _assert_batches_equal(tb, jb, f"{kind} epoch {epoch} batch {i}")
            n += 1
    assert n == 2 * len(jl)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dataset_filter_and_shard_match(dumps, kind):
    jcfg, cfg = _cfgs(kind)
    jd, td = jds.WaveNetDataset(dumps[kind], jcfg), tds.WaveNetDataset(
        dumps[kind], cfg)
    assert len(td) == len(jd) < 7      # the short ones were dropped
    assert [u.__dict__ for u in td.utterances] == [
        u.__dict__ for u in jd.utterances]
    assert td.multi_speaker == jd.multi_speaker
    np.testing.assert_array_equal(td.lengths(), jd.lengths())
    for n_proc in (1, 2, 3):
        for pid in range(n_proc):
            if len(jd) // n_proc == 0:
                with pytest.raises(ValueError):
                    td.shard(pid, n_proc)
                continue
            assert [u.wave_path for u in td.shard(pid, n_proc).utterances] \
                == [u.wave_path for u in jd.shard(pid, n_proc).utterances]
    w_t, c_t, g_t = td[0]
    w_j, c_j, g_j = jd[0]
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(c_t, c_j)
    assert g_t == g_j


def test_speaker_filter_matches(dumps):
    jcfg, cfg = _cfgs("multi_speaker")
    kept = 0
    for spk in (0, 1, 2):
        try:
            j = jds.WaveNetDataset(dumps["multi_speaker"], jcfg,
                                   speaker_id=spk)
        except ValueError:
            # every utterance of this speaker is below the crop: both refuse
            with pytest.raises(ValueError, match="No usable utterances"):
                tds.WaveNetDataset(dumps["multi_speaker"], cfg,
                                   speaker_id=spk)
            continue
        t = tds.WaveNetDataset(dumps["multi_speaker"], cfg, speaker_id=spk)
        assert [u.wave_path for u in t.utterances] == [
            u.wave_path for u in j.utterances]
        assert {u.speaker_id for u in t.utterances} == {spk}
        kept += 1
    assert kept >= 2


@pytest.mark.parametrize("n,batch,group,drop_last", [
    (37, 4, None, True), (37, 4, None, False), (16, 3, 6, True),
    (5, 8, None, False), (100, 8, 16, True)])
def test_sampler_permutations_match(n, batch, group, drop_last):
    lengths = np.random.RandomState(n).randint(10, 500, n)
    t = tds.LengthBucketSampler(lengths, batch, group, drop_last, seed=3)
    j = jds.LengthBucketSampler(lengths, batch, group, drop_last, seed=3)
    assert len(t) == len(j)
    for _ in range(3):
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("frames", [12, 13, 20])
def test_boundary_length_crop_matches(frames):
    """tests/test_data.py's boundary case (longer than the crop, too short
    for cin_pad context on both sides) and its neighbours: the same crop."""
    kw = dict(input_type="mulaw-quantize", quantize_channels=256,
              out_channels=256, sample_rate=16000, hop_size=128,
              num_mels=20, cin_channels=20, cin_pad=2, max_time_steps=1280,
              upsample_params={"upsample_scales": [4, 4, 8]})
    x = np.random.RandomState(0).randint(0, 256, frames * 128)
    c = np.random.RandomState(1).randn(frames, 20).astype(np.float32)
    got = tds.collate_fn([(x, c, None)], Config(**kw),
                         rng=np.random.RandomState(0))
    want = jds.collate_fn([(x, c, None)], JaxConfig(**kw),
                          rng=np.random.RandomState(0))
    _assert_batches_equal(got, want, f"{frames} frames")


def test_helpers_match():
    jcfg, cfg = _cfgs("max_time_sec")
    assert tds.effective_max_time_steps(cfg) == jds.effective_max_time_steps(
        jcfg) == 800
    for n in (0, 255, 256, 257, 1000):
        for lower in (True, False):
            assert tds.ensure_divisible(n, 256, lower) == jds.ensure_divisible(
                n, 256, lower)


def test_glob_fallback_and_manifest_match(dumps):
    for kind in ("upsample_mulaw_quantize", "multi_speaker"):
        d = dumps[kind]
        assert [u.__dict__ for u in tds.glob_fallback(d)] == [
            u.__dict__ for u in jds.glob_fallback(d)]
    m = os.path.join(dumps["multi_speaker"], "train.txt")
    assert [u.__dict__ for u in tds.parse_manifest(m)] == [
        u.__dict__ for u in jds.parse_manifest(m)]


@pytest.mark.parametrize("lib", [True, False], ids=["native", "numpy"])
def test_native_matches_the_jax_native(lib, monkeypatch):
    """The same library (or, switched off, each package's numpy fallback)
    gives the same arrays."""
    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "_TRIED", not lib)
        monkeypatch.setattr(mod, "_LIB", None)
    assert tnative.available() == jnative.available()
    rs = np.random.RandomState(0)
    codes = rs.randint(0, 256, (3, 50)).astype(np.int32)
    x = rs.uniform(-1, 1, 400).astype(np.float32)
    np.testing.assert_array_equal(tnative.onehot(codes, 256),
                                  jnative.onehot(codes, 256))
    for fn in ("mulaw", "mulaw_quantize", "inv_mulaw"):
        got, want = getattr(tnative, fn)(x, 255), getattr(jnative, fn)(x, 255)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=0 if lib else 1e-6, err_msg=fn)
    q = jnative.mulaw_quantize(x, 255)
    np.testing.assert_allclose(tnative.inv_mulaw_quantize(q, 255),
                               jnative.inv_mulaw_quantize(q, 255), rtol=0,
                               atol=0 if lib else 1e-6)
    arrays = [rs.randint(0, 256, n).astype(np.int32) for n in (90, 60, 75)]
    starts = [3, 0, 10]
    tx, ty = tnative.crop_onehot_batch(arrays, starts, 50, 256)
    jx, jy = jnative.crop_onehot_batch(arrays, starts, 50, 256)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)


def test_native_switch_is_shared(monkeypatch):
    monkeypatch.setenv("WAVENET_TPU_NATIVE", "0")
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "_LIB", None)
    assert not tnative.available()
    assert tnative._SO_PATH == jnative._SO_PATH


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_on_the_cpu_keeps_order_and_depth(depth):
    """Batches come out in order as CPU tensors (no copy of what the
    loader made), and when the first is yielded ``depth`` + 1 have been
    drawn, as the JAX package's prefetch draws them."""
    from wavenet_vocoder_tpu.data.prefetch import (
        prefetch_to_device as jax_prefetch)

    def source(drawn, n=6):
        for i in range(n):
            drawn.append(i)
            yield {"x": np.full((2, 3), i, np.float32),
                   "input_lengths": np.asarray([i, i], np.int32)}

    drawn, jdrawn = [], []
    got = prefetch_to_device(source(drawn), depth=depth, device="cpu")
    want = jax_prefetch(source(jdrawn), depth=depth, put=lambda b: b)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 0:
            assert len(drawn) == len(jdrawn) == min(depth + 1, 6)
        assert isinstance(g["x"], torch.Tensor) and g["x"].device.type == "cpu"
        np.testing.assert_array_equal(g["x"].numpy(), w["x"])
        np.testing.assert_array_equal(g["input_lengths"].numpy(),
                                      w["input_lengths"])
        assert int(g["x"][0, 0]) == i
    assert len(drawn) == 6


def test_prefetch_put_and_device_default():
    """``put`` replaces the placement; without a device and without a GPU
    the prefetch raises, as every entry point of the port does."""
    seen = []
    out = list(prefetch_to_device(iter([1, 2, 3]), put=lambda b: seen.append(b)
                                  or b * 10, device="cpu"))
    assert out == [10, 20, 30] and seen == [1, 2, 3]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(prefetch_to_device(iter([1])))
