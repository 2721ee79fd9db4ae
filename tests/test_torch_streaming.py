"""PyTorch port: streaming synthesis == offline synthesis, elementwise.

The cases of tests/test_streaming.py for the port's ``StreamingSynthesizer``
and both of its engines. On the CPU the ``"cuda"`` engine runs the
generation kernel's plain version with the same carried state (packed ring,
next input, absolute step), so these tests hold the state carry, the
conditioning windows at chunk boundaries and the streamed IIR decode; the
kernel itself streams on a GPU in chip_smoke.py. One deterministic case is
held against the JAX package's ``StreamingSynthesizer`` within 1e-4 (f32 on
both sides, sums in another order).
"""
import numpy as np
import pytest

import jax
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.models.wavenet import (
    init_wavenet,
    spec_from_config as jax_spec_from_config,
)
from wavenet_vocoder_tpu.streaming import (
    StreamingSynthesizer as JaxStreamingSynthesizer,
)

from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
from wavenet_vocoder_tpu_torch.ops.cuda_generate import FusedGenerator
from wavenet_vocoder_tpu_torch.ops.generate import generate
from wavenet_vocoder_tpu_torch.streaming import StreamingSynthesizer
from wavenet_vocoder_tpu_torch.synthesis import Synthesizer

torch.set_num_threads(1)

TINY = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
            skip_out_channels=8, cin_channels=5, cin_pad=1,
            upsample_conditional_features=True,
            upsample_params={"upsample_scales": [2, 2]}, hop_size=4,
            compute_dtype="")
MOL = dict(input_type="raw", out_channels=30, output_distribution="Logistic",
           quantize_channels=65536)
MULAW = dict(input_type="mulaw-quantize", quantize_channels=256,
             out_channels=256)
ENGINES = ["scan", "cuda"]


def _setup(**kw):
    cfg = Config(**{**TINY, **kw})
    model = WaveNet(spec_from_config(cfg),
                    generator=torch.Generator().manual_seed(0))
    return cfg, model.eval()


def _engine_kw(engine):
    # f32 packs on the CPU: exactness is about the carried state
    return dict(weight_dtype=torch.float32) if engine == "cuda" else {}


def _offline(model, cfg, mel, seed, engine, g=None, **kw):
    synth = Synthesizer(model, cfg, engine=engine, device="cpu",
                        **_engine_kw(engine))
    return synth(mel, g=g, generator=torch.Generator().manual_seed(seed), **kw)


def _stream(model, cfg, mel, seed, chunks, engine, g=None, **kw):
    s = StreamingSynthesizer(
        model, cfg, generator=torch.Generator().manual_seed(seed),
        batch=mel.shape[0], g=g, engine=engine, device="cpu",
        **_engine_kw(engine), **kw)
    outs, i = [], 0
    for n in chunks:
        outs.append(s.feed(mel[:, i:i + n]))
        i += n
    assert i == mel.shape[1], "chunk plan must cover the mel"
    outs.append(s.flush())
    return np.concatenate(outs, axis=1), s


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("chunks", [[12], [3, 4, 5], [1] * 12, [6, 6]],
                         ids=["whole", "3-4-5", "ones", "6-6"])
def test_stream_equals_offline_mol(chunks, engine):
    cfg, model = _setup(**MOL)
    mel = np.random.RandomState(0).randn(2, 12, 5).astype(np.float32)
    ref = _offline(model, cfg, mel, 7, engine)
    got, s = _stream(model, cfg, mel, 7, chunks, engine)
    assert got.shape == ref.shape == (2, 12 * cfg.hop_size)
    assert float(np.std(ref)) > 0
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert s.lookahead_frames == cfg.cin_pad + 2  # 2 upsample scales
    assert s.algorithmic_latency_samples == 3 * cfg.hop_size


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_equals_offline_mulaw_sampled(engine):
    cfg, model = _setup(**MULAW)
    mel = np.random.RandomState(1).randn(1, 10, 5).astype(np.float32)
    ref = _offline(model, cfg, mel, 3, engine)
    got, _ = _stream(model, cfg, mel, 3, [4, 3, 3], engine)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_preemphasis_iir_state(engine):
    cfg, model = _setup(**MOL, postprocess="inv_preemphasis",
                        global_gain_scale=0.55)
    mel = np.random.RandomState(2).randn(1, 9, 5).astype(np.float32)
    ref = _offline(model, cfg, mel, 11, engine)
    got, _ = _stream(model, cfg, mel, 11, [2, 2, 2, 3], engine)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_no_upsample_feature_repeat(engine):
    cfg, model = _setup(**MOL, upsample_conditional_features=False,
                        upsample_params={}, cin_pad=0)
    mel = np.random.RandomState(3).randn(1, 8, 5).astype(np.float32)
    # offline no-upsample path: features repeated to the sample rate
    rep = np.repeat(mel, cfg.hop_size, axis=1)
    ref = _offline(model, cfg, rep, 5, engine, T=rep.shape[1],
                   pad_context=False)
    got, s = _stream(model, cfg, mel, 5, [5, 3], engine)
    assert s.lookahead_frames == 0
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_global_conditioning(engine):
    cfg, model = _setup(**MULAW, gin_channels=6, n_speakers=3,
                        use_speaker_embedding=True)
    mel = np.random.RandomState(4).randn(2, 8, 5).astype(np.float32)
    g = np.array([0, 2])
    ref = _offline(model, cfg, mel, 9, engine, g=g)
    got, _ = _stream(model, cfg, mel, 9, [4, 4], engine, g=g)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_reset_and_finish_guard(engine):
    cfg, model = _setup(**MOL)
    mel = np.random.RandomState(5).randn(1, 6, 5).astype(np.float32)
    first, s = _stream(model, cfg, mel, 1, [6], engine)
    with pytest.raises(RuntimeError):
        s.feed(mel)
    assert s.flush().shape == (1, 0)
    s.reset()
    again = np.concatenate([s.feed(mel), s.flush()], axis=1)
    assert again.shape == (1, 6 * cfg.hop_size)
    # reset rewinds the generator: the restarted stream repeats itself
    np.testing.assert_array_equal(again, first)
    s.reset()
    with pytest.raises(ValueError, match="mel must be"):
        s.feed(mel[0])                        # not (B, F, D)


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_categorical_deterministic(engine):
    cfg, model = _setup(**MULAW)
    mel = np.random.RandomState(1).randn(1, 10, 5).astype(np.float32)
    ref = _offline(model, cfg, mel, 3, engine, deterministic=True)
    got, _ = _stream(model, cfg, mel, 3, [4, 3, 3], engine,
                     deterministic=True)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_cuda_engine_stream_equals_scan_engine_stream():
    cfg, model = _setup(**MOL)
    mel = np.random.RandomState(6).randn(2, 9, 5).astype(np.float32)
    a, _ = _stream(model, cfg, mel, 0, [4, 5], "cuda", deterministic=True)
    b, _ = _stream(model, cfg, mel, 0, [2, 7], "scan", deterministic=True)
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_segment_alignment_error():
    """Non-chunk-aligned segments must fail loudly, not corrupt state."""
    cfg, model = _setup(**MULAW)
    gen = FusedGenerator(model, weight_dtype=torch.float32, chunk=16)
    c_up = torch.zeros(1, 24, 5)
    with pytest.raises(ValueError, match="multiples of the kernel chunk"):
        gen(T=24, c_up=c_up, return_state=True)
    out, state = gen(T=32, c_up=torch.zeros(1, 32, 5), return_state=True)
    assert out.shape == (1, 32) and state[2] == 32
    with pytest.raises(ValueError, match="multiples of the kernel chunk"):
        gen(T=24, c_up=c_up, state=state)
    with pytest.raises(ValueError, match="not both"):
        gen(T=32, c=torch.zeros(1, 32, 5), c_up=torch.zeros(1, 32, 5))


@pytest.mark.parametrize("engine", ENGINES)
def test_decoder_state_carry_equals_one_call(engine):
    """The decoders' own ``state=`` / ``return_state=``: two calls equal one,
    and the eager decoder leaves the state it was given untouched."""
    cfg, model = _setup(**MOL)
    c_up = torch.from_numpy(
        np.random.RandomState(8).randn(2, 32, 5).astype(np.float32))
    if engine == "cuda":
        gen = FusedGenerator(model, weight_dtype=torch.float32, chunk=8)
        whole = gen(c_up=c_up, seed=4)
        a, st = gen(c_up=c_up[:, :8], seed=4, return_state=True)
        b, st = gen(c_up=c_up[:, 8:], seed=4, state=st, return_state=True)
    else:
        whole = generate(model, c_up=c_up,
                         generator=torch.Generator().manual_seed(4))["samples"]
        g2 = torch.Generator().manual_seed(4)
        o1 = generate(model, c_up=c_up[:, :8], generator=g2,
                      return_state=True)
        kept = [b.clone() for b in o1["state"][1]]
        o2 = generate(model, c_up=c_up[:, 8:], generator=g2,
                      state=o1["state"], return_state=True)
        for b0, b1 in zip(kept, o1["state"][1]):
            assert torch.equal(b0, b1)
        a, b, st = o1["samples"], o2["samples"], o2["state"]
    assert st[2] == 32
    assert torch.equal(torch.cat([a, b], dim=1), whole)


def test_resumed_decoder_takes_no_test_inputs():
    """Teacher-forcing inputs are indexed from a call's first step, so a
    resumed call refuses them rather than read the wrong rows."""
    cfg, model = _setup(**MOL)
    forced = torch.zeros(1, 4, 1)
    out = generate(model, T=8, c_up=torch.zeros(1, 8, 5), test_inputs=forced,
                   return_state=True)
    assert out["samples"].shape == (1, 8, 1) and out["state"][2] == 8
    with pytest.raises(ValueError, match="resumed state"):
        generate(model, c_up=torch.zeros(1, 8, 5), test_inputs=forced,
                 state=out["state"])


def test_deterministic_stream_matches_jax_stream():
    over = {**TINY, **MOL}
    jcfg, cfg = JaxConfig(**over), Config(**over)
    jspec = jax_spec_from_config(jcfg)
    params = jax.tree.map(np.asarray,
                          init_wavenet(jax.random.PRNGKey(0), jspec))
    model = WaveNet(spec_from_config(cfg))
    model.load_state_dict(state_dict_from_jax(params, model.spec))
    mel = np.random.RandomState(0).randn(2, 12, 5).astype(np.float32)

    js = JaxStreamingSynthesizer(params, jcfg, rng=jax.random.PRNGKey(7),
                                 batch=2, engine="pallas", interpret=True,
                                 weight_dtype=jax.numpy.float32,
                                 deterministic=True)
    ref = np.concatenate([js.feed(mel[:, :3]), js.feed(mel[:, 3:7]),
                          js.feed(mel[:, 7:]), js.flush()], axis=1)
    assert js.lookahead_frames == 3
    for engine in ENGINES:
        got, s = _stream(model.eval(), cfg, mel, 7, [3, 4, 5], engine,
                         deterministic=True)
        assert s.lookahead_frames == js.lookahead_frames
        assert got.shape == ref.shape == (2, 48)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_stream_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, model = _setup(**MOL)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSynthesizer(model, cfg)
