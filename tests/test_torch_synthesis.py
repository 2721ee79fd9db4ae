"""The port's batched synthesis in segments (``synthesis.Synthesizer``).

With the fused generator on one device, a batch is generated as segments of
``SEGMENT_STEPS`` steps that carry the generator's state, and each segment
is fetched and decoded, its inverse pre-emphasis carrying the IIR state,
while the next is generated. These tests hold the result to the bits of one
generator call and one ``_decode`` of the whole batch: on the CPU with the
generator's plain version, and on the card (``-m cuda``; this file imports
nothing of JAX, so it runs on a machine that has only the port).
"""
import math

import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu_torch import synthesis
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
from wavenet_vocoder_tpu_torch.ops.mulaw import inv_mulaw, inv_mulaw_codes
from wavenet_vocoder_tpu_torch.utils import profiling

TINY = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
            skip_out_channels=8, cin_channels=4, num_mels=4, cin_pad=1,
            upsample_params={"upsample_scales": [2, 2]}, hop_size=4)
MOL = dict(input_type="raw", out_channels=30, postprocess="inv_preemphasis",
           global_gain_scale=0.6)
MULAW256 = dict(input_type="mulaw-quantize", quantize_channels=256,
                out_channels=256, postprocess="inv_preemphasis")
DECODES = {
    "mol_preemph_gain": MOL,
    "mulaw_quantize": MULAW256,
    "mulaw_input": dict(input_type="mulaw", quantize_channels=256,
                        postprocess="inv_preemphasis"),
    "no_postprocess": dict(input_type="raw", postprocess=""),
}
SEG = 64


def _samples(cfg, B, T, seed):
    rng = np.random.RandomState(seed)
    if cfg.is_mulaw_quantize:
        return rng.randint(0, cfg.quantize_channels, (B, T)).astype(np.int32)
    return rng.uniform(-1, 1, (B, T)).astype(np.float32)


def _whole_rows_decode(cfg, samples):
    """The decode as whole rows, one filter call a row, with no state
    carried (reference: synthesis.py:66-86)."""
    mu = cfg.quantize_channels - 1
    if cfg.is_mulaw_quantize:
        wav = inv_mulaw_codes(samples, mu)
    elif cfg.input_type == "mulaw":
        wav = np.asarray(inv_mulaw(samples, mu))
    else:
        wav = samples
    if cfg.postprocess:
        wav = np.stack([audio.inv_preemphasis(w) for w in wav])
    if cfg.global_gain_scale > 0:
        wav = wav / cfg.global_gain_scale
    return wav.astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("T", [SEG - 23, SEG, 3 * SEG + 37],
                         ids=["T_lt_S", "T_eq_S", "T_ragged"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("case", sorted(DECODES))
def test_segment_decode_equals_whole_decode(case, B, T):
    """``_decode_segment`` over consecutive column segments, each given the
    state the one before returned, gives the bits of ``_decode`` of the
    whole batch, and those are the whole-rows decode's."""
    cfg = Config(**{**TINY, **DECODES[case]})
    x = _samples(cfg, B, T, seed=B * 1000 + T)
    whole = synthesis._decode(cfg, x)
    assert whole.dtype == np.float32 and whole.shape == (B, T)
    np.testing.assert_array_equal(_bits(whole),
                                  _bits(_whole_rows_decode(cfg, x)))
    parts, zi = [], None
    for a in range(0, T, SEG):
        part, zi = synthesis._decode_segment(cfg, x[:, a:a + SEG], zi)
        parts.append(part)
    assert (zi is None) == (cfg.postprocess != "inv_preemphasis")
    np.testing.assert_array_equal(_bits(np.concatenate(parts, axis=1)),
                                  _bits(whole))


def _model(cfg, seed=3):
    return WaveNet(spec_from_config(cfg),
                   generator=torch.Generator().manual_seed(seed))


def _one_call(synth, cfg, mel, seed, deterministic):
    """The batch as one generator call and one ``_decode``."""
    c = torch.as_tensor(synthesis.pad_mel_context(mel, cfg.cin_pad),
                        device=synth.device)
    samples = synth._gen(c=c, deterministic=deterministic,
                         seed=synthesis._seed_from(
                             torch.Generator().manual_seed(seed)))
    return synthesis._decode(cfg, samples.cpu().numpy())


def _counted(names):
    got = profiling.counters()
    return [got.get(n, 0) for n in names]


COUNTERS = ("synth.segments", "synth.overlapped_segments",
            "generate.launches")


@pytest.mark.parametrize("frames", [20, 21], ids=["whole_chunks", "ragged"])
@pytest.mark.parametrize("deterministic", [True, False],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("head", ["mol", "mulaw256"])
def test_segmented_synthesizer_equals_one_call(monkeypatch, head,
                                               deterministic, frames):
    """``Synthesizer(engine="cuda", device="cpu")`` in segments of 32 steps
    (chunks of 16; T = 80 or 84, three segments) equals one call of its
    generator and one ``_decode``, bit for bit; each segment but the last
    is decoded while a later one is queued."""
    monkeypatch.setattr(synthesis, "SEGMENT_STEPS", 32)
    cfg = Config(**{**TINY, **(MOL if head == "mol" else MULAW256)})
    synth = synthesis.Synthesizer(_model(cfg), cfg, engine="cuda",
                                  device="cpu", weight_dtype=torch.float32,
                                  chunk=16)
    mel = np.random.RandomState(frames).randn(2, frames, 4).astype(np.float32)
    before = _counted(COUNTERS)
    wav = synth(mel, deterministic=deterministic,
                generator=torch.Generator().manual_seed(7))
    segs, overlapped, _ = (a - b for a, b in zip(_counted(COUNTERS), before))
    T = frames * cfg.hop_size
    assert wav.shape == (2, T) and wav.dtype == np.float32
    assert segs == math.ceil(T / 32) == 3 and overlapped == segs - 1
    want = _one_call(synth, cfg, mel, 7, deterministic)
    np.testing.assert_array_equal(_bits(wav), _bits(want))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [True, False],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("head", ["mol", "mulaw256"])
def test_segmented_synthesizer_on_the_card(cuda, monkeypatch, head,
                                           deterministic):
    """On the card, in segments of 512 steps (T = 1,296: three, the last
    ragged): the array equals ``_decode`` of one call of the same generator
    bit for bit, with the same launches; ``synth.segments`` is ceil(T / S)
    and ``synth.overlapped_segments`` one fewer."""
    monkeypatch.setattr(synthesis, "SEGMENT_STEPS", 512)
    over = dict(TINY, upsample_params={"upsample_scales": [4, 4]},
                hop_size=16)
    cfg = Config(**{**over, **(MOL if head == "mol" else MULAW256)})
    synth = synthesis.Synthesizer(_model(cfg), cfg, engine="cuda")
    mel = np.random.RandomState(5).randn(3, 81, 4).astype(np.float32)
    T = 81 * cfg.hop_size
    for _ in range(2):                   # built and warmed, then counted
        before = _counted(COUNTERS)
        wav = synth(mel, deterministic=deterministic,
                    generator=torch.Generator().manual_seed(11))
        segs, overlapped, launches = (
            a - b for a, b in zip(_counted(COUNTERS), before))
    assert wav.shape == (3, T) and T == 1296
    assert segs == math.ceil(T / 512) == 3 and overlapped == 2
    before = _counted(COUNTERS)
    want = _one_call(synth, cfg, mel, 11, deterministic)
    assert _counted(COUNTERS)[2] - before[2] == launches == math.ceil(T / 256)
    np.testing.assert_array_equal(_bits(wav), _bits(want))
