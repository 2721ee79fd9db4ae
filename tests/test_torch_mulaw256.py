"""r9y9's mu-law 256 recipe (``egs/mulaw256/conf/mulaw256_wavenet.json``) on
the port, on the CPU: the plain version of the generation kernel against
the benchmark's plain reference at the recipe's structure, the one-hot input
the kernel reads as codes, and the host's inverse mu-law (its table and its
spans).

The kernel itself (its categorical head split over the cluster) runs on a
GPU: ``tests/test_torch_kernels.py``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import harness
from benchmark.reference import wavenet as ref
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
from wavenet_vocoder_tpu_torch.ops.mulaw import inv_mulaw_codes, inv_mulaw_quantize
from wavenet_vocoder_tpu_torch.streaming import StreamingSynthesizer
from wavenet_vocoder_tpu_torch.synthesis import Synthesizer
from wavenet_vocoder_tpu_torch.utils import profiling

torch.set_num_threads(1)

EGS = Path(__file__).resolve().parent.parent / "egs"
RECIPE = json.loads((EGS / "mulaw256/conf/mulaw256_wavenet.json").read_text())
# f32 on both sides; the port folds weight norm once and sums each product
# in its own order (the packed [taps | cond] depth), the reference per conv:
# 30 layers of such rounding reach ~2e-6 on logits up to ~6 here
LOGIT_ATOL = 1e-4


def test_plain_path_holds_against_the_reference_at_the_recipes_structure(
        monkeypatch):
    """30 layers in 3 stacks, one-hot 256 in, 256 classes, 80 mels, at
    residual/gate/skip widths 8/16/8 with seeded weights: the plain version
    of the kernel, greedy from an empty ring, gives at every step the
    logits of the reference's teacher-forced forward over the codes it
    emitted (one-hot of [127, codes[:-1]]), and the reference's argmax."""
    keys = dict(RECIPE, residual_channels=8, gate_channels=16,
                skip_out_channels=8)
    weights = harness.make_weights(keys, 20260, "cpu")
    model = harness.build_model(harness.port_config(keys), weights, "cpu")
    spec = model.spec
    assert (spec.layers, spec.stacks, spec.in_channels, spec.out_channels,
            spec.cin_channels) == (30, 3, 256, 256, 80)
    assert cg.split_head(spec)
    B, T = 2, 160
    c = torch.randn(B, T, 80, generator=torch.Generator().manual_seed(1))
    packed = cg.pack_weights(model, dtype=torch.float32)
    _, rows = cg.buffer_layout(spec)
    ring = torch.zeros(rows, B, spec.residual_channels)
    x_cur = cg.default_initial_input(spec, B)
    out = torch.empty(B, T, dtype=torch.int32)
    logits = []
    sample = cg._sample

    def keep(spec_, o, keys_, deterministic):
        logits.append(o.clone())
        return sample(spec_, o, keys_, deterministic)

    monkeypatch.setattr(cg, "_sample", keep)
    cg.generate_steps_plain(packed, spec, ring, x_cur, out, c, None, t0=0,
                            seed=0, deterministic=True)
    o_plain = torch.stack(logits, dim=1)                 # (B, T, 256)
    codes = out.long()
    prev = torch.cat([torch.full((B, 1), 127), codes[:, :-1]], dim=1)
    o_ref = ref.forward(weights, keys, F.one_hot(prev, 256).float(), c)
    torch.testing.assert_close(o_plain, o_ref, rtol=0, atol=LOGIT_ATOL)
    assert torch.equal(codes, o_ref.argmax(-1))
    assert len(set(codes.flatten().tolist())) > 3       # not one stuck code
    # x_cur leaves as the one-hot of the last code
    assert torch.equal(x_cur, F.one_hot(codes[:, -1], 256).float())


def test_one_hot_input_is_read_as_codes():
    """A categorical model's input is a one-hot row (the kernel reads the
    index of its nonzero entry as the code): ``FusedGenerator`` takes an
    ``initial_input`` of one-hot or zero rows, under ``torch.inference_mode``
    too, and raises on rows that are not."""
    model, _ = _demo("mulaw256")
    gen = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=8)
    c_up = torch.randn(3, 16, model.spec.cin_channels,
                       generator=torch.Generator().manual_seed(4))
    good = F.one_hot(torch.tensor([3, 0, 255]), 256).float()
    good[1].zero_()
    want = gen(c_up=c_up, initial_input=good, deterministic=True)
    with torch.inference_mode():
        got, (x_cur, _, t) = gen(c_up=c_up, initial_input=good,
                                 deterministic=True, return_state=True)
    assert torch.equal(got, want) and t == 16
    assert torch.equal(x_cur, F.one_hot(got[:, -1].long(), 256).float())
    for bad in (torch.full((2, 256), 1 / 256),
                F.one_hot(torch.tensor([1, 2]), 256).float() * 2,
                F.one_hot(torch.tensor([1, 2]), 256).float()
                + F.one_hot(torch.tensor([5, 6]), 256).float()):
        with pytest.raises(ValueError, match="one-hot"):
            gen(c_up=c_up[:2], initial_input=bad)


def test_inv_mulaw_codes_equal_the_formula():
    """The decode's table lookup gives ``inv_mulaw_quantize``'s float64
    values bit for bit, for every code and for a batch of them."""
    codes = np.random.RandomState(0).randint(0, 256, (3, 1000))
    for c in (np.arange(256), codes, codes.astype(np.int32)):
        want = np.asarray(inv_mulaw_quantize(c, 255), np.float64)
        got = inv_mulaw_codes(c, 255)
        assert got.dtype == np.float64 and np.array_equal(got, want)


def _demo(name):
    keys = json.loads((EGS / f"{name}/conf/{name}_wavenet_demo.json")
                      .read_text())
    cfg = Config().override_from_dict(keys)
    model = WaveNet(spec_from_config(cfg),
                    generator=torch.Generator().manual_seed(3))
    return model, cfg


def _spans(*names):
    got = profiling.totals()
    return [got.get(n, (0, 0.0))[0] for n in names]


@pytest.mark.parametrize("name", ["mulaw256", "mol"])
def test_inv_mulaw_spans_once_per_decode(name):
    """``synth.inv_mulaw`` and ``stream.inv_mulaw`` time the host's inverse
    mu-law inside the decode spans: once a decode for a ``mulaw-quantize``
    configuration, never for MoL."""
    model, cfg = _demo(name)
    mel = np.random.RandomState(0).randn(2, 8, cfg.num_mels).astype(np.float32)
    synth = Synthesizer(model, cfg, engine="scan", device="cpu")
    before = _spans("synth.decode", "synth.inv_mulaw")
    synth(mel[:, :3], generator=torch.Generator().manual_seed(0))
    synth(mel[:, :2], generator=torch.Generator().manual_seed(1))
    d_dec, d_inv = (a - b for a, b in zip(
        _spans("synth.decode", "synth.inv_mulaw"), before))
    assert d_dec == 2 and d_inv == (2 if name == "mulaw256" else 0)
    stream = StreamingSynthesizer(model, cfg, engine="scan", batch=2,
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(2))
    before = _spans("stream.decode", "stream.inv_mulaw")
    for a in range(0, 8, 4):
        stream.feed(mel[:, a:a + 4])
    stream.flush()
    d_dec, d_inv = (a - b for a, b in zip(
        _spans("stream.decode", "stream.inv_mulaw"), before))
    assert d_dec >= 2 and d_inv == (d_dec if name == "mulaw256" else 0)
