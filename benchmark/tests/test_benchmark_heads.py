"""The reference and the served check at each head the program serves.

- MoL: the weights and the check's numbers are the same bits as before the
  check learnt the other heads (digests written below).
- mu-law 256 (categorical, one-hot input) and single Gaussian: the check
  gives 0 for the reference's own answer and sees planted faults in the
  served codes or samples and in the sampler's draws.
- The served codes are recovered exactly from the decoded waveform.
"""
import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import checks
from benchmark.reference import wavenet as ref
from benchmark.tests import test_benchmark_discovery as discovery
from benchmark.tests import tiny

# sha256 of each MoL configuration's tiny weights (``make_weights`` at
# ``tiny.KEYS``, seed 7), of its full-size parameter shapes, and of the
# served check's numbers over ``_judged_set`` with and without the fp8
# control, as the benchmark computed them before it took other heads
GOLDEN = {
    "synth.flagship.b256": {
        "weights": "76ce1330fe13c63b1734e2ec2ca8757cab7b885f9cea5123357d88ffdc8afa92",
        "shapes": "1066f789935d12863ab330e8657f96a1bec2b3f565de91c6fe644eb2df023763",
        "served": "66de61f3c5fb9eee39b9c389418867b2196b6d34ed9415ea55f76289a806823b"},
    "synth.512ch.b128": {
        "weights": "76ce1330fe13c63b1734e2ec2ca8757cab7b885f9cea5123357d88ffdc8afa92",
        "shapes": "8b75d916d3e2b5cf79d5926587b1ef3929eb3454703b00e764d033851def3fc4",
        "served": "66de61f3c5fb9eee39b9c389418867b2196b6d34ed9415ea55f76289a806823b"},
}


def _one_thread(fn):
    """Run ``fn`` with one intra-op thread: a sum's order, and so its bits,
    can follow the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


def _weights_digest(w) -> str:
    h = hashlib.sha256()
    for name, t in w.items():
        h.update(f"{name}{tuple(t.shape)}".encode())
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _judged_set(keys: dict, frames: int = 4):
    """Two greedy and two sampled utterances of ``frames`` mel frames, with
    samples drawn at random in [-1, 1] (the gaps are whatever they are:
    only their bits are held)."""
    g = torch.Generator().manual_seed(11)
    cp, hop = keys["cin_pad"], keys["hop_size"]
    items = []
    for noise in (None, None, (2 ** 31 + 7, 0), (2 ** 33 + 1, 3)):
        mel = torch.randn(frames + 2 * cp, keys["num_mels"], generator=g)
        x = torch.rand(frames * hop, generator=g) * 2 - 1
        items.append({"mel": mel.numpy(), "x": x.double().numpy(),
                      "noise": noise})
    return items[:2], items[2:]


def _served_digest(keys: dict, w) -> str:
    greedy, sampled = _judged_set(keys)
    out = {}
    for control in (None, "fp8"):
        nums = checks.served_numbers(w, keys, greedy, sampled, "cpu", control)
        out[str(control)] = {k: float(v).hex() for k, v in nums.items()}
    return _sha(out)


def _digests(cell: str) -> dict:
    full = harness.load_cell(cell).model_keys()
    _, keys = tiny.cell(cell)

    def run():
        w = harness.make_weights(keys, 7, "cpu")
        return {"weights": _weights_digest(w),
                "shapes": _sha([[k, list(s)] for k, s in
                                ref.param_shapes(full).items()]),
                "served": _served_digest(keys, w)}
    return _one_thread(run)


@pytest.mark.parametrize("cell", sorted(GOLDEN))
def test_mol_weights_and_check_are_the_same_bits(cell):
    assert _digests(cell) == GOLDEN[cell]


def _recipe_keys(name: str) -> dict:
    conf = json.load(open(harness.ROOT / discovery.RECIPES[name]))
    return dict(conf, **tiny.KEYS)


HEADS = {"mulaw256": "categorical", "gaussian": "gaussian"}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_recipe_heads_and_input_channels(name):
    keys = _recipe_keys(name)
    assert ref.head(keys) == HEADS[name]
    shapes = ref.param_shapes(keys)
    assert shapes["first_conv.weight_v"][1] == (
        256 if name == "mulaw256" else 1)
    cfg = harness.port_config(keys)
    model = harness.build_model(cfg, harness.make_weights(keys, 3, "cpu"),
                                "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        shapes


def _sampler_keys(name: str) -> dict:
    if name in HEADS:
        return _recipe_keys(name)
    keys = harness.load_cell("synth.flagship.b256").model_keys()
    # a mixture of 10 Gaussians, which the published sampler also takes
    return keys if name == "flagship" else dict(
        keys, output_distribution="Normal")


@pytest.mark.parametrize("name", sorted(HEADS) + ["flagship", "gaussian10"])
@pytest.mark.parametrize("greedy", [True, False])
def test_reference_sampler_picks_the_programs_sample(name, greedy):
    """At the same head outputs and step keys, the reference's sample is
    the one the program's sampler emits (its plain version, which the
    kernel matches bit for bit on the card)."""
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    keys = _sampler_keys(name)
    spec = spec_from_config(harness.port_config(keys))
    seed, t, B = 2 ** 31 + 11, 4099, 64
    o = 2.0 * torch.randn(B, keys["out_channels"],
                          generator=torch.Generator().manual_seed(5))
    rows = torch.arange(B)
    theirs, _ = cg._sample(spec, o, cg.step_keys(seed, rows, t), greedy)
    u = None if greedy else torch.cat(
        [ref.counter_uniforms(seed, r, t, 1, ref.draws(keys))
         for r in range(B)])
    mine = ref.sample(keys, o, u)
    if ref.head(keys) == "categorical":
        assert torch.equal(mine.long(), theirs.long())
    else:
        assert torch.allclose(mine, theirs, atol=1e-6, rtol=0)


def _own_decode(keys, w, c, u):
    """The reference's own answer, step by step, fed back as it serves."""
    x = torch.zeros(c.shape[1])
    for t in range(len(x)):
        o = ref.forward(w, keys, checks._inputs(keys, x, 0, t + 1),
                        c[:, :t + 1])[:, t]
        x[t] = ref.sample(keys, o, None if u is None else u[t][None])[0]
    return x


@pytest.mark.parametrize("name", sorted(HEADS))
@pytest.mark.parametrize("sampled", [False, True])
def test_gap_is_zero_for_the_references_own_answer_at_each_head(name,
                                                                sampled):
    keys = _recipe_keys(name)
    w = harness.make_weights(keys, 7, "cpu")
    mel = torch.randn(1, 2 * keys["cin_pad"] + 2, keys["num_mels"],
                      generator=torch.Generator().manual_seed(3))
    c = ref.conditioning(w, keys, mel)
    T = c.shape[1]
    noise = (2 ** 32 + 345, 2) if sampled else None
    u = None if noise is None else ref.counter_uniforms(
        *noise, 0, T, ref.draws(keys))
    x = _own_decode(keys, w, c, u)
    item = {"mel": mel[0].numpy(), "x": x.numpy(), "noise": noise}
    assert checks.served_gap(w, keys, [item], "cpu")["gap"] < 1e-5
    # the step served the least likely class, or a sample far off
    x2 = x.clone()
    if name == "mulaw256":
        o = ref.forward(w, keys, checks._inputs(keys, x, 0, T), c)
        score, _ = ref.candidates(keys, o, None if u is None else u[None])
        x2[T // 2] = float(score[0, T // 2].argmin())
    else:
        x2[T // 2] += 0.3 if x2[T // 2] < 0.5 else -0.3
    assert checks.served_gap(w, keys, [dict(item, x=x2.numpy())],
                             "cpu")["gap"] > 0.1


@pytest.fixture(scope="module")
def recipes(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipes")
    discovery.add_recipe_cells(root)
    return root


def _code_moved_by_one(monkeypatch):
    """Every served row's code at one step (mid-call) one class off."""
    from wavenet_vocoder_tpu_torch.ops import cuda_generate
    orig = cuda_generate.FusedGenerator.__call__

    def moved(self, *a, **kw):
        out = orig(self, *a, **kw)
        codes = out[0] if isinstance(out, tuple) else out
        t = codes.shape[1] // 2
        codes[:, t] = torch.where(codes[:, t] < 255, codes[:, t] + 1,
                                  codes[:, t] - 1)
        return out
    monkeypatch.setattr(cuda_generate.FusedGenerator, "__call__", moved)


def _sample_moved(monkeypatch):
    """Every served row's sample at one step (mid-call) moved by 0.25."""
    from wavenet_vocoder_tpu_torch.ops import cuda_generate
    orig = cuda_generate.FusedGenerator.__call__

    def moved(self, *a, **kw):
        out = orig(self, *a, **kw)
        x = out[0] if isinstance(out, tuple) else out
        t = x.shape[1] // 2
        x[:, t] = torch.where(x[:, t] < 0.5, x[:, t] + 0.25, x[:, t] - 0.25)
        return out
    monkeypatch.setattr(cuda_generate.FusedGenerator, "__call__", moved)


def _draws_one_off(monkeypatch):
    """The sampler's draws keyed one index off: the categorical head's
    Gumbels, the Gaussian's Box-Muller uniforms."""
    from wavenet_vocoder_tpu_torch.ops import cuda_generate
    orig = cuda_generate.uniforms
    monkeypatch.setattr(cuda_generate, "uniforms",
                        lambda keys, draws: orig(keys, draws + 1))


# (recipe, fault, the number that has to fail, the number that has to hold)
FAULTS = [("mulaw256", _code_moved_by_one, "token_gap", None),
          ("mulaw256", _draws_one_off, "sampled_gap", "token_gap"),
          ("gaussian", _sample_moved, "token_gap", None),
          ("gaussian", _draws_one_off, "sampled_gap", "token_gap")]
FAULT_RUNS = [(p.format(r), f, fails, holds)
              for r, f, fails, holds in FAULTS
              for p, _ in discovery.RECIPE_CELLS.values()]


@pytest.mark.parametrize("name,plant,fails,holds", FAULT_RUNS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f, _, _ in FAULT_RUNS])
def test_recipe_heads_check_sees_planted_faults(recipes, name, plant, fails,
                                                holds, monkeypatch):
    plant(monkeypatch)
    out = tiny.run(name, root=recipes)
    c = out["checks"]
    assert not out["correct"]
    assert c[fails]["value"] > c[fails]["limit"], c
    if holds:
        assert c[holds]["value"] <= c[holds]["limit"], c


def test_codes_are_recovered_exactly_from_the_decoded_waveform():
    """Every one of the 256 codes, at 3 s of audio, through the program's
    decode (inverse mu-law, inverse pre-emphasis, gain, float32) and back;
    one row also holds long runs of the loudest codes, where the inverse
    pre-emphasis swings widest."""
    from wavenet_vocoder_tpu_torch.synthesis import _decode
    keys = json.load(open(harness.ROOT / discovery.RECIPES["mulaw256"]))
    T = 3 * keys["sample_rate"]
    g = torch.Generator().manual_seed(2)
    spread = torch.cat([torch.randperm(256, generator=g)
                        for _ in range(-(-T // 256))])[:T]
    runs = torch.tensor([255, 0, 254, 1, 128, 127]).repeat_interleave(
        -(-T // 6))[:T]
    codes = torch.stack([spread, runs]).numpy().astype(np.int32)
    wav = _decode(harness.port_config(keys), codes)
    assert wav.dtype == np.float32
    assert set(np.unique(codes[0])) == set(range(256))
    # the nearest code: mulaw_quantize's truncation would take the code
    # below for about half of them
    assert np.array_equal(checks.served_samples(wav, keys), codes)
