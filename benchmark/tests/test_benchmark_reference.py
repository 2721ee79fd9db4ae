"""The plain reference against the program's plain path at a tiny size on the
CPU, and the imports of the reference and the harness."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import checks
from benchmark.reference import wavenet as ref
from benchmark.tests import tiny

BENCH = harness.ROOT / "benchmark"


def _setup(**over):
    _, keys = tiny.cell("train.flagship.b32")
    keys = dict(keys, **over)
    cfg = harness.port_config(keys)
    w = harness.make_weights(keys, 7, "cpu")
    return keys, cfg, w, harness.build_model(cfg, w, "cpu")


def _batch(keys, B=2, T=1024, seed=0):
    g = torch.Generator().manual_seed(seed)
    frames = T // keys["hop_size"] + 2 * keys["cin_pad"]
    x = torch.rand(B, T, 1, generator=g) - 0.5
    return {"x": x, "y": x.clone(),
            "c": torch.randn(B, frames, keys["num_mels"], generator=g),
            "input_lengths": torch.tensor([T, T - 300][:B], dtype=torch.int32)}


def test_forward_matches_the_programs_plain_path():
    keys, cfg, w, model = _setup(fused_train=False, compute_dtype="")
    b = _batch(keys)
    with torch.no_grad():
        want = model(b["x"], b["c"])
        c = ref.conditioning(w, keys, b["c"])
        got = ref.forward(w, keys, b["x"], c)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_adam_and_ema_steps_match_the_programs_step():
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    keys, cfg, w, model = _setup(fused_train=False, compute_dtype="",
                                 ema_decay=0.9)
    state = create_train_state(cfg, model=model, device="cpu")
    step, _ = make_train_step(cfg)
    batches = [_batch(keys, seed=s) for s in range(3)]
    losses = [float(step(state, b)["loss"]) for b in batches]
    out = ref.adam_steps(w, keys, batches)
    assert np.allclose(losses, out["losses"], rtol=1e-5)
    # leaves whose gradient is zero to rounding (a 1-input kernel under
    # weight norm) move under Adam by round-off alone
    moving = checks.moving_leaves(out["grad1"])
    assert len(moving) > 0.9 * len(out["grad1"])
    for n, p in state.model.named_parameters():
        if n in moving:
            assert torch.allclose(p, out["params"][n], atol=2e-6), n
            assert torch.allclose(state.ema[n], out["ema"][n], atol=2e-6), n


@pytest.mark.parametrize("sampled", [False, True])
def test_gap_is_zero_for_the_references_own_answer(sampled):
    keys, cfg, w, model = _setup()
    g = torch.Generator().manual_seed(3)
    mel = torch.randn(1, 2 * keys["cin_pad"] + 2, keys["num_mels"],
                      generator=g)
    c = ref.conditioning(w, keys, mel)
    T = c.shape[1]
    noise = (12345, 0) if sampled else None
    u = None if noise is None else ref.counter_uniforms(
        *noise, 0, T, ref.draws(keys))
    x = torch.zeros(T)
    for t in range(T):          # the reference's own decode
        inp = torch.cat([x.new_zeros(1), x[:-1]])[None, :, None]
        x[t] = ref.sample(keys, ref.forward(w, keys, inp, c)[:, t],
                          None if u is None else u[t][None])[0]
    item = {"mel": mel[0].numpy(), "x": x.numpy(), "noise": noise}
    assert checks.served_gap(w, keys, [item], "cpu")["gap"] < 1e-5
    x2 = x.clone()
    x2[T // 2] += 0.3
    assert checks.served_gap(w, keys, [dict(item, x=x2.numpy())],
                             "cpu")["gap"] > 0.1


def test_sampler_uniforms_are_the_programs():
    """The reference's counter uniforms equal the served sampler's bits."""
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    seed, rows, draws = 2 ** 31 - 3, torch.arange(5), 31
    for t in (0, 1, 4097, 2 ** 32 + 7):
        theirs = cg.uniforms(cg.step_keys(seed, rows, t)[:, None],
                             torch.arange(draws)[None])
        mine = torch.stack([ref.counter_uniforms(seed, int(r), t, 1, draws)[0]
                            for r in rows])
        assert torch.equal(theirs, mine)


def test_served_samples_undo_the_decode():
    keys = harness.load_cell("synth.flagship.b256").model_keys()
    from wavenet_vocoder_tpu_torch.synthesis import _decode
    x = np.random.RandomState(0).uniform(-1, 1, (2, 500)).astype(np.float32)
    back = checks.served_samples(_decode(harness.port_config(keys), x), keys)
    assert np.abs(back - x).max() < 1e-5


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_jax_nor_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)
    assert "wavenet_vocoder_tpu_torch" not in tops


def test_no_benchmark_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_forbidden_names_compare_whole_top_level_names():
    found = harness.forbidden_modules(["wavenet_vocoder_tpu_torch.synthesis",
                                       "jaxtyping", "numpy", "optax._src"])
    assert found == ["optax"]
    assert harness.forbidden_modules(["wavenet_vocoder_tpu.ops"]) == [
        "wavenet_vocoder_tpu"]
