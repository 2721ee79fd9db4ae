"""Every cell's control flow at a tiny size on the CPU (the dormant training
cell's too), and the check seeing faults planted under the timed path.

The harness's look for a card is skipped (``run_cell`` is called directly);
the rest of a run is what the chip runs, on the program's plain versions.
"""
import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

CELLS = tiny.CELLS
KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(name, trace):
    out = tiny.run(name, trace=trace)
    assert list(out)[:5] == list(KEYS) and list(out)[-2:] == ["checks",
                                                               "check_all"]
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    cell = tiny.load_cell(name)
    want = {m["name"] for m in cell.metrics_for(trace)}
    if trace:
        # no device ops on the CPU: only the host's metrics can be read,
        # over the untraced rest of the window
        host = {m["name"] for m in cell.metrics_for(trace)
                if m["source"] == "host_clock"}
        assert host <= set(out["metrics"]) <= want
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    else:
        assert set(out["metrics"]) == want
    assert set(out["checks"]) == set(cell.limits)
    assert harness.forbidden_modules() == []


def _alter_one_sample(monkeypatch):
    from wavenet_vocoder_tpu_torch.ops import cuda_generate
    orig = cuda_generate.FusedGenerator.__call__

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        samples = out[0] if isinstance(out, tuple) else out
        samples[:, samples.shape[1] // 2] += 0.25
        return out
    monkeypatch.setattr(cuda_generate.FusedGenerator, "__call__", altered)


def _logistic_scale_doubled(monkeypatch):
    """The sampled path only: the logistic draw at twice its scale."""
    from wavenet_vocoder_tpu_torch.ops import cuda_generate
    orig = cuda_generate._sample

    def doubled(spec, o, keys, deterministic):
        if deterministic:
            return orig(spec, o, keys, deterministic)
        n = o.shape[1] // 3
        o = o.clone()
        o[:, 2 * n:] += torch.log(torch.tensor(2.0))
        return orig(spec, o, keys, deterministic)
    monkeypatch.setattr(cuda_generate, "_sample", doubled)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from wavenet_vocoder_tpu_torch.training import train_state
    orig = train_state.masked_mol_loss

    def half(y_hat, y, mask=None, **kw):
        n = y_hat.shape[0] // 2
        return orig(y_hat[:n], y[:n], None if mask is None else mask[:n], **kw)
    monkeypatch.setattr(train_state, "masked_mol_loss", half)


def _crop_misaligned(monkeypatch):
    """The loader's conditioning one frame off its audio."""
    from wavenet_vocoder_tpu_torch.data import dataset
    orig = dataset.collate_fn

    def shifted(*a, **kw):
        out = orig(*a, **kw)
        out["c"] = out["c"][:, list(range(1, out["c"].shape[1])) + [0]]
        return out
    monkeypatch.setattr(dataset, "collate_fn", shifted)


def _one_kind_of_leaf_doubled(monkeypatch):
    """Every layer's conditioning-projection gradient twice what it is,
    and no other leaf's."""
    from wavenet_vocoder_tpu_torch.training import train_state
    orig_create, orig_step = train_state.create_train_state, torch.optim.Adam.step
    picked = set()

    def create(*a, **kw):
        state = orig_create(*a, **kw)
        picked.update(id(t) for n, t in state.model.named_parameters()
                      if n.endswith("conv1x1c.weight_v"))
        return state

    def step(self, *a, **kw):
        for g in self.param_groups:
            for t in g["params"]:
                if id(t) in picked and t.grad is not None:
                    t.grad.mul_(2.0)
        return orig_step(self, *a, **kw)
    monkeypatch.setattr(train_state, "create_train_state", create)
    monkeypatch.setattr(torch.optim.Adam, "step", step)


SERVED = [_alter_one_sample, _logistic_scale_doubled]
TRAIN = [_state_unchanged, _half_batch, _crop_misaligned,
         _one_kind_of_leaf_doubled]
FAULTS = [(c, f.__name__.strip("_"), f) for c in CELLS
          for f in (TRAIN if c.startswith("train.") else SERVED)]


@pytest.mark.parametrize("name,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_under_the_timed_path_fails_the_check(name, fault, plant,
                                                    monkeypatch):
    plant(monkeypatch)
    out = tiny.run(name)
    assert not out["correct"], out["checks"]


def test_faults_fail_the_number_meant_for_them(monkeypatch):
    """A fault in one kind of leaf, or in the sampled path alone, passes
    the numbers that cannot see it and fails the one made for it."""
    with monkeypatch.context() as m:
        _one_kind_of_leaf_doubled(m)
        out = tiny.run("train.flagship.b32")
    c = out["checks"]
    assert c["grad_gap_median"]["value"] <= c["grad_gap_median"]["limit"]
    assert c["grad_gap_kind"]["value"] > c["grad_gap_kind"]["limit"]
    assert out["check_all"]["grad_gap_kind_name"].endswith("conv1x1c.weight_v")
    with monkeypatch.context() as m:
        _logistic_scale_doubled(m)
        out = tiny.run("synth.flagship.b256")
    c = out["checks"]
    assert c["token_gap"]["value"] <= c["token_gap"]["limit"]
    assert c["sampled_gap"]["value"] > c["sampled_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    """The reference at fp8 in the program's place fails a limit, judged by
    the run's own comparison."""
    out = tiny.run(name, controls=("fp8",))
    assert out["correct"]
    assert out["controls"]["fp8"]["correct"] is False, out["controls"]
