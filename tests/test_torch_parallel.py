"""The port's mesh record and batch helpers (parallel/sharding.py) and the
per-process helpers of parallel/distributed.py, against what the JAX
package's tests/test_sharding.py and tests/test_distributed.py check.

No process group is started here (tests/test_torch_distributed.py runs
real ones); devices are torch.device records, which need no GPU to exist.
"""
import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu_torch.parallel import distributed as pdist
from wavenet_vocoder_tpu_torch.parallel import (
    Mesh,
    data_parallel_batch_size,
    local_batch_size,
    make_mesh,
    replicate,
    shard_batch,
    shard_state,
)

EIGHT = [torch.device("cuda", i) for i in range(8)]


def _cpu_mesh(n):
    """A data axis that lists the CPU n times (make_mesh refuses that)."""
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device("cpu")] * n
    return Mesh(("data",), devs)


def test_make_mesh_shapes():
    mesh = make_mesh({"data": -1}, devices=EIGHT)
    assert mesh.shape == {"data": 8}
    assert mesh.axis_devices("data") == EIGHT
    mesh2 = make_mesh({"data": 4, "model": 1}, devices=EIGHT[:4])
    assert mesh2.shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError):
        make_mesh({"data": 3}, devices=EIGHT)
    with pytest.raises(ValueError, match="at most one"):
        make_mesh({"data": -1, "x": -1}, devices=EIGHT)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh({"data": -1, "x": 3}, devices=EIGHT)


def test_make_mesh_refuses_tensor_parallel_and_repeats():
    """A model axis builds (tensor parallelism runs over processes,
    parallel/sharding.py); a device listed twice is still refused."""
    mesh = make_mesh({"data": 4, "model": 2}, devices=EIGHT)
    assert mesh.shape == {"data": 4, "model": 2}
    assert list(mesh.devices[1]) == EIGHT[2:4]
    assert make_mesh({"data": 1, "model": -1},
                     devices=EIGHT[:2]).shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="model"):
        mesh.axis_devices("data")
    with pytest.raises(ValueError, match="more than once"):
        make_mesh({"data": 2}, devices=[EIGHT[0], EIGHT[0]])


def test_make_mesh_defaults_to_the_gpus():
    if torch.cuda.is_available():
        assert make_mesh().shape["data"] == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_axis_devices_needs_the_other_axes_whole():
    devs = np.empty((2, 2), dtype=object)
    devs[:] = np.asarray(EIGHT[:4], dtype=object).reshape(2, 2)
    with pytest.raises(ValueError, match="besides 'data'"):
        Mesh(("data", "x"), devs).axis_devices("data")
    mesh = make_mesh({"x": 1, "data": 4}, devices=EIGHT[:4])
    assert mesh.axis_devices("data") == EIGHT[:4]


def test_data_parallel_batch_size():
    mesh = make_mesh({"data": -1}, devices=EIGHT)
    assert data_parallel_batch_size(8, mesh) == 8
    assert data_parallel_batch_size(9, mesh) == 16


def test_shard_batch_splits_rows_over_the_data_axis():
    mesh = _cpu_mesh(2)
    batch = {"x": np.arange(24, dtype=np.float32).reshape(4, 3, 2),
             "lengths": torch.arange(4), "scale": np.float32(2.0), "g": None}
    parts = shard_batch(batch, mesh)
    assert len(parts) == 2
    for i, part in enumerate(parts):
        np.testing.assert_array_equal(part["x"].numpy(),
                                      batch["x"][2 * i:2 * i + 2])
        assert part["lengths"].tolist() == [2 * i, 2 * i + 1]
        assert float(part["scale"]) == 2.0 and part["g"] is None
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(np.zeros((3, 2)), mesh)


def test_replicate_and_shard_state_copy_per_device():
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    cfg = Config(input_type="raw", quantize_channels=256, out_channels=30,
                 layers=2, stacks=1, residual_channels=8, gate_channels=8,
                 skip_out_channels=8, cin_channels=-1,
                 upsample_conditional_features=False, compute_dtype="",
                 lr_schedule="", exponential_moving_average=True)
    state = create_train_state(cfg, device="cpu")
    step, _ = make_train_step(cfg)
    x = np.random.RandomState(0).uniform(-0.5, 0.5, (2, 32, 1)).astype(
        np.float32)
    step(state, {"x": x, "y": x, "input_lengths": np.asarray([32, 32])})
    mesh = _cpu_mesh(2)
    copies = shard_state(state, mesh)
    assert len(copies) == 2 and copies[0].model is not copies[1].model
    for cp in copies:
        assert cp.step == state.step
        for (n, a), b in zip(cp.model.named_parameters(),
                             state.model.parameters()):
            assert torch.equal(a, b) and a is not b
            assert torch.equal(cp.ema[n], state.ema[n])
        assert (cp.optimizer.state_dict()["state"][0]["exp_avg"]
                .equal(state.optimizer.state_dict()["state"][0]["exp_avg"]))
    with torch.no_grad():
        next(copies[0].model.parameters()).add_(1.0)
    assert not torch.equal(next(copies[0].model.parameters()),
                           next(copies[1].model.parameters()))
    mods = replicate(state.model, mesh)
    assert len(mods) == 2 and all(m is not state.model for m in mods)


def test_local_batch_size_and_row_offset(monkeypatch):
    assert pdist.process_info() == (0, 1)
    assert pdist.is_primary()
    assert local_batch_size(7) == 7 and pdist.batch_row_offset(7) == 0
    monkeypatch.setattr(pdist, "process_info", lambda: (2, 3))
    assert local_batch_size(9) == 3
    assert not pdist.is_primary()
    monkeypatch.setattr(pdist.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pdist.dist, "get_rank", lambda group=None: 2)
    assert pdist.batch_row_offset(3) == 6
    with pytest.raises(ValueError, match="not divisible by 3"):
        local_batch_size(8)


def test_replicate_global_outside_a_group_is_a_no_op():
    assert pdist.replicate_global(object(), {"global_step": 5}) == {
        "global_step": 5}


@pytest.mark.parametrize("given", [
    {}, {"coordinator_address": "127.0.0.1:1"},
    {"num_processes": 2, "process_id": 0},
    {"coordinator_address": "nohostport", "num_processes": 2,
     "process_id": 0},
    {"coordinator_address": "127.0.0.1:1", "num_processes": 2,
     "process_id": 2}])
def test_initialize_distributed_refuses_incomplete_arguments(given,
                                                             monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError):
        pdist.initialize_distributed(**given)
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_nccl_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="NCCL backend needs a GPU"):
        pdist.initialize_distributed("127.0.0.1:1", 1, 0, backend="nccl")


def test_dataset_shard_matches_jax_and_partitions(tmp_path):
    """Per-process corpus slices partition the utterance list, are of equal
    length (every process runs the same number of batches) and are the
    JAX package's slices (tests/test_distributed.py's partition test)."""
    from wavenet_vocoder_tpu.config import Config as JaxConfig
    from wavenet_vocoder_tpu.data.dataset import WaveNetDataset as JaxDataset
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.data.dataset import WaveNetDataset
    kw = dict(max_time_steps=256, hop_size=64, cin_pad=0, cin_channels=8,
              num_mels=8)
    rs = np.random.RandomState(0)
    for i in range(7):
        frames = 8 + i
        np.save(tmp_path / f"u{i}-wave.npy",
                rs.randn(frames * 64).astype(np.float32))
        np.save(tmp_path / f"u{i}-feats.npy",
                rs.randn(frames, 8).astype(np.float32))
    ds = WaveNetDataset(str(tmp_path), Config(**kw))
    jds = JaxDataset(str(tmp_path), JaxConfig(**kw))
    shards = [ds.shard(i, 3) for i in range(3)]
    assert len({len(s) for s in shards}) == 1
    paths = [u.wave_path for s in shards for u in s.utterances]
    assert len(paths) == len(set(paths)) == 3 * (len(ds) // 3)
    assert ds.shard(0, 1) is ds
    for i, s in enumerate(shards):
        assert ([u.wave_path for u in s.utterances]
                == [u.wave_path for u in jds.shard(i, 3).utterances])


def test_param_shardings_follow_the_jax_rules():
    """``wavenet_param_shardings`` cuts the parameters the JAX package's
    rules shard over "model", along the same axis (the port's axes reverse
    a conv kernel's: JAX (K, In, Out)); everything else is replicated."""
    import jax

    from wavenet_vocoder_tpu.config import Config as JaxConfig
    from wavenet_vocoder_tpu.models.wavenet import (
        init_wavenet, spec_from_config as jax_spec_from_config)
    from wavenet_vocoder_tpu.parallel.sharding import (
        make_mesh as jax_make_mesh, wavenet_param_shardings as jax_rules)
    from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import (
        WaveNet, spec_from_config)
    from wavenet_vocoder_tpu_torch.parallel.sharding import (
        PARTITION_DIM, wavenet_param_shardings)
    kw = dict(layers=2, stacks=1, residual_channels=8, gate_channels=16,
              skip_out_channels=8, cin_channels=4, gin_channels=3)
    jspec = jax_spec_from_config(JaxConfig(**kw))
    params = init_wavenet(jax.random.PRNGKey(0), jspec)
    mesh = jax_make_mesh({"data": 4, "model": 2}, devices=jax.devices()[:8])
    shardings = jax_rules(params, mesh)
    # each leaf filled with its "model" axis in the JAX layout (-1: none)
    marks = jax.tree.map(
        lambda s, a: np.full(np.shape(a), float(
            list(s.spec).index("model") if "model" in tuple(s.spec)
            else -1), np.float32), shardings, params)
    spec = spec_from_config(Config(**kw))
    port_marks = state_dict_from_jax(marks, spec)
    rules = wavenet_param_shardings(WaveNet(spec))
    assert sorted(rules) == sorted(port_marks)
    cut = 0
    for name, kind in rules.items():
        jax_axis = float(port_marks[name].reshape(-1)[0])
        if kind is None:
            assert jax_axis == -1.0, name
            continue
        cut += 1
        ndim = port_marks[name].dim()
        want = PARTITION_DIM[kind]
        # JAX axis a of an n-axis kernel is port axis n - 1 - a; g and b
        # are (Out,) in JAX and port axis 0
        got = ndim - 1 - jax_axis if name.endswith("weight_v") else jax_axis
        assert got == want, (name, kind, jax_axis)
    # per block: conv (v, g, b), cond_c and cond_g (v, g), out and skip (v)
    assert cut == 2 * (3 + 2 + 2 + 1 + 1)


def test_shard_slice_keeps_glu_pairs():
    """COLUMN takes the same channels of both GLU halves, ROW a contiguous
    slice of the input axis; gathering the slices in rank order gives the
    whole tensor back."""
    from wavenet_vocoder_tpu_torch.models.layers import (
        COLUMN, ROW, gather_slices, shard_slice)
    t = torch.arange(16.0).reshape(8, 2)
    assert shard_slice(t, COLUMN, 1, 2)[:, 0].tolist() == [4, 6, 12, 14]
    for kind, x in ((COLUMN, t), (ROW, t.t().contiguous())):
        parts = [shard_slice(x, kind, r, 2) for r in range(2)]
        assert torch.equal(gather_slices(parts, kind), x)
    assert shard_slice(torch.arange(12.0).reshape(1, 12, 1), ROW, 2,
                       3).reshape(-1).tolist() == [8, 9, 10, 11]
