"""Data parallelism over processes: real 2-process gloo clusters on the CPU.

The port's counterpart of tests/test_distributed.py and of the train-step
cases of tests/test_sharding.py. The port trains one process per device,
joined by torch.distributed; each rank holds its rows of the global batch,
the step all-reduces the gradients and the losses' mask counts, and the
fused stack's dropout is keyed on the global rows. Invariant: the 2-process
run equals the single-process run on the global batch, and the JAX
package's.

The workers are this file run as a script (``--worker steps|loop`` or
``--run-module``); they import the port only, and each reports whether JAX
was imported. The JAX package runs in the test process alone. Every worker
sets one thread, takes a free port, and is killed at its own timeout.
"""
import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240
STEPS = 3
# the train-step parity config of tests/test_torch_train.py (256 classes,
# Adam eps 1e-5: see the comment there), at a global batch of 8
TRAIN = dict(input_type="raw", quantize_channels=256, out_channels=30,
             layers=4, stacks=2, residual_channels=16, gate_channels=32,
             skip_out_channels=24, cin_channels=8, batch_size=8,
             upsample_conditional_features=False, dropout=0.0,
             compute_dtype="", lr_schedule="",
             exponential_moving_average=True, ema_decay=0.9,
             optimizer_params={"lr": 1e-3, "eps": 1e-5, "weight_decay": 0.0})
CASES = {"nonfused": {}, "fused": {"fused_train": True},
         "nonfused-dropout": {"dropout": 0.1},
         "fused-dropout": {"fused_train": True, "dropout": 0.1}}
# unequal valid lengths, and unequal sums per rank (345 and 300 samples):
# the mean of the ranks' means is not the global mean
LENGTHS = (96, 89, 64, 96, 71, 96, 50, 83)


def make_batch(B=8, T=96):
    rs = np.random.RandomState(0)
    x = rs.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    return {"x": x, "y": x.copy(),
            "c": rs.randn(B, T, 8).astype(np.float32),
            "input_lengths": np.asarray(LENGTHS[:B], np.int32)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_loaded() -> bool:
    return "jax" in sys.modules or "wavenet_vocoder_tpu" in sys.modules


# ----------------------------------------------------------------------
# what the workers run (and the test process, for the single-process runs)
# ----------------------------------------------------------------------
def _fresh_state(cfg, sd_path=None, init_seed=0):
    from wavenet_vocoder_tpu_torch.models.wavenet import (
        WaveNet, spec_from_config)
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state)
    model = WaveNet(spec_from_config(cfg),
                    generator=torch.Generator().manual_seed(init_seed))
    if sd_path is not None:
        model.load_state_dict(torch.load(sd_path))
    return create_train_state(cfg, model=model, device="cpu")


def _local_rows(batch, rank, world):
    n = len(batch["x"]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _snapshot(state):
    out = {k: v.detach().numpy().copy()
           for k, v in state.model.state_dict().items()}
    out.update({"ema." + k: v.detach().numpy().copy()
                for k, v in state.ema.items()})
    return out


def run_steps(case, sd_path, batch, group=None):
    """STEPS train steps of CASES[case] from the weights in sd_path on this
    rank's rows (all rows without a group), then the dev loss: (metrics,
    parameters and EMA shadow as numpy)."""
    import torch.distributed as dist

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training.train_state import make_train_step
    cfg = Config(**{**TRAIN, **CASES[case]})
    state = _fresh_state(cfg, sd_path)
    step, ev = make_train_step(cfg, group=group)
    rank, world = ((dist.get_rank(), dist.get_world_size()) if group
                   else (0, 1))
    local = _local_rows(batch, rank, world)
    gen = torch.Generator().manual_seed(0)
    out = {"loss": [], "grad_norm": []}
    for _ in range(STEPS):
        m = step(state, local, gen)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["eval_loss"] = float(ev(state, local)["loss"])
    return out, _snapshot(state)


def _resume_check(sd_path, batch, ckpt_dir):
    """Two data-parallel steps, a checkpoint (written by rank 0 only), a
    third step; then a fresh state of another init, the checkpoint loaded
    on rank 0 and broadcast, and the third step again: the largest
    difference of the two states (the counterpart of
    tests/test_sharding.py's checkpoint_resume_under_mesh)."""
    import torch.distributed as dist

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.parallel import replicate_global
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.train_state import make_train_step
    cfg = Config(**{**TRAIN, **CASES["fused-dropout"]})
    rank = dist.get_rank()
    local = _local_rows(batch, rank, dist.get_world_size())
    gen = lambda i: torch.Generator().manual_seed(100 + i)
    state = _fresh_state(cfg, sd_path)
    step, _ = make_train_step(cfg, group=dist.group.WORLD)
    for i in range(2):
        step(state, local, gen(i))
    path = ckpt.save_checkpoint(ckpt_dir, state, global_step=2)
    dist.barrier()
    step(state, local, gen(2))
    restored = _fresh_state(cfg, None, init_seed=7 + rank)
    if rank == 0:
        ckpt.load_checkpoint(path, restored)
    replicate_global(restored, {})
    step2, _ = make_train_step(cfg, group=dist.group.WORLD)
    step2(restored, local, gen(2))
    a, b = _snapshot(state), _snapshot(restored)
    return {"max_diff": max(float(np.abs(a[k] - b[k]).max()) for k in a),
            "step": restored.step}


LOOP_CFG = dict(TRAIN, cin_channels=-1, batch_size=4, max_time_steps=512,
                checkpoint_interval=2, train_eval_interval=2,
                test_eval_epoch_interval=10 ** 9, num_workers=0, nepochs=50,
                fused_train=True, dropout=0.1)


def _loop_runs(dump, work, rank):
    """The full train_loop three times on this rank: 4 steps into exp_a,
    2 steps into exp_b, then 2 more resumed from exp_b's checkpoint. Each
    rank gets its own checkpoint dir, so what a rank writes shows."""
    import torch.distributed as dist

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training.loop import train_loop
    cfg = Config(**LOOP_CFG)
    steps = []
    for exp, n, restore in (("exp_a", 4, None), ("exp_b", 2, None),
                            ("exp_b", 4, "exp_b_rank0")):
        if restore:
            restore = os.path.join(work, restore, "checkpoint_latest.npz")
        state = train_loop(cfg, dump, os.path.join(work, f"{exp}_rank{rank}"),
                           max_steps_override=n, restore_checkpoint=restore,
                           log_interval=1, device="cpu")
        dist.barrier()
        steps.append(state.step)
    return {"steps": steps}


def worker_main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", choices=("steps", "loop"), required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--work", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from wavenet_vocoder_tpu_torch.parallel import initialize_distributed
    rank, world = initialize_distributed(f"127.0.0.1:{args.port}", 2,
                                         args.rank, backend="gloo",
                                         timeout_s=WORKER_TIMEOUT_S)
    assert (rank, world) == (args.rank, 2)
    res = {}
    if args.worker == "steps":
        batch = dict(np.load(os.path.join(args.work, "batch.npz")))
        sd = os.path.join(args.work, "sd.pt")
        for case in CASES:
            res[case], params = run_steps(case, sd, batch, dist.group.WORLD)
            np.savez(os.path.join(args.work, f"{case}.rank{rank}.npz"),
                     **params)
        res["resume"] = _resume_check(sd, batch,
                                      os.path.join(args.work, "ckpt"))
    else:
        res = _loop_runs(os.path.join(args.work, "dump"), args.work, rank)
    res["jax_loaded"] = _jax_loaded()
    with open(os.path.join(args.work, f"{args.worker}.rank{rank}.json"),
              "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def spawn_main(argv):
    """``--spawn DUMP CKPT_DIR OUT``: train_loop with use_mesh in a process
    that sees two GPUs (CUDA's answers patched here; the spawned ranks see
    the real machine, train on the CPU over gloo, and the final state is
    read back onto the CPU)."""
    dump, ckpt_dir, out = argv
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training import loop
    torch.set_num_threads(1)
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 2
    real = loop.create_train_state
    loop.create_train_state = lambda cfg, device=None: real(cfg, device="cpu")
    state = loop.train_loop(Config(**LOOP_CFG), dump, ckpt_dir,
                            max_steps_override=2, log_interval=1)
    with open(out, "w") as f:
        json.dump({"step": state.step, "jax_loaded": _jax_loaded()}, f)


def run_module_main(argv):
    """``--run-module MOD ARGS``: run a CLI module as ``python -m`` would,
    then fail if it pulled in JAX."""
    import runpy
    torch.set_num_threads(1)
    sys.argv = [argv[0]] + argv[1:]
    runpy.run_module(argv[0], run_name="__main__", alter_sys=True)
    if _jax_loaded():
        sys.exit("the port imported JAX")


# ----------------------------------------------------------------------
# launching
# ----------------------------------------------------------------------
def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def _launch(argvs):
    """Run the given argument lists as processes of this file together;
    fail with their output if one fails or passes the timeout."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                              + a, env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for a in argvs]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a worker passed its timeout (a rank waiting on a "
                        "collective the others never reached?)")
        logs.append(out.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return logs


def _cluster(worker, work):
    port = _free_port()
    _launch([["--worker", worker, "--rank", str(r), "--port", str(port),
              "--work", str(work)] for r in range(2)])
    return [json.loads((work / f"{worker}.rank{r}.json").read_text())
            for r in range(2)]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _checksum(params):
    return float(sum(np.abs(v).astype(np.float64).sum()
                     for k, v in params.items() if not k.startswith("ema.")))


# ----------------------------------------------------------------------
# the step-level cluster: one launch, read by several tests
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Weights from the JAX package's init (through compat/from_jax.py),
    the global batch, the 2-process run, the port's single-process runs
    and the JAX package's single-process runs of the dropout-free cases."""
    import jax
    import jax.numpy as jnp

    from wavenet_vocoder_tpu.config import Config as JaxConfig
    from wavenet_vocoder_tpu.training.train_state import (
        create_train_state as jax_create_train_state,
        make_train_step as jax_make_train_step)
    from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    work = tmp_path_factory.mktemp("steps")
    batch = make_batch()
    np.savez(work / "batch.npz", **batch)
    jcfg = JaxConfig(**TRAIN)
    jstate0 = jax_create_train_state(jcfg)
    params = jax.tree.map(np.asarray, jstate0.params)
    spec = spec_from_config(Config(**TRAIN))
    torch.save(state_dict_from_jax(params, spec), work / "sd.pt")

    ranks = _cluster("steps", work)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as the workers
    try:
        single = {case: run_steps(case, work / "sd.pt", batch)
                  for case in CASES}
    finally:
        torch.set_num_threads(threads)
    jax_runs = {}
    for case in ("nonfused", "fused"):
        jcfg = JaxConfig(**{**TRAIN, **CASES[case]})
        jstep, _ = jax_make_train_step(jcfg)
        jstate = jax_create_train_state(jcfg)
        jbatch = jax.tree.map(jnp.asarray, batch)
        losses = []
        for _ in range(STEPS):
            jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
        jax_runs[case] = dict(loss=losses, params=state_dict_from_jax(
            jax.tree.map(np.asarray, jstate.params), spec))
    return dict(work=work, ranks=ranks, single=single, jax=jax_runs)


def _rank_params(work, case, rank):
    return dict(np.load(work / f"{case}.rank{rank}.npz"))


def test_workers_import_no_jax(steps):
    assert [r["jax_loaded"] for r in steps["ranks"]] == [False, False]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_hold_bitwise_equal_states(steps, case):
    """Only the all-reduced gradient keeps the ranks together: after three
    steps every parameter and EMA leaf is bitwise equal across ranks, and
    so are the reported losses and norms."""
    a, b = (_rank_params(steps["work"], case, r) for r in range(2))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    r0, r1 = (r[case] for r in steps["ranks"])
    assert r0 == r1


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_process_steps_match_single_process(steps, case):
    """Three steps on two ranks (4 rows each, unequal lengths; with dropout
    too) against the port's single process on the 8 rows: losses, the
    first step's grad norm and the dev loss within 1e-6 relative, the later
    norms within 1e-5 (their gradients are taken at weights that carry the
    first update's noise, as in tests/test_torch_train.py), the parameters'
    checksum within
    1e-6 relative, and every element of the parameters and the EMA shadow
    within 5e-6 (tests/test_sharding.py holds its sharded step to 2e-5):
    Adam divides gradients summed in another order by their own size, which
    moves a weight by up to ~1e-6 more or less."""
    got, want = steps["ranks"][0][case], steps["single"][case][0]
    for i in range(STEPS):
        assert _rel(got["loss"][i], want["loss"][i]) <= 1e-6, (i, got, want)
        assert (_rel(got["grad_norm"][i], want["grad_norm"][i])
                <= (1e-6 if i == 0 else 1e-5)), (i, got, want)
    assert _rel(got["eval_loss"], want["eval_loss"]) <= 1e-6
    params = _rank_params(steps["work"], case, 0)
    ref = steps["single"][case][1]
    assert _rel(_checksum(params), _checksum(ref)) <= 1e-6
    worst = max((float(np.abs(params[k] - v).max()), k)
                for k, v in ref.items())
    assert worst[0] <= 5e-6, worst


@pytest.mark.parametrize("case", ["nonfused", "fused"])
def test_two_process_steps_match_jax(steps, case):
    """The same three steps against the JAX package's single-process run on
    the same weights and global batch: losses and the parameters' checksum
    within 1e-5 relative (tests/test_distributed.py's measure)."""
    got, want = steps["ranks"][0][case], steps["jax"][case]
    for i in range(STEPS):
        assert _rel(got["loss"][i], want["loss"][i]) <= 1e-5, (i, got, want)
    params = _rank_params(steps["work"], case, 0)
    ref = {k: np.asarray(v) for k, v in want["params"].items()}
    assert _rel(_checksum(params), _checksum(ref)) <= 1e-5


def test_data_parallel_losses_are_global_means(steps):
    """The normalisation the cluster must get right: with unequal lengths
    the mean of the ranks' mean-loss gradients (what a per-rank mean, e.g.
    DistributedDataParallel's, averages to) is off the global mean's
    gradient by 0.8% of its norm, thousands of times the 1e-6 to which the
    cluster's grad norms match the single process (above)."""
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training.train_state import make_train_step
    cfg = Config(**TRAIN)
    step, _ = make_train_step(cfg)
    batch = make_batch()

    def grad(rows):
        state = _fresh_state(cfg, steps["work"] / "sd.pt")
        step(state, rows)
        return torch.cat([p.grad.reshape(-1)
                          for p in state.model.parameters()])

    whole = grad(batch)
    mean_of_means = (grad(_local_rows(batch, 0, 2))
                     + grad(_local_rows(batch, 1, 2))) / 2
    off = float((mean_of_means - whole).norm() / whole.norm())
    assert off > 1e-3, off
    got, want = (steps["ranks"][0]["nonfused"]["grad_norm"][0],
                 steps["single"]["nonfused"][0]["grad_norm"][0])
    assert _rel(got, want) <= 1e-6


def test_dropout_masks_differ_between_ranks(steps):
    """With dropout the 2-process run equals the 1-process run (above);
    here: it differs from a run whose ranks share one mask, i.e. dropout
    really keyed each rank on its own rows."""
    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    a = ft.dropout_mask(5, B=4, T=16, R=16, L=8, l=0, b0=0, keep=0.9)
    b = ft.dropout_mask(5, B=4, T=16, R=16, L=8, l=0, b0=4, keep=0.9)
    assert not torch.equal(a, b)
    drop = steps["ranks"][0]["fused-dropout"]["loss"]
    plain = steps["ranks"][0]["fused"]["loss"]
    assert drop[0] != plain[0]


def test_checkpoint_from_data_parallel_state_resumes_exactly(steps):
    """Saved from a 2-rank state by rank 0, restored into a fresh state of
    another init on rank 0 and broadcast: the next step equals the
    uninterrupted one on both ranks (bf16-free, so exactly)."""
    for r in steps["ranks"]:
        assert r["resume"]["step"] == 3
        assert r["resume"]["max_diff"] == 0.0
    files = sorted(os.listdir(steps["work"] / "ckpt"))
    assert "checkpoint_latest.npz" in files
    assert "checkpoint_step000000002.npz" in files


# ----------------------------------------------------------------------
# the row offset of the dropout key, against the JAX package
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1234, -2 ** 31])
def test_dropout_mask_row_offset_matches_jax(seed):
    """dropout_mask(b0=4) is rows 4..7 of the b0=0 mask over 8 rows, and
    the JAX kernels' mask at the same row offset."""
    import jax.numpy as jnp

    from wavenet_vocoder_tpu.ops import pallas_train as pt
    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    for l, t0, keep in ((0, 0, 0.9), (5, 504, 0.7)):
        kw = dict(T=40, R=16, L=24, l=l, t0=t0, keep=keep)
        whole = ft.dropout_mask(seed, B=8, b0=0, **kw)
        part = ft.dropout_mask(seed, B=4, b0=4, **kw)
        assert torch.equal(part, whole[4:])
        want = pt.dropout_mask(jnp.asarray(seed, jnp.int32), Bt=4, E=40,
                               R=16, L=24, l=l, b0=4, t0=t0, keep=keep)
        np.testing.assert_array_equal(part.numpy(), np.asarray(want))


def test_fused_stack_row_offset_matches_jax_shard():
    """The JAX fused stack over a 2-device mesh hands shard 1 the row
    offset 4 (seed_arr = [seed, 4]); the port's plain stack on rows 4..7
    with b0=4 gives JAX's skips of those rows, and the forward and
    backward of its own 8-row run restricted to them."""
    import jax
    import jax.numpy as jnp

    from wavenet_vocoder_tpu.models.wavenet import (
        WaveNetSpec as JaxSpec, init_wavenet, make_generation_fast)
    from wavenet_vocoder_tpu.ops import pallas_train as pt
    from wavenet_vocoder_tpu.parallel import make_mesh
    from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
    from wavenet_vocoder_tpu_torch.models.layers import remove_weight_norm
    from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    kw = dict(out_channels=64, layers=4, stacks=2, residual_channels=16,
              gate_channels=32, skip_out_channels=24, cin_channels=8)
    jspec, tspec = JaxSpec(**kw), WaveNetSpec(**kw)
    params = jax.tree.map(np.asarray, init_wavenet(jax.random.PRNGKey(0),
                                                   jspec))
    model = WaveNet(tspec)
    model.load_state_dict(state_dict_from_jax(params, tspec))
    remove_weight_norm(model)
    blocks = make_generation_fast(jax.tree.map(jnp.asarray,
                                               params))["blocks"]
    rs = np.random.RandomState(3)
    B, T, drop, seed = 8, 64, 0.3, 4321
    x0 = rs.randn(B, T, 16).astype(np.float32)
    c = rs.randn(B, T, 8).astype(np.float32)
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    jskips = np.asarray(pt.fused_res_stack(
        jnp.asarray(x0), jnp.asarray(c), blocks, jspec, dtype=jnp.float32,
        Bt=2, Tt=32, interpret=True, mesh=mesh, dropout=drop,
        seed=jnp.full((1, 1), seed, jnp.int32)))
    run = lambda rows, b0: ft.fused_res_stack(
        torch.from_numpy(x0[rows]).requires_grad_(),
        torch.from_numpy(c[rows]), model.conv_layers, tspec,
        dtype=torch.float32, dropout=drop, seed=seed, b0=b0)
    part = run(slice(4, 8), 4)
    np.testing.assert_allclose(part.detach().numpy(), jskips[4:],
                               rtol=1e-5, atol=2e-5)
    whole = run(slice(0, 8), 0)
    np.testing.assert_allclose(part.detach().numpy(),
                               whole.detach().numpy()[4:], rtol=1e-6,
                               atol=1e-6)
    # the keys differ from rank 0's: the same rows at b0=0 drop otherwise
    other = run(slice(4, 8), 0)
    assert float((other - part).detach().abs().max()) > 1e-3


# ----------------------------------------------------------------------
# the full loop and the evaluation CLI on two processes
# ----------------------------------------------------------------------
def test_two_process_train_loop_primary_writes_and_resumes(tmp_path):
    """train_loop on 2 ranks (fused, dropout 0.1, eval audio every 2
    steps): only rank 0 writes (each rank has its own checkpoint dir), and
    2 steps + a resume of 2 more end where 4 uninterrupted steps end, to
    the bit. The dump gives each rank one batch per epoch of two equal
    utterances, so the resumed loader feeds what the uninterrupted one
    feeds."""
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    _loop_dump(tmp_path / "dump")
    ranks = _cluster("loop", tmp_path)
    assert [r["jax_loaded"] for r in ranks] == [False, False]
    assert [r["steps"] for r in ranks] == [[4, 2, 4]] * 2
    for exp in ("exp_a", "exp_b"):
        assert os.listdir(tmp_path / f"{exp}_rank1") == []
        files = set(os.listdir(tmp_path / f"{exp}_rank0"))
        assert {"hparams.json", "checkpoint_latest.npz",
                "checkpoint_latest_ema.npz", "log", "intermediate"} <= files
    wavs = os.listdir(tmp_path / "exp_a_rank0" / "intermediate"
                      / "train_no_dev_eval")
    assert "step000000004_predicted.wav" in wavs
    spec = spec_from_config(Config(**LOOP_CFG))
    a, ca = ckpt.load_params(str(tmp_path / "exp_a_rank0"
                                 / "checkpoint_latest.npz"), spec)
    b, cb = ckpt.load_params(str(tmp_path / "exp_b_rank0"
                                 / "checkpoint_latest.npz"), spec)
    assert ca["global_step"] == cb["global_step"] == 4
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _loop_dump(root):
    root.mkdir()
    rs = np.random.RandomState(0)
    waves = [rs.uniform(-0.5, 0.5, 512).astype(np.float32) for _ in range(2)]
    for i in range(4):       # rank 0 gets u0, u2; rank 1 gets u1, u3
        np.save(root / f"u{i}-wave.npy", waves[i % 2])
    return root


def test_use_mesh_spawns_one_rank_per_gpu(tmp_path):
    """train_loop(use_mesh=True) in a process that sees two GPUs and no
    process group spawns one rank per GPU (torch.multiprocessing, a free
    localhost port): both ranks train, the primary writes, and the final
    state comes back."""
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    dump = _loop_dump(tmp_path / "dump")
    out = tmp_path / "spawn.json"
    log = _launch([["--spawn", str(dump), str(tmp_path / "exp"), str(out)]])[0]
    assert "Training data-parallel over 2 GPUs, one process each" in log
    assert "rank 0 of 2" in log and "rank 1 of 2" in log
    res = json.loads(out.read_text())
    assert res == {"step": 2, "jax_loaded": False}
    _, counters = ckpt.load_params(str(tmp_path / "exp"
                                       / "checkpoint_latest.npz"),
                                   spec_from_config(Config(**LOOP_CFG)))
    assert counters["global_step"] == 2


def test_use_mesh_false_trains_on_one_of_several_gpus(tmp_path, monkeypatch,
                                                      capsys):
    """use_mesh=False with several GPUs spawns nothing and says it trains
    on one of them."""
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training import loop

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(loop, "_spawn_data_parallel", stop)
    monkeypatch.setattr(loop, "get_data_loaders", stop)
    with pytest.raises(Stop):
        loop.train_loop(Config(**LOOP_CFG), str(tmp_path), str(tmp_path),
                        use_mesh=False)
    out = capsys.readouterr().out
    assert "use_mesh=False: training on one of 2 GPUs" in out
    monkeypatch.setattr(loop, "get_data_loaders", lambda *a, **k: 1 / 0)
    with pytest.raises(Stop):       # use_mesh=True: the spawn, nothing else
        loop.train_loop(Config(**LOOP_CFG), str(tmp_path), str(tmp_path))


def test_two_process_evaluate_writes_disjoint_shards(tmp_path):
    """cli.evaluate --distributed on 2 processes: disjoint wav sets whose
    union is the corpus, per-process manifests, and in deterministic mode
    the same audio as one process, utterance by utterance."""
    from scipy.io import wavfile

    from wavenet_vocoder_tpu_torch.cli.evaluate import main as evaluate
    from wavenet_vocoder_tpu_torch.config import load_config
    from wavenet_vocoder_tpu_torch.training.checkpoint import save_checkpoint
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state)
    preset = {
        "name": "wavenet_vocoder",
        "input_type": "mulaw-quantize", "quantize_channels": 256,
        "out_channels": 256, "sample_rate": 16000, "hop_size": 128,
        "num_mels": 8, "cin_channels": 8, "cin_pad": 0,
        "upsample_conditional_features": True,
        "upsample_params": {"upsample_scales": [4, 4, 8]},
        "layers": 2, "stacks": 1, "residual_channels": 8,
        "gate_channels": 8, "skip_out_channels": 8,
        "compute_dtype": "", "lr_schedule": "",
    }
    preset_path = tmp_path / "preset.json"
    preset_path.write_text(json.dumps(preset))
    cfg = load_config(str(preset_path), "")
    ckpt = save_checkpoint(str(tmp_path / "ckpt"),
                           create_train_state(cfg, device="cpu"),
                           global_step=0)
    dump = tmp_path / "dump"
    dump.mkdir()
    rs = np.random.RandomState(0)
    n_utt = 6
    for i in range(n_utt):
        np.save(dump / f"u{i}-feats.npy", rs.randn(4, 8).astype(np.float32))
    common = ["--preset", str(preset_path), "--batch-size", "2",
              "--device", "cpu", "--deterministic"]
    out_dir = tmp_path / "generated"
    port = _free_port()
    _launch([["--run-module", "wavenet_vocoder_tpu_torch.cli.evaluate",
              str(dump), ckpt, str(out_dir)] + common
             + ["--coordinator-address", f"127.0.0.1:{port}",
                "--num-processes", "2", "--process-id", str(pid)]
             for pid in range(2)])
    gens = sorted(f for f in os.listdir(out_dir) if f.endswith("_gen.wav"))
    assert len(gens) == n_utt, gens
    lists = [(out_dir / f"eval_manifest.proc{pid}.txt").read_text().split()
             for pid in range(2)]
    assert len(lists[0]) + len(lists[1]) == n_utt
    assert not set(lists[0]) & set(lists[1])
    assert sorted(lists[0] + lists[1]) == gens
    assert not (out_dir / "eval_manifest.txt").exists()

    one = tmp_path / "one"
    evaluate([str(dump), ckpt, str(one)] + common)
    assert sorted((one / "eval_manifest.txt").read_text().split()) == gens
    for name in gens:
        np.testing.assert_array_equal(wavfile.read(out_dir / name)[1],
                                      wavfile.read(one / name)[1],
                                      err_msg=name)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run-module"]:
        run_module_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--spawn"]:
        spawn_main(sys.argv[2:])
    else:
        worker_main(sys.argv[1:])
