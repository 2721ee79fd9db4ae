"""Gate-channel tensor parallelism over processes: real gloo clusters on
the CPU (model 2; data 2 x model 2) against one process.

The port's counterpart of tests/test_sharding.py's tensor-parallel cases.
``parallel.sharding.shard_train_state`` cuts the residual blocks (conv and
conditioning 1x1s column-parallel in GLU pairs, out/skip row-parallel with
g whole) over the model group; the step then runs Megatron's collectives
(plain loop) or gathers each block's weights for the fused stack, sums the
gradients over the data group, and takes the clip's norm and the
optimizers' whole-tensor statistics over the model group. Invariant: after
two steps (Adam, Lamb and Adafactor; clip 0.5, dropout 0.1, weight decay
0.01, global conditioning, unequal valid lengths) the losses, grad norms,
every gathered parameter and the gathered EMA equal one process's, to the
limits of tests/test_torch_distributed.py (losses and the first grad norm
1e-6 relative, the second 1e-5, elements 5e-6). The config takes one-hot
input: Lamb's trust ratio and Adafactor's first step scale every tensor's
update to the tensor's size, so a scalar input's first_conv.weight_v (one
element an output channel, its gradient rounding noise) would move by a
full step in a direction that depends on the summation order.

Also: Adafactor's factored statistics and Lamb's norms of cut tensors
(a (256, 128, 3) column-parallel and a (128, 128, 1) row-parallel tensor,
both factored) through the optimizers alone; a checkpoint written from the
cut state loads into an unsharded run of the port and of the JAX package;
``entry.dryrun_multichip(4)`` on the CPU.

The workers are this file run as a script; one thread each, a free port,
a 240 s timeout.
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
STEPS = 2
TP = dict(input_type="mulaw-quantize", quantize_channels=64, out_channels=64,
          layers=4, stacks=2, residual_channels=16, gate_channels=32,
          skip_out_channels=24, cin_channels=8, gin_channels=4, batch_size=8,
          upsample_conditional_features=False, dropout=0.1,
          compute_dtype="", lr_schedule="", clip_thresh=0.5,
          exponential_moving_average=True, ema_decay=0.9,
          optimizer_params={"lr": 1e-3, "eps": 1e-5, "weight_decay": 0.01})
CASES = {f"{opt.lower()}-{path}": dict(optimizer=opt,
                                       fused_train=path == "fused")
         for opt in ("Adam", "Lamb", "Adafactor")
         for path in ("plain", "fused")}
LENGTHS = (96, 89, 64, 96, 71, 96, 50, 83)
# train_loop with a model axis: tests/test_torch_distributed.py's loop
# config (scalar input, Adam eps 1e-5), the blocks cut over 2 ranks
LOOP_CFG = dict(input_type="raw", quantize_channels=256, out_channels=30,
                layers=4, stacks=2, residual_channels=16, gate_channels=32,
                skip_out_channels=24, cin_channels=-1, batch_size=4,
                max_time_steps=512, upsample_conditional_features=False,
                dropout=0.1, compute_dtype="", lr_schedule="",
                exponential_moving_average=True, ema_decay=0.9,
                checkpoint_interval=2, train_eval_interval=2,
                test_eval_epoch_interval=10 ** 9, num_workers=0, nepochs=50,
                optimizer_params={"lr": 1e-3, "eps": 1e-5,
                                  "weight_decay": 0.0},
                mesh_axes={"data": -1, "model": 2})
WORLDS = {"model2": (2, 2), "data2-model2": (4, 2)}
# the plain layer loop in bf16 under the model axis (world "model2"): its
# f and g collectives reduce bf16 tensors. At the flagship's widths, where
# phase 6's bf16 STEP_TOL was set (one bf16 step is within 1e-3 of the f32
# one's grad norm there, not at TP's narrow widths), on the bench's batch
# (B=8, T=10240), one step from one state, as phase 6 holds its limits:
# the loss, the grad norm and every leaf's gradient against its largest
# value. SGD, as chip_smoke.py's phase 15 (c): Adam
# turns a gradient that is bf16 rounding noise into a full step of random
# sign.
BF16_CASE = dict(optimizer="SGD", optimizer_params={"lr": 1e-2},
                 compute_dtype="bfloat16", fused_train=False,
                 max_time_steps=10240)
BF16_B = 8
BF16_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "leaf": 0.1}
# synthesis of entry.dryrun_config()'s model, deterministic
SYNTH_B, SYNTH_T = 2, 64


def make_batch(B=8, T=96):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 64, (B, T))
    return {"x": np.eye(64, dtype=np.float32)[ids], "y": ids.astype(np.int32),
            "c": rs.randn(B, T, 8).astype(np.float32),
            "g": rs.randn(B, 4).astype(np.float32),
            "input_lengths": np.asarray(LENGTHS[:B], np.int32)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------------
# what the workers run (and the test process, for the single process)
# ----------------------------------------------------------------------
def run_steps(case, batch, groups=None, ckpt_dir=None):
    """STEPS train steps of CASES[case] from the init of seed 0 on this
    rank's rows (all rows without groups): (metrics, the gathered
    parameters and EMA as numpy)."""
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.parallel.sharding import (
        gather_train_state, shard_train_state)
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    cfg = Config(**{**TP, **CASES[case]})
    state = create_train_state(cfg, device="cpu")
    local = batch
    if groups is not None:
        shard_train_state(state, groups)
        n = len(batch["x"]) // groups.data_size
        local = {k: v[groups.data_rank * n:(groups.data_rank + 1) * n]
                 for k, v in batch.items()}
    step, _ = make_train_step(cfg, group=None if groups is None
                              else groups.data)
    gen = torch.Generator().manual_seed(0)
    out = {"loss": [], "grad_norm": []}
    for _ in range(STEPS):
        m = step(state, local, gen)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    if ckpt_dir is not None:
        ckpt.save_checkpoint(ckpt_dir, state, global_step=STEPS)
    whole = gather_train_state(state)
    snap = {k: v.detach().numpy().copy()
            for k, v in whole.model.state_dict().items()}
    snap.update({"ema." + k: v.detach().numpy().copy()
                 for k, v in whole.ema.items()})
    return out, snap


def run_bf16_steps(groups=None):
    """One plain-loop bf16 SGD step of the flagship under BF16_CASE on the
    bench's batch: its loss and grad norm, the whole gradients and the
    whole parameters after it."""
    from wavenet_vocoder_tpu_torch.bench import train_batch
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.layers import all_gather_slices
    from wavenet_vocoder_tpu_torch.parallel.sharding import (
        shard_train_state, wavenet_param_shardings)
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    cfg = Config(**BF16_CASE)
    batch = train_batch(cfg, BF16_B)
    state = create_train_state(cfg, device="cpu")
    rules = wavenet_param_shardings(state.model)
    if groups is not None:
        shard_train_state(state, groups)

    def whole(grads):
        out = {}
        for n, p in state.model.named_parameters():
            t = (p.grad if grads else p).detach()
            if groups is not None and rules[n] is not None:
                t = all_gather_slices(t, rules[n], groups.model)
            out[("grad." if grads else "") + n] = t.numpy().copy()
        return out

    step, _ = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    m = step(state, batch, gen)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    return out, {**whole(grads=True), **whole(grads=False)}


def run_synthesis(groups=None):
    """Deterministic synthesis of ``entry.dryrun_config()``'s model (the
    init of its seed), its blocks cut over the model group when given:
    SYNTH_T steps of the eager decoder (logits and samples), the kernel
    engine's packed weights and its samples (its plain version here)."""
    from wavenet_vocoder_tpu_torch.entry import dryrun_config
    from wavenet_vocoder_tpu_torch.models.wavenet import (
        WaveNet, spec_from_config)
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    from wavenet_vocoder_tpu_torch.ops.generate import generate
    from wavenet_vocoder_tpu_torch.parallel.sharding import shard_params_tp
    cfg = dryrun_config()
    model = WaveNet(spec_from_config(cfg),
                    generator=torch.Generator().manual_seed(cfg.seed)).eval()
    if groups is not None:
        shard_params_tp(model, groups)
    frames = SYNTH_T // cfg.hop_size + 1 + 2 * cfg.cin_pad
    c = torch.from_numpy(np.random.RandomState(3).randn(
        SYNTH_B, frames, cfg.cin_channels).astype(np.float32))
    with torch.no_grad():
        c_up = model.upsample_conditioning(c)[:, :SYNTH_T]
    out = generate(model, T=SYNTH_T, c_up=c_up, deterministic=True,
                   output="both")
    gen = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=32)
    res = {"logits": out["logits"].numpy(),
           "samples": out["samples"].numpy(),
           "fused": gen(T=SYNTH_T, c_up=c_up, deterministic=True).numpy()}
    res.update({"packed." + k: v.detach().numpy()
                for k, v in gen.packed.items()})
    return res


def _opt_tensors(seed=0):
    """Whole tensors and three steps of gradients: a column-parallel
    (256, 128, 3), a row-parallel (128, 128, 1) and a replicated bias."""
    rs = np.random.RandomState(seed)
    shapes = [(256, 128, 3), (128, 128, 1), (7,)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) * 0.1 for s in shapes]
             for _ in range(3)]
    return params, grads


def run_optimizer(name, groups=None):
    """Lamb or Adafactor alone on the cut tensors (clip 0.5 through
    ``clip_by_global_norm``): the whole tensors after 3 steps."""
    from wavenet_vocoder_tpu_torch.models.layers import (
        COLUMN, ROW, all_gather_slices, shard_slice)
    from wavenet_vocoder_tpu_torch.training import optimizers
    from wavenet_vocoder_tpu_torch.training.train_state import (
        clip_by_global_norm)
    whole, grads = _opt_tensors()
    kinds = [COLUMN, ROW, None]
    cut = (lambda a, k: a) if groups is None else (
        lambda a, k: a if k is None else shard_slice(
            a, k, groups.model_rank, groups.model_size).clone())
    params = [torch.nn.Parameter(cut(torch.from_numpy(a), k))
              for a, k in zip(whole, kinds)]
    part = [0, 1, None]
    opt = getattr(optimizers, name)(
        [{"params": params, "partition_dim": part}], lr=0.05)
    if groups is not None:
        opt.model_group = groups.model
    for gs in grads:
        for p, g, k in zip(params, gs, kinds):
            p.grad = cut(torch.from_numpy(g), k)
        clip_by_global_norm([p.grad for p in params], 0.5,
                            [d is not None for d in part],
                            None if groups is None else groups.model)
        opt.step()
    if groups is None:
        return [p.detach().numpy() for p in params]
    return [p.detach().numpy() if k is None else
            all_gather_slices(p.detach(), k, groups.model).numpy()
            for p, k in zip(params, kinds)]


def worker_main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--model", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--work", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from wavenet_vocoder_tpu_torch.parallel import initialize_distributed
    from wavenet_vocoder_tpu_torch.parallel.distributed import (
        parallel_groups)
    initialize_distributed(f"127.0.0.1:{args.port}", args.world, args.rank,
                           backend="gloo", timeout_s=WORKER_TIMEOUT_S)
    groups = parallel_groups(args.model)
    batch = make_batch()
    res = {"groups": [groups.data_rank, groups.data_size, groups.model_rank,
                      groups.model_size]}
    for case in CASES:
        ckpt_dir = (os.path.join(args.work, "ckpt") if case == "lamb-fused"
                    else None)
        res[case], snap = run_steps(case, batch, groups, ckpt_dir)
        np.savez(os.path.join(args.work, f"{case}.rank{args.rank}.npz"),
                 **snap)
    for name in ("Lamb", "Adafactor"):
        np.savez(os.path.join(args.work, f"opt-{name}.rank{args.rank}.npz"),
                 *run_optimizer(name, groups))
    if args.world == 2:
        res["bf16"], arrays = run_bf16_steps(groups)
        np.savez(os.path.join(args.work, f"bf16.rank{args.rank}.npz"),
                 **arrays)
        np.savez(os.path.join(args.work, f"synth.rank{args.rank}.npz"),
                 **run_synthesis(groups))
        from wavenet_vocoder_tpu_torch.config import Config
        from wavenet_vocoder_tpu_torch.training.loop import train_loop
        state = train_loop(Config(**LOOP_CFG), os.path.join(args.work, "dump"),
                           os.path.join(args.work, f"exp_rank{args.rank}"),
                           max_steps_override=4, log_interval=1,
                           device="cpu")
        res["loop_step"] = state.step
    res["jax_loaded"] = ("jax" in sys.modules
                         or "wavenet_vocoder_tpu" in sys.modules)
    with open(os.path.join(args.work, f"rank{args.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# the clusters
# ----------------------------------------------------------------------
def _launch(world, model, work):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(world), "--model", str(model), "--port", str(port),
         "--work", str(work)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a worker passed its timeout")
        logs.append(out.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both clusters, and the single-process references."""
    out = {}
    for tag, (world, model) in WORLDS.items():
        work = tmp_path_factory.mktemp(tag)
        _loop_dump(work / "dump")
        out[tag] = dict(work=work, world=world, ranks=_launch(world, model,
                                                              work))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batch = make_batch()
        out["single"] = {case: run_steps(case, batch) for case in CASES}
        out["single_opt"] = {n: run_optimizer(n) for n in ("Lamb",
                                                           "Adafactor")}
        out["single_bf16"] = run_bf16_steps()
        out["single_synth"] = run_synthesis()
    finally:
        torch.set_num_threads(threads)
    return out


def _loop_dump(root):
    root.mkdir()
    rs = np.random.RandomState(0)
    for i in range(4):
        np.save(root / f"u{i}-wave.npy",
                rs.uniform(-0.5, 0.5, 512).astype(np.float32))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("tag", sorted(WORLDS))
def test_workers_form_the_mesh_and_import_no_jax(runs, tag):
    world, model = WORLDS[tag]
    ranks = runs[tag]["ranks"]
    assert [r["jax_loaded"] for r in ranks] == [False] * world
    assert [r["groups"] for r in ranks] == [
        [i // model, world // model, i % model, model] for i in range(world)]


@pytest.mark.parametrize("tag", sorted(WORLDS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_parallel_steps_match_one_process(runs, tag, case):
    run = runs[tag]
    want, ref = runs["single"][case]
    for r, got in enumerate(run["ranks"]):
        got = got[case]
        for i in range(STEPS):
            assert _rel(got["loss"][i], want["loss"][i]) <= 1e-6, (r, i)
            assert (_rel(got["grad_norm"][i], want["grad_norm"][i])
                    <= (1e-6 if i == 0 else 1e-5)), (r, i, got, want)
        params = dict(np.load(run["work"] / f"{case}.rank{r}.npz"))
        assert sorted(params) == sorted(ref)
        # the ranks hold one model: their gathered states are bitwise equal
        first = np.load(run["work"] / f"{case}.rank0.npz")
        for k, v in params.items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)
        worst = max((float(np.abs(params[k] - v).max()), k)
                    for k, v in ref.items())
        assert worst[0] <= 5e-6, (r, worst)


@pytest.mark.parametrize("tag", sorted(WORLDS))
@pytest.mark.parametrize("name", ["Lamb", "Adafactor"])
def test_whole_tensor_statistics_of_cut_tensors(runs, tag, name):
    """Factored Adafactor statistics, parameter RMS, update clip and Lamb's
    norms over the model group: the gathered tensors equal one process's
    after 3 steps within 1e-6 of their largest value."""
    want = runs["single_opt"][name]
    for r in range(runs[tag]["world"]):
        got = np.load(runs[tag]["work"] / f"opt-{name}.rank{r}.npz")
        for i, w in enumerate(want):
            err = np.abs(got[f"arr_{i}"] - w).max()
            assert err <= 1e-6 * np.abs(w).max(), (r, i, err)


@pytest.mark.parametrize("tag", sorted(WORLDS))
def test_checkpoint_of_a_cut_state_loads_unsharded_in_both_packages(runs,
                                                                     tag):
    """The checkpoint written from the cut Lamb/fused state after two steps
    holds the whole model: it loads into an unsharded port state (equal to
    one process's parameters and EMA within 5e-6), and the JAX package
    reads it (``load_params``, then ``params_tree`` of its keystr paths):
    its forward equals the port's within 1e-4."""
    import jax
    import jax.numpy as jnp

    from wavenet_vocoder_tpu.config import Config as JaxConfig
    from wavenet_vocoder_tpu.models.wavenet import (
        apply_wavenet, spec_from_config as jax_spec_from_config)
    from wavenet_vocoder_tpu.training import checkpoint as jax_ckpt
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state)
    case = "lamb-fused"
    kw = {**TP, **CASES[case]}
    path = str(runs[tag]["work"] / "ckpt" / "checkpoint_latest.npz")
    state = create_train_state(Config(**kw), device="cpu")
    ckpt.load_checkpoint(path, state)
    assert state.step == STEPS
    _, ref = runs["single"][case]
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    got.update({"ema." + k: v.numpy() for k, v in state.ema.items()})
    worst = max(float(np.abs(got[k] - v).max()) for k, v in ref.items())
    assert worst <= 5e-6
    jspec = jax_spec_from_config(JaxConfig(**kw))
    payload = jax_ckpt.load_params(path)
    assert payload.counters["global_step"] == STEPS
    params = jax_ckpt.params_tree(payload)
    b = make_batch(B=2)
    want = np.asarray(apply_wavenet(
        params, jspec, jnp.asarray(b["x"]), c=jnp.asarray(b["c"]),
        g=jnp.asarray(b["g"])))
    with torch.no_grad():
        mine = state.model(torch.from_numpy(b["x"]), torch.from_numpy(b["c"]),
                           torch.from_numpy(b["g"])).numpy()
    np.testing.assert_allclose(mine, want, rtol=1e-4, atol=1e-4)


def test_train_loop_reads_a_model_axis(runs, tmp_path):
    """train_loop in a process group of 2 with ``mesh_axes`` {"data": -1,
    "model": 2}: both ranks feed the same rows and cut the blocks; the
    primary writes checkpoints (and eval audio) from the gathered state,
    the other rank nothing; after 4 steps its checkpoint equals a single
    process's train_loop on the same dump within 5e-6."""
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.loop import train_loop
    work = runs["model2"]["work"]
    assert [r["loop_step"] for r in runs["model2"]["ranks"]] == [4, 4]
    assert os.listdir(work / "exp_rank1") == []
    assert "step000000004_predicted.wav" in os.listdir(
        work / "exp_rank0" / "intermediate" / "train_no_dev_eval")
    cfg = Config(**LOOP_CFG)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_loop(cfg, str(work / "dump"), str(tmp_path / "one"),
                   max_steps_override=4, log_interval=1, device="cpu")
    finally:
        torch.set_num_threads(threads)
    spec = spec_from_config(cfg)
    for ema in (False, True):
        a, ca = ckpt.load_params(ckpt.latest_path(str(work / "exp_rank0"),
                                                  ema=ema), spec)
        b, cb = ckpt.load_params(ckpt.latest_path(str(tmp_path / "one"),
                                                  ema=ema), spec)
        assert ca["global_step"] == cb["global_step"] == 4
        assert sorted(a) == sorted(b)
        for k in a:
            assert float((a[k] - b[k]).abs().max()) <= 5e-6, (ema, k)


def test_bf16_plain_loop_under_a_model_axis(runs):
    """The plain layer loop in bf16 with the blocks cut over two ranks
    (its collectives reduce bf16 tensors) against one process, one step
    from one state within phase 6's bf16 STEP_TOL: the loss, the grad
    norm and every parameter's gradient (max |diff| over the leaf's
    largest value, as ``chip_smoke.leaf_grad_errors``); the ranks'
    gathered parameters after the step bitwise equal."""
    work = runs["model2"]["work"]
    want, ref = runs["single_bf16"]
    first = np.load(work / "bf16.rank0.npz")
    for r, rank in enumerate(runs["model2"]["ranks"]):
        got = rank["bf16"]
        assert _rel(got["loss"], want["loss"]) <= BF16_TOL["loss"]
        assert _rel(got["grad_norm"], want["grad_norm"]) <= BF16_TOL[
            "grad_norm"]
        arrays = np.load(work / f"bf16.rank{r}.npz")
        assert sorted(arrays.files) == sorted(ref)
        scale = {k: float(np.abs(v).max()) for k, v in ref.items()
                 if k.startswith("grad.")}
        # phase 6's floor: no scale below 1e-6 of the largest leaf's (the
        # gradient of first_conv.weight_v is rounding noise, ~1e-11)
        floor = 1e-6 * max(scale.values())
        for k, v in ref.items():
            if k in scale:
                err = float(np.abs(arrays[k] - v).max())
                assert err <= BF16_TOL["leaf"] * max(scale[k], floor), (
                    r, k, err, scale[k])
            else:
                np.testing.assert_array_equal(arrays[k], first[k], err_msg=k)


def test_synthesis_of_a_cut_model_computes_the_whole_model(runs):
    """Deterministic synthesis with the blocks cut over two ranks: the
    eager decoder's logits within 1e-5 of the whole model's and its
    samples equal; the kernel engine packs the whole weights (equal to
    the whole model's pack) and gives the whole model's samples; both
    ranks' outputs bitwise equal."""
    work = runs["model2"]["work"]
    want = runs["single_synth"]
    first = dict(np.load(work / "synth.rank0.npz"))
    for r in range(2):
        got = dict(np.load(work / f"synth.rank{r}.npz"))
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)
        assert float(np.abs(got["logits"] - want["logits"]).max()) <= 1e-5
        np.testing.assert_array_equal(got["samples"], want["samples"])
        for k in want:
            if k.startswith("packed.") or k == "fused":
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dryrun_multichip_on_the_cpu(capsys):
    from wavenet_vocoder_tpu_torch.entry import dryrun_multichip
    res = dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): mesh={'data': 2, "
                           "'model': 2}") and line.endswith("OK")
    assert res["backend"] == "gloo" and res["synth"] == [2, 512]
    assert np.isfinite(res["loss"]) and np.isfinite(res["fused_loss"])
    # the two model ranks of a data row synthesise the same utterance
    wavs = [r["wav"] for r in res["ranks"]]
    assert wavs[0] == wavs[1] and wavs[2] == wavs[3]


if __name__ == "__main__":
    worker_main(sys.argv[1:])
