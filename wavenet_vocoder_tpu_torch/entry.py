"""Driver entry points of the port (the counterpart of the repository's
``__graft_entry__.py``).

``entry(device=None)``    -- (fn, args): the flagship forward (24 layers, 4
                             stacks, MoL head, 80-mel conditioning) on the
                             card unless ``device`` names another.
``dryrun_multichip(n)``   -- one training step of each kind over n ranks,
                             then utterance-sharded synthesis, on tiny
                             shapes; prints its OK line.

    python -m wavenet_vocoder_tpu_torch.entry [N] [--device cpu]

The dry run spawns n processes joined by ``torch.distributed``: NCCL when
every rank has a GPU of its own, gloo when the ranks share one (a check of
the mechanism, not a way to train) or run on the CPU. The ranks form a
(data, model) mesh with model 2 when n is even and above 2, else 1, as the
JAX dry run builds its mesh:

  * a plain-loop training step of the JAX dry run's mulaw256 config with
    the residual blocks' gate channels cut over the model axis
    (``parallel.sharding.shard_train_state``), the batch over the data axis;
  * a data-parallel step of the fused stack over all n ranks (the training
    kernels on a GPU, their plain versions on the CPU);
  * deterministic synthesis of the gathered model through the generation
    engine (``csrc/generate.cu`` on a GPU), each data row its utterance.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

DRYRUN_TIMEOUT_S = 300


def entry(device=None):
    """Return (fn, example_args) for the flagship forward step."""
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import (
        WaveNet, spec_from_config)
    from wavenet_vocoder_tpu_torch.synthesis import resolve_device
    device = resolve_device(device)
    cfg = Config()
    model = WaveNet(spec_from_config(cfg),
                    generator=torch.Generator().manual_seed(0)).to(device)
    hop = cfg.hop_size
    B, frames = 1, 40
    T = (frames - 2 * cfg.cin_pad) * hop
    x = torch.zeros(B, T, 1, device=device)
    c = torch.zeros(B, frames, cfg.num_mels, device=device)
    dtype = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None

    def fn(model, x, c):
        with torch.no_grad():
            return model(x, c, dtype=dtype)

    return fn, (model, x, c)


def dryrun_config():
    """The JAX dry run's tiny mulaw256 config."""
    from wavenet_vocoder_tpu_torch.config import Config
    return Config(
        input_type="mulaw-quantize", quantize_channels=256, out_channels=256,
        layers=4, stacks=2, residual_channels=32, gate_channels=64,
        skip_out_channels=32, cin_channels=20, cin_pad=2,
        upsample_conditional_features=True,
        upsample_params={"upsample_scales": [4, 4, 8]},
        hop_size=128, compute_dtype="", lr_schedule="",
        exponential_moving_average=True)


def dryrun_batch(cfg, B: int, T: int = 1280):
    """The JAX dry run's batch (numpy, from RandomState(0))."""
    frames = T // cfg.hop_size + 2 * cfg.cin_pad
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (B, T))
    batch = {
        "x": np.eye(256, dtype=np.float32)[ids],
        "y": ids.astype(np.int32),
        "c": rs.randn(B, frames, cfg.cin_channels).astype(np.float32),
        "input_lengths": np.full(B, T, np.int32),
    }
    return batch, rs


def _rows(batch, i: int, n: int):
    m = len(batch["x"]) // n
    return {k: v[i * m:(i + 1) * m] for k, v in batch.items()}


def _rank_main(rank: int, n: int, port: int, backend: str, device: str,
               out_dir: str) -> None:
    """One rank of the dry run; writes its results to out_dir."""
    from wavenet_vocoder_tpu_torch.parallel import distributed as pdist
    from wavenet_vocoder_tpu_torch.parallel.sharding import (
        gather_train_state, make_mesh, shard_train_state)
    from wavenet_vocoder_tpu_torch.synthesis import batch_wavegen
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    torch.set_num_threads(1)
    ids = None if device == "cpu" else (str(rank) if backend == "nccl"
                                        else device.split(":")[-1])
    pdist.initialize_distributed(f"127.0.0.1:{port}", n, rank,
                                 local_device_ids=ids, backend=backend,
                                 timeout_s=DRYRUN_TIMEOUT_S)
    try:
        dev = torch.device("cpu") if device == "cpu" \
            else pdist.process_device()
        model_axis = 2 if n % 2 == 0 and n > 2 else 1
        shape = {"data": n // model_axis, "model": model_axis}
        make_mesh(shape, devices=[torch.device("cpu", i) for i in range(n)])
        groups = pdist.parallel_groups(model_axis)
        cfg = dryrun_config()
        B = groups.data_size * 2
        batch, rs = dryrun_batch(cfg, B)

        state = create_train_state(cfg, device=dev)
        shard_train_state(state, groups)
        step, _ = make_train_step(cfg, group=groups.data)
        m = step(state, _rows(batch, groups.data_rank, groups.data_size))
        loss = float(m["loss"])
        if not np.isfinite(loss) or state.step != 1:
            raise RuntimeError(f"plain tensor-parallel step: loss {loss}, "
                               f"step {state.step}")

        # the fused leg: data-parallel over every rank
        cfg_f = dataclasses.replace(cfg, fused_train=True)
        dp = pdist.parallel_groups(1)
        state_f = create_train_state(cfg_f, device=dev)
        step_f, _ = make_train_step(cfg_f, group=dp.data)
        loss_f = float(step_f(state_f, _rows(batch, rank, n))["loss"])
        if not np.isfinite(loss_f):
            raise RuntimeError(f"fused data-parallel step: loss {loss_f}")

        # utterance-sharded synthesis of the whole (gathered) model
        whole = gather_train_state(state).model
        Bs, frames = groups.data_size, 4 + 2 * cfg.cin_pad
        c_syn = rs.randn(Bs, frames, cfg.cin_channels).astype(np.float32)
        wav = batch_wavegen(whole, cfg, c=c_syn[groups.data_rank:
                                               groups.data_rank + 1],
                            engine="cuda", device=dev, deterministic=True)
        if wav.shape != (1, 4 * cfg.hop_size) or not np.isfinite(wav).all():
            raise RuntimeError(f"synthesis gave {wav.shape}")
        from wavenet_vocoder_tpu_torch.utils import profiling
        counts = profiling.counters()
        res = dict(rank=rank, mesh=shape, loss=loss, fused_loss=loss_f,
                   synth=[Bs, int(wav.shape[1])], wav=wav[0].tolist(),
                   launches={k: counts.get(k + ".launches", 0) for k in
                             ("train_fwd", "train_bwd", "generate")},
                   jax_loaded="jax" in sys.modules
                   or "wavenet_vocoder_tpu" in sys.modules)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> dict:
    """Run the dry run on ``n_devices`` ranks (see the module docstring);
    ``device`` None means the GPUs, "cpu" the CPU. Prints the OK line and
    returns rank 0's results; raises if a rank fails or passes
    DRYRUN_TIMEOUT_S."""
    import torch.multiprocessing as mp
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a dry run "
                           "on the CPU")
    if device == "cpu":
        backend, dev = "gloo", "cpu"
    elif torch.cuda.device_count() >= n_devices:
        backend, dev = "nccl", "cuda"
    else:       # ranks share the first GPU: gloo (NCCL refuses that)
        backend, dev = "gloo", "cuda:0"
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_devices, port, backend, dev, out))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        try:
            # a rank that fails leaves the others waiting on a collective:
            # stop them all at once
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit "
                               f"codes {codes}")
        res = [json.load(open(os.path.join(out, f"rank{r}.json")))
               for r in range(n_devices)]
    r0 = res[0]
    if any(r["jax_loaded"] for r in res):
        raise RuntimeError("a rank imported JAX")
    if len({r["loss"] for r in res}) != 1 or len(
            {r["fused_loss"] for r in res}) != 1:
        raise RuntimeError(f"the ranks report different losses: {res}")
    print(f"dryrun_multichip({n_devices}): mesh={r0['mesh']} "
          f"loss={r0['loss']:.4f} fused_loss={r0['fused_loss']:.4f} "
          f"synth={tuple(r0['synth'])} backend={backend} OK", flush=True)
    return dict(r0, backend=backend, ranks=res)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
    n = a.n or max(torch.cuda.device_count() if a.device is None else 1, 1)
    dryrun_multichip(n, a.device)
