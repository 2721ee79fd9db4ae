"""Training loop orchestration (reference: train.py:780-849, 1035-1114).

The port's counterpart of ``wavenet_vocoder_tpu/training/loop.py``: an epoch
loop over the {train_no_dev, dev} splits of a dump directory; per-step LR
schedule, checkpoint and eval intervals; EMA; TensorBoard (or JSONL
fallback) metrics; graceful KeyboardInterrupt -> final checkpoint
(reference: train.py:1101-1110).

Batches come from ``data.DataLoader`` (numpy) through
``data.prefetch.prefetch_to_device`` (pinned host memory, copies on a side
stream) into ``train_step``. The step runs the model's fused stack, which on
the card launches the training kernels; eval audio runs the generation
kernel through ``synthesis.batch_wavegen(engine="cuda")``. Entry points run
on the card unless ``device`` names another device.

Data parallelism is one process per device (``parallel.distributed``). In a
process group (the CLI ran ``initialize_distributed``, or torchrun did) each
rank loads a disjoint corpus slice and feeds ``cfg.batch_size // world``
rows a step; the step all-reduces the gradients and the losses' mask counts,
so every rank holds the same state; only the primary writes hparams.json,
checkpoints, metrics and eval audio. With ``use_mesh`` and several GPUs in
one process, the loop spawns one worker per GPU (the JAX loop meshes all
local devices there); with ``use_mesh=False`` it trains on one of them and
says so. A ``model`` axis above 1 in ``cfg.mesh_axes`` (as the JAX loop
reads it) cuts the residual blocks' gate channels over that many ranks
(``parallel.sharding.shard_train_state``): the ranks of one model group
feed the same rows, the corpus and the batch split over the data axis, and
checkpoints and eval audio come from the gathered state (every rank takes
part in the gather; the primary writes).
"""
from __future__ import annotations

import json
import os
import sys
import time
import types
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.data import DataLoader, WaveNetDataset
from wavenet_vocoder_tpu_torch.data.prefetch import prefetch_to_device, to_device
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
from wavenet_vocoder_tpu_torch.parallel import distributed as pdist
from wavenet_vocoder_tpu_torch.parallel.sharding import (
    gather_train_state,
    shard_train_state,
)
from wavenet_vocoder_tpu_torch.synthesis import batch_wavegen, resolve_device
from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt_lib
from wavenet_vocoder_tpu_torch.training.train_state import (
    TrainState,
    create_train_state,
    make_train_step,
    sanity_check,
)


class MetricWriter:
    """TensorBoard if importable, else JSONL only; ``metrics.jsonl`` is
    always written (reference: train.py:771-775 tensorboardX scalars).
    ``enabled=False`` (the ranks other than the primary) writes nothing."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            # TensorBoard's no-TensorFlow mode: scalars need nothing of TF,
            # and a TensorFlow installed beside the port imports JAX
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is None:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


def get_data_loaders(data_root: str, cfg: Config,
                     speaker_id: Optional[int] = None,
                     batch_size: Optional[int] = None,
                     process_shard: Optional[tuple] = None
                     ) -> Dict[str, DataLoader]:
    """Loaders for the {train_no_dev, dev} dump layout
    (reference: train.py:973-1032); a flat dump dir (no splits) trains on
    everything. Static shapes, shuffled with ``cfg.seed``.

    process_shard: (rank, world) under data parallelism: each rank loads a
    disjoint corpus slice (``WaveNetDataset.shard``, equal lengths, so every
    rank runs the same number of batches) in batches of ``batch_size`` =
    global batch / world rows."""
    loaders = {}
    for phase in ("train_no_dev", "dev"):
        d = os.path.join(data_root, phase)
        if not os.path.isdir(d):
            if phase == "train_no_dev":
                d = data_root
            else:
                continue
        train = phase == "train_no_dev"
        ds = WaveNetDataset(d, cfg, speaker_id=speaker_id, train=train)
        if process_shard is not None:
            ds = ds.shard(*process_shard)
        loaders[phase] = DataLoader(ds, cfg, batch_size=batch_size,
                                    shuffle=train, seed=cfg.seed,
                                    static_shapes=True)
    return loaders


def step_generator(cfg: Config, tag: int, step: int,
                   device) -> torch.Generator:
    """A generator on ``device`` with a seed distinct per (kind, train
    step): every intermediate audio dump samples its own path (tags 1-3),
    and each train step draws its dropout seed from its own (tag 0), so a
    resumed run draws what an uninterrupted one draws, on every rank alike
    (the JAX step derives its randomness from the step count)."""
    seed = int(np.random.SeedSequence(
        [cfg.seed, tag, step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


def _decode_target(cfg: Config, y: np.ndarray) -> np.ndarray:
    """Row 0's targets as a waveform (reference: train.py:596-613)."""
    from wavenet_vocoder_tpu_torch.ops.mulaw import (
        inv_mulaw,
        inv_mulaw_quantize,
    )
    mu = cfg.quantize_channels - 1
    if cfg.is_mulaw_quantize:
        return np.asarray(inv_mulaw_quantize(y[0], mu))
    if cfg.input_type == "mulaw":
        return np.asarray(inv_mulaw(y[0, :, 0], mu))
    return y[0, :, 0]


def ema_model(state: TrainState) -> WaveNet:
    """A copy of the model with the EMA weights (the weights when there is
    no EMA), on the CPU; the training model's weights and mode are left as
    they are."""
    sd = (ckpt_lib._ema_state_dict(state) if state.ema is not None
          else state.model.state_dict())
    model = WaveNet(state.model.spec, generator=torch.Generator())
    model.load_state_dict({k: v.detach() for k, v in sd.items()})
    return model


def save_eval_audio(state: TrainState, cfg: Config, batch: Dict[str, Any],
                    out_dir: str, global_step: int,
                    generator: torch.Generator, device=None) -> None:
    """Generate row 0 of a host batch with the EMA model through the
    generation kernel and dump generated/target wavs and a PNG
    (reference: eval_model, train.py:555-623)."""
    os.makedirs(out_dir, exist_ok=True)
    device = resolve_device(device)
    one = {k: None if v is None else np.asarray(v[:1])
           for k, v in batch.items()}
    c = one.get("c")
    # c of row 0 already carries its cin_pad context (the collate adds it)
    wav = batch_wavegen(ema_model(state), cfg, c=c, g=one.get("g"),
                        T=one["x"].shape[1] if c is None else None,
                        generator=generator, engine="cuda", device=device)[0]
    audio.save_wav(wav, os.path.join(
        out_dir, f"step{global_step:09d}_predicted.wav"), cfg.sample_rate)
    target = _decode_target(cfg, one["y"])
    audio.save_wav(target, os.path.join(
        out_dir, f"step{global_step:09d}_target.wav"), cfg.sample_rate)
    # waveform comparison PNG (reference: train.py:542-552)
    from wavenet_vocoder_tpu_torch.utils.plot import save_waveplot
    save_waveplot(os.path.join(out_dir, f"step{global_step:09d}_wave.png"),
                  wav, np.asarray(target), cfg.sample_rate,
                  title=f"step {global_step}")


@torch.no_grad()
def save_states(state: TrainState, cfg: Config, batch: Dict[str, Any],
                out_dir: str, global_step: int,
                generator: torch.Generator) -> None:
    """Teacher-forced one-step predictions of row 0, sampled from the head
    -> audio dump (reference: save_states, train.py:626-674). The forward
    runs in the step's compute dtype, as the dev loss does."""
    from wavenet_vocoder_tpu_torch.ops.mixture import (
        sample_from_discretized_mix_logistic,
        sample_from_mix_gaussian,
    )
    from wavenet_vocoder_tpu_torch.ops.mulaw import inv_mulaw_quantize
    os.makedirs(out_dir, exist_ok=True)
    model = state.model
    device = next(model.parameters()).device
    one = to_device({k: None if v is None else np.asarray(v[:1])
                     for k, v in batch.items()}, device, pin_memory=False)
    dtype = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None
    y_hat = model(one["x"], one.get("c"), one.get("g"), train=False,
                  dtype=dtype).float()
    if cfg.is_mulaw_quantize:
        codes = y_hat[0].argmax(dim=-1).cpu().numpy()
        wav = np.asarray(inv_mulaw_quantize(codes, cfg.quantize_channels - 1))
    elif cfg.output_distribution == "Logistic":
        wav = sample_from_discretized_mix_logistic(
            y_hat, generator, log_scale_min=cfg.log_scale_min)[0]
    else:
        wav = sample_from_mix_gaussian(
            y_hat, generator, log_scale_min=cfg.log_scale_min)[0]
    if isinstance(wav, torch.Tensor):
        wav = wav.cpu().numpy()
    audio.save_wav(wav, os.path.join(
        out_dir, f"step{global_step:09d}_teacher_forced.wav"),
        cfg.sample_rate)


def restore(state: TrainState, *, restore_parts_path: Optional[str] = None,
            restore_checkpoint: Optional[str] = None,
            reset_optimizer: bool = False) -> Dict[str, int]:
    """Partial restore, then checkpoint restore, into ``state`` in place;
    returns the three counters (zeros without a checkpoint). After a
    partial restore the EMA shadow starts from the restored weights: the
    reference registers its EMA in its train loop (train.py:793-799), after
    restoring. (The JAX package's loop keeps the fresh init's shadow.)"""
    counters = {"global_step": 0, "global_epoch": 0, "global_test_step": 0}
    if restore_parts_path:
        ckpt_lib.restore_parts(restore_parts_path, state.model)
        if state.ema is not None:
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    state.ema[name].copy_(p)
    if restore_checkpoint:
        _, counters = ckpt_lib.load_checkpoint(
            restore_checkpoint, state, reset_optimizer=reset_optimizer)
    return counters


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawned_worker(rank: int, world: int, port: int, args: tuple,
                    kwargs: dict) -> None:
    """One rank of ``train_loop``'s spawned data-parallel run."""
    pdist.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                 local_device_ids=str(rank))
    try:
        train_loop(*args, **kwargs)
    finally:
        dist.destroy_process_group()


def _spawn_data_parallel(n: int, cfg: Config, data_root: str,
                         checkpoint_dir: str, kwargs: dict) -> TrainState:
    """Train on ``n`` local GPUs, one spawned process each (NCCL over a free
    localhost port); returns the primary's final state, read back from its
    last checkpoint onto the first GPU."""
    import torch.multiprocessing as mp
    print(f"Training data-parallel over {n} GPUs, one process each")
    mp.spawn(_spawned_worker, args=(n, _free_port(), (cfg, data_root,
                                                      checkpoint_dir), kwargs),
             nprocs=n, join=True)
    state = create_train_state(cfg, device="cuda:0")
    ckpt_lib.load_checkpoint(ckpt_lib.latest_path(checkpoint_dir), state)
    return state


def train_loop(cfg: Config, data_root: str, checkpoint_dir: str, *,
               log_event_path: Optional[str] = None,
               restore_checkpoint: Optional[str] = None,
               restore_parts_path: Optional[str] = None,
               reset_optimizer: bool = False,
               speaker_id: Optional[int] = None,
               max_steps_override: Optional[int] = None,
               use_mesh: bool = True,
               log_interval: int = 10,
               device=None) -> TrainState:
    """Full training entry (reference: train.py:1035-1114), on ``device``
    (default: the GPU; raises without one unless a device is named).

    In a process group (``parallel.initialize_distributed`` ran) this
    process is one data-parallel rank: ``device`` defaults to its GPU, it
    trains on its corpus slice and local rows, and only rank 0 writes.
    Outside one, with ``use_mesh``, no ``device`` and several GPUs, it
    spawns one rank per GPU and returns the primary's final state."""
    rank, world = pdist.process_info()
    in_group = dist.is_initialized()
    n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not in_group and device is None and n_gpu > 1:
        if use_mesh:
            return _spawn_data_parallel(
                n_gpu, cfg, data_root, checkpoint_dir, dict(
                    log_event_path=log_event_path,
                    restore_checkpoint=restore_checkpoint,
                    restore_parts_path=restore_parts_path,
                    reset_optimizer=reset_optimizer, speaker_id=speaker_id,
                    max_steps_override=max_steps_override,
                    log_interval=log_interval))
        print(f"use_mesh=False: training on one of {n_gpu} GPUs")
    if world > 1 and not use_mesh:
        raise ValueError("multi-process training requires use_mesh=True")
    if in_group and device is None:
        device = pdist.process_device()
    device = resolve_device(device)
    primary = rank == 0
    os.makedirs(checkpoint_dir, exist_ok=True)
    if primary:
        # effective config next to the checkpoints (reference:
        # train.py:1065-1067)
        with open(os.path.join(checkpoint_dir, "hparams.json"), "w") as f:
            f.write(cfg.to_json(indent=2))

    spec = spec_from_config(cfg)
    print(f"Receptive field: {spec.receptive_field} samples "
          f"({spec.receptive_field / cfg.sample_rate * 1000:.1f} ms)")

    groups = None
    if world > 1:
        groups = pdist.parallel_groups(int(cfg.mesh_axes.get("model", 1)))
        if cfg.batch_size % groups.data_size:
            raise ValueError(f"global batch {cfg.batch_size} not divisible "
                             f"by the data axis ({groups.data_size})")
        loaders = get_data_loaders(
            data_root, cfg, speaker_id,
            batch_size=cfg.batch_size // groups.data_size,
            process_shard=(groups.data_rank, groups.data_size))
        print(f"Training over a (data {groups.data_size}, model "
              f"{groups.model_size}) mesh: rank {rank} of {world} on "
              f"{device}")
    else:
        loaders = get_data_loaders(data_root, cfg, speaker_id)
    state = create_train_state(cfg, device=device)
    counters = {"global_step": 0, "global_epoch": 0, "global_test_step": 0}
    # under data parallelism only rank 0 reads the checkpoint files (the
    # only writer; the file system need not be shared) and broadcasts the
    # state and counters, which also makes every rank's state bit-identical
    if primary:
        counters = restore(state, restore_parts_path=restore_parts_path,
                           restore_checkpoint=restore_checkpoint,
                           reset_optimizer=reset_optimizer)
    if world > 1:
        counters = pdist.replicate_global(state, counters)
        shard_train_state(state, groups)
    global_step = counters["global_step"]
    global_epoch = counters["global_epoch"]
    global_test_step = counters["global_test_step"]

    train_step, eval_step = make_train_step(
        cfg, group=None if groups is None else groups.data)
    checked = False
    writer = MetricWriter(log_event_path or
                          os.path.join(checkpoint_dir, "log"), enabled=primary)
    max_steps = max_steps_override or cfg.max_train_steps

    try:
        while global_step < max_steps and global_epoch < cfg.nepochs:
            for phase, loader in loaders.items():
                train = phase == "train_no_dev"
                # per-phase artifact dirs (reference: train.py:809)
                eval_dir = os.path.join(checkpoint_dir, "intermediate",
                                        f"{phase}_eval")
                running, n_batches = 0.0, 0
                # dev-phase generation once per epoch every
                # test_eval_epoch_interval epochs (reference: train.py:816-821)
                test_evaluated = False
                # the host copy of the batch in hand, for sanity checks and
                # eval artifacts
                host_batches = deque()

                def put(b):
                    host_batches.append(b)
                    return to_device(b, device, pin_memory=cfg.pin_memory)

                for batch in prefetch_to_device(loader, put=put,
                                                device=device):
                    host = host_batches.popleft()
                    if not checked:
                        sanity_check(spec, host)
                        checked = True
                    if train:
                        t0 = time.time()
                        metrics = train_step(state, batch, step_generator(
                            cfg, 0, global_step, "cpu"))
                        global_step += 1
                        # fetching the loss synchronises with the card: log
                        # on an interval and let other steps run ahead
                        if global_step % log_interval == 0 or global_step == 1:
                            loss = float(metrics["loss"])
                            writer.scalar("train/loss", loss, global_step)
                            writer.scalar("train/grad_norm",
                                          float(metrics["grad_norm"]),
                                          global_step)
                            writer.scalar("train/lr", float(metrics["lr"]),
                                          global_step)
                            writer.scalar("train/step_time_s",
                                          time.time() - t0, global_step)
                        else:
                            loss = None
                        if global_step % cfg.checkpoint_interval == 0:
                            # every rank: a cut state is gathered first
                            ckpt_lib.save_checkpoint(
                                checkpoint_dir, state,
                                global_step=global_step,
                                global_epoch=global_epoch,
                                global_test_step=global_test_step,
                                save_optimizer_state=cfg.save_optimizer_state)
                        if global_step % cfg.train_eval_interval == 0:
                            whole = gather_train_state(state)
                            if primary:
                                save_eval_audio(
                                    whole, cfg, host, eval_dir, global_step,
                                    step_generator(cfg, 1, global_step,
                                                   device), device)
                                save_states(whole, cfg, host, eval_dir,
                                            global_step,
                                            step_generator(cfg, 2,
                                                           global_step,
                                                           device))
                        if global_step >= max_steps:
                            break
                    else:
                        loss = float(eval_step(state, batch)["loss"])
                        global_test_step += 1
                        writer.scalar("dev/loss", loss, global_test_step)
                        if (not test_evaluated
                                and global_epoch % cfg.test_eval_epoch_interval
                                == 0):
                            # file names use the train step (reference:
                            # train.py:753-756)
                            test_evaluated = True
                            whole = gather_train_state(state)
                            if primary:
                                save_eval_audio(
                                    whole, cfg, host, eval_dir, global_step,
                                    step_generator(cfg, 3, global_step,
                                                   device), device)
                    if loss is not None:
                        running += loss
                        n_batches += 1
                if n_batches:
                    avg = running / n_batches
                    writer.scalar(f"{phase}/epoch_loss", avg, global_epoch)
                    print(f"[epoch {global_epoch}] {phase} avg loss: {avg:.4f} "
                          f"(step {global_step})")
                if global_step >= max_steps:
                    break
            global_epoch += 1
    except KeyboardInterrupt:
        print("Interrupted — saving final checkpoint "
              "(reference: train.py:1101-1110)")
    finally:
        ckpt_lib.save_checkpoint(
            checkpoint_dir, state, global_step=global_step,
            global_epoch=global_epoch, global_test_step=global_test_step,
            save_optimizer_state=cfg.save_optimizer_state)
        writer.close()
    return state
