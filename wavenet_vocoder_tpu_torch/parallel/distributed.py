"""Multi-process bring-up: one process per device, joined by
``torch.distributed``.

The port's counterpart of ``wavenet_vocoder_tpu/parallel/distributed.py``.
The JAX package joins its processes with ``jax.distributed`` and spans one
mesh over every device, so a jitted step runs SPMD and XLA inserts the
gradient reduction. The port runs one process per device instead, joined by
a ``torch.distributed`` process group (NCCL between GPUs, gloo on the CPU):

  * each process loads its slice of the corpus (``WaveNetDataset.shard``)
    and feeds its local batch rows, ``local_batch_size`` of the global batch;
    its rows are [``batch_row_offset``, + local batch) of the global batch,
    the offset that keys its dropout masks;
  * the train step all-reduces the gradients and the losses' mask counts
    (``training.train_state.make_train_step(group=)``), which is what
    ``global_batch_from_local`` and XLA's reduction give the JAX step;
  * ``replicate_global`` broadcasts a state from rank 0, the counterpart of
    ``multihost_utils.broadcast_one_to_all``;
  * a mesh with a ``model`` axis (``parallel_groups``) lays the ranks out
    as the JAX mesh lays out its devices, (data, model) in row-major order,
    and joins one process group per data row (the model group: the ranks
    that share a data shard and cut the gate channels between them) and
    one per model column (the data group: the ranks that hold the same
    slices and sum their gradients).

Tested with 2 processes on the CPU over gloo (tests/test_torch_distributed.py).
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 900.0   # a collective that waits longer than this fails

_device: Optional[torch.device] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[str] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S
                           ) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    Arguments left out are read from torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), as ``jax.distributed.initialize()`` detects its cluster.
    ``coordinator_address`` is "host:port" of rank 0. ``local_device_ids``
    names this process's GPU (one id: one process per device); without it
    the GPU is ``LOCAL_RANK`` (else the rank modulo the GPUs). On a machine
    with a GPU the process's current device is set to it.

    ``backend``: None picks NCCL where CUDA is available and gloo on the
    CPU. Two ranks on one GPU need "gloo" (NCCL refuses them). A collective
    that waits longer than ``timeout_s`` raises instead of hanging.
    """
    global _device
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    missing = [n for n, v in (("coordinator_address (MASTER_ADDR/MASTER_PORT)",
                               coordinator_address),
                              ("num_processes (WORLD_SIZE)", num_processes),
                              ("process_id (RANK)", process_id)) if v is None]
    if missing:
        raise ValueError("initialize_distributed: give " + ", ".join(missing)
                         + ", or run under torchrun")
    if ":" not in coordinator_address:
        raise ValueError(f"coordinator address {coordinator_address!r} is not "
                         "host:port")
    rank, world = int(process_id), int(num_processes)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl" and not cuda:
        raise RuntimeError("the NCCL backend needs a GPU; pass backend='gloo' "
                           "to join on the CPU")
    if cuda:
        if local_device_ids not in (None, ""):
            ids = [int(d) for d in str(local_device_ids).split(",")]
            if len(ids) != 1:
                raise ValueError(f"local_device_ids {local_device_ids!r}: the "
                                 "port runs one process per device, give one")
            local = ids[0]
        else:
            local = _env_int("LOCAL_RANK")
            if local is None:
                local = rank % torch.cuda.device_count()
        _device = torch.device("cuda", local)
        torch.cuda.set_device(_device)
    else:
        _device = torch.device("cpu")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


def add_cli_flags(p) -> None:
    """The CLIs' flags that join a process group (cli.train, cli.evaluate),
    those of the JAX package's CLIs plus ``--local-device-ids`` and
    ``--dist-backend``."""
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process cluster (torchrun's "
                        "environment, or the flags below)")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 (implies --distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--local-device-ids", default=None,
                   help="this process's GPU (default: LOCAL_RANK)")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="process-group backend (default: nccl with a GPU, "
                        "gloo without)")


def initialize_from_args(args) -> Tuple[int, int]:
    """Join the process group when any distributed flag is given; returns
    (rank, world), (0, 1) when none is."""
    if not (args.distributed or args.coordinator_address is not None
            or args.num_processes is not None or args.process_id is not None):
        return 0, 1
    rank, world = initialize_distributed(
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes, process_id=args.process_id,
        local_device_ids=args.local_device_ids, backend=args.dist_backend)
    print(f"distributed: process {rank}/{world}")
    return rank, world


def process_device() -> torch.device:
    """The device ``initialize_distributed`` gave this process."""
    if _device is None:
        raise RuntimeError("initialize_distributed has not run")
    return _device


def process_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the process that writes checkpoints, metrics and artifacts."""
    return process_info()[0] == 0


def local_batch_size(global_batch_size: int) -> int:
    """Batch rows per process (the reference hard-errors on
    batch % num_gpu != 0, README.md:176; the same constraint across
    processes)."""
    n = process_info()[1]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{n} processes")
    return global_batch_size // n


def batch_row_offset(local_batch: int, group=None) -> int:
    """The global row of this process's first local row: its rank in
    ``group`` (the default group when None) times the local batch; 0
    outside a process group. Together with the reductions of
    ``make_train_step(group=)`` this is the port's counterpart of
    ``global_batch_from_local``: the rows stay where they are and the step
    reduces over them."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group) * int(local_batch)


def replicate_global(state, counters: Optional[Dict[str, int]] = None,
                     src: int = 0) -> Dict[str, int]:
    """Broadcast a ``TrainState`` from rank ``src`` into every rank's state,
    in place: the model's parameters and buffers, the optimizer state, the
    EMA shadow and the step count, and the loop's ``counters`` (returned).
    Afterwards every rank holds bit-identical values, the precondition of
    the data-parallel step. A no-op outside a process group."""
    counters = dict(counters or {})
    if process_info()[1] == 1:
        return counters
    cpu = lambda sd: {k: v.detach().cpu() if torch.is_tensor(v) else v
                      for k, v in sd.items()}
    payload = [None]
    if dist.get_rank() == src:
        opt = state.optimizer.state_dict()
        opt["state"] = {i: cpu(s) for i, s in opt["state"].items()}
        payload[0] = dict(
            model=cpu(state.model.state_dict()), optimizer=opt,
            ema=None if state.ema is None else cpu(state.ema),
            step=int(state.step), counters=counters)
    dist.broadcast_object_list(payload, src=src)
    p = payload[0]
    state.model.load_state_dict(p["model"])
    state.optimizer.load_state_dict(p["optimizer"])
    if (state.ema is None) != (p["ema"] is None):
        raise ValueError("ranks disagree on whether the state has an EMA")
    if state.ema is not None:
        with torch.no_grad():
            for k, v in p["ema"].items():
                state.ema[k].copy_(v)
    state.step = p["step"]
    return p["counters"]



@dataclass(frozen=True)
class ParallelGroups:
    """This rank's place in a (data, model) mesh of processes: the data
    group (ranks holding the same model slices, over which gradients and
    mask counts are summed) and the model group (ranks holding the same
    batch rows, over which the gate channels are cut; None when the model
    axis is 1), with this rank's index and the size of each."""
    data: Any
    model: Any
    data_rank: int
    data_size: int
    model_rank: int
    model_size: int


def parallel_groups(model: int) -> ParallelGroups:
    """Join the process groups of a mesh of (world / model, model) ranks,
    rank = data index * model + model index (every rank must call this, in
    the same order). ``model`` 1 gives the world as the data group."""
    rank, world = process_info()
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide "
                         f"{world} processes")
    data = world // model
    if model == 1:
        group = dist.group.WORLD if dist.is_initialized() else None
        return ParallelGroups(group, None, rank, world, 0, 1)
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    d, m = divmod(rank, model)
    return ParallelGroups(data_groups[m], model_groups[d], d, data, m, model)
