"""Device meshes for the port: utterance sharding, per-device replicas and
gate-channel tensor parallelism (replaces torch DataParallel, reference:
train.py:676-689).

The port's counterpart of ``wavenet_vocoder_tpu/parallel/sharding.py``. A
JAX mesh places arrays; here a :class:`Mesh` is a small record, axis names
and an array of ``torch.device``, and the functions below split a batch
over its ``data`` axis or copy a module or state onto each of its devices:

  * batched synthesis: independent utterances split over the devices along
    the batch axis (``ops.cuda_generate.FusedGenerator(mesh=)``), no
    communication between them;
  * training runs one process per device (``parallel.distributed``), not
    over a mesh in one process.

Tensor parallelism over the gate channels runs over processes too: a
(data, model) mesh of ranks (``distributed.parallel_groups``), and
``shard_params_tp`` / ``shard_train_state`` cut each rank's slice of the
residual blocks by the JAX module's rules (``wavenet_param_shardings``):
the dilated conv and the conditioning 1x1s column-parallel over the gate
channels (in GLU pairs), out and skip row-parallel over G/2 with their g
kept whole, everything else replicated. The blocks then compute with
collectives over the model group (``models/layers.py``), which equals
replicated execution, in the batch forward and in the decoders' steps
alike (``ops.cuda_generate.pack_weights`` gathers whole weights), so a cut
model synthesises what the whole one does. ``gather_train_state`` puts the
slices back together (for checkpoints, which both packages read).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.models.layers import (
    COLUMN,
    ROW,
    all_gather_slices,
    shard_slice,
)
from wavenet_vocoder_tpu_torch.training.optimizers import state_partition_dim

# the parameter axis each cut runs along
PARTITION_DIM = {COLUMN: 0, ROW: 1}


@dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and a device array of shape (axis sizes). Built by
    :func:`make_mesh`, or directly where a check lists one device twice
    (two shards on one card, or on the CPU)."""
    axis_names: Tuple[str, ...]
    devices: np.ndarray

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str = "data") -> List[torch.device]:
        """The devices along ``axis``, in order. Every other axis must be
        of size 1 (a shard is not replicated within the mesh here)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh {self.shape} has no {axis!r} axis")
        others = {a: n for a, n in self.shape.items() if a != axis and n != 1}
        if others:
            raise ValueError(f"mesh axes {others} besides {axis!r}: a shard "
                             "is held by one device in the port")
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0).reshape(-1))


def _key(d: torch.device):
    return (d.type, d.index)


def local_devices() -> List[torch.device]:
    """This process's GPUs; raises without one (pass devices= to mesh
    anything else)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices= to make_mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Build a Mesh from an axis spec like {"data": -1} or {"data": 4,
    "model": 2}; -1 fills with the remaining devices. ``devices`` defaults
    to the local GPUs. A device listed twice raises, as in JAX."""
    axes = dict(axes or {"data": -1})
    devices = [torch.device(d) for d in
               (devices if devices is not None else local_devices())]
    if len({_key(d) for d in devices}) != len(devices):
        raise ValueError(f"devices listed more than once: {devices}")
    n = len(devices)
    sizes = list(axes.values())
    n_fill = sizes.count(-1)
    if n_fill > 1:
        raise ValueError("at most one -1 axis")
    fixed = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if n_fill:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by {fixed}")
        sizes = [s if s != -1 else n // fixed for s in sizes]
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(tuple(axes.keys()), arr.reshape(sizes))


def data_parallel_batch_size(cfg_batch_size: int, mesh: Mesh,
                             axis: str = "data") -> int:
    """Round the global batch up to a multiple of the data axis (the
    reference hard-errors on batch_size % num_gpu != 0, README.md:176)."""
    n = mesh.shape[axis]
    return ((cfg_batch_size + n - 1) // n) * n


def _split(x, n: int, i: int, device):
    if x is None:
        return None
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if t.dim() == 0:
        return t.to(device)
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} not divisible by the data axis "
                         f"({n})")
    m = t.shape[0] // n
    return t[i * m:(i + 1) * m].to(device)


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data") -> List[Any]:
    """Split every array's leading (batch) dim over the mesh's ``axis``:
    one batch per device along it, each on its device. 0-d leaves are
    copied to every device; None passes through. ``batch`` is an array or
    a dict of them."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if isinstance(batch, dict):
        return [{k: _split(v, n, i, d) for k, v in batch.items()}
                for i, d in enumerate(devs)]
    return [_split(batch, n, i, d) for i, d in enumerate(devs)]


def _copy_to(obj: Any, device: torch.device) -> Any:
    if obj is None:
        return None
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device)
    if torch.is_tensor(obj):
        return obj.detach().clone().to(device)
    if isinstance(obj, dict):
        return {k: _copy_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_copy_to(v, device) for v in obj)
    return obj


def replicate(obj: Any, mesh: Mesh) -> List[Any]:
    """One copy of a module, tensor or dict/list of them on each device of
    the mesh (flattened in mesh order)."""
    return [_copy_to(obj, d) for d in mesh.devices.reshape(-1)]


def shard_state(state, mesh: Mesh) -> list:
    """One copy of a ``TrainState`` on each device of the mesh: the model,
    the optimizer (its state loaded into a new optimizer over the copy's
    parameters), the EMA shadow and the step count."""
    from wavenet_vocoder_tpu_torch.training.train_state import TrainState
    out = []
    for d in mesh.devices.reshape(-1):
        model = _copy_to(state.model, d)
        opt = type(state.optimizer)(model.parameters(),
                                    **state.optimizer.defaults)
        opt.load_state_dict(state.optimizer.state_dict())
        out.append(TrainState(model, opt, state.schedule,
                              _copy_to(state.ema, d), state.step))
    return out


# ----------------------------------------------------------------------
# tensor parallelism over the gate channels
# ----------------------------------------------------------------------
def wavenet_param_shardings(model) -> Dict[str, Optional[str]]:
    """The Megatron rules of the JAX module, by parameter name: COLUMN for
    every parameter of a block's ``conv``, ``conv1x1c`` and ``conv1x1g``
    (gate channels in GLU pairs), ROW for ``conv1x1_out`` and
    ``conv1x1_skip``'s ``weight_v`` (their input, G/2), None (replicated)
    for their ``weight_g`` and ``bias`` and everything outside the
    blocks."""
    rules = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        kind = None
        if parts[0] == "conv_layers":
            if parts[2] in ("conv", "conv1x1c", "conv1x1g"):
                kind = COLUMN
            elif parts[3] == "weight_v":
                kind = ROW
        rules[name] = kind
    return rules


def _check_cut(model, size: int) -> None:
    G2 = model.spec.gate_channels // 2
    if G2 % size:
        raise ValueError(f"a model axis of {size} does not divide the "
                         f"{G2} channels of a GLU half")
    if any("weight_v" not in m._parameters
           for blk in model.conv_layers for m in blk.children()):
        raise ValueError("tensor parallelism cuts weight-normed "
                         "convolutions; this model's weights are folded")


def shard_params_tp(model, groups):
    """Cut the model's residual blocks to this rank's slices (in place,
    keeping each parameter object) and point their convolutions at the
    model group. A model axis of 1 leaves the model whole."""
    if groups.model is None:
        return model
    _check_cut(model, groups.model_size)
    rules = wavenet_param_shardings(model)
    named = dict(model.named_parameters())
    with torch.no_grad():
        for name, kind in rules.items():
            if kind is not None:
                p = named[name]
                p.data = shard_slice(p.data, kind, groups.model_rank,
                                     groups.model_size).clone()
    for name, m in model.named_modules():
        kind = rules.get(name + ".weight_v")
        if kind is not None:
            m.tp = (kind, groups.model)
    return model


def _opt_names(state) -> List[str]:
    """The model's parameter names in the optimizer's order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups
            for p in g["params"]]


def shard_train_state(state, groups):
    """Cut a whole ``TrainState`` to this rank's slices, in place: the
    model (``shard_params_tp``), the optimizer's state of every cut
    parameter (moments sliced as their parameter; Adafactor's statistic
    averaged over the cut axis kept whole) and the EMA shadow. The
    optimizer then sums whole-tensor statistics over the model group
    (``training/optimizers.py``), and ``train_step`` the clip's norm. Every
    rank must hold the same whole state first (``replicate_global``)."""
    state.parallel = groups
    if groups.model is None:
        return state
    model, opt = state.model, state.optimizer
    _check_cut(model, groups.model_size)
    rules = wavenet_param_shardings(model)
    named = dict(model.named_parameters())
    cut = lambda t, kind: shard_slice(t, kind, groups.model_rank,
                                      groups.model_size).clone()
    for name, kind in rules.items():
        if kind is None:
            continue
        p = named[name]
        st = opt.state.get(p, {})
        for k, v in st.items():
            if (torch.is_tensor(v) and state_partition_dim(
                    v, p.shape, PARTITION_DIM[kind]) is not None):
                st[k] = cut(v, kind)
        if state.ema is not None:
            state.ema[name] = cut(state.ema[name], kind)
    shard_params_tp(model, groups)
    it = iter(_opt_names(state))
    for g in opt.param_groups:
        g["partition_dim"] = [PARTITION_DIM.get(rules[next(it)])
                              for _ in g["params"]]
    opt.model_group = groups.model
    return state


def gather_train_state(state):
    """The whole ``TrainState`` of a tensor-parallel one (a collective: every
    rank of the model group calls it): a new model, optimizer and EMA
    shadow on the same device, equal to what one process training the
    whole model holds; the state itself when it is not cut."""
    from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet
    from wavenet_vocoder_tpu_torch.training.train_state import TrainState
    groups = getattr(state, "parallel", None)
    if groups is None or groups.model is None:
        return state
    model, opt = state.model, state.optimizer
    rules = wavenet_param_shardings(model)
    whole = lambda t, kind: all_gather_slices(t.detach(), kind, groups.model)
    device = next(model.parameters()).device
    full = WaveNet(model.spec).to(device)
    with torch.no_grad():
        full.load_state_dict({
            n: t if rules.get(n) is None else whole(t, rules[n])
            for n, t in model.state_dict().items()})
    sd = opt.state_dict()
    # state_dict() hands out the optimizer's own per-parameter dicts
    sd["state"] = {i: dict(st) for i, st in sd["state"].items()}
    names = _opt_names(state)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    for i, st in sd["state"].items():
        kind = rules[names[i]]
        if kind is None:
            continue
        for k, v in st.items():
            if (torch.is_tensor(v) and state_partition_dim(
                    v, shapes[names[i]], PARTITION_DIM[kind]) is not None):
                st[k] = whole(v, kind)
    for g in sd["param_groups"]:
        g.pop("partition_dim", None)
    # the hyperparameters come back with the state dict's param groups
    full_opt = type(opt)(full.parameters(), lr=opt.defaults["lr"])
    full_opt.load_state_dict(sd)
    ema = None
    if state.ema is not None:
        ema = {n: v if rules[n] is None else whole(v, rules[n])
               for n, v in state.ema.items()}
    return TrainState(full, full_opt, state.schedule, ema, state.step)
