"""Device meshes for the port: utterance sharding and per-device replicas
(replaces torch DataParallel, reference: train.py:676-689).

The port's counterpart of ``wavenet_vocoder_tpu/parallel/sharding.py``
(lines 29-82 there). A JAX mesh places arrays; here a :class:`Mesh` is a
small record, axis names and an array of ``torch.device``, and the
functions below split a batch over its ``data`` axis or copy a module or
state onto each of its devices:

  * batched synthesis: independent utterances split over the devices along
    the batch axis (``ops.cuda_generate.FusedGenerator(mesh=)``), no
    communication between them;
  * data-parallel training runs one process per device
    (``parallel.distributed``), not over a mesh in one process.

Tensor parallelism over the gate channels (the JAX module's
``wavenet_param_shardings`` / ``shard_params_tp``) is not ported: it needs
column- and row-parallel products with collectives of their own, so a mesh
with a ``model`` axis above 1 raises.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_TP_MISSING = ("tensor parallelism over a 'model' axis is not ported to the "
               "PyTorch port (wavenet_param_shardings / shard_params_tp of "
               "the JAX package's parallel/sharding.py); use 'model': 1")


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
    """Build a Mesh from an axis spec like {"data": -1} or {"data": 4};
    -1 fills with the remaining devices. ``devices`` defaults to the local
    GPUs. A device listed twice raises, as in JAX."""
    axes = dict(axes or {"data": -1})
    if axes.get("model", 1) not in (1, -1):
        raise NotImplementedError(_TP_MISSING)
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
    if axes.get("model", 1) == -1 and sizes[list(axes).index("model")] > 1:
        raise NotImplementedError(_TP_MISSING)
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
