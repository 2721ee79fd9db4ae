"""Checkpoint / resume (reference: train.py:852-970).

The port's counterpart of ``wavenet_vocoder_tpu/training/checkpoint.py``,
with the same file names and the same format, so the two packages read
each other's checkpoints:

  * ``checkpoint_step%09d[_ema].npz`` and ``checkpoint_latest[_ema].npz``;
  * format ``wavenet-tpu-ckpt`` v1: flat numpy arrays ``param_i`` /
    ``opt_i`` plus a JSON manifest embedded as a uint8 array. Loading never
    runs pickled code;
  * writes are atomic (tmp + ``os.replace``), so a crash mid-save cannot
    corrupt an existing checkpoint, and readers fall back from a corrupted
    ``checkpoint_latest`` to the newest intact step file.

What is written is what the JAX package writes: ``param_paths`` are the
JAX params tree's ``jax.tree_util.keystr`` paths
(``['blocks'][0]['conv']['v']``), ``param_i`` its leaves in JAX's order
and axes (``compat/to_jax.py``), and ``opt_i`` optax's state leaves
(``jax.tree.leaves(opt_state)``) for the optimizer ``make_optimizer``
built, with ``has_opt``/``n_opt`` as JAX sets them. The optimizer's state
maps one to one where its update is optax's (``_optax_layout``): torch's
Adam and AdamW (``step``, ``exp_avg``, ``exp_avg_sq`` as optax's
``ScaleByAdamState(count, mu, nu)`` and the schedule's count), SGD
(``momentum_buffer`` as ``trace``), Adadelta (``square_avg``,
``acc_delta`` as ``e_g``, ``e_x``), and the port's Adamax, NAdam, RAdam,
Lamb, RMSprop and Adagrad. Adafactor's state does not map: its file holds
no optax state (``has_opt`` false, so JAX starts it afresh) and keeps the
port's own under ``opt_keys`` ([parameter index, state name]) and
``port_opt_i``, so a port run resumes it exactly.

The loader reads three kinds of file, told apart by their paths: the
JAX package's and the port's (keystr paths; the rebuilt tree goes through
``compat/from_jax.py:state_dict_from_jax`` and optax's leaves into the
optimizer), and the port's files written before it wrote the JAX layout
(``state_dict()`` names in ``param_paths``, its own optimizer state in
``opt_i`` under ``opt_keys``). Where optax's state cannot go into the
optimizer (Adafactor, or a file of another optimizer), the optimizer starts
fresh and a NOTE names it. Legacy pickle checkpoints of the JAX package
hold pickled JAX arrays; the port refuses them.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
from wavenet_vocoder_tpu_torch.compat.to_jax import (
    from_jax_array, jax_order, to_jax)
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
from wavenet_vocoder_tpu_torch.parallel.distributed import is_primary
from wavenet_vocoder_tpu_torch.parallel.sharding import gather_train_state
from wavenet_vocoder_tpu_torch.training import optimizers

_FORMAT = "wavenet-tpu-ckpt"
_VERSION = 1
_COUNTERS = ("global_step", "global_epoch", "global_test_step")


def checkpoint_path(directory: str, step: int, ema: bool = False) -> str:
    """(reference: train.py:856-860 naming)."""
    suffix = "_ema" if ema else ""
    return os.path.join(directory, f"checkpoint_step{step:09d}{suffix}.npz")


def latest_path(directory: str, ema: bool = False) -> str:
    suffix = "_ema" if ema else ""
    return os.path.join(directory, f"checkpoint_latest{suffix}.npz")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _flatten_optimizer(optimizer: torch.optim.Optimizer
                       ) -> Tuple[List[List[Any]], List[np.ndarray]]:
    """([[parameter index, state name], ...], arrays) of the optimizer's
    per-parameter state (moments, step counts)."""
    keys, arrays = [], []
    for idx, st in sorted(optimizer.state_dict()["state"].items()):
        for name, value in sorted(st.items()):
            if value is not None:
                keys.append([int(idx), name])
                arrays.append(_np(value))
    return keys, arrays


def _optax_layout(optimizer: torch.optim.Optimizer) -> Optional[List[str]]:
    """optax's state leaves for the chain the JAX package builds for this
    optimizer (``train_state.py:_make_core_optimizer``), in
    ``jax.tree.leaves`` order: "count" (the number of updates: the
    transform's and the schedule's), or the name of the port's
    per-parameter state that fills a tree shaped like the params. None
    where the two states are not one to one."""
    group = optimizer.param_groups[0]
    if isinstance(optimizer, torch.optim.Adam):       # AdamW too
        return ["count", "exp_avg", "exp_avg_sq", "count"]
    if isinstance(optimizer, (optimizers.Adamax, optimizers.NAdam,
                              optimizers.RAdam, optimizers.Lamb)):
        return ["count", "mu", "nu", "count"]
    if isinstance(optimizer, torch.optim.SGD):
        return (["momentum_buffer"] if group["momentum"] else []) + ["count"]
    if isinstance(optimizer, optimizers.RMSprop):
        return ((["mu"] if group["centered"] else []) + ["nu", "count"]
                + (["trace"] if group["momentum"] is not None else []))
    if isinstance(optimizer, optimizers.Adagrad):
        return ["sum_of_squares", "count"]
    if isinstance(optimizer, torch.optim.Adadelta):
        return ["square_avg", "acc_delta", "count"]
    return None


def _fresh_value(group, name: str) -> float:
    """What optax initialises a state of ``name`` to."""
    return {"sum_of_squares": group.get("initial_accumulator_value", 0.0),
            "nu": group.get("initial_scale", 0.0)}.get(name, 0.0)


def _named_params(state) -> List[Tuple[str, torch.Tensor, dict]]:
    """(name, parameter, its param group) in the optimizer's order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [(names[id(p)], p, g) for g in state.optimizer.param_groups
            for p in g["params"]]


def _optax_leaves(state) -> Optional[List[np.ndarray]]:
    """The optimizer's state as optax's leaves (``jax.tree.leaves`` of the
    JAX package's ``opt_state``), or None where it does not map."""
    opt = state.optimizer
    layout = _optax_layout(opt)
    if layout is None:
        return None
    named = _named_params(state)
    steps = [opt.state[p]["step"] for _, p, _ in named
             if "step" in opt.state.get(p, {})]
    count = np.asarray(int(steps[0]) if steps else int(state.step), np.int32)
    leaves: List[np.ndarray] = []
    for kind in layout:
        if kind == "count":
            leaves.append(count)
            continue
        tree = {}
        for n, p, g in named:
            v = opt.state.get(p, {}).get(kind)
            tree[n] = (_np(v) if v is not None else
                       np.full(p.shape, _fresh_value(g, kind), np.float32))
        leaves += [a for _, a in to_jax(tree)]
    return leaves


def _write_npz_atomic(path: str, params: Dict[str, torch.Tensor],
                      opt, counters: Dict[str, int]) -> None:
    """``opt``: None, or (optax leaves or None, port keys, port arrays)."""
    leaves = to_jax({n: _np(t) for n, t in params.items()})
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {
        "format": _FORMAT, "version": _VERSION,
        "param_paths": [k for k, _ in leaves],
        "has_opt": opt is not None and opt[0] is not None,
        **counters,
    }
    for i, (_, leaf) in enumerate(leaves):
        arrays[f"param_{i}"] = leaf
    if manifest["has_opt"]:
        manifest["n_opt"] = len(opt[0])
        for i, leaf in enumerate(opt[0]):
            arrays[f"opt_{i}"] = leaf
    elif opt is not None:
        # optax's state is not the optimizer's: keep the port's own
        manifest["opt_keys"] = opt[1]
        for i, leaf in enumerate(opt[2]):
            arrays[f"port_opt_{i}"] = leaf
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class _Payload:
    """What a checkpoint file holds, as numpy arrays."""

    def __init__(self, params_flat, param_paths, opt_flat, opt_keys,
                 port_opt_flat, counters):
        self.params_flat = params_flat          # list of np arrays
        self.param_paths = param_paths          # keystr or state_dict names
        self.opt_flat = opt_flat                # list of np arrays or None
        self.opt_keys = opt_keys                # [[index, name]] or None
        self.port_opt_flat = port_opt_flat      # under opt_keys, or None
        self.counters = counters                # dict of ints

    @property
    def keystr_paths(self) -> bool:
        """The JAX layout (written by either package): keystr paths, and
        ``opt_i`` holds optax's leaves. Otherwise a port file from before
        the port wrote it: ``state_dict()`` names, its own ``opt_i``."""
        return bool(self.param_paths) and all(
            p.startswith("[") for p in self.param_paths)


def _read_payload(path: str) -> _Payload:
    """Parse a checkpoint file. Raises on any corruption — callers decide
    whether to fall back."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:2] != b"PK":  # not a zip, so not an npz
        raise ValueError(
            f"{path}: not an npz checkpoint. The JAX package's legacy pickle "
            "checkpoints hold pickled JAX arrays and are not read by the "
            "PyTorch port; load and re-save them with the JAX package")
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"].tobytes()).decode())
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"{path}: unrecognized checkpoint manifest")
        paths = manifest["param_paths"]
        params_flat = [z[f"param_{i}"] for i in range(len(paths))]
        opt_flat = None
        if manifest.get("has_opt"):
            opt_flat = [z[f"opt_{i}"] for i in range(manifest["n_opt"])]
        keys = manifest.get("opt_keys")
        port_opt = None
        if keys is not None and "port_opt_0" in z.files:
            port_opt = [z[f"port_opt_{i}"] for i in range(len(keys))]
        counters = {k: int(manifest.get(k, 0)) for k in _COUNTERS}
        return _Payload(params_flat, paths, opt_flat, keys, port_opt,
                        counters)


def _ema_state_dict(state) -> Dict[str, torch.Tensor]:
    """The model's state dict with the EMA shadow in place of the parameters."""
    sd = dict(state.model.state_dict())
    sd.update(state.ema)
    return sd


def save_checkpoint(directory: str, state, *, global_step: int,
                    global_epoch: int = 0, global_test_step: int = 0,
                    save_optimizer_state: bool = True) -> str:
    """Write step-stamped + latest checkpoints of a ``TrainState``, and the
    EMA twin stream when it has an EMA shadow (reference: train.py:852-884).
    Every file is written atomically; an interrupt mid-save leaves prior
    checkpoints intact. Under data parallelism only the primary process
    writes (every rank holds the same state); the others return the path
    the primary writes. A state cut by tensor parallelism is gathered
    first (every rank of its model group must call this), so the files
    hold the whole model, optimizer state and EMA, as one process writes
    them."""
    state = gather_train_state(state)
    if not is_primary():
        return checkpoint_path(directory, global_step)
    os.makedirs(directory, exist_ok=True)
    counters = {"global_step": int(global_step),
                "global_epoch": int(global_epoch),
                "global_test_step": int(global_test_step)}
    opt = None
    if save_optimizer_state:
        leaves = _optax_leaves(state)
        opt = (leaves,) + (([], []) if leaves is not None
                           else _flatten_optimizer(state.optimizer))
    params = state.model.state_dict()
    path = checkpoint_path(directory, global_step)
    _write_npz_atomic(path, params, opt, counters)
    _write_npz_atomic(latest_path(directory), params, opt, counters)

    if state.ema is not None:
        # EMA checkpoint stores averaged weights as the model params
        # (reference: train.py:871-884 clone_as_averaged_model)
        ema = _ema_state_dict(state)
        _write_npz_atomic(checkpoint_path(directory, global_step, ema=True),
                          ema, opt, counters)
        _write_npz_atomic(latest_path(directory, ema=True), ema, opt,
                          counters)
    return path


_STEP_RE = re.compile(r"checkpoint_step(\d+)(_ema)?\.npz$")


def _step_files(directory: str, ema: bool) -> List[Tuple[int, str]]:
    out = []
    for p in glob.glob(os.path.join(directory, "checkpoint_step*")):
        m = _STEP_RE.search(os.path.basename(p))
        if m and bool(m.group(2)) == ema:
            out.append((int(m.group(1)), p))
    return sorted(out, reverse=True)


def _read_with_fallback(path: str) -> Tuple[_Payload, str]:
    """Read ``path``; if it is a corrupted ``checkpoint_latest`` file, fall
    back to the newest intact step checkpoint in the same directory."""
    try:
        return _read_payload(path), path
    except Exception as e:  # noqa: BLE001 — any parse failure triggers fallback
        base = os.path.basename(path)
        if not base.startswith("checkpoint_latest"):
            raise
        ema = "_ema" in base
        for _, cand in _step_files(os.path.dirname(path) or ".", ema):
            try:
                payload = _read_payload(cand)
            except Exception:  # noqa: BLE001
                continue
            print(f"WARNING: {path} is unreadable ({e!r}); "
                  f"falling back to {cand}")
            return payload, cand
        raise


_TOKEN_RE = re.compile(r"\[('[^']*'|\d+)\]")


def params_tree(payload: _Payload):
    """Rebuild a JAX-written checkpoint's params pytree (nested dicts /
    lists of numpy arrays) from the flat leaves + keystr paths — the
    structure as saved, independent of any model config."""
    root: Dict[Any, Any] = {}
    for key, leaf in zip(payload.param_paths, payload.params_flat):
        tokens = [t[1:-1] if t.startswith("'") else int(t)
                  for t in _TOKEN_RE.findall(key)]
        if not tokens:
            raise ValueError(f"unparseable param path {key!r}")
        node = root
        for tok in tokens[:-1]:
            node = node.setdefault(tok, {})
        node[tokens[-1]] = leaf

    def finalize(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [finalize(node[i]) for i in range(len(node))]
        return {k: finalize(v) for k, v in node.items()}

    return finalize(root)


def _state_dict(payload: _Payload, spec: WaveNetSpec
                ) -> Dict[str, torch.Tensor]:
    """The payload's params under the port's names and layouts."""
    if payload.keystr_paths:
        return state_dict_from_jax(params_tree(payload), spec)
    return {k: torch.from_numpy(np.asarray(v))
            for k, v in zip(payload.param_paths, payload.params_flat)}


def _load_into(model: WaveNet, sd: Dict[str, torch.Tensor]) -> None:
    """Copy ``sd`` into the model. Entries the model has no use for are
    ignored (a model built with fewer conditioning inputs leaves them);
    a tensor the model needs and the checkpoint lacks raises."""
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise ValueError(
            f"checkpoint has {len(sd)} tensors; the model expects "
            f"{len(own)} and misses {missing[:4]} — wrong architecture or "
            "preset?")
    model.load_state_dict({k: sd[k] for k in own})


def load_params(path: str, spec: WaveNetSpec
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Read just the model weights and the counters from a checkpoint — the
    inference-side loader of the synthesis/evaluate CLIs. Reads the port's
    checkpoints and the JAX package's npz checkpoints. Returns (state dict
    of CPU tensors for ``WaveNet(spec)``, counters)."""
    payload, _ = _read_with_fallback(path)
    return _state_dict(payload, spec), payload.counters


def load_model(path: str, spec: WaveNetSpec) -> Tuple[WaveNet, Dict[str, int]]:
    """``WaveNet(spec)`` on the CPU with a checkpoint's weights, and the
    checkpoint's counters."""
    if not spec.has_local_conditioning:
        # e.g. a ``cin_channels=-1`` override for unconditional synthesis:
        # there is nothing to upsample, so no upsample net is built
        spec = dataclasses.replace(spec, upsample_conditional_features=False)
    sd, counters = load_params(path, spec)
    model = WaveNet(spec)
    _load_into(model, sd)
    return model, counters


def _ema_twin(path: str) -> Optional[str]:
    base, ext = os.path.splitext(path)
    if base.endswith("_ema"):
        return None
    return base + "_ema" + ext


def _restore_optimizer(optimizer: torch.optim.Optimizer, opt_keys,
                       arrays) -> None:
    """The port's own optimizer state ([[index, name]] and arrays)."""
    own = optimizer.state_dict()
    st: Dict[int, Dict[str, torch.Tensor]] = {}
    for (idx, name), arr in zip(opt_keys, arrays):
        st.setdefault(int(idx), {})[name] = torch.from_numpy(np.asarray(arr))
    n_params = sum(len(g["params"]) for g in own["param_groups"])
    if any(idx >= n_params for idx in st):
        raise ValueError("checkpoint's optimizer state names more parameters "
                         f"than the optimizer has ({n_params})")
    optimizer.load_state_dict({"state": st,
                               "param_groups": own["param_groups"]})


def _restore_optax(state, leaves: List[np.ndarray], path: str) -> None:
    """optax's state leaves into the optimizer, through ``_optax_layout``
    and the params' JAX layout; a NOTE and a fresh optimizer where they
    do not fit it."""
    opt = state.optimizer
    layout = _optax_layout(opt)
    named = _named_params(state)
    n_trees = 0 if layout is None else len(layout) - layout.count("count")
    want = None if layout is None else (len(layout) - n_trees
                                        + n_trees * len(named))
    if want != len(leaves):
        print(f"NOTE: {path} holds {len(leaves)} optax state leaves; the "
              f"{type(opt).__name__} optimizer's state "
              + ("does not map to optax's" if layout is None else
                 f"maps to {want} (another optimizer wrote it)")
              + ", so the optimizer starts fresh (as with "
              "reset_optimizer=True)")
        return
    order = jax_order([n for n, _, _ in named])
    by_name = {n: p for n, p, _ in named}
    index = {id(p): i for i, (_, p, _) in enumerate(named)}
    count, it = None, iter(leaves)
    st: Dict[int, Dict[str, torch.Tensor]] = {}
    for kind in layout:
        if kind == "count":
            c = int(next(it))
            count = c if count is None else count
            continue
        for n, _ in order:
            p = by_name[n]
            a = from_jax_array(n, next(it), p.shape)
            st.setdefault(index[id(p)], {})[kind] = torch.from_numpy(
                a.astype(np.float32))
    if not isinstance(opt, torch.optim.SGD):       # SGD counts no steps
        for i in range(len(named)):
            st.setdefault(i, {})["step"] = torch.tensor(float(count))
    own = opt.state_dict()
    opt.load_state_dict({"state": st, "param_groups": own["param_groups"]})


def load_checkpoint(path: str, state, *, reset_optimizer: bool = False
                    ) -> Tuple[Any, Dict[str, int]]:
    """Restore params (+optimizer unless reset) + counters into ``state``,
    in place (reference: train.py:930-947). Returns (state, counters)."""
    payload, path = _read_with_fallback(path)
    model = state.model
    _load_into(model, _state_dict(payload, model.spec))
    if not reset_optimizer:
        if payload.keystr_paths and payload.opt_flat is not None:
            _restore_optax(state, payload.opt_flat, path)
        elif payload.keystr_paths and payload.port_opt_flat is not None:
            _restore_optimizer(state.optimizer, payload.opt_keys,
                               payload.port_opt_flat)
        elif payload.opt_flat is not None:
            _restore_optimizer(state.optimizer, payload.opt_keys,
                               payload.opt_flat)
    if state.ema is not None:
        # resume EMA from the twin file if present, else re-seed from params
        ema_file = _ema_twin(path)
        named = dict(model.named_parameters())
        src = named
        if ema_file and os.path.exists(ema_file):
            src = _state_dict(_read_payload(ema_file), model.spec)
        with torch.no_grad():
            for name, p in named.items():
                state.ema[name] = src[name].detach().to(
                    device=p.device, dtype=p.dtype).clone()
    state.step = payload.counters["global_step"]
    return state, payload.counters


def restore_parts(path: str, model: WaveNet) -> int:
    """Partial / fine-tune restore, in place: copy every tensor whose name
    and shape match; keep the fresh init elsewhere (reference:
    train.py:951-970). Returns the number of tensors restored."""
    payload, _ = _read_with_fallback(path)
    src = _state_dict(payload, model.spec)
    n_restored = 0
    with torch.no_grad():
        for name, leaf in model.state_dict().items():
            cand = src.get(name)
            if cand is not None and cand.shape == leaf.shape:
                leaf.copy_(cand)
                n_restored += 1
    print(f"restore_parts: restored {n_restored} tensors from {path}")
    return n_restored
