"""Checkpoint / resume (reference: train.py:852-970).

The port's counterpart of ``wavenet_vocoder_tpu/training/checkpoint.py``,
with the same file names and the same format, so the two packages read each
other's weights:

  * ``checkpoint_step%09d[_ema].npz`` and ``checkpoint_latest[_ema].npz``;
  * format ``wavenet-tpu-ckpt`` v1: flat numpy arrays ``param_i`` /
    ``opt_i`` plus a JSON manifest embedded as a uint8 array. Loading never
    runs pickled code;
  * writes are atomic (tmp + ``os.replace``), so a crash mid-save cannot
    corrupt an existing checkpoint, and readers fall back from a corrupted
    ``checkpoint_latest`` to the newest intact step file.

The port writes its ``state_dict()`` names as ``param_paths``. A checkpoint
written by the JAX package carries ``jax.tree_util.keystr`` paths
(``['blocks'][0]['conv']['v']``); those are parsed here without JAX and the
rebuilt tree goes through ``compat/from_jax.py:state_dict_from_jax``.

Kept different on purpose: optimizer state is the port's own
(``torch.optim`` tensors; the manifest's ``opt_keys`` name them), so a JAX
checkpoint's optax state is not carried and ``load_checkpoint`` on one keeps
the fresh optimizer and says so. Legacy pickle checkpoints of the JAX
package hold pickled JAX arrays; the port refuses them.
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
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
from wavenet_vocoder_tpu_torch.parallel.distributed import is_primary
from wavenet_vocoder_tpu_torch.parallel.sharding import gather_train_state

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


def _write_npz_atomic(path: str, params: Dict[str, torch.Tensor],
                      optimizer: Optional[torch.optim.Optimizer],
                      counters: Dict[str, int]) -> None:
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {
        "format": _FORMAT, "version": _VERSION,
        "param_paths": list(params),
        "has_opt": optimizer is not None,
        **counters,
    }
    for i, leaf in enumerate(params.values()):
        arrays[f"param_{i}"] = _np(leaf)
    if optimizer is not None:
        keys, o_flat = _flatten_optimizer(optimizer)
        manifest["n_opt"] = len(o_flat)
        manifest["opt_keys"] = keys
        for i, leaf in enumerate(o_flat):
            arrays[f"opt_{i}"] = leaf
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
                 counters):
        self.params_flat = params_flat          # list of np arrays
        self.param_paths = param_paths          # state_dict names or keystr
        self.opt_flat = opt_flat                # list of np arrays or None
        self.opt_keys = opt_keys                # [[index, name]] or None
        self.counters = counters                # dict of ints

    @property
    def from_jax(self) -> bool:
        """Written by the JAX package: its paths are keystr strings."""
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
        counters = {k: int(manifest.get(k, 0)) for k in _COUNTERS}
        return _Payload(params_flat, paths, opt_flat,
                        manifest.get("opt_keys"), counters)


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
    opt = state.optimizer if save_optimizer_state else None
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
    if payload.from_jax:
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


def _restore_optimizer(optimizer: torch.optim.Optimizer,
                       payload: _Payload) -> None:
    own = optimizer.state_dict()
    st: Dict[int, Dict[str, torch.Tensor]] = {}
    for (idx, name), arr in zip(payload.opt_keys, payload.opt_flat):
        st.setdefault(int(idx), {})[name] = torch.from_numpy(np.asarray(arr))
    n_params = sum(len(g["params"]) for g in own["param_groups"])
    if any(idx >= n_params for idx in st):
        raise ValueError("checkpoint's optimizer state names more parameters "
                         f"than the optimizer has ({n_params})")
    optimizer.load_state_dict({"state": st,
                               "param_groups": own["param_groups"]})


def load_checkpoint(path: str, state, *, reset_optimizer: bool = False
                    ) -> Tuple[Any, Dict[str, int]]:
    """Restore params (+optimizer unless reset) + counters into ``state``,
    in place (reference: train.py:930-947). Returns (state, counters)."""
    payload, path = _read_with_fallback(path)
    model = state.model
    _load_into(model, _state_dict(payload, model.spec))
    if not reset_optimizer and payload.opt_flat is not None:
        if payload.opt_keys is None:
            print(f"NOTE: {path} was written by the JAX package; its optax "
                  "optimizer state is not carried over, the optimizer starts "
                  "fresh (as with reset_optimizer=True)")
        else:
            _restore_optimizer(state.optimizer, payload)
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
