"""The port's state dict -> the JAX package's params, as flat keystr paths.

The inverse of ``compat/from_jax.py:state_dict_from_jax`` and the
counterpart of the JAX package's ``compat/torch_import.py:
params_from_state_dict``: a conv's ``weight_v (Out, In, K)`` (Conv2d
``(1, 1, freq, time)``) becomes ``v`` by a full axis reversal,
``weight_g`` (unit trailing axes) becomes ``g (Out,)``, ``bias`` ``b``, a
folded ``weight`` ``w``, and the speaker embedding's ``weight`` ``table``.
Blocks go under ``['blocks'][i]`` with the JAX names of their convs, the
head under ``last_conv1``/``last_conv2``, and the upsample net's Conv2ds
under ``['convs'][j]`` in the order of their module indices.

A path is what ``jax.tree_util.keystr`` prints for the leaf
(``['blocks'][0]['conv']['v']``), and ``to_jax`` returns the leaves in
JAX's flattening order (dict keys sorted, lists in order), so the flat
list is ``jax.tree.leaves`` of the params tree. Numpy only: this module
imports nothing of JAX.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple, Union

import numpy as np

_BLOCK_CONVS = {"conv": "conv", "conv1x1c": "cond_c", "conv1x1g": "cond_g",
                "conv1x1_out": "out", "conv1x1_skip": "skip"}
_HEAD = {"1": "last_conv1", "3": "last_conv2"}
_LEAF = {"weight_v": "v", "weight_g": "g", "bias": "b", "weight": "w"}
_UP = re.compile(r"(.*)\.up_layers\.(\d+)$")

Token = Union[str, int]


def _conv_node(prefix: str, up_rank: Dict[Tuple[str, int], int]
               ) -> Tuple[Token, ...]:
    """The JAX path of the conv module ``prefix`` (a port module name)."""
    parts = prefix.split(".")
    if prefix == "first_conv":
        return ("first_conv",)
    if parts[0] == "conv_layers" and len(parts) == 3:
        return ("blocks", int(parts[1]), _BLOCK_CONVS[parts[2]])
    if parts[0] == "last_conv_layers" and len(parts) == 2:
        return (_HEAD[parts[1]],)
    if prefix == "upsample_net.conv_in":
        return ("upsample_net", "conv_in")
    m = _UP.match(prefix)
    if m:
        head = ("upsample_net", "upsample") if m.group(1).endswith(
            ".upsample") else ("upsample_net",)
        return head + ("convs", up_rank[(m.group(1), int(m.group(2)))])
    raise KeyError(f"no JAX counterpart for the port's module {prefix!r}")


def jax_paths(names) -> Dict[str, Tuple[Token, ...]]:
    """Port parameter name -> its JAX path as a token tuple, for every
    name of a ``WaveNet.state_dict()`` (or ``named_parameters()``)."""
    names = list(names)
    # the upsample nets interleave parameter-free modules with their
    # Conv2ds: the j-th conv is the j-th module index that holds weights
    idx: Dict[str, set] = {}
    for n in names:
        m = _UP.match(n.rsplit(".", 1)[0])
        if m:
            idx.setdefault(m.group(1), set()).add(int(m.group(2)))
    up_rank = {(base, j): r for base, js in idx.items()
               for r, j in enumerate(sorted(js))}
    out = {}
    for n in names:
        if n == "embed_speakers.weight":
            out[n] = ("embed_speakers", "table")
            continue
        prefix, leaf = n.rsplit(".", 1)
        out[n] = _conv_node(prefix, up_rank) + (_LEAF[leaf],)
    return out


def keystr(path: Tuple[Token, ...]) -> str:
    """``jax.tree_util.keystr`` of a dict/list path."""
    return "".join(f"[{t!r}]" for t in path)


def _reversed(name: str) -> bool:
    """A conv kernel: its axes are reversed between the packages."""
    return (name.endswith(("weight_v", ".weight"))
            and name != "embed_speakers.weight")


def to_jax_array(name: str, a: np.ndarray) -> np.ndarray:
    """One port tensor (numpy) in the JAX package's axes."""
    a = np.asarray(a)
    if name.endswith("weight_g"):
        a = a.reshape(-1)
    return np.ascontiguousarray(a.T if _reversed(name) else a)


def from_jax_array(name: str, a: np.ndarray, shape) -> np.ndarray:
    """The inverse of :func:`to_jax_array` for a port tensor of ``shape``."""
    a = np.asarray(a)
    return np.ascontiguousarray(
        (a.T if _reversed(name) else a).reshape(tuple(shape)))


def jax_order(names) -> List[Tuple[str, str]]:
    """[(port name, keystr path)] in JAX's leaf order."""
    paths = jax_paths(names)
    return [(n, keystr(p)) for n, p in sorted(paths.items(),
                                              key=lambda kv: kv[1])]


def to_jax(arrays: Dict[str, np.ndarray]) -> List[Tuple[str, np.ndarray]]:
    """Port name -> numpy array (a state dict, or any per-parameter state
    shaped like it) -> [(keystr path, array in JAX's axes)] in JAX's leaf
    order: ``jax.tree_util.tree_flatten_with_path`` of the params tree
    that ``params_from_state_dict`` would build."""
    return [(path, to_jax_array(n, arrays[n]))
            for n, path in jax_order(arrays)]
