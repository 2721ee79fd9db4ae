"""ctypes bindings for the native data-path library (native/wavenet_data.cpp).

The port's counterpart of ``wavenet_vocoder_tpu/data/native.py``: the same
shared library (``native/libwavenet_data.so`` at the repo root, which both
packages load), auto-built with make on first use if a toolchain is present.
This is host C++ for the data path, not a device kernel: every entry point
keeps the JAX module's numpy fallback, here through the port's own
``ops/mulaw``. Enable / disable explicitly with WAVENET_TPU_NATIVE=1/0 (the
switch is shared with the JAX package, since the library is).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from wavenet_vocoder_tpu_torch.ops import mulaw as _mulaw

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libwavenet_data.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("WAVENET_TPU_NATIVE", "1") == "0":
        return None
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None

    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    f32 = ctypes.c_float
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pl = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.onehot_f32.argtypes = [pi, i64, i32, pf]
    lib.onehot_f32.restype = i32
    lib.mulaw_f32.argtypes = [pf, i64, f32, pf]
    lib.mulaw_quantize_i32.argtypes = [pf, i64, f32, pi]
    lib.inv_mulaw_f32.argtypes = [pf, i64, f32, pf]
    lib.inv_mulaw_quantize_f32.argtypes = [pi, i64, f32, pf]
    lib.crop_onehot_batch_i32.argtypes = [pi, pl, pl, i64, i64, i32, pf, pi]
    lib.crop_onehot_batch_i32.restype = i32
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def onehot(codes: np.ndarray, num_classes: int) -> np.ndarray:
    """int codes (any shape) -> f32 one-hot (..., num_classes)."""
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    if lib is None:
        return np.eye(num_classes, dtype=np.float32)[codes]
    out = np.empty(codes.shape + (num_classes,), dtype=np.float32)
    rc = lib.onehot_f32(codes.reshape(-1), codes.size, num_classes,
                        out.reshape(-1, num_classes))
    if rc != 0:
        raise ValueError("one-hot code out of range")
    return out


def mulaw(x: np.ndarray, mu: int) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    if lib is None:
        return np.asarray(_mulaw.mulaw(x, mu), dtype=np.float32)
    out = np.empty_like(x)
    lib.mulaw_f32(x.reshape(-1), x.size, float(mu), out.reshape(-1))
    return out


def mulaw_quantize(x: np.ndarray, mu: int) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    if lib is None:
        return np.asarray(_mulaw.mulaw_quantize(x, mu), dtype=np.int32)
    out = np.empty(x.shape, dtype=np.int32)
    lib.mulaw_quantize_i32(x.reshape(-1), x.size, float(mu), out.reshape(-1))
    return out


def inv_mulaw(y: np.ndarray, mu: int) -> np.ndarray:
    lib = _load()
    y = np.ascontiguousarray(y, dtype=np.float32)
    if lib is None:
        return np.asarray(_mulaw.inv_mulaw(y, mu), dtype=np.float32)
    out = np.empty_like(y)
    lib.inv_mulaw_f32(y.reshape(-1), y.size, float(mu), out.reshape(-1))
    return out


def inv_mulaw_quantize(codes: np.ndarray, mu: int) -> np.ndarray:
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    if lib is None:
        return np.asarray(_mulaw.inv_mulaw_quantize(codes, mu),
                          dtype=np.float32)
    out = np.empty(codes.shape, dtype=np.float32)
    lib.inv_mulaw_quantize_f32(codes.reshape(-1), codes.size, float(mu),
                               out.reshape(-1))
    return out


def crop_onehot_batch(code_arrays, starts, crop_len: int,
                      num_classes: int):
    """Per-utterance crop + one-hot batch assembly.

    code_arrays: list of 1-D int arrays (per-utterance mu-law codes)
    starts: per-utterance crop start indices
    Returns (x (B, crop_len, num_classes) f32, y (B, crop_len) i32).
    """
    lib = _load()
    B = len(code_arrays)
    if lib is None:
        y = np.stack([np.asarray(a[s:s + crop_len], dtype=np.int32)
                      for a, s in zip(code_arrays, starts)])
        return onehot(y, num_classes), y
    flat = np.ascontiguousarray(
        np.concatenate([np.asarray(a, dtype=np.int32) for a in code_arrays]))
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum([len(a) for a in code_arrays], out=offsets[1:])
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    x = np.empty((B, crop_len, num_classes), dtype=np.float32)
    y = np.empty((B, crop_len), dtype=np.int32)
    rc = lib.crop_onehot_batch_i32(flat, offsets, starts, B, crop_len,
                                   num_classes, x, y)
    if rc != 0:
        raise ValueError(f"crop_onehot_batch failed: rc={rc}")
    return x, y
