"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``wavenet_vocoder_tpu_torch/csrc/`` compiles, at its first
use in a process, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source never loads a stale
build. ``defines`` (macro names, passed as ``-D``) build a variant of a
source into a library of its own. Libraries go to ``build/kernels/`` at the
repository root (listed in .gitignore); nvcc is taken from
``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``.
Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def _target(name: str, defines: Sequence[str] = ()) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # what a source may include
        h.update(header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + list(defines)).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    return the library's path. Safe to call from several processes: each
    writes a private temporary file and renames it into place."""
    src, lib = _target(name, defines)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, *(f"-D{d}" for d in defines),
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name, key[1])))
            _libs[key] = lib
        return lib
