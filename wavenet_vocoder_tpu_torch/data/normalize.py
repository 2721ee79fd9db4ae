"""Feature normalization (reference: compute-meanvar-stats.py +
preprocess_normalize.py).

A copy of ``wavenet_vocoder_tpu/data/normalize.py`` for the port (numpy
only; the port imports nothing of the JAX package): the same statistics,
scaler file and outputs.

Streaming mean/variance over all feats files (the reference uses sklearn
StandardScaler.partial_fit + joblib, compute-meanvar-stats.py:25-32), saved as
a plain npz; then parallel application of the (inverse) transform to every
``*-feats.npy``, copying ``*-wave.npy`` and ``train.txt`` through
(reference: preprocess_normalize.py:32-79).
"""
from __future__ import annotations

import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor
from glob import glob
from os.path import basename, exists, join
from typing import List, Optional

import numpy as np


class StreamingStandardScaler:
    """Welford-style streaming mean/var, sklearn-compatible results."""

    def __init__(self):
        self.n = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def partial_fit(self, X: np.ndarray) -> "StreamingStandardScaler":
        X = np.asarray(X, dtype=np.float64)
        if self.mean is None:
            self.mean = np.zeros(X.shape[1])
            self.m2 = np.zeros(X.shape[1])
        for_mean = X.mean(axis=0)
        n_new = X.shape[0]
        delta = for_mean - self.mean
        tot = self.n + n_new
        self.mean = self.mean + delta * n_new / tot
        self.m2 = (self.m2 + ((X - for_mean) ** 2).sum(axis=0)
                   + delta ** 2 * self.n * n_new / tot)
        self.n = tot
        return self

    @property
    def var(self) -> np.ndarray:
        return self.m2 / self.n

    @property
    def scale(self) -> np.ndarray:
        return np.sqrt(np.maximum(self.var, 1e-20))

    def transform(self, X: np.ndarray) -> np.ndarray:
        return ((X - self.mean) / self.scale).astype(np.float32)

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return (X * self.scale + self.mean).astype(np.float32)

    def save(self, path: str) -> None:
        np.savez(path, n=self.n, mean=self.mean, m2=self.m2)

    @classmethod
    def load(cls, path: str) -> "StreamingStandardScaler":
        d = np.load(path)
        s = cls()
        s.n = int(d["n"])
        s.mean = d["mean"]
        s.m2 = d["m2"]
        return s


def compute_meanvar_stats(feats_files: List[str], out_path: str
                          ) -> StreamingStandardScaler:
    """(reference: compute-meanvar-stats.py:25-32)."""
    scaler = StreamingStandardScaler()
    for p in feats_files:
        scaler.partial_fit(np.load(p))
    scaler.save(out_path)
    return scaler


def _apply_one(in_path: str, out_dir: str, scaler_path: str,
               inverse: bool) -> None:
    scaler = StreamingStandardScaler.load(scaler_path)
    x = np.load(in_path)
    y = scaler.inverse_transform(x) if inverse else scaler.transform(x)
    np.save(join(out_dir, basename(in_path)), y, allow_pickle=False)


def normalize_dir(in_dir: str, out_dir: str, scaler_path: str,
                  inverse: bool = False, num_workers: int = 1) -> None:
    """Apply (inverse) normalization to all ``*-feats.npy``; copy waves and
    train.txt through (reference: preprocess_normalize.py:32-79)."""
    os.makedirs(out_dir, exist_ok=True)
    feats = sorted(glob(join(in_dir, "*-feats.npy")))
    if num_workers <= 1:
        for p in feats:
            _apply_one(p, out_dir, scaler_path, inverse)
    else:
        # spawned workers: forking a process that runs threads (torch's)
        # is unsafe
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=ctx) as ex:
            list(ex.map(_apply_one, feats, [out_dir] * len(feats),
                        [scaler_path] * len(feats), [inverse] * len(feats)))
    for p in sorted(glob(join(in_dir, "*-wave.npy"))):
        dst = join(out_dir, basename(p))
        if not exists(dst):
            shutil.copyfile(p, dst)
    manifest = join(in_dir, "train.txt")
    if exists(manifest):
        shutil.copyfile(manifest, join(out_dir, "train.txt"))
