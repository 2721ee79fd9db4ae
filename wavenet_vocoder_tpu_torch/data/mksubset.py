"""Dataset subset/split tool (reference: mksubset.py).

A copy of ``wavenet_vocoder_tpu/data/mksubset.py`` for the port, on the
port's ``dsp/audio``: the same splits from the same seed.

Reads .wav (or headerless 24kHz int16 .raw) files, optionally caps total
corpus hours, splits into train-dev/dev/eval, optionally resamples, and
reports the waveform abs-max to recommend ``global_gain_scale``
(reference: mksubset.py:28-151).
"""
from __future__ import annotations

import os
import shutil
from glob import glob
from os.path import basename, join
from typing import List, Optional, Tuple

import numpy as np

from wavenet_vocoder_tpu_torch.dsp import audio


def _read_any(path: str, raw_sr: int = 24000) -> Tuple[np.ndarray, int]:
    if path.endswith(".raw"):
        x = np.fromfile(path, dtype=np.int16).astype(np.float32) / 2 ** 15
        return x, raw_sr
    from scipy.io import wavfile
    sr, x = wavfile.read(path)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 2 ** 15
    return x.astype(np.float32), sr


def split_files(files: List[str], dev_size, test_size,
                seed: int = 1234) -> Tuple[List[str], List[str], List[str]]:
    """Random split when sizes are fractions; take-from-end when counts
    (reference: mksubset.py:88-108)."""
    files = list(files)
    if isinstance(dev_size, float) or isinstance(test_size, float):
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(files))
        n_dev = (int(len(files) * dev_size) if isinstance(dev_size, float)
                 else int(dev_size))
        n_test = (int(len(files) * test_size) if isinstance(test_size, float)
                  else int(test_size))
        dev = [files[i] for i in idx[:n_dev]]
        test = [files[i] for i in idx[n_dev:n_dev + n_test]]
        train = [files[i] for i in idx[n_dev + n_test:]]
        return train, dev, test
    n_dev, n_test = int(dev_size), int(test_size)
    train = files[:-(n_dev + n_test)] if (n_dev + n_test) else files
    dev = files[-(n_dev + n_test):-n_test] if n_test else files[-n_dev:]
    test = files[-n_test:] if n_test else []
    return train, dev, test


def mksubset(in_dir: str, out_dir: str, *, limit_hours: Optional[float] = None,
             dev_size=0.1, test_size=0.1, target_sr: Optional[int] = None,
             raw_sr: int = 24000, seed: int = 1234,
             train_dev_test_split: bool = True) -> dict:
    """Build {train_no_dev, dev, eval} wav subsets and report gain stats
    (reference: mksubset.py:68-151). With ``train_dev_test_split=False``,
    copy every kept utterance flat into ``out_dir`` instead of splitting
    (reference: mksubset.py:69-73, 110-111)."""
    src = sorted(glob(join(in_dir, "*.wav"))) + sorted(glob(join(in_dir, "*.raw")))
    if not src:
        raise ValueError(f"No .wav/.raw files in {in_dir}")

    # cap corpus by hours (reference: mksubset.py:75-85)
    if limit_hours is not None:
        kept, total_sec = [], 0.0
        for p in src:
            x, sr = _read_any(p, raw_sr)
            total_sec += len(x) / sr
            kept.append(p)
            if total_sec / 3600 >= limit_hours:
                break
        src = kept

    if train_dev_test_split:
        train, dev, test = split_files(src, dev_size, test_size, seed)
        sets = [("train_no_dev", train), ("dev", dev), ("eval", test)]
    else:
        train, dev, test = src, [], []
        sets = [("", src)]

    abs_max = 0.0
    for split_name, files in sets:
        d = join(out_dir, split_name) if split_name else out_dir
        os.makedirs(d, exist_ok=True)
        for p in files:
            x, sr = _read_any(p, raw_sr)
            abs_max = max(abs_max, float(np.max(np.abs(x))) if x.size else 0.0)
            dst = join(d, basename(p).replace(".raw", ".wav"))
            if target_sr is not None and sr != target_sr:
                x = audio.resample(x, sr, target_sr)
                audio.save_wav(x, dst, target_sr)
            elif p.endswith(".raw"):
                audio.save_wav(x, dst, sr)
            else:
                shutil.copyfile(p, dst)

    # gain-scale recommendation (reference: mksubset.py:112-151)
    rec = 1.0 / abs_max if abs_max > 0 else 1.0
    stats = {"abs_max": abs_max,
             "clipping": abs_max > 1.0,
             "recommended_global_gain_scale": min(rec, 1.0) if abs_max <= 1.0 else rec,
             "n_train": len(train), "n_dev": len(dev), "n_eval": len(test)}
    print(f"abs max: {abs_max:.4f}; "
          f"recommended global_gain_scale <= {stats['recommended_global_gain_scale']:.4f}")
    if train_dev_test_split:
        print(f"splits: train_no_dev={len(train)} dev={len(dev)} "
              f"eval={len(test)}")
    else:
        print(f"copied {len(train)} utterances (no split)")
    return stats
