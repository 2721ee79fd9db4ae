"""Waveform comparison plots for eval-during-train artifacts
(reference: train.py:542-552 save_waveplot). matplotlib is optional — a
missing backend degrades to a no-op so headless training never fails on
plotting. A copy of ``wavenet_vocoder_tpu/utils/plot.py`` for the port."""
from __future__ import annotations

from typing import Optional

import numpy as np


def save_waveplot(path: str, y_hat: np.ndarray, y_target: np.ndarray,
                  sample_rate: int = 22050,
                  title: Optional[str] = None) -> bool:
    """Write a two-panel target/predicted waveform PNG. Returns False if
    matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    t_hat = np.arange(len(y_hat)) / sample_rate
    t_tgt = np.arange(len(y_target)) / sample_rate
    fig, axes = plt.subplots(2, 1, figsize=(16, 6), sharex=True)
    axes[0].plot(t_tgt, y_target, linewidth=0.5)
    axes[0].set_title("target")
    axes[1].plot(t_hat, y_hat, linewidth=0.5)
    axes[1].set_title("predicted")
    axes[1].set_xlabel("time [s]")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True
