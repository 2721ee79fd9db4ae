"""Learning-rate schedules (reference: lrschedule.py:5-35), as functions of
the step count on Python floats.

The port's counterpart of ``wavenet_vocoder_tpu/training/lrschedule.py``;
selected by name (reference: train.py:712-718).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict


def noam_learning_rate_decay(init_lr: float, global_step: int,
                             warmup_steps: int = 4000) -> float:
    """Noam/tensor2tensor scheme (reference: lrschedule.py:5-11)."""
    warmup_steps = float(warmup_steps)
    step = float(global_step) + 1.0
    return init_lr * warmup_steps ** 0.5 * min(step * warmup_steps ** -1.5,
                                               step ** -0.5)


def step_learning_rate_decay(init_lr: float, global_step: int,
                             anneal_rate: float = 0.98,
                             anneal_interval: int = 30000) -> float:
    """x anneal_rate every anneal_interval steps
    (reference: lrschedule.py:14-17)."""
    return init_lr * anneal_rate ** (int(global_step) // int(anneal_interval))


def cyclic_cosine_annealing(init_lr: float, global_step: int, T: int,
                            M: int) -> float:
    """SGDR cyclic cosine (reference: lrschedule.py:20-35)."""
    TdivM = T // M
    step = float(global_step)
    return init_lr / 2.0 * (math.cos(math.pi * ((step - 1) % TdivM) / TdivM)
                            + 1.0)


SCHEDULES: Dict[str, Callable[..., float]] = {
    "noam_learning_rate_decay": noam_learning_rate_decay,
    "step_learning_rate_decay": step_learning_rate_decay,
    "cyclic_cosine_annealing": cyclic_cosine_annealing,
}


def make_schedule(name: str, init_lr: float,
                  kwargs: Dict[str, Any]) -> Callable[[int], float]:
    """step -> lr (reference selection: train.py:712-718); no name is a
    constant schedule."""
    if name is None or name in ("", "none"):
        return lambda step: float(init_lr)
    fn = SCHEDULES[name]
    return lambda step: float(fn(init_lr, step, **kwargs))
