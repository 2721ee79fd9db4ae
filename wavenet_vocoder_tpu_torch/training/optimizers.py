"""optax's optimizers that ``torch.optim`` has no equal of, as
``torch.optim.Optimizer`` subclasses.

The JAX package trains with ``optax.adamax``, ``nadam``, ``radam``,
``rmsprop``, ``adagrad``, ``lamb`` and ``adafactor``
(``wavenet_vocoder_tpu/training/train_state.py:_make_core_optimizer``);
their torch namesakes differ (eps inside or outside a max or a square
root, Adagrad's initial accumulator, NAdam's momentum schedule, RAdam's
eps) or do not exist. Each class below applies optax 0.2.6's update
(``optax/_src/alias.py``, ``transform.py``, ``factorized.py``) to the
parameters in place, with the learning rate the caller puts in
``group["lr"]`` before each step (``train_step`` sets it from the
schedule, as optax's ``scale_by_learning_rate`` reads it from its count).
Bias corrections count from optax's ``count + 1``.

Two per-parameter facts reach the update through the param group, as
lists aligned with ``group["params"]`` (absent: the defaults):

* ``same_layout`` (default False): the JAX package keeps a conv kernel as
  ``(K, In, Out)``, the port as ``(Out, In, K)``, the full axis reversal.
  Adafactor factors the two largest axes of the JAX tensor, ties broken by
  axis order, so it maps the port's axes through that reversal. A tensor
  that both packages keep in one order (the speaker embedding) says so.
* ``partition_dim`` (default None): under gate-channel tensor parallelism
  (``parallel/sharding.shard_train_state``) a parameter may be this rank's
  slice along one port axis of the logical tensor; ``model_group`` is then
  the process group of the slices. Lamb's trust ratio, Adafactor's
  parameter RMS, update clip and factored row/column means are statistics
  of the whole logical tensor, as GSPMD computes them in JAX: their sums
  are all-reduced over the model group.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class OptaxOptimizer(torch.optim.Optimizer):
    """What the seven optax optimizers share: the per-parameter layout and
    partition facts, and whole-tensor sums over the model group."""

    model_group = None

    def _facts(self, group) -> List[Tuple[torch.Tensor, bool, Optional[int]]]:
        params = group["params"]
        same = group.get("same_layout") or [False] * len(params)
        part = group.get("partition_dim") or [None] * len(params)
        return list(zip(params, same, part))

    def _sum(self, x: torch.Tensor, part: Optional[int],
             dims: Optional[Sequence[int]] = None) -> torch.Tensor:
        """sum(x) over ``dims`` (all when None, keeping them as size 1
        otherwise) of the logical tensor: all-reduced over the model group
        when the partitioned axis is among them."""
        if dims is None:
            s = torch.sum(x)
            reduce = part is not None
        else:
            s = torch.sum(x, dim=tuple(dims), keepdim=True)
            reduce = part is not None and part in dims
        if reduce and self.model_group is not None:
            dist.all_reduce(s, group=self.model_group)
        return s

    def _logical_shape(self, p: torch.Tensor,
                       part: Optional[int]) -> List[int]:
        shape = list(p.shape)
        if part is not None and self.model_group is not None:
            shape[part] *= dist.get_world_size(self.model_group)
        return shape

    def _size(self, p: torch.Tensor, part: Optional[int],
              dims: Optional[Sequence[int]] = None) -> int:
        """The logical tensor's element count over ``dims`` (all: None)."""
        shape = self._logical_shape(p, part)
        return int(np.prod([shape[d] for d in (dims if dims is not None
                                               else range(len(shape)))]))

    def _norm(self, x: torch.Tensor, part: Optional[int]) -> torch.Tensor:
        return torch.sqrt(self._sum(x * x, part))

    @staticmethod
    def _count(state) -> int:
        """optax's count before this update, and the state's step after."""
        t = int(state["step"])
        state["step"] = torch.tensor(float(t + 1))
        return t


def _adam_moments(state, g, b1, b2):
    """mu, nu after optax's ``update_moment`` (order 1) and
    ``update_moment_per_elem_norm`` (order 2), in place."""
    mu, nu = state["mu"], state["nu"]
    mu.mul_(b1).add_((1 - b1) * g)
    nu.mul_(b2).add_((1 - b2) * (g * g))
    return mu, nu


def _init(state, p, *names, value=0.0):
    if "step" not in state:
        state["step"] = torch.tensor(0.0)
        for n in names:
            state[n] = torch.full_like(p, value,
                                       memory_format=torch.preserve_format)


class Adamax(OptaxOptimizer):
    """optax.adamax: nu = max(|g| + eps, b2 nu); update mu_hat / nu."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p, _, _ in self._facts(group):
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                _init(state, p, "mu", "nu")
                t = self._count(state) + 1
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_((1 - b1) * g)
                torch.maximum(g.abs() + group["eps"], b2 * nu, out=nu)
                p.sub_(group["lr"] * ((mu / (1 - b1 ** t)) / nu))


class NAdam(OptaxOptimizer):
    """optax.nadam (``adam(nesterov=True)``): mu_hat = b1 mu / (1 -
    b1^(t+1)) + (1 - b1) g / (1 - b1^t)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p, _, _ in self._facts(group):
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                _init(state, p, "mu", "nu")
                t = self._count(state) + 1
                mu, nu = _adam_moments(state, g, b1, b2)
                mu_hat = (b1 * (mu / (1 - b1 ** (t + 1)))
                          + (1 - b1) * (g / (1 - b1 ** t)))
                nu_hat = nu / (1 - b2 ** t)
                p.sub_(group["lr"] * (mu_hat / (torch.sqrt(nu_hat)
                                                + group["eps"])))


class RAdam(OptaxOptimizer):
    """optax.radam: Adam's step rectified by r while the variance's
    length ro is at least ``threshold``, the bias-corrected momentum
    alone before that."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 threshold=5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p, _, _ in self._facts(group):
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                _init(state, p, "mu", "nu")
                t = self._count(state) + 1
                mu, nu = _adam_moments(state, g, b1, b2)
                b2t = b2 ** t
                ro = ro_inf - 2 * t * b2t / (1 - b2t)
                mu_hat = mu / (1 - b1 ** t)
                if ro >= group["threshold"]:
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    nu_hat = nu / (1 - b2 ** t)
                    u = r * mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                else:
                    u = mu_hat
                p.sub_(group["lr"] * u)


def _decayed(g, p, weight_decay):
    """optax.add_decayed_weights chained before the core: g + wd * p."""
    return g if weight_decay == 0.0 else g + weight_decay * p


class RMSprop(OptaxOptimizer):
    """optax.rmsprop: eps inside the square root, nu from
    ``initial_scale``, optional centering; momentum (``trace``) acts after
    the learning rate, on the scaled step. ``weight_decay`` is the JAX
    package's ``add_decayed_weights`` chained before it."""

    def __init__(self, params, lr=1e-2, decay=0.9, eps=1e-8,
                 initial_scale=0.0, centered=False, momentum=None,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      initial_scale=initial_scale,
                                      centered=centered, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            d, mom = group["decay"], group["momentum"]
            for p, _, _ in self._facts(group):
                if p.grad is None:
                    continue
                g = _decayed(p.grad, p, group["weight_decay"])
                state = self.state[p]
                if "step" not in state:
                    _init(state, p, "nu", value=group["initial_scale"])
                    if group["centered"]:
                        state["mu"] = torch.zeros_like(p)
                    if mom is not None:
                        state["trace"] = torch.zeros_like(p)
                self._count(state)
                nu = state["nu"]
                nu.mul_(d).add_((1 - d) * (g * g))
                if group["centered"]:
                    mu = state["mu"]
                    mu.mul_(d).add_((1 - d) * g)
                    u = g * torch.rsqrt(nu - mu * mu + group["eps"])
                else:
                    u = g * torch.rsqrt(nu + group["eps"])
                u = -group["lr"] * u
                if mom is not None:
                    u = state["trace"].mul_(mom).add_(u)
                p.add_(u)


class Adagrad(OptaxOptimizer):
    """optax.adagrad: the sum of squares starts at
    ``initial_accumulator_value``; the step is g * rsqrt(sum + eps) where
    the sum is positive. ``weight_decay`` as for RMSprop."""

    def __init__(self, params, lr=1e-2, initial_accumulator_value=0.1,
                 eps=1e-7, weight_decay=0.0):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p, _, _ in self._facts(group):
                if p.grad is None:
                    continue
                g = _decayed(p.grad, p, group["weight_decay"])
                state = self.state[p]
                _init(state, p, "sum_of_squares",
                      value=group["initial_accumulator_value"])
                self._count(state)
                s = state["sum_of_squares"]
                s.add_(g * g)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]),
                                    torch.zeros_like(s))
                p.sub_(group["lr"] * (scale * g))


class Lamb(OptaxOptimizer):
    """optax.lamb: Adam's direction plus ``weight_decay * p``, scaled by
    the trust ratio ||p|| / ||u|| of the whole logical tensor (1 where
    either norm is 0)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p, _, part in self._facts(group):
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                _init(state, p, "mu", "nu")
                t = self._count(state) + 1
                mu, nu = _adam_moments(state, g, b1, b2)
                u = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t))
                                            + group["eps"])
                u = u + group["weight_decay"] * p
                pn, un = self._norm(p, part), self._norm(u, part)
                ratio = torch.where((pn == 0) | (un == 0),
                                    torch.ones_like(pn), pn / un)
                p.sub_(group["lr"] * (u * ratio))


def factored_dims(shape: Sequence[int], same_layout: bool,
                  min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims`` on the JAX tensor, as port axes: (d1,
    d0), the second largest and the largest axis (d0 is averaged out of
    the row statistics, d1 out of the column statistics); None when the
    second largest is below ``min_dim_size_to_factor`` or the tensor has
    fewer than two axes. ``shape`` is the logical (whole) port shape."""
    n = len(shape)
    if n < 2:
        return None
    jax_shape = list(shape) if same_layout else list(shape)[::-1]
    order = np.argsort(jax_shape)
    if jax_shape[order[-2]] < min_dim_size_to_factor:
        return None
    to_port = (lambda a: int(a)) if same_layout else (lambda a: n - 1 - int(a))
    return to_port(order[-2]), to_port(order[-1])


class Adafactor(OptaxOptimizer):
    """optax.adafactor with optax's defaults (the JAX package passes only
    the schedule): factored second moments for tensors whose two largest
    axes are at least ``min_dim_size_to_factor``, decay 1 - (t+1)^-0.8,
    the update clipped to RMS 1 per tensor, scaled by the learning rate
    and by the parameter's RMS (at least 1e-3); no momentum, no weight
    decay. Row and column statistics keep their averaged axis as size 1."""

    def __init__(self, params, lr=1e-3, min_dim_size_to_factor=128,
                 decay_rate=0.8, decay_offset=0, clipping_threshold=1.0,
                 eps=1e-30, min_scale=1e-3):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, decay_offset=decay_offset,
            clipping_threshold=clipping_threshold, eps=eps,
            min_scale=min_scale))

    def _mean(self, x, p, part, dims):
        return self._sum(x, part, dims) / self._size(p, part, dims)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p, same, part in self._facts(group):
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                dims = factored_dims(self._logical_shape(p, part), same,
                                     group["min_dim_size_to_factor"])
                if "step" not in state:
                    state["step"] = torch.tensor(0.0)
                    if dims is None:
                        state["v"] = torch.zeros_like(p)
                    else:
                        d1, d0 = dims
                        row = list(p.shape)
                        row[d0] = 1
                        col = list(p.shape)
                        col[d1] = 1
                        state["v_row"] = p.new_zeros(row)
                        state["v_col"] = p.new_zeros(col)
                step = self._count(state)
                i = np.float32(step - group["decay_offset"] + 1)
                decay = float(np.float32(1.0) - i ** np.float32(
                    -group["decay_rate"]))
                grad_sqr = g * g + group["eps"]
                if dims is None:
                    v = state["v"]
                    v.mul_(decay).add_((1.0 - decay) * grad_sqr)
                    u = g * v ** -0.5
                else:
                    d1, d0 = dims
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.mul_(decay).add_(
                        (1.0 - decay) * self._mean(grad_sqr, p, part, [d0]))
                    v_col.mul_(decay).add_(
                        (1.0 - decay) * self._mean(grad_sqr, p, part, [d1]))
                    row_col_mean = self._mean(v_row, p, part, [d1])
                    u = (g * (v_row / row_col_mean) ** -0.5) * v_col ** -0.5
                rms = torch.sqrt(self._sum(u * u, part) / self._size(p, part))
                u = u / torch.clamp(rms / group["clipping_threshold"],
                                    min=1.0)
                u = u * group["lr"]
                p_rms = torch.sqrt(self._sum(p * p, part)
                                   / self._size(p, part))
                p_rms = torch.where(p_rms <= group["min_scale"],
                                    torch.full_like(p_rms, group["min_scale"]),
                                    p_rms)
                p.sub_(u * p_rms)


def state_partition_dim(value: torch.Tensor, param_shape: Sequence[int],
                        part: Optional[int]) -> Optional[int]:
    """Which axis of an optimizer state tensor holds this rank's slice when
    its parameter is partitioned along ``part``: ``part`` for a tensor of
    the parameter's rank that is not of size 1 there (moments, Adafactor's
    unfactored v, and the row or column statistic that keeps that axis);
    None (the same on every rank) for scalars and for a statistic averaged
    over that axis."""
    if part is None or value.dim() != len(param_shape):
        return None
    if value.shape[part] == 1 and param_shape[part] != 1:
        return None
    return part
