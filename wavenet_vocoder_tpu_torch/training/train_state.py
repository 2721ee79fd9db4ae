"""Training state and step: optimizer by name, LR schedule, gradient clip,
masked losses and the EMA shadow.

The port's counterpart of ``wavenet_vocoder_tpu/training/train_state.py``
(reference: train.py:692-849). Where the JAX step is a pure function that
returns a new state, the port's ``train_step`` updates the ``TrainState``
it is given in place: the model's parameters, the optimizer's moments, the
EMA shadow and the step count.

The optimizer follows the JAX package's table (``_make_core_optimizer``):
Adam (AdamW when weight_decay > 0, as the JAX package maps it to
optax.adamw), AdamW, SGD (momentum, nesterov; weight decay added to the
gradient) and Adadelta map onto ``torch.optim``, where torch has optax's
update; Adamax, NAdam, RAdam, RMSprop, Adagrad, Lamb and Adafactor are
optax's updates written out in ``training/optimizers.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.wavenet import (
    WaveNet,
    WaveNetSpec,
    spec_from_config,
)
from wavenet_vocoder_tpu_torch.ops.losses import (
    masked_cross_entropy,
    masked_gaussian_loss,
    masked_mol_loss,
    sequence_mask,
)
from wavenet_vocoder_tpu_torch.parallel.distributed import batch_row_offset
from wavenet_vocoder_tpu_torch.training import optimizers
from wavenet_vocoder_tpu_torch.training.lrschedule import make_schedule
from wavenet_vocoder_tpu_torch.utils import profiling


class TrainState:
    """The model, its optimizer, the LR schedule, the EMA shadow (name ->
    tensor, or None) and the number of steps taken. ``train_step`` updates
    all of them in place. ``parallel``: the ``ParallelGroups`` of a state
    cut by ``parallel.sharding.shard_train_state`` (this rank's slices of
    the model, its optimizer state and its EMA), else None."""

    def __init__(self, model: WaveNet, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 ema: Optional[Dict[str, torch.Tensor]], step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.ema = ema
        self.step = step
        self.parallel = None


def make_optimizer(cfg: Config, params) -> Tuple[torch.optim.Optimizer,
                                                 Callable[[int], float]]:
    """Optimizer by name with the config's schedule (reference:
    train.py:1083-1085), mapped as the JAX package's
    ``_make_core_optimizer`` maps the name and ``optimizer_params`` onto
    optax: what it ignores for a name (weight decay for Adamax, NAdam and
    RAdam; everything but the schedule for Adafactor) is ignored here too.
    ``params``: a model (the speaker embedding is then marked as kept in
    the JAX package's axis order, ``optimizers.Adafactor``) or an iterable
    of tensors. The lr is set from the schedule before each update;
    clipping is done by ``train_step``."""
    p = dict(cfg.optimizer_params)
    init_lr = float(p.get("lr", 1e-3))
    schedule = make_schedule(cfg.lr_schedule, init_lr,
                             dict(cfg.lr_schedule_kwargs))
    eps = float(p.get("eps", 1e-8))
    weight_decay = float(p.get("weight_decay", 0.0))
    betas = p.get("betas", (0.9, 0.999))
    betas = (float(betas[0]), float(betas[1]))
    momentum = float(p.get("momentum", 0.0))
    key = cfg.optimizer.lower()
    if isinstance(params, torch.nn.Module):
        embeds = {id(m.weight) for m in params.modules()
                  if isinstance(m, torch.nn.Embedding)}
        params = list(params.parameters())
        params = [{"params": params,
                   "same_layout": [id(q) in embeds for q in params]}]
    else:
        params = list(params)
    lr = schedule(0)
    if key == "adam" and weight_decay == 0.0:
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    elif key in ("adam", "adamw"):
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                weight_decay=weight_decay)
    elif key in ("adamax", "nadam", "radam"):
        cls = {"adamax": optimizers.Adamax, "nadam": optimizers.NAdam,
               "radam": optimizers.RAdam}[key]
        opt = cls(params, lr=lr, betas=betas, eps=eps)
    elif key == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              nesterov=bool(p.get("nesterov", False)),
                              weight_decay=weight_decay)
    elif key == "rmsprop":
        opt = optimizers.RMSprop(
            params, lr=lr, decay=float(p.get("alpha", 0.99)), eps=eps,
            momentum=momentum or None,
            centered=bool(p.get("centered", False)),
            weight_decay=weight_decay)
    elif key == "adagrad":
        opt = optimizers.Adagrad(params, lr=lr,
                                 eps=float(p.get("eps", 1e-10)),
                                 weight_decay=weight_decay)
    elif key == "adadelta":
        opt = torch.optim.Adadelta(params, lr=lr,
                                   rho=float(p.get("rho", 0.9)), eps=eps,
                                   weight_decay=weight_decay)
    elif key == "lamb":
        opt = optimizers.Lamb(params, lr=lr, betas=betas, eps=eps,
                              weight_decay=weight_decay)
    elif key == "adafactor":
        opt = optimizers.Adafactor(params, lr=lr)
    else:
        raise ValueError(
            f"Unsupported optimizer: {cfg.optimizer!r}; supported: Adam, "
            "AdamW, Adamax, NAdam, RAdam, SGD, RMSprop, Adagrad, Adadelta, "
            "Lamb, Adafactor (reference accepts any torch.optim name, "
            "train.py:1083-1085)")
    return opt, schedule


def _partitions(optimizer):
    """(which parameters are a slice of a logical tensor, the model group)
    of an optimizer over a tensor-parallel model; (None, None) otherwise."""
    group = getattr(optimizer, "model_group", None)
    if group is None:
        return None, None
    return [d is not None for g in optimizer.param_groups
            for d in g.get("partition_dim") or [None] * len(g["params"])
            ], group


def _all_reduce_into(tensors, extra, group):
    """Sum ``tensors`` (and the 0-dim ``extra``, returned) over ``group`` in
    one flat buffer, in place."""
    flat = torch.cat([t.reshape(-1) for t in tensors]
                     + ([] if extra is None else [extra[None]]))
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    n = sum(t.numel() for t in tensors)
    torch._foreach_copy_(tensors, [
        v.view_as(t) for v, t in
        zip(flat[:n].split([t.numel() for t in tensors]), tensors)])
    return None if extra is None else flat[-1]


def clip_by_global_norm(grads, clip_thresh: float, partitioned=None,
                        model_group=None) -> torch.Tensor:
    """The global norm of ``grads`` (the optimizer's order), and the
    gradients scaled in place by thresh / max(norm, thresh) when
    ``clip_thresh`` > 0 (optax.clip_by_global_norm, not
    ``clip_grad_norm_``'s formula). Under tensor parallelism the norm is
    the logical model's: the squares of the ``partitioned`` gradients are
    summed over ``model_group``, the replicated ones counted once."""
    norms = torch.stack(torch._foreach_norm(grads))
    if model_group is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        sq = norms * norms
        mask = torch.tensor(partitioned, device=sq.device)
        shards = sq[mask].sum()
        dist.all_reduce(shards, group=model_group)
        norm = torch.sqrt(sq[~mask].sum() + shards)
    if clip_thresh > 0:
        thresh = float(clip_thresh)
        torch._foreach_mul_(grads, thresh / torch.clamp(norm, min=thresh))
    return norm


def create_train_state(cfg: Config, *, model: Optional[WaveNet] = None,
                       device=None) -> TrainState:
    """Model (random init from ``cfg.seed``, unless given), optimizer and
    EMA shadow, on ``device`` (default: the GPU; raises without one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train "
                               "on the CPU")
        device = "cuda"
    if model is None:
        model = WaveNet(spec_from_config(cfg),
                        generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    opt, schedule = make_optimizer(cfg, model)
    ema = None
    if cfg.exponential_moving_average:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model, opt, schedule, ema)


def select_criterion(cfg: Config, group=None):
    """Loss by input_type / output_distribution (reference: train.py:781-791);
    under a process ``group`` each rank's share of the global masked mean
    (ops/losses.py)."""
    if cfg.is_mulaw_quantize:
        return lambda y_hat, y, mask: masked_cross_entropy(y_hat, y, mask,
                                                           group=group)
    if cfg.output_distribution == "Logistic":
        return lambda y_hat, y, mask: masked_mol_loss(
            y_hat, y, mask, num_classes=cfg.quantize_channels,
            log_scale_min=cfg.log_scale_min, group=group)
    if cfg.output_distribution == "Normal":
        return lambda y_hat, y, mask: masked_gaussian_loss(
            y_hat, y, mask, log_scale_min=cfg.log_scale_min, group=group)
    raise ValueError(
        f"Not supported: input_type={cfg.input_type}, "
        f"output_distribution={cfg.output_distribution} "
        "(reference: train.py:781-791)")


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: WaveNet,
               decay: float) -> None:
    """shadow -= (1 - decay) * (shadow - param), in place
    (reference: train.py:329-333)."""
    for name, p in model.named_parameters():
        s = ema[name]
        s.sub_((1.0 - decay) * (s - p))


def sanity_check(spec: WaveNetSpec, batch: Dict[str, Any]) -> None:
    """Model-vs-batch conditioning consistency (reference: train.py:72-87)."""
    has_c = batch.get("c") is not None
    has_g = batch.get("g") is not None
    if has_c and not spec.has_local_conditioning:
        raise ValueError("Batch has local conditioning but cin_channels <= 0 "
                         "(reference: train.py:76-80)")
    if not has_c and spec.has_local_conditioning:
        raise ValueError(
            "cin_channels > 0 but batch has no local conditioning features")
    if has_g and not spec.has_global_conditioning:
        raise ValueError("Batch has speaker ids but gin_channels <= 0 "
                         "(reference: train.py:81-85)")
    if not has_g and spec.has_global_conditioning:
        raise ValueError("gin_channels > 0 but batch has no global conditioning")
    if has_c and batch["c"].shape[-1] != spec.cin_channels:
        raise ValueError(f"conditioning feature dim {batch['c'].shape[-1]} != "
                         f"cin_channels {spec.cin_channels}")


def _on(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: None if v is None else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def make_train_step(cfg: Config, group=None):
    """Build ``(train_step, eval_step)``.

    batch dict (tensors or numpy arrays):
      x: (B, T, C_in) model input (one-hot or scalar)
      y: (B, T) int targets (categorical) or (B, T, 1) float targets
      c: (B, T_mel, C) local conditioning, or absent
      g: (B,) / (B, gin) global conditioning, or absent
      input_lengths: (B,) valid lengths of x

    ``train_step(state, batch, generator)`` runs one update in place and
    returns {"loss", "grad_norm"} (0-dim tensors) and {"lr"} (the lr of this
    update, ``schedule(step)`` before the step count rises, as optax). When
    ``cfg.dropout > 0`` it draws one int32 dropout seed from ``generator``,
    which must then be given.
    ``eval_step(state, batch)`` returns {"loss"} with dropout off.

    ``group``: a ``torch.distributed`` process group over which the step
    runs data-parallel, each rank on its rows of the global batch (rank r
    holds rows [r * B, (r + 1) * B) of B local rows). The losses divide by
    the global mask count; the gradients are summed over the ranks in one
    flat buffer; the reported loss is the global one. The grad norm, the
    clip, the optimizer and the EMA then see identical values on every
    rank, and dropout is keyed on the global rows. Every
    rank must draw the same dropout seed (the same generator state).
    Under tensor parallelism (a state cut by
    ``parallel.sharding.shard_train_state``) ``group`` is its data group:
    the model group's collectives run inside the model and the optimizer,
    and the grad norm (and clip) is the whole model's.
    """
    import torch.distributed as dist
    criterion = select_criterion(cfg, group)
    # compute dtype below the head's output; "" is f32 throughout
    dtype = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None

    def loss_fn(model, batch, seed, train):
        x = batch["x"]
        b0 = 0 if group is None else batch_row_offset(x.shape[0], group)
        y_hat = model(x, batch.get("c"), batch.get("g"), train=train,
                      dtype=dtype, seed=seed, b0=b0)
        T = x.shape[1]
        # one-sample AR shift (reference: train.py:728-729, 742-748)
        mask = sequence_mask(batch["input_lengths"], T)[:, 1:]
        return criterion(y_hat[:, :-1], batch["y"][:, 1:], mask)

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        model = state.model
        device = next(model.parameters()).device
        batch = _on(batch, device)
        seed = None
        if cfg.dropout > 0:
            if generator is None:
                raise ValueError("dropout > 0: pass a torch.Generator to "
                                 "draw the step's dropout seed from")
            seed = int(torch.randint(-2 ** 31, 2 ** 31 - 1, (),
                                     generator=generator))
        model.train()
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        for p in params:
            p.grad = None
        # cuDNN's deterministic algorithms (the fused stack's kernels sum in
        # a fixed order): one state, batch and generator give one result
        # on a card, as the JAX step does
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                         deterministic=True, allow_tf32=cudnn.allow_tf32):
            with profiling.span("train.forward"):
                loss = loss_fn(model, batch, seed, True)
            with profiling.span("train.backward"):
                loss.backward()
                grads = []
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    grads.append(p.grad)
        loss = loss.detach()
        with profiling.span("train.clip"):
            partitioned, model_group = _partitions(state.optimizer)
            if model_group is not None:
                # every rank of the model group holds all of a replicated
                # tensor's gradient; the copies are averaged so that the
                # replicas stay bitwise equal even where a library's sums
                # differ between ranks in their last bits
                rep = [g for g, cut in zip(grads, partitioned) if not cut]
                _all_reduce_into(rep, None, model_group)
                torch._foreach_div_(rep, dist.get_world_size(model_group))
            if group is not None:
                # the ranks' shares summed: the global loss and its gradient
                loss = _all_reduce_into(grads, loss, group)
            grad_norm = clip_by_global_norm(grads, cfg.clip_thresh,
                                            partitioned, model_group)
        with profiling.span("train.optimizer"):
            lr = state.schedule(state.step)
            for pg in state.optimizer.param_groups:
                pg["lr"] = lr
            state.optimizer.step()
        if state.ema is not None:
            with profiling.span("train.ema"):
                ema_update(state.ema, model, cfg.ema_decay)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm.detach(), "lr": lr}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Dev-set loss with the same criterion, no update, dropout off
        (reference: train.py:702-709); under ``group`` the global masked
        mean, on every rank."""
        model = state.model
        batch = _on(batch, next(model.parameters()).device)
        model.eval()
        loss = loss_fn(model, batch, None, False)
        if group is not None:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        return {"loss": loss}

    return train_step, eval_step
