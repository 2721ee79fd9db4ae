"""Training state and step: optimizer by name, LR schedule, gradient clip,
masked losses and the EMA shadow.

The port's counterpart of ``wavenet_vocoder_tpu/training/train_state.py``
(reference: train.py:692-849). Where the JAX step is a pure function that
returns a new state, the port's ``train_step`` updates the ``TrainState``
it is given in place: the model's parameters, the optimizer's moments, the
EMA shadow and the step count.

The optimizer follows the JAX package's table (``_make_core_optimizer``)
mapped onto ``torch.optim``, where torch has the same update: Adam (AdamW
when weight_decay > 0, as the JAX package maps it to optax.adamw), AdamW,
SGD (momentum, nesterov; weight decay added to the gradient) and Adadelta.
The other names the JAX package accepts differ from their torch
namesakes, or have none, and raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

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
from wavenet_vocoder_tpu_torch.training.lrschedule import make_schedule

# names the JAX package accepts, and why the port does not map them
_UNMAPPED = {
    "adamax": "torch's Adamax adds eps inside the max, optax's to the "
              "denominator",
    "nadam": "torch's NAdam applies a momentum-decay schedule that "
             "optax.nadam does not",
    "radam": "torch's RAdam scales eps by the bias correction, optax's "
             "does not",
    "rmsprop": "optax adds eps inside the square root, torch outside",
    "adagrad": "optax starts the accumulator at 0.1 and adds eps inside "
               "the square root",
    "lamb": "torch.optim has no Lamb",
    "adafactor": "torch's Adafactor is not optax's (factored moments, "
                 "update clipping and step-size rules differ)",
}


class TrainState:
    """The model, its optimizer, the LR schedule, the EMA shadow (name ->
    tensor, or None) and the number of steps taken. ``train_step`` updates
    all of them in place."""

    def __init__(self, model: WaveNet, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 ema: Optional[Dict[str, torch.Tensor]], step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.ema = ema
        self.step = step


def make_optimizer(cfg: Config, params) -> Tuple[torch.optim.Optimizer,
                                                 Callable[[int], float]]:
    """Optimizer by name with the config's schedule (reference:
    train.py:1083-1085). The lr is set from the schedule before each
    update; clipping is done by ``train_step``."""
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
    params = list(params)
    lr = schedule(0)
    if key == "adam" and weight_decay == 0.0:
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    elif key in ("adam", "adamw"):
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                weight_decay=weight_decay)
    elif key == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              nesterov=bool(p.get("nesterov", False)),
                              weight_decay=weight_decay)
    elif key == "adadelta":
        opt = torch.optim.Adadelta(params, lr=lr,
                                   rho=float(p.get("rho", 0.9)), eps=eps,
                                   weight_decay=weight_decay)
    elif key in _UNMAPPED:
        raise ValueError(f"optimizer {cfg.optimizer!r} is not mapped in the "
                         f"PyTorch port: {_UNMAPPED[key]}; supported: Adam, "
                         "AdamW, SGD, Adadelta")
    else:
        raise ValueError(f"Unsupported optimizer: {cfg.optimizer!r}; "
                         "supported: Adam, AdamW, SGD, Adadelta")
    return opt, schedule


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
    opt, schedule = make_optimizer(cfg, model.parameters())
    ema = None
    if cfg.exponential_moving_average:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model, opt, schedule, ema)


def select_criterion(cfg: Config):
    """Loss by input_type / output_distribution (reference: train.py:781-791)."""
    if cfg.is_mulaw_quantize:
        return lambda y_hat, y, mask: masked_cross_entropy(y_hat, y, mask)
    if cfg.output_distribution == "Logistic":
        return lambda y_hat, y, mask: masked_mol_loss(
            y_hat, y, mask, num_classes=cfg.quantize_channels,
            log_scale_min=cfg.log_scale_min)
    if cfg.output_distribution == "Normal":
        return lambda y_hat, y, mask: masked_gaussian_loss(
            y_hat, y, mask, log_scale_min=cfg.log_scale_min)
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


def make_train_step(cfg: Config):
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
    """
    criterion = select_criterion(cfg)
    # compute dtype below the head's output; "" is f32 throughout
    dtype = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None

    def loss_fn(model, batch, seed, train):
        x = batch["x"]
        y_hat = model(x, batch.get("c"), batch.get("g"), train=train,
                      dtype=dtype, seed=seed)
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
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss = loss_fn(model, batch, seed, True)
        loss.backward()
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        grad_norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        if cfg.clip_thresh > 0:
            # optax.clip_by_global_norm: scale by thresh / max(norm, thresh)
            thresh = float(cfg.clip_thresh)
            scale = thresh / torch.clamp(grad_norm, min=thresh)
            for g in grads:
                g.mul_(scale)
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        if state.ema is not None:
            ema_update(state.ema, model, cfg.ema_decay)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
                "lr": lr}

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Dev-set loss with the same criterion, no update, dropout off
        (reference: train.py:702-709)."""
        model = state.model
        batch = _on(batch, next(model.parameters()).device)
        model.eval()
        return {"loss": loss_fn(model, batch, None, False)}

    return train_step, eval_step
