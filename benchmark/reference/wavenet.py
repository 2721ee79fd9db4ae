"""Plain PyTorch WaveNet: the benchmark's reference.

Written from the published description (van den Oord et al. 2016, and
r9y9/wavenet_vocoder's ``wavenet.py``, ``modules.py``, ``upsample.py`` and
``mixture.py``): weight-normed 1x1 and dilated causal convolutions, gated
residual blocks with local conditioning, the skip head, a mel upsampler of
one unpadded context conv and nearest-neighbour stretches each smoothed by a
(1, 2s+1) conv, the discretized MoL likelihood, Adam and the EMA shadow.
The input is a raw (or mu-law) sample or, for ``mulaw-quantize``, the
one-hot of a mu-law code; the head is a mixture of logistics, a (mixture
of) Gaussian(s) or a categorical over the codes (``head``), each with its
sampler's candidates.

It imports nothing but torch: no JAX and nothing of the program under test.
Parameters are a dict of tensors under the names of the program's state dict
(``param_shapes`` lists them), so the harness hands one set of weights to
both. The harness builds them itself; nothing the program derived from them
(packs, folded weights) is read here.

``q`` is the rounding applied to both inputs of every product: identity for
the f32 reference, ``fp8`` for the lower-precision control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]

FP8_MAX = 448.0      # largest finite float8_e4m3fn


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (its largest magnitude
    maps to 448), as an fp8 product's operand would be; the gradient passes
    straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    y = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (y - x.detach())


def dilations(cfg: dict) -> List[int]:
    per_stack = cfg["layers"] // cfg["stacks"]
    return [2 ** (i % per_stack) for i in range(cfg["layers"])]


def in_channels(cfg: dict) -> int:
    """The network's input channels: 1 for a scalar input (``raw``,
    ``mulaw``), the one-hot's ``quantize_channels`` for ``mulaw-quantize``."""
    scalar = cfg["input_type"] in ("raw", "mulaw")
    return 1 if scalar else cfg["quantize_channels"]


def head(cfg: dict) -> str:
    """The head the configuration serves: ``categorical`` over the codes of
    a one-hot input, else ``mol`` (Logistic) or ``gaussian`` (Normal)."""
    if in_channels(cfg) > 1:
        return "categorical"
    heads = {"Logistic": "mol", "Normal": "gaussian"}
    return heads[cfg["output_distribution"]]


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter, in the program's state-dict names."""
    R, G, S = (cfg["residual_channels"], cfg["gate_channels"],
               cfg["skip_out_channels"])
    k, cin, out = cfg["kernel_size"], cfg["cin_channels"], cfg["out_channels"]
    shapes = {}

    def wn(name, o, i, kk=1, bias=True):
        shapes[f"{name}.weight_v"] = (o, i, kk)
        shapes[f"{name}.weight_g"] = (o, 1, 1)
        if bias:
            shapes[f"{name}.bias"] = (o,)

    wn("first_conv", R, in_channels(cfg))
    for l in range(cfg["layers"]):
        wn(f"conv_layers.{l}.conv", G, R, k)
        wn(f"conv_layers.{l}.conv1x1c", G, cin, bias=False)
        wn(f"conv_layers.{l}.conv1x1_out", R, G // 2)
        wn(f"conv_layers.{l}.conv1x1_skip", S, G // 2)
    wn("last_conv_layers.1", S, S)
    wn("last_conv_layers.3", out, S)
    wn("upsample_net.conv_in", cin, cin, 2 * cfg["cin_pad"] + 1, bias=False)
    for i, s in enumerate(cfg["upsample_params"]["upsample_scales"]):
        name = f"upsample_net.upsample.up_layers.{2 * i + 1}"
        shapes[f"{name}.weight_v"] = (1, 1, 1, 2 * s + 1)
        shapes[f"{name}.weight_g"] = (1, 1, 1, 1)
    return shapes


def weight(p: Params, name: str) -> torch.Tensor:
    """g * v / ||v||, the norm over every axis but the first."""
    v, g = p[f"{name}.weight_v"], p[f"{name}.weight_g"]
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())),
                                keepdim=True))
    return g * v / norm


def _dense(p: Params, name: str, x: torch.Tensor, q: Quant,
           bias: bool = True) -> torch.Tensor:
    """1x1 conv over the last axis: (..., In) -> (..., Out)."""
    w = weight(p, name)[:, :, 0]
    y = q(x) @ q(w).t()
    return y + p[f"{name}.bias"] if bias else y


def conditioning(p: Params, cfg: dict, mel: torch.Tensor,
                 q: Quant = identity) -> torch.Tensor:
    """mel (B, T_mel, C) with cin_pad context frames on each side ->
    (B, (T_mel - 2 cin_pad) * hop, C) at the sample rate."""
    x = F.conv1d(q(mel.transpose(1, 2)), q(weight(p, "upsample_net.conv_in")))
    x = x.unsqueeze(1)                                   # (B, 1, C, T)
    for i, s in enumerate(cfg["upsample_params"]["upsample_scales"]):
        x = torch.repeat_interleave(x, s, dim=-1)
        w = weight(p, f"upsample_net.upsample.up_layers.{2 * i + 1}")
        x = F.conv2d(q(x), q(w), padding=(0, s))
    return x[:, 0].transpose(1, 2)


def forward(p: Params, cfg: dict, x: torch.Tensor, c: torch.Tensor,
            q: Quant = identity) -> torch.Tensor:
    """Teacher-forced network: inputs x (B, T, in_channels), a scalar
    sample or the one-hot of a mu-law code (``first_conv`` is a 1x1 conv,
    ``_dense``, either way), conditioning c (B, T, C) at the sample rate ->
    head output (B, T, out_channels)."""
    k = cfg["kernel_size"]
    h = _dense(p, "first_conv", x, q)
    skips = 0.0
    for l, d in enumerate(dilations(cfg)):
        name = f"conv_layers.{l}"
        hin = F.pad(h.transpose(1, 2), ((k - 1) * d, 0))
        z = F.conv1d(q(hin), q(weight(p, f"{name}.conv")),
                     p[f"{name}.conv.bias"], dilation=d).transpose(1, 2)
        z = z + _dense(p, f"{name}.conv1x1c", c, q, bias=False)
        a, b = z.chunk(2, dim=-1)
        gated = torch.tanh(a) * torch.sigmoid(b)
        skips = skips + _dense(p, f"{name}.conv1x1_skip", gated, q)
        h = (_dense(p, f"{name}.conv1x1_out", gated, q) + h) * math.sqrt(0.5)
    out = torch.relu(skips * math.sqrt(1.0 / cfg["layers"]))
    out = torch.relu(_dense(p, "last_conv_layers.1", out, q))
    return _dense(p, "last_conv_layers.3", out, q)


def mol_split(o: torch.Tensor, log_scale_min: float):
    n = o.shape[-1] // 3
    return (o[..., :n], o[..., n:2 * n],
            torch.clamp(o[..., 2 * n:], min=log_scale_min))


# ----------------------------------------------------------------------
# the sampler's random numbers
# ----------------------------------------------------------------------
M32 = 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit integer hash the served sampler keys its draws with
    (int64 tensors holding uint32 values; both multipliers are under 2^31,
    so the products fit)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & M32
    return x ^ (x >> 16)


def counter_uniforms(seed: int, row: int, t0: int, T: int, draws: int,
                     device=None) -> torch.Tensor:
    """The uniforms of steps [t0, t0 + T) of stream ``row`` under ``seed``:
    (T, draws) f32 in [1e-5, 1 - 1e-5]. Step t's key is
    mix(mix(mix(seed) ^ row) ^ t), draw d's 24 bits are mix(key ^ d) >> 8.
    A mixture step draws one Gumbel per component (draws 0..n-1), then one
    uniform for the logistic's inverse CDF (draw n) or two for the
    Gaussian's Box-Muller normal (draws n, n + 1; 0 and 1 for a single
    Gaussian); a categorical step one Gumbel per class (draws 0..C-1)."""
    i64 = dict(dtype=torch.int64, device=device)
    k0 = mix32(torch.tensor(seed & M32, **i64))
    t = (torch.arange(t0, t0 + T, **i64) & M32)
    keys = mix32(mix32(k0 ^ row) ^ t)
    bits = mix32(keys[:, None] ^ torch.arange(draws, **i64)[None]) >> 8
    u = bits.to(torch.float32) * (1.0 / (1 << 24))
    return u.clamp(1e-5, 1.0 - 1e-5)


def _gumbel(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return logits - torch.log(-torch.log(u[..., :logits.shape[-1]]))


def mol_candidates(o: torch.Tensor, log_scale_min: float,
                   u: torch.Tensor = None):
    """Each component's (score, value) at every step: greedy (``u`` None)
    the logit and the clipped mean; sampled, the Gumbel-perturbed logit
    and the clipped logistic draw mean + exp(log_scale) * logit(u_n)."""
    logits, means, log_scales = mol_split(o, log_scale_min)
    if u is None:
        return logits, means.clamp(-1.0, 1.0)
    n = logits.shape[-1]
    score = _gumbel(logits, u)
    un = u[..., n:n + 1]
    draw = means + torch.exp(log_scales) * (torch.log(un) - torch.log(1.0 - un))
    return score, draw.clamp(-1.0, 1.0)


def categorical_candidates(o: torch.Tensor, u: torch.Tensor = None):
    """Each class's (score, value) at every step: the logit, Gumbel-perturbed
    by draw c when sampled (``OneHotCategorical`` of the softmax, drawn by
    Gumbel-max), and the class's code."""
    score = o if u is None else _gumbel(o, u)
    value = torch.arange(o.shape[-1], device=o.device,
                         dtype=o.dtype).expand_as(o)
    return score, value


def gaussian_split(o: torch.Tensor):
    """(logits, means, log_stds): a mixture packs [logits, means, log_stds];
    a single Gaussian [mean, log_std] in 2 channels, its one logit 0."""
    if o.shape[-1] == 2:
        return torch.zeros_like(o[..., :1]), o[..., :1], o[..., 1:2]
    n = o.shape[-1] // 3
    return o[..., :n], o[..., n:2 * n], o[..., 2 * n:3 * n]


def gaussian_candidates(o: torch.Tensor, u: torch.Tensor = None):
    """Each component's (score, value), after r9y9's
    ``sample_from_mix_gaussian``: greedy, the logit and the clipped mean;
    sampled, the Gumbel-perturbed logit and clip(mean + exp(log_std) * z),
    z a standard normal. The published sampler applies no floor to log_std
    (its ``log_scale_min`` is unused), and neither does this. z is
    Box-Muller's sqrt(-2 ln u_a) cos(2 pi u_b) from the two draws after a
    mixture's Gumbels, draws 0 and 1 for a single Gaussian (whose one
    candidate's score is beside the point)."""
    logits, means, log_stds = gaussian_split(o)
    if u is None:
        return logits, means.clamp(-1.0, 1.0)
    d0 = 0 if o.shape[-1] == 2 else logits.shape[-1]
    ua, ub = u[..., d0:d0 + 1], u[..., d0 + 1:d0 + 2]
    z = torch.sqrt(-2.0 * torch.log(ua)) * torch.cos(2.0 * math.pi * ub)
    draw = means + torch.exp(log_stds) * z
    return _gumbel(logits, u), draw.clamp(-1.0, 1.0)


def draws(cfg: dict) -> int:
    """Uniforms a sampled step of the configuration's head draws."""
    C, h = cfg["out_channels"], head(cfg)
    if h == "categorical":
        return C
    if h == "gaussian":
        return 2 if C == 2 else C // 3 + 2
    return C // 3 + 1


def candidates(cfg: dict, o: torch.Tensor, u: torch.Tensor = None):
    """(score, value) of every candidate of the configuration's head."""
    h = head(cfg)
    if h == "mol":
        return mol_candidates(o, cfg["log_scale_min"], u)
    if h == "gaussian":
        return gaussian_candidates(o, u)
    return categorical_candidates(o, u)


def sample(cfg: dict, o: torch.Tensor, u: torch.Tensor = None
           ) -> torch.Tensor:
    """The sample of each step: the value of the best-scoring candidate (a
    code for the categorical head)."""
    score, value = candidates(cfg, o, u)
    k = score.argmax(-1, keepdim=True)
    return torch.gather(value, -1, k)[..., 0]


def mol_nll(o: torch.Tensor, y: torch.Tensor, num_classes: int,
            log_scale_min: float) -> torch.Tensor:
    """Discretized mixture-of-logistics negative log-likelihood of targets y
    (..., 1) in [-1, 1] under head output o (..., 3n); per element."""
    logits, means, log_scales = mol_split(o, log_scale_min)
    centered = y - means
    inv_s = torch.exp(-log_scales)
    half_bin = 1.0 / (num_classes - 1)
    plus = inv_s * (centered + half_bin)
    minus = inv_s * (centered - half_bin)
    cdf_delta = torch.sigmoid(plus) - torch.sigmoid(minus)
    log_cdf_plus = plus - F.softplus(plus)           # the lowest bin
    log_one_minus_cdf_min = -F.softplus(minus)       # the highest bin
    mid = inv_s * centered
    log_pdf_mid = mid - log_scales - 2.0 * F.softplus(mid)
    inner = torch.where(cdf_delta > 1e-5,
                        torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid - math.log((num_classes - 1) / 2.0))
    log_probs = torch.where(y < -0.999, log_cdf_plus,
                            torch.where(y > 0.999, log_one_minus_cdf_min,
                                        inner))
    log_probs = log_probs + torch.log_softmax(logits, dim=-1)
    return -torch.logsumexp(log_probs, dim=-1)


def _mask(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Which targets y[t+1] lie inside each row's valid length."""
    T = batch["x"].shape[1]
    t = torch.arange(T, device=batch["x"].device)[None]
    return (t < batch["input_lengths"].long()[:, None]).float()[:, 1:]


def train_loss(p: Params, cfg: dict, batch: Dict[str, torch.Tensor],
               q: Quant = identity, count=None) -> torch.Tensor:
    """Masked NLL of y[t+1] given x[..t] over each row's valid length,
    summed over the rows and divided by ``count`` (by default the rows'
    own count of targets: their mean)."""
    x, y = batch["x"].float(), batch["y"].float()
    o = forward(p, cfg, x, conditioning(p, cfg, batch["c"].float(), q), q)
    nll = mol_nll(o[:, :-1], y[:, 1:], cfg["quantize_channels"],
                  cfg["log_scale_min"])
    mask = _mask(batch)
    return torch.sum(nll * mask) / (torch.sum(mask) if count is None
                                    else count)


def batch_grads(p: Params, names: List[str], cfg: dict, batch: dict,
                q: Quant = identity, rows: int = 8):
    """The masked mean loss of ``batch`` and its gradient, summed over
    blocks of ``rows`` rows so that the activations of one block at a time
    are held."""
    count = torch.sum(_mask(batch))
    B = batch["x"].shape[0]
    loss, grads = 0.0, {n: torch.zeros_like(p[n]) for n in names}
    for a in range(0, B, rows):
        part = {k: v[a:a + rows] for k, v in batch.items()}
        leaves = {n: p[n].detach().requires_grad_(True) for n in names}
        block = train_loss(leaves, cfg, part, q, count)
        got = torch.autograd.grad(block, [leaves[n] for n in names],
                                  allow_unused=True)
        for n, g in zip(names, got):
            if g is not None:
                grads[n] += g
        loss += float(block.detach())
        del block, got, leaves
    return loss, grads


def adam_steps(p0: Params, cfg: dict, batches: Sequence[dict],
               q: Quant = identity) -> dict:
    """Adam (bias-corrected, torch.optim.Adam's update) and the EMA shadow
    over ``batches`` from the parameters ``p0``, with the config's
    step-decay learning rate. Returns each step's loss, the first step's
    gradient, and the parameters and the shadow after the last step."""
    opt = cfg["optimizer_params"]
    lr0, eps = float(opt["lr"]), float(opt["eps"])
    b1, b2 = 0.9, 0.999
    sched = cfg["lr_schedule_kwargs"]
    decay = float(cfg["ema_decay"])
    names = list(p0)
    p = {n: t.detach().clone().float() for n, t in p0.items()}
    ema = {n: t.clone() for n, t in p.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, grad1 = [], None
    for step, batch in enumerate(batches):
        loss, grads = batch_grads(p, names, cfg, batch, q)
        if grad1 is None:
            grad1 = {n: g.clone() for n, g in grads.items()}
        losses.append(loss)
        lr = lr0 * sched["anneal_rate"] ** (step // sched["anneal_interval"])
        t = step + 1
        with torch.no_grad():
            for n in names:
                g = grads[n]
                m[n] = b1 * m[n] + (1 - b1) * g
                v[n] = b2 * v[n] + (1 - b2) * g * g
                denom = torch.sqrt(v[n]) / math.sqrt(1 - b2 ** t) + eps
                p[n] = p[n].detach() - (lr / (1 - b1 ** t)) * m[n] / denom
                ema[n] = ema[n] - (1 - decay) * (ema[n] - p[n])
        del grads
    return {"losses": losses, "grad1": grad1,
            "params": {n: t.detach() for n, t in p.items()}, "ema": ema}
