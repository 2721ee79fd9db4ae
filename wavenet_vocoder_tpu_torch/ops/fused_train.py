"""The fused residual stack for training: weight packing, the counter-hash
dropout mask, the plain PyTorch forward and backward, and the
``FusedResStack`` autograd Function that joins them (or the CUDA kernels).

The port's counterpart of ``wavenet_vocoder_tpu/ops/pallas_train.py``. It
keeps the TPU kernels' function and drops their tiling: no time tiles,
carries, boundary stashes or VMEM pickers. What crosses from the forward to
the backward is every layer's input x_l in the storage dtype (the JAX
kernels' default ``xs_hbm`` stash); the backward recomputes z from it.

Numerics (kernel and plain version alike, and as the TPU kernels):
  * the residual chain x_l is carried in f32; x0, c, the weights and the
    x_l stash are in the storage dtype (bf16 or f32), biases and gb in f32;
  * conv input: round(x_l), under dropout round(round(x_l) * m / keep);
  * every product reads storage-dtype values and accumulates in f32;
  * gated = round(tanh(a) * sigmoid(b)); skips sum in f32;
  * backward: dgated = round(dy) @ w_og^T with dy = [dx_{l+1} * sqrt(1/2)
    | dskips]; the weight gradients and dx contract against round(dz);
    db_in and dgb sum f32 dz; db_og sums round(dy).

Dropout: the mask is a hash of (seed, batch row, absolute time + H, layer,
channel) with the JAX kernel's int32 arithmetic, so the forward and the
backward, kernel and plain version, draw the same bits as the JAX kernel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_M32 = 0xFFFFFFFF
_SQRT_HALF = math.sqrt(0.5)


def stack_receptive(dilations: Sequence[int], k: int) -> int:
    """H = sum((k-1) * d): the stack's history, and the dropout time key's
    offset."""
    return sum((k - 1) * d for d in dilations)


# ----------------------------------------------------------------------
# counter-hash dropout mask (bit-exact with pallas_train._mix_bits and
# dropout_mask)
# ----------------------------------------------------------------------
def mix_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> hashed uint32 values. torch's >> on
    int32 is arithmetic, so the uint32 arithmetic runs in int64; both
    multipliers are below 2^31, so the products stay inside int64."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x119DE1F3) & _M32
    return x ^ (x >> 16)


def keep_threshold(keep: float) -> int:
    """Keep iff the hash's top 24 bits are below this."""
    return min(int(keep * (1 << 24)), 1 << 24)


def dropout_mask(seed: int, *, B: int, T: int, R: int, L: int, l: int,
                 b0: int = 0, t0: int = 0, keep: float,
                 device=None) -> torch.Tensor:
    """f32 {0, 1} mask over a (B, T, R) tile whose row 0 is batch row b0
    and whose time 0 has key t0. Row key mix(b ^ seed); element
    mix(key ^ ((t*L + l)*R + r)); kept iff its top 24 bits < keep * 2^24."""
    b = torch.arange(B, dtype=torch.int64, device=device) + b0
    t = torch.arange(T, dtype=torch.int64, device=device) + t0
    r = torch.arange(R, dtype=torch.int64, device=device)
    bkey = mix_bits((b ^ (int(seed) & _M32)) & _M32)
    idx = ((t[:, None] * L + l) * R + r[None, :]) & _M32
    u = mix_bits(bkey[:, None, None] ^ idx[None])
    return ((u >> 8) < keep_threshold(keep)).float()


# ----------------------------------------------------------------------
# packing
# ----------------------------------------------------------------------
def _w1x1(conv) -> torch.Tensor:
    return conv.effective_weight()[:, :, 0].t()          # (In, Out)


def pack_block_weights(blocks, spec, dtype=torch.float32):
    """Stack the blocks' folded weights for the fused stack; differentiable,
    so gradients reach ``weight_g`` and ``weight_v``.

    Returns w_in (L, k*R, G) — row j*R + r is tap j (j=0 the oldest,
    (k-1-j)*d back) and input channel r — b_in (L, G), w_cond (L, cin, G)
    or None, w_og (L, G/2, R+S) = [out | skip], b_og (L, R+S). Weights in
    ``dtype``, biases f32."""
    k, R = spec.kernel_size, spec.residual_channels
    w_in = torch.stack([blk.conv.effective_weight().permute(2, 1, 0)
                        .reshape(k * R, -1) for blk in blocks]).to(dtype)
    b_in = torch.stack([blk.conv.bias for blk in blocks]).float()
    w_cond = None
    if spec.has_local_conditioning:
        w_cond = torch.stack([_w1x1(blk.conv1x1c) for blk in blocks]).to(dtype)
    w_og = torch.stack([torch.cat([_w1x1(blk.conv1x1_out),
                                   _w1x1(blk.conv1x1_skip)], dim=1)
                        for blk in blocks]).to(dtype)
    b_og = torch.stack([torch.cat([blk.conv1x1_out.bias,
                                   blk.conv1x1_skip.bias])
                        for blk in blocks]).float()
    return w_in, b_in, w_cond, w_og, b_og


# ----------------------------------------------------------------------
# the plain PyTorch versions of the kernels
# ----------------------------------------------------------------------
def _conv_input(xs_l: torch.Tensor, l: int, L: int, H: int, drop: float,
                seed: int) -> torch.Tensor:
    """Layer l's conv input in f32 from its stash: round(x_l), dropped."""
    x = xs_l.float()
    if drop <= 0:
        return x
    B, T, R = x.shape
    m = dropout_mask(seed, B=B, T=T, R=R, L=L, l=l, t0=H, keep=1.0 - drop,
                     device=x.device)
    return (x * (m * (1.0 / (1.0 - drop)))).to(xs_l.dtype).float()


def _taps(xin: torch.Tensor, d: int, k: int):
    """The k causal taps of xin (B, T, R): tap j is xin[t - (k-1-j)*d]."""
    T = xin.shape[1]
    xp = F.pad(xin, (0, 0, (k - 1) * d, 0))
    return [xp[:, j * d:j * d + T] for j in range(k)]


def _z(taps, cf, gb, w_in, b_in, w_cond, l: int):
    R = taps[0].shape[-1]
    z = b_in[l] if gb is None else b_in[l] + gb[l][:, None, :]
    for j, tap in enumerate(taps):
        z = z + tap @ w_in[l, j * R:(j + 1) * R].float()
    if cf is not None:
        z = z + cf @ w_cond[l].float()
    return z


def fused_res_stack_fwd_plain(x0, c, gb, w_in, b_in, w_cond, w_og, b_og, *,
                              dils: Sequence[int], k: int, drop: float = 0.0,
                              seed: int = 0):
    """What ``cuda_train.train_fwd`` computes, with torch ops: (skips
    (B, T, S) f32, xs (L, B, T, R) in the storage dtype = w_in.dtype)."""
    dtype = w_in.dtype
    L, (B, T, R) = len(dils), x0.shape
    H = stack_receptive(dils, k)
    G2 = w_og.shape[1]
    cf = None if c is None else c.float()
    x = x0.float()
    xs = []
    skips = torch.zeros(B, T, w_og.shape[2] - R, device=x0.device)
    for l, d in enumerate(dils):
        xs.append(x.to(dtype))
        z = _z(_taps(_conv_input(xs[l], l, L, H, drop, seed), d, k), cf, gb,
               w_in, b_in, w_cond, l)
        gated = (torch.tanh(z[..., :G2]) * torch.sigmoid(z[..., G2:])
                 ).to(dtype).float()
        y = gated @ w_og[l].float() + b_og[l]
        skips = skips + y[..., R:]
        x = (y[..., :R] + x) * _SQRT_HALF
    return skips, torch.stack(xs)


def fused_res_stack_bwd_plain(dskips, xs, c, gb, w_in, b_in, w_cond, w_og,
                              b_og, *, dils: Sequence[int], k: int,
                              drop: float = 0.0, seed: int = 0):
    """What ``cuda_train.train_bwd`` computes, written out (not autograd):
    (dx0, dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og), all f32; dc, dgb,
    dw_cond are None where c, gb are absent."""
    dtype = w_in.dtype
    rd = lambda a: a.to(dtype).float()
    L, B, T, R = xs.shape
    H = stack_receptive(dils, k)
    G = w_in.shape[2]
    G2 = G // 2
    cf = None if c is None else c.float()
    dw_in = torch.zeros(w_in.shape, device=xs.device)
    db_in = torch.zeros(b_in.shape, device=xs.device)
    dw_og = torch.zeros(w_og.shape, device=xs.device)
    db_og = torch.zeros(b_og.shape, device=xs.device)
    dw_cond = None if c is None else torch.zeros(w_cond.shape, device=xs.device)
    dgb = None if gb is None else torch.zeros(gb.shape, device=xs.device)
    dc = None if c is None else torch.zeros(c.shape, device=xs.device)
    dx = torch.zeros(B, T, R, device=xs.device)
    keep = 1.0 - drop
    for l in range(L - 1, -1, -1):
        d = dils[l]
        taps = _taps(_conv_input(xs[l], l, L, H, drop, seed), d, k)
        z = _z(taps, cf, gb, w_in, b_in, w_cond, l)
        ta, sb = torch.tanh(z[..., :G2]), torch.sigmoid(z[..., G2:])
        gated = rd(ta * sb)
        dy_out = dx * _SQRT_HALF
        dyr = rd(torch.cat([dy_out, dskips], dim=-1))
        dgated = dyr @ w_og[l].float().t()
        dz = torch.cat([dgated * sb * (1.0 - ta * ta),
                        dgated * ta * sb * (1.0 - sb)], dim=-1)
        dzr = rd(dz)
        dz2, dzr2 = dz.reshape(-1, G), dzr.reshape(-1, G)
        for j, tap in enumerate(taps):
            dw_in[l, j * R:(j + 1) * R] = tap.reshape(-1, R).t() @ dzr2
        db_in[l] = dz2.sum(0)
        if dgb is not None:
            dgb[l] = dz.sum(1)
        if c is not None:
            dw_cond[l] = cf.reshape(-1, cf.shape[-1]).t() @ dzr2
            dc = dc + dzr @ w_cond[l].float().t()
        dw_og[l] = gated.reshape(-1, G2).t() @ dyr.reshape(-1, dyr.shape[-1])
        db_og[l] = dyr.reshape(-1, dyr.shape[-1]).sum(0)
        dzp = F.pad(dzr, (0, 0, 0, (k - 1) * d))
        dxin = 0.0
        for j in range(k):
            sh = (k - 1 - j) * d
            dxin = dxin + dzp[:, sh:sh + T] @ w_in[l, j * R:(j + 1) * R].float().t()
        if drop > 0:
            m = dropout_mask(seed, B=B, T=T, R=R, L=L, l=l, t0=H, keep=keep,
                             device=xs.device)
            dxin = dxin * (m * (1.0 / keep))
        dx = dy_out + dxin
    return dx, dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og


# ----------------------------------------------------------------------
# the autograd Function
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class StackStatics:
    """Non-tensor arguments of the fused stack."""
    dils: Tuple[int, ...]
    k: int
    drop: float = 0.0
    seed: int = 0


def _impl(device: torch.device):
    """The kernels for CUDA tensors, the plain versions for CPU tensors."""
    if device.type == "cuda":
        from wavenet_vocoder_tpu_torch.ops import cuda_train
        return cuda_train.train_fwd, cuda_train.train_bwd
    if device.type == "cpu":
        return fused_res_stack_fwd_plain, fused_res_stack_bwd_plain
    raise ValueError(f"no fused training stack for device {device}")


class FusedResStack(torch.autograd.Function):
    """skips = stack(x0, c, gb, weights); the backward is the backward
    kernel (or its plain version), not autograd of the forward. Inputs as
    ``cuda_train.train_fwd``; the gradients come back in their inputs'
    dtypes (the JAX custom VJP casts them the same way)."""

    @staticmethod
    def forward(ctx, x0, c, gb, w_in, b_in, w_cond, w_og, b_og,
                st: StackStatics):
        fwd, _ = _impl(x0.device)
        skips, xs = fwd(x0, c, gb, w_in, b_in, w_cond, w_og, b_og,
                        dils=st.dils, k=st.k, drop=st.drop, seed=st.seed)
        ctx.st = st
        ctx.save_for_backward(xs, c, gb, w_in, b_in, w_cond, w_og, b_og)
        return skips

    @staticmethod
    def backward(ctx, dskips):
        xs, c, gb, w_in, b_in, w_cond, w_og, b_og = ctx.saved_tensors
        st = ctx.st
        _, bwd = _impl(xs.device)
        grads = bwd(dskips.float().contiguous(), xs, c, gb, w_in, b_in,
                    w_cond, w_og, b_og, dils=st.dils, k=st.k, drop=st.drop,
                    seed=st.seed)
        like = (xs, c, gb, w_in, b_in, w_cond, w_og, b_og)
        return tuple(None if g is None else g.to(a.dtype)
                     for g, a in zip(grads, like)) + (None,)


def fused_res_stack(x0: torch.Tensor, c: Optional[torch.Tensor], blocks,
                    spec, *, g: Optional[torch.Tensor] = None,
                    dtype=torch.bfloat16, dropout: float = 0.0,
                    seed: Optional[int] = None) -> torch.Tensor:
    """The whole residual stack fused; returns skips (B, T, S) f32.

    x0: (B, T, R) first_conv output; c: (B, T, cin) sample-rate
    conditioning or None; blocks: the model's ``conv_layers``; g: (B, gin)
    embedded global conditioning or None, whose time-constant projection
    ``g @ w_cond_g`` enters as a per-layer bias (L, B, G) computed here, so
    its gradient reaches the cond_g weights through autograd. dropout > 0
    needs an int32 ``seed`` (one per step)."""
    if c is None and spec.has_local_conditioning:
        raise ValueError("spec has local conditioning but c is None")
    drop = float(dropout)
    if drop > 0 and seed is None:
        raise ValueError("fused_res_stack: dropout > 0 requires a seed")
    w_in, b_in, w_cond, w_og, b_og = pack_block_weights(blocks, spec, dtype)
    gb = None
    if g is not None:
        gb = torch.stack([g.float() @ _w1x1(blk.conv1x1g).float()
                          for blk in blocks]).contiguous()
    st = StackStatics(dils=tuple(spec.dilations), k=spec.kernel_size,
                      drop=drop, seed=0 if seed is None else int(seed))
    cont = lambda a: None if a is None else a.contiguous()
    return FusedResStack.apply(
        x0.to(dtype).contiguous(), cont(None if c is None else c.to(dtype)),
        gb, w_in.contiguous(), b_in.contiguous(), cont(w_cond),
        w_og.contiguous(), b_og.contiguous(), st)
