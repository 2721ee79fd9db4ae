"""ctypes wrappers of the residual-stack training kernels.

``train_fwd`` launches ``csrc/train_fwd.cu`` once per layer and
``train_bwd`` launches the three kernels of ``csrc/train_bwd.cu`` per layer,
top layer first. Both take CUDA tensors only and have the signatures of
their plain versions in ``ops/fused_train.py``, which ``FusedResStack``
uses for CPU tensors. Outputs and scratch are allocated here with
``torch.empty`` (accumulated outputs with ``torch.zeros``); the kernels run
on the current stream and do not synchronise. Each wrapper counts its
kernel launches in ``.launches``.

Importing this module builds nothing: the sources compile with nvcc at the
first launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from wavenet_vocoder_tpu_torch.ops.fused_train import (
    keep_threshold,
    stack_receptive,
)

_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p


class TrainArgs(ctypes.Structure):
    """Mirror of ``struct TrainArgs`` in ``csrc/train_common.cuh``."""
    _fields_ = ([(n, _P) for n in (
        "xs_l", "xres", "xnext", "xs_next", "c", "gb", "w_in", "b_in",
        "w_cond", "w_og", "b_og", "skips", "dskips", "dx_next", "dx_out",
        "dz", "gated", "w_in_t", "w_og_t", "w_cond_t", "dc", "dgb", "dw_in",
        "db_in", "dw_cond", "dw_og", "db_og")]
        + [(n, ctypes.c_int) for n in (
            "B", "T", "R", "G", "S", "cin", "k", "d", "L", "l", "H",
            "has_drop")]
        + [("seed", ctypes.c_uint), ("thresh", ctypes.c_uint),
           ("inv_keep", ctypes.c_float), ("bf16", ctypes.c_int),
           ("chunk", ctypes.c_int)])


def _fn(source: str, name: str):
    from wavenet_vocoder_tpu_torch.kernels.build import load
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(TrainArgs), _P]
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, args: TrainArgs, device: torch.device, what: str) -> None:
    with torch.cuda.device(device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


def _check(name: str, a: Optional[torch.Tensor], shape, dtype, device) -> None:
    if a is None:
        return
    if tuple(a.shape) != tuple(shape) or a.dtype != dtype:
        raise ValueError(f"{name}: {tuple(a.shape)} {a.dtype}, expected "
                         f"{tuple(shape)} {dtype}")
    if a.device != device:
        raise ValueError(f"{name}: on {a.device}, expected {device}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _common(w_in, b_in, w_cond, w_og, b_og, c, gb, *, B, T, dils, k, drop,
            seed) -> TrainArgs:
    """Check the weights and conditioning; fill the fields both sides share."""
    device, dtype = w_in.device, w_in.dtype
    if device.type != "cuda":
        raise ValueError(f"the training kernels need CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"storage dtype {dtype} not supported")
    L, kR, G = w_in.shape
    R = kR // k
    G2 = G // 2
    S = w_og.shape[2] - R
    cin = 0 if c is None else c.shape[2]
    if len(dils) != L or kR != k * R or G % 2:
        raise ValueError("w_in must be (L, k*R, G) with one dilation per "
                         "layer and G even")
    _check("w_in", w_in, (L, kR, G), dtype, device)
    _check("b_in", b_in, (L, G), torch.float32, device)
    _check("w_og", w_og, (L, G2, R + S), dtype, device)
    _check("b_og", b_og, (L, R + S), torch.float32, device)
    if (c is None) != (w_cond is None):
        raise ValueError("c and w_cond must be given together")
    _check("c", c, (B, T, cin), dtype, device)
    _check("w_cond", w_cond, (L, cin, G), dtype, device)
    _check("gb", gb, (L, B, G), torch.float32, device)
    if not 0.0 <= drop < 1.0:
        raise ValueError(f"dropout {drop} outside [0, 1)")
    keep = 1.0 - drop
    return TrainArgs(
        c=_ptr(c), gb=_ptr(gb), w_in=_ptr(w_in), b_in=_ptr(b_in),
        w_cond=_ptr(w_cond), w_og=_ptr(w_og), b_og=_ptr(b_og),
        B=B, T=T, R=R, G=G, S=S, cin=cin, k=k, L=L,
        H=stack_receptive(dils, k), has_drop=int(drop > 0),
        seed=int(seed) & _M32, thresh=keep_threshold(keep),
        inv_keep=1.0 / keep, bf16=int(dtype == torch.bfloat16))


def train_fwd(x0: torch.Tensor, c: Optional[torch.Tensor],
              gb: Optional[torch.Tensor], w_in: torch.Tensor,
              b_in: torch.Tensor, w_cond: Optional[torch.Tensor],
              w_og: torch.Tensor, b_og: torch.Tensor, *, dils: Sequence[int],
              k: int, drop: float = 0.0, seed: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of the stack: (skips (B, T, S) f32, xs (L, B, T, R)), where
    xs[l] is layer l's input in the storage dtype (the backward's stash).
    x0, c and the weights are in the storage dtype, b_in, b_og, gb f32."""
    B, T, R = x0.shape
    args = _common(w_in, b_in, w_cond, w_og, b_og, c, gb, B=B, T=T,
                   dils=dils, k=k, drop=drop, seed=seed)
    _check("x0", x0, (B, T, args.R), w_in.dtype, w_in.device)
    L = args.L
    dev = x0.device
    xs = torch.empty(L, B, T, R, dtype=x0.dtype, device=dev)
    xs[0].copy_(x0)
    skips = torch.zeros(B, T, args.S, dtype=torch.float32, device=dev)
    carry = [torch.empty(B, T, R, dtype=torch.float32, device=dev)
             for _ in range(2 if L > 1 else 0)]
    fn = _fn("train_fwd", "wn_train_fwd_layer")
    args.skips = _ptr(skips)
    for l, d in enumerate(dils):
        last = l == L - 1
        args.l, args.d = l, d
        args.xs_l = _ptr(xs[l])
        args.xres = None if l == 0 else _ptr(carry[(l - 1) % 2])
        args.xnext = None if last else _ptr(carry[l % 2])
        args.xs_next = None if last else _ptr(xs[l + 1])
        _launch(fn, args, dev, "train_fwd")
        train_fwd.launches += 1
    return skips, xs


train_fwd.launches = 0


def _wgrad_chunk(B: int, T: int, tiles: int, device) -> int:
    """Positions per weight-gradient block: about four blocks per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = max(1, (4 * sms) // max(tiles, 1))
    return max(16, -(-(B * T) // chunks))


def train_bwd(dskips: torch.Tensor, xs: torch.Tensor,
              c: Optional[torch.Tensor], gb: Optional[torch.Tensor],
              w_in: torch.Tensor, b_in: torch.Tensor,
              w_cond: Optional[torch.Tensor], w_og: torch.Tensor,
              b_og: torch.Tensor, *, dils: Sequence[int], k: int,
              drop: float = 0.0, seed: int = 0):
    """Backward of the stack from dskips (B, T, S) f32 and the forward's
    stash xs. Returns (dx0, dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og),
    all f32; dc, dgb and dw_cond are None where c, gb are absent. The
    weight and bias gradients are f32 atomic sums."""
    L, B, T, R = xs.shape
    args = _common(w_in, b_in, w_cond, w_og, b_og, c, gb, B=B, T=T,
                   dils=dils, k=k, drop=drop, seed=seed)
    dev, dtype = xs.device, w_in.dtype
    _check("xs", xs, (L, B, T, args.R), dtype, dev)
    _check("dskips", dskips, (B, T, args.S), torch.float32, dev)
    G, S, cin = args.G, args.S, args.cin
    G2 = G // 2
    f32 = dict(dtype=torch.float32, device=dev)
    dx = [torch.empty(B, T, R, **f32) for _ in range(2)]
    dz = torch.empty(B, T, G, dtype=dtype, device=dev)
    gated = torch.empty(B, T, G2, dtype=dtype, device=dev)
    dc = torch.zeros(B, T, cin, **f32) if c is not None else None
    dgb = torch.zeros(L, B, G, **f32) if gb is not None else None
    dw_in = torch.zeros(L, k * R, G, **f32)
    db_in = torch.zeros(L, G, **f32)
    dw_cond = torch.zeros(L, cin, G, **f32) if c is not None else None
    dw_og = torch.zeros(L, G2, R + S, **f32)
    db_og = torch.zeros(L, R + S, **f32)
    # the products that read a weight transposed get a transposed copy
    w_in_t = w_in.view(L, k, R, G).transpose(2, 3).contiguous()
    w_og_t = w_og.transpose(1, 2).contiguous()
    w_cond_t = None if w_cond is None else w_cond.transpose(1, 2).contiguous()
    up = lambda n, m: -(-n // m)
    # output tiles (64 rows x 128 columns) of dW_in, dW_cond and dW_og
    tiles = ((up(k * R, 64) + up(cin, 64)) * up(G, 128)
             + up(G2, 64) * up(R + S, 128))
    args.chunk = _wgrad_chunk(B, T, tiles, dev)
    for name, a in (("dskips", dskips), ("dz", dz), ("gated", gated),
                    ("w_in_t", w_in_t), ("w_og_t", w_og_t),
                    ("w_cond_t", w_cond_t), ("dc", dc), ("dgb", dgb),
                    ("dw_in", dw_in), ("db_in", db_in), ("dw_cond", dw_cond),
                    ("dw_og", dw_og), ("db_og", db_og)):
        setattr(args, name, _ptr(a))
    kernels = [_fn("train_bwd", n) for n in
               ("wn_train_bwd_dz", "wn_train_bwd_wgrad", "wn_train_bwd_dx")]
    for l in range(L - 1, -1, -1):
        args.l, args.d = l, dils[l]
        args.xs_l = _ptr(xs[l])
        args.dx_next = None if l == L - 1 else _ptr(dx[(l + 1) % 2])
        args.dx_out = _ptr(dx[l % 2])
        for fn in kernels:
            _launch(fn, args, dev, "train_bwd")
            train_bwd.launches += 1
    return dx[0], dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og


train_bwd.launches = 0
