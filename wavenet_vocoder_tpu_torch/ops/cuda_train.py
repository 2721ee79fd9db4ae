"""ctypes wrappers of the residual-stack training kernels.

``train_fwd`` launches ``csrc/train_fwd.cu`` once per layer and
``train_bwd`` launches the three kernels of ``csrc/train_bwd.cu`` per layer,
top layer first. Both take CUDA tensors only and have the signatures of
their plain versions in ``ops/fused_train.py``, which ``FusedResStack``
uses for CPU tensors. Outputs and scratch are allocated here with
``torch.empty`` (accumulated outputs with ``torch.zeros``); the kernels run
on the current stream and do not synchronise. The weights go to the kernels
as stored: no transposed or padded copies.

The kernels dispatch by storage dtype: bf16 (the training path) runs the
tensor-core kernels, f32 the FMA-tile kernels. Each wrapper counts its
kernel launches in ``.launches`` and, split by design, in ``.tc_launches``
(bf16) and ``.fma_launches`` (f32).

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
# variant build: the products compiled out (a timing aid; outputs mean nothing)
NO_PRODUCTS = ("WN_NO_PRODUCTS",)


class TrainArgs(ctypes.Structure):
    """Mirror of ``struct TrainArgs`` in ``csrc/train_common.cuh``."""
    _fields_ = ([(n, _P) for n in (
        "xs_l", "xres", "xnext", "xs_next", "c", "gb", "w_in", "b_in",
        "w_cond", "w_og", "b_og", "skips", "dskips", "dx_next", "dx_out",
        "dz", "gated", "dyr", "dc", "dgb", "dw_in",
        "db_in", "dw_cond", "dw_og", "db_og")]
        + [(n, ctypes.c_int) for n in (
            "B", "T", "R", "G", "S", "cin", "k", "d", "L", "l", "H",
            "has_drop")]
        + [("seed", ctypes.c_uint), ("thresh", ctypes.c_uint),
           ("inv_keep", ctypes.c_float), ("bf16", ctypes.c_int),
           ("chunk", ctypes.c_int)])


def _fn(source: str, name: str, defines: Tuple[str, ...] = ()):
    from wavenet_vocoder_tpu_torch.kernels.build import load
    fn = getattr(load(source, defines), name)
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
    if dtype == torch.bfloat16 and (R % 8 or G % 16 or S % 2):
        raise ValueError(f"the bf16 training kernels need R % 8 == 0, "
                         f"G % 16 == 0 and S even, got R={R}, G={G}, S={S}")
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
              k: int, drop: float = 0.0, seed: int = 0,
              _defines: Tuple[str, ...] = ()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of the stack: (skips (B, T, S) f32, xs (L, B, T, R)), where
    xs[l] is layer l's input in the storage dtype (the backward's stash).
    x0, c and the weights are in the storage dtype, b_in, b_og, gb f32.
    ``_defines`` launches a variant build (``NO_PRODUCTS``)."""
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
    fn = _fn("train_fwd", "wn_train_fwd_layer", tuple(_defines))
    args.skips = _ptr(skips)
    for l, d in enumerate(dils):
        last = l == L - 1
        args.l, args.d = l, d
        args.xs_l = _ptr(xs[l])
        args.xres = None if l == 0 else _ptr(carry[(l - 1) % 2])
        args.xnext = None if last else _ptr(carry[l % 2])
        args.xs_next = None if last else _ptr(xs[l + 1])
        _launch(fn, args, dev, "train_fwd")
        _count(train_fwd, args)
    return skips, xs


def _count(wrapper, args: TrainArgs) -> None:
    wrapper.launches += 1
    if args.bf16:
        wrapper.tc_launches += 1
    else:
        wrapper.fma_launches += 1


train_fwd.launches = train_fwd.tc_launches = train_fwd.fma_launches = 0

# Output tiles of the weight-gradient kernel (rows x columns) and the blocks
# it keeps in flight per SM: the tensor-core kernel (bf16) and the FMA tiles
# (f32).
WGRAD_TILE = {True: (64, 256), False: (64, 128)}
WGRAD_BLOCKS_PER_SM = {True: 2, False: 4}
WGRAD_STAGE = 32          # positions a stage of bwd_wgrad_tc holds


def wgrad_tiles(k: int, R: int, G: int, S: int, cin: int, bf16: bool):
    """The output tiles of dW_in (k*R x G), dW_cond (cin x G) and dW_og
    (G/2 x (R+S)) in the order blockIdx.x enumerates them: a list of
    (which, row0, col0), which 0, 1, 2 for dW_in, dW_cond, dW_og."""
    rows, cols = WGRAD_TILE[bf16]
    tiles = []
    for which, (M, N) in enumerate(((k * R, G), (cin, G), (G // 2, R + S))):
        tiles += [(which, m0, n0) for m0 in range(0, M, rows)
                  for n0 in range(0, N, cols)]
    return tiles


def wgrad_chunk(P: int, n_tiles: int, sms: int, bf16: bool) -> int:
    """Positions per weight-gradient block: enough chunks of the P = B*T
    positions for the kernel's blocks per SM, rounded up to a whole stage."""
    chunks = max(1, (WGRAD_BLOCKS_PER_SM[bf16] * sms) // max(n_tiles, 1))
    per = -(-P // chunks)
    return -(-per // WGRAD_STAGE) * WGRAD_STAGE


def train_bwd(dskips: torch.Tensor, xs: torch.Tensor,
              c: Optional[torch.Tensor], gb: Optional[torch.Tensor],
              w_in: torch.Tensor, b_in: torch.Tensor,
              w_cond: Optional[torch.Tensor], w_og: torch.Tensor,
              b_og: torch.Tensor, *, dils: Sequence[int], k: int,
              drop: float = 0.0, seed: int = 0,
              _defines: Tuple[str, ...] = ()):
    """Backward of the stack from dskips (B, T, S) f32 and the forward's
    stash xs. Returns (dx0, dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og),
    all f32; dc, dgb and dw_cond are None where c, gb are absent. The
    weight and bias gradients are f32 atomic sums. ``_defines`` launches a
    variant build (``NO_PRODUCTS``)."""
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
    dyr = (torch.empty(B, T, R + S, dtype=dtype, device=dev) if args.bf16
           else None)
    dc = torch.zeros(B, T, cin, **f32) if c is not None else None
    dgb = torch.zeros(L, B, G, **f32) if gb is not None else None
    dw_in = torch.zeros(L, k * R, G, **f32)
    db_in = torch.zeros(L, G, **f32)
    dw_cond = torch.zeros(L, cin, G, **f32) if c is not None else None
    dw_og = torch.zeros(L, G2, R + S, **f32)
    db_og = torch.zeros(L, R + S, **f32)
    bf16 = bool(args.bf16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    args.chunk = wgrad_chunk(B * T, len(wgrad_tiles(k, R, G, S, cin, bf16)),
                             sms, bf16)
    for name, a in (("dskips", dskips), ("dz", dz), ("gated", gated),
                    ("dyr", dyr), ("dc", dc), ("dgb", dgb),
                    ("dw_in", dw_in), ("db_in", db_in), ("dw_cond", dw_cond),
                    ("dw_og", dw_og), ("db_og", db_og)):
        setattr(args, name, _ptr(a))
    kernels = [_fn("train_bwd", n, tuple(_defines)) for n in
               ("wn_train_bwd_dz", "wn_train_bwd_wgrad", "wn_train_bwd_dx")]
    for l in range(L - 1, -1, -1):
        args.l, args.d = l, dils[l]
        args.xs_l = _ptr(xs[l])
        args.dx_next = None if l == L - 1 else _ptr(dx[(l + 1) % 2])
        args.dx_out = _ptr(dx[l % 2])
        for fn in kernels:
            _launch(fn, args, dev, "train_bwd")
            _count(train_bwd, args)
    return dx[0], dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og


train_bwd.launches = train_bwd.tc_launches = train_bwd.fma_launches = 0
