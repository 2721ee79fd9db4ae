"""ctypes wrappers of the residual-stack training kernels.

``train_fwd`` launches ``csrc/train_fwd.cu`` once per layer and
``train_bwd`` launches the three kernels of ``csrc/train_bwd.cu`` per layer,
top layer first. Both take CUDA tensors only and have the signatures of
their plain versions in ``ops/fused_train.py``, which ``FusedResStack``
uses for CPU tensors. Outputs and scratch are allocated here with
``torch.empty`` (accumulated outputs with ``torch.zeros``); the kernels run
on the current stream and do not synchronise. The weights go to the kernels
as stored: no transposed copies, and padded ones only at widths that the
tensor-core kernels do not cut into fragments (``kernel_widths``).

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
import torch.nn.functional as F

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
           ("chunk", ctypes.c_int), ("key_R", ctypes.c_int)])


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


def _up(a: int, m: int) -> int:
    return -(-a // m) * m


def kernel_widths(R: int, G: int, S: int, dtype) -> Tuple[int, int, int]:
    """(R, G, S) as the kernels run a stack of these widths. The bf16
    tensor-core kernels cut R into 8-column fragment rows, each GLU half
    into 8-column fragments and R + S into column pairs, so the wrappers pad
    those widths with zero channels to the next multiple and slice the
    results back; the f32 kernels take any widths. A zero channel stays
    exactly zero through the stack (zero weights and biases, and
    tanh(0) * sigmoid(0) = 0), and adds exact zeros to every real sum."""
    if dtype != torch.bfloat16:
        return R, G, S
    return _up(R, 8), 2 * _up(G // 2, 8), _up(S, 2)


class _Pad:
    """Zero padding of a stack's operands from (R, G, S) to the kernels'
    widths, and the slices that take the results back."""

    def __init__(self, R: int, G: int, S: int, widths: Tuple[int, int, int]):
        self.R, self.G2, self.S = R, G // 2, S
        self.Rp, Gp, self.Sp = widths
        self.G2p = Gp // 2

    def last(self, a, n):             # pad the last dimension to n
        return None if a is None else F.pad(a, (0, n - a.shape[-1])).contiguous()

    def gate(self, a):                # [..., a-half | b-half]
        if a is None:
            return None
        g = self.G2
        return torch.cat([self.last(a[..., :g], self.G2p),
                          self.last(a[..., g:], self.G2p)], -1).contiguous()

    def res_skip(self, a):            # [..., residual | skip]
        return torch.cat([self.last(a[..., :self.R], self.Rp),
                          self.last(a[..., self.R:], self.Sp)], -1).contiguous()

    def w_in(self, w, k):             # (L, k*R, G): rows tap j, channel r
        L = w.shape[0]
        w = F.pad(w.reshape(L, k, self.R, -1), (0, 0, 0, self.Rp - self.R))
        return self.gate(w.reshape(L, k * self.Rp, -1))

    def w_og(self, w):                # (L, G/2, R+S)
        return self.res_skip(F.pad(w, (0, 0, 0, self.G2p - self.G2)))

    def ungate(self, a):
        if a is None:
            return None
        g = self.G2p
        return torch.cat([a[..., :self.G2], a[..., g:g + self.G2]], -1)

    def unres_skip(self, a):
        return torch.cat([a[..., :self.R], a[..., self.Rp:self.Rp + self.S]], -1)


def _padding(x_R: int, w_in, w_og, k: int) -> Optional[_Pad]:
    """The padding a stack with weights w_in, w_og needs, or None."""
    G = w_in.shape[2]
    S = w_og.shape[2] - x_R
    widths = kernel_widths(x_R, G, S, w_in.dtype)
    if widths == (x_R, G, S) or w_in.shape[1] != k * x_R or G % 2 or S < 0:
        return None        # (operands of the wrong shape raise in _common)
    return _Pad(x_R, G, S, widths)


def _common(w_in, b_in, w_cond, w_og, b_og, c, gb, *, B, T, dils, k, drop,
            seed, key_R) -> TrainArgs:
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
    if kernel_widths(R, G, S, dtype) != (R, G, S):
        raise ValueError(f"the training kernels take R, G, S = "
                         f"{kernel_widths(R, G, S, dtype)}, got {(R, G, S)}")
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
        inv_keep=1.0 / keep, bf16=int(dtype == torch.bfloat16),
        key_R=R if key_R is None else key_R)


def train_fwd(x0: torch.Tensor, c: Optional[torch.Tensor],
              gb: Optional[torch.Tensor], w_in: torch.Tensor,
              b_in: torch.Tensor, w_cond: Optional[torch.Tensor],
              w_og: torch.Tensor, b_og: torch.Tensor, *, dils: Sequence[int],
              k: int, drop: float = 0.0, seed: int = 0,
              _defines: Tuple[str, ...] = (), _key_R: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of the stack: (skips (B, T, S) f32, xs (L, B, T, R)), where
    xs[l] is layer l's input in the storage dtype (the backward's stash).
    x0, c and the weights are in the storage dtype, b_in, b_og, gb f32.
    ``_defines`` launches a variant build (``NO_PRODUCTS``)."""
    B, T, R = x0.shape
    pad = _padding(R, w_in, w_og, k)
    if pad is not None:     # run at the kernels' widths, slice back
        skips, xs = train_fwd(
            pad.last(x0, pad.Rp), c, pad.gate(gb), pad.w_in(w_in, k),
            pad.gate(b_in), pad.gate(w_cond), pad.w_og(w_og),
            pad.res_skip(b_og), dils=dils, k=k, drop=drop, seed=seed,
            _defines=_defines, _key_R=R)
        return (skips[..., :pad.S].contiguous(),
                xs[..., :R].contiguous())
    args = _common(w_in, b_in, w_cond, w_og, b_og, c, gb, B=B, T=T,
                   dils=dils, k=k, drop=drop, seed=seed, key_R=_key_R)
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
              _defines: Tuple[str, ...] = (), _key_R: Optional[int] = None):
    """Backward of the stack from dskips (B, T, S) f32 and the forward's
    stash xs. Returns (dx0, dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og),
    all f32; dc, dgb and dw_cond are None where c, gb are absent. The
    weight and bias gradients are f32 atomic sums. ``_defines`` launches a
    variant build (``NO_PRODUCTS``)."""
    L, B, T, R = xs.shape
    pad = _padding(R, w_in, w_og, k)
    if pad is not None:     # run at the kernels' widths, slice back
        dx0, dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og = train_bwd(
            pad.last(dskips, pad.Sp), pad.last(xs, pad.Rp), c, pad.gate(gb),
            pad.w_in(w_in, k), pad.gate(b_in), pad.gate(w_cond),
            pad.w_og(w_og), pad.res_skip(b_og), dils=dils, k=k, drop=drop,
            seed=seed, _defines=_defines, _key_R=R)
        dw_in = dw_in.reshape(L, k, pad.Rp, -1)[:, :, :R].reshape(L, k * R, -1)
        return (dx0[..., :R].contiguous(), dc, pad.ungate(dgb),
                pad.ungate(dw_in), pad.ungate(db_in), pad.ungate(dw_cond),
                pad.unres_skip(dw_og[:, :pad.G2]), pad.unres_skip(db_og))
    args = _common(w_in, b_in, w_cond, w_og, b_og, c, gb, B=B, T=T,
                   dils=dils, k=k, drop=drop, seed=seed, key_R=_key_R)
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
