"""Fused AR generation: weight packing, the CUDA kernel's wrapper, its plain
PyTorch version, and ``FusedGenerator``.

The port's counterpart of ``wavenet_vocoder_tpu/ops/pallas_generate.py``
(variant "fused"). The kernel (``csrc/generate.cu``) runs steps
``[t0, t0+n)`` of the whole decoder for B streams per launch; its header
note says what bounds it on an H100 and how the design answers that.

State lives in two tensors the caller allocates and the kernel updates in
place, so a generation can be continued launch after launch:

  * ``ring (total_rows, B, R)`` in the pack dtype: every layer's dilated ring
    buffer packed along the rows (``buffer_layout``), with the JAX kernel's
    read-before-write modular indexing;
  * ``x_cur (B, C_in)`` f32: the next step's input.

Sampling is keyed by a counter-based hash of (seed, stream row, absolute
step, draw index), so kernel and plain version draw the same numbers, and
outputs do not depend on how streams are blocked or steps are split into
launches. The draws of a step: categorical — one per class (Gumbel-max);
mixtures — one per component (Gumbel-max), then one for the logistic
inverse CDF or two for Box–Muller; single Gaussian — two (Box–Muller).
Uniforms are clipped to (1e-5, 1-1e-5), samples to [-1, 1].

The GLU is tanh(a)*sigmoid(b) for f32 packs and the one-divide exp form of
the JAX bf16 production kernel for bf16 packs, in both the kernel and the
plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from wavenet_vocoder_tpu_torch.models.layers import conv1x1
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
from wavenet_vocoder_tpu_torch.ops.generate import default_initial_input

DEFAULT_CHUNK = 256          # steps per kernel launch
BLOCK_STREAMS = (1, 2)     # streams per CUDA block the kernel is built for
_M32 = 0xFFFFFFFF


# ----------------------------------------------------------------------
# packing
# ----------------------------------------------------------------------
def _w1x1(conv) -> torch.Tensor:
    return conv.effective_weight()[:, :, 0].t()          # (In, Out)


def _bias(conv, n: int, device) -> torch.Tensor:
    if conv.bias is None:
        return torch.zeros(n, device=device)
    return conv.bias.float()


@torch.no_grad()
def pack_weights(model: WaveNet, *, dtype=torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """Fold weight norm and stack per-layer weights, on the model's device.

    Shapes (L layers, R residual, G gate, G2 = G/2, S skip, k taps):
      w_first (C_in, R); w_in (L, k*R + cin, G) — rows [0, k*R) the conv
      taps oldest..newest, rows [k*R, k*R+cin) the local conditioning;
      w_og (L, G2, R+S) — residual-out and skip-out side by side;
      w_h1 (S, S); w_h2 (S, C_out). Weights in ``dtype``, biases f32.
    """
    spec = model.spec
    dev = model.first_conv.effective_weight().device
    k, R = spec.kernel_size, spec.residual_channels
    w_in, b_in, w_og, b_og = [], [], [], []
    for blk in model.conv_layers:
        w = blk.conv.effective_weight().permute(2, 1, 0).reshape(k * R, -1)
        if blk.conv1x1c is not None:
            w = torch.cat([w, _w1x1(blk.conv1x1c)], dim=0)
        w_in.append(w)
        b_in.append(_bias(blk.conv, spec.gate_channels, dev))
        w_og.append(torch.cat([_w1x1(blk.conv1x1_out),
                               _w1x1(blk.conv1x1_skip)], dim=1))
        b_og.append(torch.cat([_bias(blk.conv1x1_out, R, dev),
                               _bias(blk.conv1x1_skip,
                                     spec.skip_out_channels, dev)]))
    h1, h2 = model.last_conv_layers[1], model.last_conv_layers[3]
    packed = {
        "w_first": _w1x1(model.first_conv),
        "b_first": _bias(model.first_conv, R, dev),
        "w_in": torch.stack(w_in), "b_in": torch.stack(b_in),
        "w_og": torch.stack(w_og), "b_og": torch.stack(b_og),
        "w_h1": _w1x1(h1), "b_h1": _bias(h1, spec.skip_out_channels, dev),
        "w_h2": _w1x1(h2), "b_h2": _bias(h2, spec.out_channels, dev),
    }
    return {name: (a.to(torch.float32) if name.startswith("b_")
                   else a.to(dtype)).contiguous()
            for name, a in packed.items()}


def buffer_layout(spec: WaveNetSpec) -> Tuple[Tuple[int, ...], int]:
    """Static (offsets, total_rows) of the packed ring buffer."""
    offs, total = [], 0
    for d in spec.dilations:
        offs.append(total)
        total += (spec.kernel_size - 1) * d
    return tuple(offs), total


def packed_shapes(spec: WaveNetSpec) -> Dict[str, Tuple[int, ...]]:
    """The shape of every array ``pack_weights`` makes for ``spec``."""
    L, k, R, G = (spec.layers, spec.kernel_size, spec.residual_channels,
                  spec.gate_channels)
    S, C = spec.skip_out_channels, spec.out_channels
    cin = spec.cin_channels if spec.has_local_conditioning else 0
    return {"w_first": (spec.in_channels, R), "b_first": (R,),
            "w_in": (L, k * R + cin, G), "b_in": (L, G),
            "w_og": (L, G // 2, R + S), "b_og": (L, R + S),
            "w_h1": (S, S), "b_h1": (S,), "w_h2": (S, C), "b_h2": (C,)}


def head_code(spec: WaveNetSpec) -> int:
    """0 categorical, 1 logistic mixture, 2 Gaussian (the kernel's ``head``)."""
    if not spec.scalar_input:
        return 0
    return {"Logistic": 1, "Normal": 2}[spec.output_distribution]


# ----------------------------------------------------------------------
# counter-based random numbers (same bits as the kernel's mix32/uniform)
# ----------------------------------------------------------------------
def _mix32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> hashed uint32 values. Multipliers
    are below 2^31, so the products stay inside int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def step_keys(seed: int, rows: torch.Tensor, t: int) -> torch.Tensor:
    """Per-stream key of step t: mix(mix(mix(seed) ^ row) ^ t)."""
    k0 = _mix32(torch.tensor(seed & _M32, dtype=torch.int64,
                             device=rows.device))
    return _mix32(_mix32(k0 ^ rows) ^ (t & _M32))


def uniforms(keys: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """keys (B, 1) x draw indices (1, D) -> f32 uniforms in (1e-5, 1-1e-5)."""
    bits = _mix32(keys ^ draws) >> 8
    return (bits.to(torch.float32) * (1.0 / (1 << 24))).clamp(1e-5, 1.0 - 1e-5)


# ----------------------------------------------------------------------
# the plain PyTorch version of the kernel
# ----------------------------------------------------------------------
def _glu(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    if not bf16:
        return torch.tanh(a) * torch.sigmoid(b)
    u = torch.exp(2.0 * a.clamp(-15.0, 15.0))
    v = torch.exp((-b).clamp(-30.0, 30.0))
    return (u - 1.0) / ((u + 1.0) * (1.0 + v))


def _sample(spec: WaveNetSpec, o: torch.Tensor, keys: torch.Tensor,
            deterministic: bool):
    """Head output (B, C_out) f32 -> (emitted (B,), next input (B, C_in))."""
    B, C = o.shape
    dev = o.device
    if not spec.scalar_input:
        v = o
        if not deterministic:
            u = uniforms(keys[:, None], torch.arange(C, device=dev)[None])
            v = o - torch.log(-torch.log(u))
        code = torch.argmax(v, dim=-1)
        return code.to(torch.int32), F.one_hot(code, spec.in_channels).float()
    normal = spec.output_distribution == "Normal"
    if C == 2:
        nr, mean, ls = 1, o[:, 0], o[:, 1]
    else:
        nr = C // 3
        logit = o[:, :nr]
        if not deterministic:
            u = uniforms(keys[:, None], torch.arange(nr, device=dev)[None])
            logit = logit - torch.log(-torch.log(u))
        sel = torch.argmax(logit, dim=-1, keepdim=True)
        mean = torch.gather(o[:, nr:2 * nr], 1, sel)[:, 0]
        ls = torch.gather(o[:, 2 * nr:3 * nr], 1, sel)[:, 0]
    x = mean
    if not deterministic:
        if normal:
            d0 = 0 if C == 2 else nr
            u = uniforms(keys[:, None],
                         torch.arange(d0, d0 + 2, device=dev)[None])
            z0 = torch.sqrt(-2.0 * torch.log(u[:, 0])) \
                * torch.cos(2.0 * math.pi * u[:, 1])
            x = mean + torch.exp(ls) * z0
        elif C != 2:
            u = uniforms(keys[:, None],
                         torch.tensor([[nr]], device=dev))[:, 0]
            x = mean + torch.exp(ls) * (torch.log(u) - torch.log(1.0 - u))
    x = x.clamp(-1.0, 1.0)
    return x, x[:, None]


@torch.no_grad()
def generate_steps_plain(packed: Dict[str, torch.Tensor], spec: WaveNetSpec,
                         ring: torch.Tensor, x_cur: torch.Tensor,
                         out: torch.Tensor, cond: Optional[torch.Tensor],
                         g_gate: Optional[torch.Tensor], *, t0: int,
                         seed: int, deterministic: bool) -> None:
    """What the kernel computes, as a step loop of torch ops over the same
    packed weights: ``out[:, j]`` for steps t0+j, j < out.shape[1]; ``ring``
    and ``x_cur`` are updated in place. Products take inputs rounded to the
    pack dtype and accumulate in f32, as the kernel does."""
    dtype = ring.dtype
    rd = lambda a: a.to(dtype).float()
    w = {n: a.float() for n, a in packed.items()}
    L, k, R = spec.layers, spec.kernel_size, spec.residual_channels
    G2 = spec.gate_channels // 2
    offs, _ = buffer_layout(spec)
    sqrt_half, sqrt_inv_L = math.sqrt(0.5), math.sqrt(1.0 / L)
    bf16 = dtype == torch.bfloat16
    rows = torch.arange(x_cur.shape[0], device=x_cur.device)
    for j in range(out.shape[1]):
        t = t0 + j
        h = rd(x_cur) @ w["w_first"] + w["b_first"]
        skips = 0.0
        for li, d in enumerate(spec.dilations):
            Ll, off = (k - 1) * d, offs[li]
            parts = [ring[off + (t - jj * d) % Ll].float()
                     for jj in range(k - 1, 0, -1)]
            parts.append(rd(h))
            if cond is not None:
                parts.append(cond[:, j].float())
            inp = torch.cat(parts, dim=-1)
            # write after the reads: the oldest tap's slot is this slot
            ring[off + t % Ll] = h.to(dtype)
            z = inp @ w["w_in"][li] + w["b_in"][li]
            if g_gate is not None:
                z = z + g_gate[li]
            gated = rd(_glu(z[:, :G2], z[:, G2:], bf16))
            y = gated @ w["w_og"][li] + w["b_og"][li]
            skips = skips + y[:, R:]
            h = (y[:, :R] + h) * sqrt_half
        o = rd(torch.relu(skips * sqrt_inv_L))
        o = rd(torch.relu(o @ w["w_h1"] + w["b_h1"]))
        o = o @ w["w_h2"] + w["b_h2"]
        emitted, x_next = _sample(spec, o, step_keys(seed, rows, t),
                                  deterministic)
        out[:, j] = emitted.to(out.dtype)
        x_cur.copy_(x_next)


# ----------------------------------------------------------------------
# the kernel's wrapper
# ----------------------------------------------------------------------
_PTR = ctypes.c_void_p
_ARGTYPES = ([_PTR] * 11 + [ctypes.c_longlong] + [_PTR] * 4
             + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_uint]
             + [ctypes.c_int] * 13 + [_PTR])


def _kernel_fn():
    from wavenet_vocoder_tpu_torch.kernels.build import load
    fn = load("generate").wn_generate
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def default_block_streams(B: int, device) -> int:
    """Streams per block: the fewest that keep the grid within one wave of
    the card's SMs (more streams per block means fewer L2 weight rereads)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for bt in BLOCK_STREAMS:
        if -(-B // bt) <= sms:
            return bt
    return BLOCK_STREAMS[-1]


def _check(name: str, a: torch.Tensor, shape, dtype, device) -> None:
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {tuple(shape)}")
    if a.dtype != dtype:
        raise TypeError(f"{name}: dtype {a.dtype}, expected {dtype}")
    if a.device != device:
        raise ValueError(f"{name}: on {a.device}, expected {device}")


def generate_steps(packed: Dict[str, torch.Tensor], spec: WaveNetSpec,
                   ring: torch.Tensor, x_cur: torch.Tensor, out: torch.Tensor,
                   cond: Optional[torch.Tensor] = None,
                   g_gate: Optional[torch.Tensor] = None, *, t0: int,
                   seed: int, deterministic: bool = False,
                   _block_streams: Optional[int] = None) -> None:
    """Run steps [t0, t0 + out.shape[1]) of the fused decoder in place.

    ring (total_rows, B, R) pack dtype; x_cur (B, C_in) f32; out (B, n) f32
    (scalar heads) or int32 (codes), rows may be strided; cond (B, n, cin)
    pack dtype or None; g_gate (L, B, G) f32 or None. CUDA tensors launch
    the kernel (``generate_steps.launches`` counts the launches); CPU
    tensors run the plain version. There is no fallback between the two.
    ``_block_streams`` overrides ``default_block_streams`` (sweeps, tests).
    """
    B, n = out.shape
    dev, dtype = ring.device, packed["w_first"].dtype
    L, R, G = spec.layers, spec.residual_channels, spec.gate_channels
    _, rows = buffer_layout(spec)
    cin = spec.cin_channels if spec.has_local_conditioning else 0
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pack dtype {dtype} not supported")
    for name, shape in packed_shapes(spec).items():
        a = packed[name]
        want = torch.float32 if name.startswith("b_") else dtype
        if (tuple(a.shape) != shape or a.dtype != want or a.device != dev
                or not a.is_contiguous()):
            raise ValueError(f"packed[{name!r}]: {tuple(a.shape)} {a.dtype} "
                             f"on {a.device}; expected contiguous {shape} "
                             f"{want} on {dev}")
    _check("ring", ring, (rows, B, R), dtype, dev)
    _check("x_cur", x_cur, (B, spec.in_channels), torch.float32, dev)
    _check("out", out, (B, n),
           torch.float32 if spec.scalar_input else torch.int32, dev)
    if (cin > 0) != (cond is not None):
        raise ValueError("cond must be given exactly when the model has "
                         "local conditioning")
    if cond is not None:
        _check("cond", cond, (B, n, cin), dtype, dev)
    if g_gate is not None:
        _check("g_gate", g_gate, (L, B, G), torch.float32, dev)
    if not (ring.is_contiguous() and x_cur.is_contiguous()
            and (g_gate is None or g_gate.is_contiguous())
            and out.stride(1) == 1
            and (cond is None or (cond.stride(2) == 1
                                  and cond.stride(1) == cin))):
        raise ValueError("ring, x_cur, g_gate must be contiguous; out and "
                         "cond contiguous within each stream")

    if dev.type == "cpu":
        generate_steps_plain(packed, spec, ring, x_cur, out, cond, g_gate,
                             t0=t0, seed=seed, deterministic=deterministic)
        return
    if dev.type != "cuda":
        raise ValueError(f"no generation kernel for device {dev}")
    RS = R + spec.skip_out_channels
    if any(m % 8 or m > 4096 for m in (G, RS, spec.skip_out_channels)) \
            or spec.out_channels > 512:
        raise ValueError("the generation kernel needs gate, residual+skip and "
                         "skip widths that are multiples of 8 up to 4096 and "
                         "at most 512 output channels; got "
                         f"{G}, {RS}, {spec.skip_out_channels}, "
                         f"{spec.out_channels}")
    bt = _block_streams or default_block_streams(B, dev)
    if bt not in BLOCK_STREAMS:
        raise ValueError(f"_block_streams must be one of {BLOCK_STREAMS}")
    ptr = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(
            ptr(packed["w_first"]), ptr(packed["b_first"]),
            ptr(packed["w_in"]), ptr(packed["b_in"]),
            ptr(packed["w_og"]), ptr(packed["b_og"]),
            ptr(packed["w_h1"]), ptr(packed["b_h1"]),
            ptr(packed["w_h2"]), ptr(packed["b_h2"]),
            ptr(cond), 0 if cond is None else cond.stride(0),
            ptr(g_gate), ptr(ring), ptr(x_cur), ptr(out), out.stride(0),
            B, n, int(t0), int(seed) & _M32, L, spec.layers_per_stack,
            spec.kernel_size, R, G, spec.skip_out_channels,
            spec.in_channels, spec.out_channels, cin, head_code(spec),
            int(bool(deterministic)), int(dtype == torch.bfloat16), bt,
            stream)
    if err != 0:
        raise RuntimeError(f"generation kernel launch failed: CUDA error {err}")
    generate_steps.launches += 1


generate_steps.launches = 0


# ----------------------------------------------------------------------
# pack-once, generate-many
# ----------------------------------------------------------------------
class FusedGenerator:
    """Pack-once, generate-many wrapper around ``generate_steps`` — the
    counterpart of the JAX package's ``PallasGenerator``. Build once per
    model, call per batch."""

    def __init__(self, model: WaveNet, *, weight_dtype=torch.bfloat16,
                 chunk: int = DEFAULT_CHUNK):
        self.model = model
        self.spec = model.spec
        self.chunk = int(chunk)
        self.weight_dtype = weight_dtype
        self.packed = pack_weights(model, dtype=weight_dtype)
        self.device = self.packed["w_first"].device

    @torch.no_grad()
    def __call__(self, *, T: Optional[int] = None,
                 c: Optional[torch.Tensor] = None,
                 c_up: Optional[torch.Tensor] = None,
                 g: Optional[torch.Tensor] = None,
                 initial_input: Optional[torch.Tensor] = None,
                 log_scale_min: float = -50.0,
                 deterministic: bool = False,
                 seed: int = 0,
                 state: Optional[Tuple] = None,
                 return_state: bool = False):
        """(B, T) f32 samples (scalar heads) or int32 codes (categorical).

        c: (B, T_mel, C) mel with an upsample net, else (B, T, C); c_up,
        instead of c: (B, T, C) conditioning already at the sample rate;
        log_scale_min is accepted and not applied, as in the JAX kernel.
        T is padded to a multiple of ``chunk`` (conditioning repeats its last
        frame) and the output trimmed.

        state: (x_cur, ring, t) from an earlier call's returned state —
        resumes generation at absolute step t with the same ``seed``, so
        segment after segment equals one long call. The kernel updates
        ``x_cur`` and ``ring`` in place: a state that was passed in is used
        up, and the returned state holds the same tensors. With
        ``return_state`` the result is (samples, state). Carried segments
        must be multiples of ``chunk``: padding steps would advance the
        state past the segment's end.
        """
        del log_scale_min
        spec, dev, dtype, chunk = self.spec, self.device, self.weight_dtype, self.chunk
        model = self.model
        as_dev = lambda a: None if a is None else torch.as_tensor(a, device=dev)
        if c is not None and c_up is not None:
            raise ValueError("give c or c_up, not both")
        c, g = as_dev(c), as_dev(g)
        if c_up is not None:
            c_up = as_dev(c_up).float()
        else:
            c_up = model.upsample_conditioning(None if c is None else c.float())
        if c_up is not None:
            T = c_up.shape[1] if T is None else T
            if c_up.shape[1] != T:
                raise ValueError(f"conditioning covers {c_up.shape[1]} "
                                 f"samples, T is {T}")
        if T is None:
            raise ValueError("T required without conditioning")
        if (state is not None or return_state) and T % chunk:
            raise ValueError(
                f"streaming segments must be multiples of the kernel chunk "
                f"({chunk}); got T={T}")
        if c_up is not None:
            B = c_up.shape[0]
        elif state is not None:
            B = state[0].shape[0]
        elif initial_input is not None:
            B = initial_input.shape[0]
        elif g is not None:
            B = g.shape[0]
        else:
            B = 1
        T_pad = -(-T // chunk) * chunk
        cond = None
        if c_up is not None:
            if T_pad != T:
                c_up = torch.cat(
                    [c_up, c_up[:, -1:].expand(B, T_pad - T, -1)], dim=1)
            cond = c_up.to(dtype).contiguous()
        g_vec = model.embed_global(g)
        g_gate = None
        if g_vec is not None:
            g_gate = torch.stack([conv1x1(blk.conv1x1g, g_vec.float())
                                  for blk in model.conv_layers]).float().contiguous()
        t_off = 0
        if state is not None:
            x_cur, ring, t_off = state
        else:
            if initial_input is None:
                x_cur = default_initial_input(spec, B, device=dev)
            else:
                x_cur = as_dev(initial_input).reshape(B, -1).float().clone()
            _, rows = buffer_layout(spec)
            ring = torch.zeros(rows, B, spec.residual_channels, dtype=dtype,
                               device=dev)
        out = torch.empty(B, T_pad, device=dev, dtype=(
            torch.float32 if spec.scalar_input else torch.int32))
        for t0 in range(0, T_pad, chunk):
            generate_steps(self.packed, spec, ring, x_cur,
                           out[:, t0:t0 + chunk],
                           None if cond is None else cond[:, t0:t0 + chunk],
                           g_gate, t0=t_off + t0, seed=seed,
                           deterministic=deterministic)
        if return_state:
            return out[:, :T], (x_cur, ring, t_off + T)
        return out[:, :T]
