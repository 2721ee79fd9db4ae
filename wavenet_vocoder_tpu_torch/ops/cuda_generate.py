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
  * ``x_cur (B, C_in)`` f32: the next step's input; for the categorical
    head the one-hot row of the last code (a zero row: no input), which the
    kernel reads as the index of the row's nonzero entry.

The kernel reads a second, kernel-side pack (``kernel_pack``): every
product's columns cut into one slice per CTA of a thread-block cluster,
zero padded to the tensor-core tiles and laid out in mma fragment order.
``pack_weights`` keeps the public layout that the plain version uses.

Sampling is keyed by a counter-based hash of (seed, stream row, absolute
step, draw index), so kernel and plain version draw the same numbers, and
outputs do not depend on how streams are grouped into clusters or steps are
split into launches. The draws of a step: categorical — one per class (Gumbel-max);
mixtures — one per component (Gumbel-max), then one for the logistic
inverse CDF or two for Box–Muller; single Gaussian — two (Box–Muller).
Uniforms are clipped to (1e-5, 1-1e-5), samples to [-1, 1].

The GLU is tanh(a)*sigmoid(b) for f32 packs and the one-divide exp form of
the JAX bf16 production kernel for bf16 packs, in both the kernel and the
plain version.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from wavenet_vocoder_tpu_torch.models.layers import conv1x1
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
from wavenet_vocoder_tpu_torch.ops.generate import default_initial_input
from wavenet_vocoder_tpu_torch.utils import profiling

DEFAULT_CHUNK = 256          # steps per kernel launch
_M32 = 0xFFFFFFFF


# ----------------------------------------------------------------------
# packing
# ----------------------------------------------------------------------
def _w1x1(conv) -> torch.Tensor:
    return conv.full_weight()[:, :, 0].t()               # (In, Out)


def _bias(conv, n: int, device) -> torch.Tensor:
    if conv.bias is None:
        return torch.zeros(n, device=device)
    return conv.full_bias().float()


@torch.no_grad()
def pack_weights(model: WaveNet, *, dtype=torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """Fold weight norm and stack per-layer weights, on the model's device.
    The weights are whole: a model cut by tensor parallelism gathers them
    within its model group (every rank of it must call this).

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
        w = blk.conv.full_weight().permute(2, 1, 0).reshape(k * R, -1)
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
# the launch plan: cluster shape, weight ring, shared-memory layout
# ----------------------------------------------------------------------
# The constants csrc/generate.cu names in brackets (tests/test_torch_generate_ring.py
# holds them equal)
CLUSTER_SIZES = (1, 2, 4, 8)   # CTAs per cluster the picker chooses from
TILE_ROWS = 16                 # streams of one mma row tile [kTileRows]
CLUSTER_STREAMS = 32           # streams a cluster owns at most [kTileRows * kMaxTiles]
KERNEL_THREADS = 256           # computing threads per CTA [kThreads]
SPLIT_IN = 2                   # parts the kernel cuts the w_in product's depth into [kSplitIn]
BARRIERS = 5                   # mbarriers besides the ring's: the head's weights, four exchanges [kBars]
RING_UNITS = 2                 # units a warp (f32: a thread) runs through a chunk ring pass [kUnits]
SMEM_BYTES = 232448            # shared memory a CTA can have on an H100 [kSmemLimit]
RESIDENT_CTAS = 120            # CTAs an H100 holds at once in clusters of 4 or 8
RING_SLOTS = 2                 # chunks the ring holds where that many fit


def _up(a: int, m: int) -> int:
    return -(-a // m) * m


def _row_stride(K: int) -> int:
    """Row stride (elements) of a shared-memory activation buffer of K
    columns: congruent to 8 modulo 64, so that the 8 rows an mma fragment
    load touches fall into different banks, and rows stay 16-byte aligned."""
    return K + (8 - K) % 64


def split_head(spec: WaveNetSpec) -> bool:
    """Whether the kernel splits the head's second 1x1 and its sampler over
    the cluster's CTAs: the categorical head (a class a column, Gumbel-max
    over the classes). The scalar heads' few columns stay whole in every CTA."""
    return head_code(spec) == 0


def _kernel_dims(spec: WaveNetSpec, cluster_size: int) -> Dict[str, int]:
    """Widths, depths and strides of the kernel-side pack (see KernelPack).
    ``Cq``: the output columns of the head a CTA holds, C_out padded to 8,
    or for a split head its 1/CS share of them, padded to 8."""
    CS, k = cluster_size, spec.kernel_size
    cin = spec.cin_channels if spec.has_local_conditioning else 0
    Gq, Rq, Sq = (_up(-(-w // CS), 8) for w in (
        spec.gate_channels // 2, spec.residual_channels, spec.skip_out_channels))
    Kin, Kog, Ksk = _up(k * CS * Rq + cin, 16), _up(CS * Gq, 16), _up(CS * Sq, 16)
    C = spec.out_channels
    return dict(Gq=Gq, Rq=Rq, Sq=Sq, Kin=Kin, Kog=Kog, Ksk=Ksk,
                Cq=_up(-(-C // CS) if split_head(spec) else C, 8),
                xs=_row_stride(Kin), gs=_row_stride(Kog), ss=_row_stride(Ksk))


def smem_layout(spec: WaveNetSpec, dtype, cluster_size: int, tiles: int = 1,
                nstage: int = 0, slot_bytes: Optional[int] = None
                ) -> Dict[str, int]:
    """A CTA's dynamic shared memory for ``tiles`` mma row tiles a cluster:
    the byte offset of every buffer, each a multiple of 128 B, in this
    order, and their ``total``; beside them the bytes of a CTA's layer block
    and head block in the kernel-side pack (``stage_bytes``, ``head_bytes``).
    ``nstage`` whole layer blocks (``slot_bytes`` None) with the head's block
    resident, or chunk slots of ``slot_bytes``, ``stage_stride`` apart at 0."""
    d = _kernel_dims(spec, cluster_size)
    elt = 2 if dtype == torch.bfloat16 else 4
    M, split, chunked = TILE_ROWS * tiles, split_head(spec), slot_bytes is not None
    NA, NB, Sq, Cq = 2 * d["Gq"], d["Rq"] + d["Sq"], d["Sq"], d["Cq"]
    at = dict(stage_bytes=(d["Kin"] * NA + d["Kog"] * NB) * elt + (NA + NB) * 4,
              head_bytes=d["Ksk"] * (Sq + Cq) * elt + (Sq + Cq) * 4)
    at["stage_stride"] = _up(slot_bytes if chunked else at["stage_bytes"], 128)
    buffers = (
        ("headw", 0 if chunked else at["head_bytes"]),
        ("xin", 2 * M * d["xs"] * elt),     # [taps | cond], by layer parity
        ("gt", M * d["gs"] * elt),          # gated, every CTA's slice
        ("hx", M * d["ss"] * elt),          # the head's input
        ("o1", M * d["ss"] * elt),          # the head's hidden layer
        # bf16: the w_in product's partial sums, SPLIT_IN x tiles parts
        ("part", SPLIT_IN * tiles * M * NA * 4 if elt == 2 else 0),
        ("bst", 4 * NA if chunked else 0),  # b_in, copied out of its chunk
        ("hbf", M * d["Rq"] * 4),           # own residual columns, f32
        ("sk", M * Sq * 4),                 # own skip sums
        ("lo", M * Cq * 4),                 # the head's output
        # the scalar heads' current input; the split head keeps codes
        # instead and takes every CTA's candidate (score, class) a stream
        ("xc", 0 if split else M * spec.in_channels * 4),
        ("cand", M * cluster_size * 8 if split else 0),
        ("first", 2 * cluster_size * d["Rq"] * 4),   # the first conv's bias, row
        ("code", M * 4),                    # each stream's last class
        ("ltab", spec.layers * 16),         # per layer: ring row, dilation, t mods
        ("bars", (2 * nstage + BARRIERS + split) * 8))
    o = nstage * at["stage_stride"]
    for name, size in buffers:
        at[name] = o
        o += _up(size, 128)
    at["total"] = o
    return at


class Plan(collections.namedtuple("Plan", (
        "L lps k R G C_in C_out cin head bf16 CS spc tiles Gq Rq Sq Kin Kog Ksk "
        "Cq xs gs ss stage_bytes head_bytes nstage slot_bytes ck passes head_res "
        "stage_stride headw xin gt hx o1 part bst hbf sk lo xc cand first code "
        "ltab bars total"))):
    """One launch of ``csrc/generate.cu`` as ``plan_launch`` lays it out: the
    model as the kernel runs it, the cluster shape, the kernel-side pack's
    widths (``_kernel_dims``), the ring of weights, and the shared-memory
    layout (``smem_layout``). Its fields are ``struct Plan``'s, in order and
    described there; the kernel reads them (``struct``) and derives none.

    The ring: ``slot_bytes`` 0: ``nstage`` whole layer blocks (all layers
    when they fit, else a ring refilled as layers are read out) beside the
    head's block (``head_res``). Else the chunk ring: ``nstage`` slots of
    ``slot_bytes``, through which the kernel's filler streams, step after
    step, each layer's w_in then w_og slice and the head's w_h1 then w_h2 in
    chunks of whole steps (bf16 k-steps of 16 rows, f32 rows; ``ck`` of
    them, a product's last chunk shorter), each product ``passes`` times,
    ``RING_UNITS`` units of its work a pass; a pass's last chunk carries the
    product's biases behind its weights."""

    @property
    def chunked(self) -> bool:
        return self.slot_bytes > 0

    @functools.cached_property
    def struct(self) -> "_CPlan":
        """The plan as ``wn_generate`` reads it."""
        return _CPlan(*self)


class _CPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int * 4 if name in ("ck", "passes") else ctypes.c_int)
                for name in Plan._fields]


def ring_products(spec: WaveNetSpec, cluster_size: int, dtype):
    """(steps, bytes a step, columns, units a warp or thread runs) of w_in,
    w_og, w_h1 and w_h2 in one CTA's slice. A step is a k-step of 16 rows
    (bf16, an mma's depth) or one row (f32). A unit is a pair of n-tiles over
    one of SPLIT_IN parts of the k-steps (bf16 w_in), an n-tile (bf16), or
    one stream's output (f32: a gate channel's pair of columns for w_in)."""
    d = _kernel_dims(spec, cluster_size)
    M, NW = TILE_ROWS, KERNEL_THREADS // 32
    cols = (2 * d["Gq"], d["Rq"] + d["Sq"], d["Sq"], d["Cq"])
    depth = (d["Kin"], d["Kog"], d["Ksk"], d["Ksk"])
    if dtype == torch.bfloat16:
        rows, elt = 16, 2
        units = [-(-n // NW) for n in (cols[0] // 16 * SPLIT_IN, *(
            c // 8 for c in cols[1:]))]
    else:
        rows, elt = 1, 4
        units = [-(-M * n // KERNEL_THREADS) for n in (d["Gq"], *cols[1:])]
    return tuple((K // rows, rows * N * elt, N, u)
                 for K, N, u in zip(depth, cols, units))


@functools.lru_cache(maxsize=256)
def _plan(spec: WaveNetSpec, dtype, cluster_size: int, streams: int,
          max_stages: int = -1) -> Optional[Plan]:
    """The plan of clusters of ``cluster_size`` CTAs and ``streams`` streams,
    or None where no ring fits beside the activation buffers.

    Whole layer blocks where two fit (or one, for a one-layer model) with
    the head's block, as many as fit up to every layer (``max_stages`` >= 0
    caps them; 0 forces the chunk ring). Else the chunk ring, which runs one
    row tile: RING_SLOTS slots where each holds a step of every product and
    its biases, fewer where not, the slots sharing out what the activation
    buffers leave; each product's chunk as many steps as a slot holds. Few
    large chunks run faster than many small ones: every chunk costs each
    warp a wait and a release, and the filler a round trip."""
    tiles, L = -(-streams // TILE_ROWS), spec.layers
    layout = functools.partial(smem_layout, spec, dtype, cluster_size, tiles)
    cap = L if max_stages < 0 or max_stages >= L else max_stages
    stages = next((s for s in range(cap, min(L, 2) - 1, -1)
                   if s > 0 and layout(s)["total"] <= SMEM_BYTES), 0)
    if stages:
        ring = dict(nstage=stages, slot_bytes=0, ck=(0,) * 4, passes=(0,) * 4)
        at = layout(stages)
    elif tiles > 1:
        return None
    else:
        prods = ring_products(spec, cluster_size, dtype)
        for slots in range(RING_SLOTS, 0, -1):
            slot = (SMEM_BYTES - layout(slots, 0)["total"]) // slots // 128 * 128
            chunk = tuple(min(KS, (slot - 4 * N) // step)
                          for KS, step, N, _ in prods)
            if min(chunk) >= 1:
                break
        else:
            return None
        slot_bytes = max(c * step + 4 * N
                         for c, (_, step, N, _) in zip(chunk, prods))
        ring = dict(nstage=slots, slot_bytes=slot_bytes, ck=chunk, passes=tuple(
            max(1, -(-units // RING_UNITS)) for *_, units in prods))
        at = layout(slots, slot_bytes)
    return Plan(L=L, lps=spec.layers_per_stack, k=spec.kernel_size,
                R=_up(spec.residual_channels, 8), G=spec.gate_channels,
                C_in=spec.in_channels, C_out=spec.out_channels,
                cin=spec.cin_channels if spec.has_local_conditioning else 0,
                head=head_code(spec), bf16=int(dtype == torch.bfloat16),
                CS=cluster_size, spc=streams, tiles=tiles,
                **_kernel_dims(spec, cluster_size), **ring,
                head_res=int(not ring["slot_bytes"]), **at)


def _whole_stages(spec: WaveNetSpec, cluster_size: int, dtype,
                  streams: int) -> bool:
    """Whether the plan at this cluster shape is whole layer blocks."""
    plan = _plan(spec, dtype, cluster_size, streams)
    return plan is not None and not plan.chunked


def _waves(B: int, cluster_size: int, streams: int) -> int:
    """How many times over the card runs the clusters of B streams."""
    return -(-(-(-B // streams)) // (RESIDENT_CTAS // cluster_size))


def pick_cluster(spec: WaveNetSpec, B: int, dtype=torch.bfloat16
                 ) -> Tuple[int, int]:
    """(CTAs per cluster, streams per cluster) for B streams of a pack of
    ``dtype``. The cluster is the largest in which every CTA still owns 8
    gate, residual and skip channels; it owns 16 streams (one mma row tile),
    fewer when B is, while its clusters all fit the card at once (B <= 240
    at clusters of 8). Past that, either the cluster is halved (to 4; 16
    streams, each CTA pulling twice the weights), or it keeps its size and
    owns 32 streams (two row tiles), where whole layer blocks fit beside the
    32-row buffers (``plan_launch``). The second wave of a grid that does
    not fit doubles the time, so the shape with fewer waves wins. At equal
    waves the halved cluster wins unless its plan is the chunk ring: on an
    H100 (256-step bf16 launches at B=256) 32-stream clusters of 8 took
    89.4-89.5 us a step against 87.4-87.6 for clusters of 4 at the mol
    recipe's model (24 layers, 128/256/128) and 111.0-111.2 against
    108.1-109.3 at its 30-layer one, where both keep whole layer blocks; at
    the mu-law 256 recipe's model, whose clusters of 4 stream the chunk
    ring, 111.9-112.8 against 122.5-122.8."""
    width = min(spec.gate_channels // 2, spec.residual_channels,
                spec.skip_out_channels)
    cs = max([c for c in CLUSTER_SIZES if 8 * c <= width], default=1)
    if -(-B // TILE_ROWS) * cs <= RESIDENT_CTAS:
        return cs, min(TILE_ROWS, B)
    half = min(cs, 4)
    if _whole_stages(spec, cs, dtype, CLUSTER_STREAMS):
        wide, narrow = _waves(B, cs, CLUSTER_STREAMS), _waves(B, half, TILE_ROWS)
        if wide < narrow or (wide == narrow and not _whole_stages(
                spec, half, dtype, TILE_ROWS)):
            return cs, CLUSTER_STREAMS
    return half, TILE_ROWS


def cluster_sizes(spec: WaveNetSpec, dtype=torch.bfloat16) -> Tuple[int, ...]:
    """The cluster sizes ``pick_cluster`` returns for this spec and dtype:
    its largest while one wave of clusters holds B streams, and what it
    takes past that, which no larger B changes (the halved size is 4, and
    16-stream clusters of 4 take as many waves as 32-stream ones of 8)."""
    past = TILE_ROWS * RESIDENT_CTAS + 1     # past one wave at every size
    return tuple(sorted({pick_cluster(spec, B, dtype)[0] for B in (1, past)}))


@functools.lru_cache(maxsize=256)
def plan_launch(spec: WaveNetSpec, dtype, B: int, *,
                cluster: Optional[Tuple[int, int]] = None,
                max_stages: int = -1) -> Plan:
    """The plan of a launch for B streams of a pack of ``dtype``, made once
    per key: ``pick_cluster``'s shape (``cluster`` = (CTAs, streams a
    cluster) overrides it) and the ring of ``_plan`` (``max_stages`` caps
    its whole layer blocks; 0 forces the chunk ring). Raises ValueError,
    with the reason, where the kernel does not take the model so."""
    G, R, S = spec.gate_channels, spec.residual_channels, spec.skip_out_channels
    if max(G, R + S) > 4096 or spec.out_channels > 512 \
            or spec.kernel_size < 2:
        raise ValueError(
            "the generation kernel needs gate and residual+skip widths up to "
            "4096, at most 512 output channels and at least 2 taps; got "
            f"{G}, {R + S}, {spec.out_channels}, {spec.kernel_size}")
    cs, streams = cluster or pick_cluster(spec, B, dtype)
    if cs not in CLUSTER_SIZES or not 1 <= streams <= CLUSTER_STREAMS:
        raise ValueError(f"_cluster must be (one of {CLUSTER_SIZES}, "
                         f"1..{CLUSTER_STREAMS}); got {(cs, streams)}")
    plan = _plan(spec, dtype, cs, streams, max_stages)
    if plan is None:
        tiles = -(-streams // TILE_ROWS)
        at = smem_layout(spec, dtype, cs, tiles)
        raise ValueError(
            f"the generation kernel's buffers for {TILE_ROWS * tiles} streams "
            f"of this model take {at['total'] - at['xin']} bytes of shared "
            f"memory at cluster size {cs}, and "
            + ("no whole layer blocks fit beside them (the chunk ring runs "
               "one row tile)" if tiles > 1 else
               "a ring of one step of its weights does not fit beside them")
            + f"; a block has {SMEM_BYTES}")
    return plan


def kernel_supports(spec: WaveNetSpec, dtype=torch.bfloat16,
                    cluster_size: Optional[int] = None) -> Tuple[bool, str]:
    """Whether ``csrc/generate.cu`` takes a model of this spec with a pack of
    this dtype, and if not, why. Any gate, residual and skip width is taken:
    ``KernelPack`` pads each to its CTA slices of 8-column fragments, and
    ``generate_steps`` pads the ring of a residual width that is not a
    multiple of 8. The kernel keeps at most 4096 channels a width and 512
    output channels a stream, needs two taps or more, and holds its
    activation buffers for 16 streams and a ring of weights in one block's
    shared memory at the cluster size (every size ``cluster_sizes`` gives
    when none is given): ``plan_launch`` raises with the reason otherwise."""
    sizes = cluster_sizes(spec, dtype) if cluster_size is None else (cluster_size,)
    for cs in sizes:
        try:
            plan_launch(spec, dtype, TILE_ROWS, cluster=(cs, TILE_ROWS))
        except ValueError as e:
            return False, str(e)
    return True, ""


def stream_groups(B: int, streams: int) -> Tuple[Tuple[int, int], ...]:
    """[start, end) of the streams each cluster owns, in grid order."""
    return tuple((s, min(B, s + streams)) for s in range(0, B, streams))


def _fragment_order(m: torch.Tensor) -> torch.Tensor:
    """(..., K, N) row-major, K % 16 == 0 and N % 8 == 0 -> (..., K*N) in
    the B-operand order of mma.m16n8k16: [k-step][n-tile][lane][4], lane
    (g = lane // 4, t = lane % 4) holding m[16 ks + 2t + {0, 1, 8, 9}, 8 nt + g]."""
    *lead, K, N = m.shape
    n = len(lead)
    f = m.reshape(*lead, K // 16, 2, 4, 2, N // 8, 8)   # ks, h, t, lo, nt, g
    f = f.permute(*range(n), n, n + 4, n + 5, n + 2, n + 1, n + 3)
    return f.reshape(*lead, K * N)


def _from_fragment_order(f: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """Inverse of ``_fragment_order``: (..., K*N) -> (..., K, N)."""
    *lead, _ = f.shape
    n = len(lead)
    m = f.reshape(*lead, K // 16, N // 8, 8, 4, 2, 2)   # ks, nt, g, t, h, lo
    m = m.permute(*range(n), n, n + 4, n + 3, n + 5, n + 1, n + 2)
    return m.reshape(*lead, K, N)


class KernelPack:
    """What ``csrc/generate.cu`` reads for one cluster size, as bytes: per CTA
    ``r`` of the cluster and per layer, one contiguous block [w_in slice |
    w_og slice | b_in | b_og] (``wl``), and per CTA [w_h1 slice | w_h2 slice
    | b_h1 slice | b_h2 slice] (``wh``); weights in the pack dtype, biases
    f32 in the same column order. Every width is cut into ``cluster_size``
    blocks of ``Gq`` gate, ``Rq`` residual and ``Sq`` skip channels
    (multiples of 8, zero padded past the real width); a w_in slice holds
    both GLU halves of its gate channels, [a | b]. w_h2 is cut into blocks
    of ``Cq`` classes for a split head (``split_head``), and whole (``Cq``
    = C_out padded) in every CTA otherwise. Depths are padded with zero rows
    to multiples of 16: ``Kin`` = k taps of ``CS*Rq`` channels, then cond;
    ``Kog`` and ``Ksk`` the padded gate and skip widths. bf16 slices are in
    mma fragment order, f32 slices row-major."""

    def __init__(self, packed: Dict[str, torch.Tensor], spec: WaveNetSpec,
                 cluster_size: int):
        dtype, dev = packed["w_first"].dtype, packed["w_first"].device
        CS = self.cluster_size = int(cluster_size)
        self.spec = spec
        L, k, R = spec.layers, spec.kernel_size, spec.residual_channels
        G2, S, C = spec.gate_channels // 2, spec.skip_out_channels, spec.out_channels
        cin = spec.cin_channels if spec.has_local_conditioning else 0
        d = self.dims = _kernel_dims(spec, CS)
        Gq, Rq, Sq, Kin, Kog, Ksk, Cq = (d[n] for n in (
            "Gq", "Rq", "Sq", "Kin", "Kog", "Ksk", "Cq"))
        Gp, Rp, Sp = CS * Gq, CS * Rq, CS * Sq
        self.dtype, self.bf16 = dtype, dtype == torch.bfloat16
        zeros = lambda *shape: torch.zeros(*shape, dtype=dtype, device=dev)

        w_in = zeros(L, Kin, 2, Gp)
        for tap in range(k):
            rows = packed["w_in"][:, tap * R:(tap + 1) * R]
            w_in[:, tap * Rp:tap * Rp + R, 0, :G2] = rows[..., :G2]
            w_in[:, tap * Rp:tap * Rp + R, 1, :G2] = rows[..., G2:]
        if cin:
            rows = packed["w_in"][:, k * R:]
            w_in[:, k * Rp:k * Rp + cin, 0, :G2] = rows[..., :G2]
            w_in[:, k * Rp:k * Rp + cin, 1, :G2] = rows[..., G2:]
        w_in = w_in.reshape(L, Kin, 2, CS, Gq).permute(3, 0, 1, 2, 4) \
            .reshape(CS, L, Kin, 2 * Gq)
        res, skip = zeros(L, Kog, Rp), zeros(L, Kog, Sp)
        res[:, :G2, :R] = packed["w_og"][..., :R]
        skip[:, :G2, :S] = packed["w_og"][..., R:]
        w_og = torch.cat([res.reshape(L, Kog, CS, Rq),
                          skip.reshape(L, Kog, CS, Sq)], dim=3).permute(2, 0, 1, 3)
        w_h1 = zeros(Ksk, Sp)
        w_h1[:S, :S] = packed["w_h1"]
        w_h1 = w_h1.reshape(Ksk, CS, Sq).permute(1, 0, 2)
        split = split_head(spec)
        Cp = CS * Cq if split else Cq     # the head's padded columns
        w_h2 = zeros(Ksk, Cp)
        w_h2[:S, :C] = packed["w_h2"]
        w_h2 = (w_h2.reshape(Ksk, CS, Cq).permute(1, 0, 2) if split
                else w_h2.expand(CS, Ksk, Cq))
        lay = _fragment_order if self.bf16 else (lambda m: m.flatten(-2))
        raw = lambda a: a.contiguous().view(torch.uint8)
        fz = lambda *shape: torch.zeros(*shape, device=dev)
        b_in = fz(L, 2, Gp)
        b_in[:, 0, :G2], b_in[:, 1, :G2] = packed["b_in"][:, :G2], packed["b_in"][:, G2:]
        b_in = b_in.reshape(L, 2, CS, Gq).permute(2, 0, 1, 3).reshape(CS, L, 2 * Gq)
        b_res, b_skip = fz(L, Rp), fz(L, Sp)
        b_res[:, :R], b_skip[:, :S] = packed["b_og"][:, :R], packed["b_og"][:, R:]
        b_og = torch.cat([b_res.reshape(L, CS, Rq), b_skip.reshape(L, CS, Sq)],
                         dim=2).permute(1, 0, 2)
        b_h1, b_h2 = fz(Sp), fz(Cp)
        b_h1[:S], b_h2[:C] = packed["b_h1"], packed["b_h2"]
        self.wl = torch.cat([raw(lay(w_in.contiguous())),
                             raw(lay(w_og.contiguous())),
                             raw(b_in), raw(b_og)], dim=2).contiguous()
        self.wh = torch.cat([raw(lay(w_h1.contiguous())),
                             raw(lay(w_h2.contiguous())),
                             raw(b_h1.reshape(CS, Sq)),
                             raw(b_h2.reshape(CS, Cq) if split
                                 else b_h2.expand(CS, Cq))], dim=1).contiguous()
        self.w_first = packed["w_first"]
        # the first 1x1 conv as the kernel reads it: its columns padded with
        # zeros to the ring's width, a multiple of 8 (generate_steps)
        self.first = tuple(F.pad(packed[n], (0, _up(R, 8) - R)).contiguous()
                           for n in ("w_first", "b_first"))

    def slices(self) -> Dict[str, torch.Tensor]:
        """The per-CTA slices as row-major matrices and their biases: w_in
        (CS, L, Kin, 2 Gq), w_og (CS, L, Kog, Rq + Sq), w_h1 (CS, Ksk, Sq),
        w_h2 (CS, Ksk, Cq); b_in (CS, L, 2 Gq), b_og (CS, L, Rq + Sq), b_h1
        (CS, Sq), b_h2 (CS, Cq)."""
        d, width = self.dims, 2 if self.bf16 else 4
        NA, NB = 2 * d["Gq"], d["Rq"] + d["Sq"]
        out = {}
        for blob, parts in ((self.wl, (("w_in", d["Kin"], NA), ("w_og", d["Kog"], NB),
                                       ("b_in", 0, NA), ("b_og", 0, NB))),
                            (self.wh, (("w_h1", d["Ksk"], d["Sq"]),
                                       ("w_h2", d["Ksk"], d["Cq"]),
                                       ("b_h1", 0, d["Sq"]), ("b_h2", 0, d["Cq"])))):
            at = 0
            for name, K, N in parts:
                if K == 0:   # a bias
                    out[name] = blob[..., at:at + 4 * N].contiguous().view(torch.float32)
                    at += 4 * N
                    continue
                flat = blob[..., at:at + width * K * N].contiguous().view(self.dtype)
                at += width * K * N
                out[name] = (_from_fragment_order(flat, K, N) if self.bf16
                             else flat.reshape(*flat.shape[:-1], K, N))
        return out


_KERNEL_PACKS: Dict[Tuple[int, int], Tuple[tuple, KernelPack]] = {}


@torch.no_grad()
def kernel_pack(packed: Dict[str, torch.Tensor], spec: WaveNetSpec,
                cluster_size: int) -> KernelPack:
    """The kernel-side pack of ``packed`` for one cluster size, made once:
    kept for the last few ``packed`` dicts seen, and remade when one of a
    dict's tensors was replaced or written to."""
    key = (id(packed), int(cluster_size))
    stamp = tuple((a.data_ptr(), a._version) for a in packed.values())
    hit = _KERNEL_PACKS.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    kp = KernelPack(packed, spec, cluster_size)
    _KERNEL_PACKS.pop(key, None)
    while len(_KERNEL_PACKS) >= 8:
        _KERNEL_PACKS.pop(next(iter(_KERNEL_PACKS)))
    _KERNEL_PACKS[key] = (stamp, kp)
    return kp


# ----------------------------------------------------------------------
# the kernel's wrapper
# ----------------------------------------------------------------------
_PTR = ctypes.c_void_p
_ARGTYPES = ([_PTR] * 5 + [ctypes.c_longlong] + [_PTR] * 4
             + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_uint]
             + [ctypes.c_int, ctypes.POINTER(_CPlan)] + [_PTR] * 3)
NO_PRODUCTS, TRACE = ("WN_NO_PRODUCTS",), ("WN_TRACE",)   # variant builds


def _kernel_fn(defines=()):
    from wavenet_vocoder_tpu_torch.kernels.build import load
    fn = load("generate", defines).wn_generate
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


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
                   kpack: Optional[KernelPack] = None,
                   plan: Optional[Plan] = None,
                   _cluster: Optional[Tuple[int, int]] = None,
                   _max_stages: int = -1,
                   _defines: Tuple[str, ...] = (),
                   _info: Optional[list] = None,
                   _trace: Optional[torch.Tensor] = None) -> None:
    """Run steps [t0, t0 + out.shape[1]) of the fused decoder in place.

    ring (total_rows, B, R) pack dtype; x_cur (B, C_in) f32; out (B, n) f32
    (scalar heads) or int32 (codes), rows may be strided; cond (B, n, cin)
    pack dtype or None; g_gate (L, B, G) f32 or None. CUDA tensors launch
    the kernel (the counter ``generate.launches`` of ``utils.profiling``
    counts the launches); CPU tensors run the plain version. There is no
    fallback between the two.

    ``plan`` is the launch's ``plan_launch`` for B streams, ``kpack`` the
    kernel-side pack of ``packed`` (``kernel_pack``) at its cluster size;
    each is made (and cached) here when not given. The counter
    ``generate.chunked_launches`` counts the launches whose plan is the
    chunk ring, ``generate.split_head_launches`` those whose head is split
    over the cluster (``split_head``: categorical, its x_cur rows one-hot or
    zero, unchecked here), ``generate.wide_cluster_launches`` those whose
    clusters own two row tiles, ``generate.gaussian_launches`` those whose
    head is the Gaussian (``head_code`` 2: the Box-Muller sampler). For
    sweeps and tests, where no ``plan`` is given: ``_cluster`` = (CTAs per
    cluster, streams per cluster) overrides ``pick_cluster``; ``_max_stages`` caps the whole layer blocks held in
    shared memory (0: the chunk ring); ``_defines`` launches a variant build (``NO_PRODUCTS``:
    a timing aid, outputs mean nothing; ``TRACE``: clock stamps of the last
    step of cluster 0 go to ``_trace``, an int64 tensor of 4 L + 5 values);
    ``_info`` receives [stages or chunk slots, head weights resident,
    shared bytes, clusters the card holds at once, chunk ring].
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
    if plan is None:
        plan = plan_launch(spec, dtype, B, cluster=_cluster,
                           max_stages=int(_max_stages))
    if kpack is None:
        kpack = kernel_pack(packed, spec, plan.CS)
    if (kpack.cluster_size != plan.CS or kpack.dtype != dtype
            or kpack.w_first is not packed["w_first"]
            or kpack.wl.shape[2] != plan.stage_bytes):
        raise ValueError("kpack was not made from this packed dict for "
                         f"the plan's cluster size {plan.CS}")
    info = (ctypes.c_int * 5)() if _info is not None else None
    ptr = lambda a: None if a is None else a.data_ptr()
    # the kernel reads and writes ring rows 8 channels a vector: a residual
    # width that is not a multiple of 8 runs on a copy padded with zero
    # channels, which stay zero (their weights are zero), copied back after
    kring = ring if plan.R == R else F.pad(ring, (0, plan.R - R)).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn(tuple(_defines))(
            ptr(kpack.first[0]), ptr(kpack.first[1]),
            ptr(kpack.wl), ptr(kpack.wh), ptr(cond), 0 if cond is None else cond.stride(0),
            ptr(g_gate), ptr(kring), ptr(x_cur), ptr(out), out.stride(0),
            B, n, int(t0), int(seed) & _M32, int(bool(deterministic)),
            plan.struct, info, ptr(_trace), stream)
    if err != 0:
        raise RuntimeError(
            f"generation kernel launch failed: CUDA error {err} (cluster "
            f"{plan.CS} x {plan.spc} streams)")
    if kring is not ring:
        ring.copy_(kring[..., :R])
    if _info is not None:
        _info[:] = list(info)
    profiling.count("generate.launches")
    if plan.chunked:
        profiling.count("generate.chunked_launches")
    if plan.head == 0:
        profiling.count("generate.split_head_launches")
    if plan.tiles > 1:
        profiling.count("generate.wide_cluster_launches")
    if plan.head == 2:
        profiling.count("generate.gaussian_launches")


# ----------------------------------------------------------------------
# pack-once, generate-many
# ----------------------------------------------------------------------
class FusedGenerator:
    """Pack-once, generate-many wrapper around ``generate_steps`` — the
    counterpart of the JAX package's ``PallasGenerator``. Build once per
    model, call per batch.

    ``mesh``: a ``parallel.Mesh`` whose ``data_axis`` lists the devices the
    utterances are split over (the JAX generator's shard_map dispatch): one
    weight pack per device, shard i of the batch on the i-th device with
    seed + i (JAX's ``seed + axis_index``), no communication between the
    shards. Every shard's launches are issued before any result is waited
    on. The conditioning is upsampled on the model's device and split."""

    def __init__(self, model: WaveNet, *, weight_dtype=torch.bfloat16,
                 chunk: int = DEFAULT_CHUNK, mesh=None,
                 data_axis: str = "data"):
        self.model = model
        self.spec = model.spec
        self.chunk = int(chunk)
        self.weight_dtype = weight_dtype
        self.mesh = mesh
        with profiling.span("generator.pack"):
            self.packed = pack_weights(model, dtype=weight_dtype)
            self.device = self.packed["w_first"].device
            devices = ([self.device] if mesh is None else
                       [torch.device(d) for d in mesh.axis_devices(data_axis)])
            # one weight pack (and kernel-side packs) per device; shard i
            # runs on devices[i]
            packs = {}
            for d in devices:
                if d not in packs:
                    packed = (self.packed if d == self.device else
                              {k: v.to(d) for k, v in self.packed.items()})
                    packs[d] = (packed, self._kernel_packs(packed, d))
        self.shards = [(d,) + packs[d] for d in devices]

    def _kernel_packs(self, packed, device):
        """The kernel-side packs for each cluster size the picker returns
        (``cluster_sizes``); the plain version on the CPU needs none."""
        if device.type != "cuda":
            return {}
        with torch.cuda.device(device):
            return {cs: kernel_pack(packed, self.spec, cs)
                    for cs in cluster_sizes(self.spec, self.weight_dtype)}

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
        """(B, T) f32 samples (scalar heads) or int32 codes (categorical),
        on the model's device.

        c: (B, T_mel, C) mel with an upsample net, else (B, T, C); c_up,
        instead of c: (B, T, C) conditioning already at the sample rate;
        log_scale_min is accepted and not applied, as in the JAX kernel.
        T is padded to a multiple of ``chunk`` (conditioning repeats its last
        frame) and the output trimmed.

        initial_input: (B, C_in) first input; a categorical model's rows are
        one-hot (or zero), checked where given, else it raises.

        state: (x_cur, ring, t) from an earlier call's returned state —
        resumes generation at absolute step t with the same ``seed``, so
        segment after segment equals one long call. The kernel updates
        ``x_cur`` and ``ring`` in place: a state that was passed in is used
        up, and the returned state holds the same tensors. With
        ``return_state`` the result is (samples, state). Carried segments
        must be multiples of ``chunk``: padding steps would advance the
        state past the segment's end. A generator over a mesh carries no
        state.
        """
        del log_scale_min
        spec, dev, dtype, chunk = self.spec, self.device, self.weight_dtype, self.chunk
        model = self.model
        as_dev = lambda a: None if a is None else torch.as_tensor(a, device=dev)
        if c is not None and c_up is not None:
            raise ValueError("give c or c_up, not both")
        if self.mesh is not None and (state is not None or return_state):
            raise ValueError("streaming state carry is single-device; run "
                             "one stream group per device instead")
        c, g = as_dev(c), as_dev(g)
        # the conditioning at the sample rate, padded to whole chunks in the
        # pack dtype, and the global conditioning's gate biases
        with profiling.span("generate.condition"):
            if c_up is not None:
                c_up = as_dev(c_up).float()
            else:
                c_up = model.upsample_conditioning(
                    None if c is None else c.float())
            if c_up is not None:
                T = c_up.shape[1] if T is None else T
                if c_up.shape[1] != T:
                    raise ValueError(f"conditioning covers {c_up.shape[1]} "
                                     f"samples, T is {T}")
            if T is None:
                raise ValueError("T required without conditioning")
            if (state is not None or return_state) and T % chunk:
                raise ValueError(
                    f"streaming segments must be multiples of the kernel "
                    f"chunk ({chunk}); got T={T}")
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
            n = len(self.shards)
            if B % n:
                raise ValueError(f"batch {B} not divisible by the mesh's "
                                 f"data axis ({n}); pad the utterance batch")
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
                g_gate = torch.stack(
                    [conv1x1(blk.conv1x1g, g_vec.float())
                     for blk in model.conv_layers]).float().contiguous()
        t_off = 0
        if state is not None:
            x_cur, ring, t_off = state
        elif initial_input is None:
            x_cur = default_initial_input(spec, B, device=dev)
        else:
            x_cur = torch.as_tensor(initial_input).reshape(B, -1).float()
            if split_head(spec) and not bool(
                    (((x_cur == 0) | (x_cur == 1)).all(dim=1)
                     & (x_cur.sum(dim=1) <= 1)).all()):
                raise ValueError("initial_input of a categorical model must "
                                 "hold one-hot (or zero) rows")
            x_cur = as_dev(x_cur).clone()
        _, rows = buffer_layout(spec)
        Bs = B // n
        runs = []
        for i, (d, packed, kpacks) in enumerate(self.shards):
            part = lambda a, ax=0: None if a is None else a.narrow(
                ax, i * Bs, Bs).to(d).contiguous()
            plan = plan_launch(spec, dtype, Bs) if d.type == "cuda" else None
            runs.append(dict(
                packed=packed, cond=part(cond), g_gate=part(g_gate, 1),
                x_cur=x_cur if n == 1 else part(x_cur),
                ring=(ring if state is not None else torch.zeros(
                    rows, Bs, spec.residual_channels, dtype=dtype, device=d)),
                out=torch.empty(Bs, T_pad, device=d, dtype=(
                    torch.float32 if spec.scalar_input else torch.int32)),
                plan=plan, kpack=plan and kpacks[plan.CS]))
        # chunk by chunk, every shard's launch before the next chunk: the
        # devices run side by side, and nothing here waits on them
        with profiling.span("generate.launch"):
            for t0 in range(0, T_pad, chunk):
                for i, r in enumerate(runs):
                    generate_steps(r["packed"], spec, r["ring"], r["x_cur"],
                                   r["out"][:, t0:t0 + chunk],
                                   None if r["cond"] is None
                                   else r["cond"][:, t0:t0 + chunk],
                                   r["g_gate"], t0=t_off + t0, seed=seed + i,
                                   deterministic=deterministic,
                                   kpack=r["kpack"], plan=r["plan"])
        out = (runs[0]["out"] if n == 1 else
               torch.cat([r["out"].to(dev) for r in runs]))
        if return_state:
            return out[:, :T], (x_cur, runs[0]["ring"], t_off + T)
        return out[:, :T]
