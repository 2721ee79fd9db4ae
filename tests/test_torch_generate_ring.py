"""The generation kernel's launch plan (``ops/cuda_generate.plan_launch``),
checked on the CPU: whole layer blocks where two fit beside the activation
buffers and the head's block, else the chunk ring, whose chunks tile every
layer block and the head's block in whole steps and fit a block's shared
memory with the buffers; the cluster shapes the picker takes; and the plan's
fields and constants as ``csrc/generate.cu`` declares them. The kernel
itself runs these plans on a GPU (``tests/test_torch_kernels.py``)."""
import ctypes
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from wavenet_vocoder_tpu_torch.config import Config, load_config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec, spec_from_config
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg


ROOT = Path(__file__).resolve().parent.parent
EGS = ROOT / "egs"
KERNEL_SRC = ROOT / "wavenet_vocoder_tpu_torch" / "csrc" / "generate.cu"


def _spec(R, G, S, layers=24, stacks=4, cin=80):
    return WaveNetSpec(layers=layers, stacks=stacks, residual_channels=R,
                       gate_channels=G, skip_out_channels=S, cin_channels=cin,
                       out_channels=30, scalar_input=True)


def _widest():
    """The widest of the models with R = S = G / 2 that kernel_supports
    takes at both cluster sizes the picker may choose (4 and 8)."""
    taken = [w for w in range(64, 1025, 64)
             if cg.kernel_supports(_spec(w, 2 * w, w))[0]]
    assert taken and taken[-1] < 1024
    return _spec(taken[-1], 2 * taken[-1], taken[-1])


SPECS = {
    "flagship": lambda: spec_from_config(Config()),
    "512ch": lambda: spec_from_config(Config(residual_channels=512,
                                             gate_channels=512,
                                             skip_out_channels=256)),
    "widest": _widest,
    # a ragged model whose chunks end on partial chunks and passes
    "ragged": lambda: _spec(40, 1096, 56, layers=3, stacks=1, cin=5),
    # r9y9's mu-law 256 recipe: one-hot 256 in, a 256-way categorical head
    # split over the cluster (30 layers in 3 stacks, 128/256/128)
    "mulaw256": lambda: spec_from_config(load_config(
        str(EGS / "mulaw256/conf/mulaw256_wavenet.json"))),
    # the MoL and Gaussian models of the same family
    "30L3S": lambda: spec_from_config(Config(layers=30, stacks=3)),
    "gaussian": lambda: spec_from_config(load_config(
        str(EGS / "gaussian/conf/gaussian_wavenet.json"))),
}
# (spec, dtype, cluster size) whose plan is the chunk ring; the ragged
# model's w_in product takes three passes at clusters of 4
CHUNKED = [(name, dtype, cs) for name, dtype in (
    ("512ch", torch.bfloat16), ("widest", torch.bfloat16),
    ("flagship", torch.float32)) for cs in (4, 8)] + [
    ("ragged", torch.bfloat16, 4)]
# and the mu-law 256 recipe at clusters of 4, whose two layer blocks fit
# but not beside its head's block (a 64-class slice of w_h2)
TILED = CHUNKED + [("mulaw256", torch.bfloat16, 4)]
_ids = lambda cases: [f"{n}-{str(d)[6:]}-{cs}" for n, d, cs in cases]
CHUNKED_IDS = _ids(CHUNKED)


def _plan(spec, cs, dtype, rows=16, max_stages=-1):
    """The plan of clusters of ``cs`` CTAs and ``rows`` streams."""
    return cg.plan_launch(spec, dtype, rows, cluster=(cs, rows),
                          max_stages=max_stages)


def _no_plan(spec, cs, dtype, rows=16, max_stages=-1):
    """No ring fits beside the buffers: the planner says so."""
    with pytest.raises(ValueError, match="shared memory"):
        _plan(spec, cs, dtype, rows, max_stages)
    return True


def _buffers(spec, cs, dtype, tiles=1):
    """(bytes of a CTA's activation buffers and mbarriers beside no ring,
    bytes of one layer block)."""
    at = cg.smem_layout(spec, dtype, cs, tiles)
    return at["total"] - at["xin"], at["stage_bytes"]


def _copies(spec, cs, dtype, plan):
    """(source offset, bytes, offset in the slot) of every copy the chunk
    ring's filler issues for one layer block and for the head's block, in
    its order, as ``generate_kernel`` computes them from the plan."""
    d = cg._kernel_dims(spec, cs)
    elt = 2 if dtype == torch.bfloat16 else 4
    NA, NB = 2 * d["Gq"], d["Rq"] + d["Sq"]
    prods = cg.ring_products(spec, cs, dtype)
    win, wog = d["Kin"] * NA * elt, d["Kog"] * NB * elt
    wh1, wh2 = d["Ksk"] * d["Sq"] * elt, d["Ksk"] * d["Cq"] * elt
    starts = (0, win, 0, wh1)
    biases = (win + wog, win + wog + 4 * NA, wh1 + wh2, wh1 + wh2 + 4 * d["Sq"])
    layer, head = [], []
    for i, ((KS, step, N, _), at, bias) in enumerate(zip(prods, starts, biases)):
        out = layer if i < 2 else head
        for _ in range(plan.passes[i]):
            for k0 in range(0, KS, plan.ck[i]):
                k1 = min(KS, k0 + plan.ck[i])
                out.append((at + k0 * step, (k1 - k0) * step, 0))
                if k1 == KS:
                    out.append((bias, 4 * N, (k1 - k0) * step))
    return layer, head


@pytest.mark.parametrize("name,dtype,cs", TILED, ids=_ids(TILED))
def test_chunks_tile_every_block(name, dtype, cs):
    """Each pass of each product is cut into whole steps that tile its
    weights, and the biases come once a pass behind the last chunk: one
    pass's copies cover the layer block and the head's block exactly, in
    16-byte multiples, and every chunk with its biases fits its slot."""
    spec = SPECS[name]()
    plan = _plan(spec, cs, dtype)
    assert plan.chunked
    d = cg._kernel_dims(spec, cs)
    elt = 2 if dtype == torch.bfloat16 else 4
    NA, NB = 2 * d["Gq"], d["Rq"] + d["Sq"]
    block = (d["Kin"] * NA + d["Kog"] * NB) * elt + (NA + NB) * 4
    head = d["Ksk"] * (d["Sq"] + d["Cq"]) * elt + (d["Sq"] + d["Cq"]) * 4
    assert (plan.stage_bytes, plan.head_bytes) == (block, head)
    for copies, size in zip(_copies(spec, cs, dtype, plan), (block, head)):
        # a product's later passes copy the same bytes again
        spans = sorted({(at, at + n) for at, n, _ in copies})
        assert spans[0][0] == 0 and spans[-1][1] == size
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        for at, n, dst in copies:
            assert at % 16 == 0 and n % 16 == 0 and dst % 16 == 0 and n > 0
            assert dst + n <= plan.slot_bytes
    for (KS, step, N, units), c, passes in zip(
            cg.ring_products(spec, cs, dtype), plan.ck, plan.passes):
        assert 1 <= c <= KS and step % 16 == 0
        assert passes * cg.RING_UNITS >= units


@pytest.mark.parametrize("name,dtype,cs", CHUNKED, ids=CHUNKED_IDS)
def test_chunk_ring_fits_shared_memory(name, dtype, cs):
    """The ring and the activation buffers fit a block's shared memory, the
    plan's offsets those of ``smem_layout`` for its ring; the 512ch model,
    whose layer blocks do not fit twice, streams through RING_SLOTS slots of
    30-40 KB, in one pass of each product at clusters of 8 (two of w_og at
    clusters of 4: three tiles a warp)."""
    spec = SPECS[name]()
    assert cg.kernel_supports(spec, dtype, cs) == (True, "")
    fixed, block = _buffers(spec, cs, dtype)
    plan = _plan(spec, cs, dtype)
    assert plan.total <= cg.SMEM_BYTES
    assert plan.total >= fixed + plan.nstage * plan.slot_bytes
    assert fixed + 2 * block > cg.SMEM_BYTES or dtype == torch.float32
    at = cg.smem_layout(spec, dtype, cs, 1, plan.nstage, plan.slot_bytes)
    assert at == {n: getattr(plan, n) for n in at}
    if name == "512ch":
        assert plan.nstage == cg.RING_SLOTS == 2
        assert 30 * 1024 <= plan.slot_bytes <= 40 * 1024
        assert plan.passes == ((1, 1, 1, 1) if cs == 8 else (1, 2, 1, 1))
    if name == "ragged":
        assert plan.passes[0] == 3


@pytest.mark.parametrize("B", [1, 240, 256])
def test_flagship_keeps_whole_layer_stages(B):
    """The flagship's bf16 launches keep whole layer blocks, the head's
    block resident: four at clusters of 8 (B <= 240), two at clusters of 4
    (B=256; 32-stream clusters of 8 would keep two as well, but the
    picker keeps them for models whose clusters of 4 stream the chunk
    ring). ``_max_stages=0`` forces the chunk ring, as does an f32 pack
    (two f32 blocks do not fit); at 32 streams nothing does (the chunk ring
    runs one row tile)."""
    spec = spec_from_config(Config())
    cs, streams = cg.pick_cluster(spec, B)
    plan = cg.plan_launch(spec, torch.bfloat16, B)
    assert (plan.CS, plan.spc, plan.tiles) == (cs, streams, 1)
    assert not plan.chunked and plan.nstage == {8: 4, 4: 2}[cs]
    assert plan.head_res == 1
    assert (cs, streams) == ((8, min(B, 16)) if B <= 240 else (4, 16))
    assert _plan(spec, 8, torch.bfloat16, rows=32).nstage == 2
    for c in (cs, 4):
        assert not _plan(spec, c, torch.bfloat16).chunked
        assert _plan(spec, c, torch.bfloat16, max_stages=0).chunked
        assert _plan(spec, c, torch.float32).chunked
        capped = _plan(spec, c, torch.bfloat16, max_stages=2)
        assert not capped.chunked and capped.nstage == 2
    assert _no_plan(spec, 8, torch.bfloat16, 32, max_stages=0)
    assert _no_plan(spec, 8, torch.float32, 32)


def test_kernel_pack_plan_carries_the_ring():
    """The struct ``wn_generate`` reads carries the ring's slots, slot bytes,
    chunks and passes, and the pack's block sizes."""
    spec = _spec(64, 128, 64, layers=4, stacks=2, cin=4)
    model = WaveNet(spec, generator=torch.Generator().manual_seed(0))
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    kp = cg.kernel_pack(packed, spec, 8)
    plan = _plan(spec, 8, torch.bfloat16, max_stages=0)
    assert plan.chunked and not plan.head_res
    st = plan.struct
    assert (st.nstage, st.slot_bytes) == (plan.nstage, plan.slot_bytes)
    assert list(st.ck) == list(plan.ck) and list(st.passes) == list(plan.passes)
    assert (st.stage_bytes, st.head_bytes) == (kp.wl.shape[2], kp.wh.shape[1])
    whole = _plan(spec, 8, torch.bfloat16)
    assert not whole.chunked and whole.nstage == spec.layers


def test_supports_exactly_where_a_ring_fits():
    """kernel_supports takes a model where a ring fits beside the buffers
    at every cluster size the picker may choose (``cluster_sizes``: here
    its largest and 4), and says why otherwise."""
    def fits(spec, cs, dtype):
        try:
            return _plan(spec, cs, dtype) is not None
        except ValueError:
            return False
    for R, G, S in ((512, 512, 256), (2048, 4096, 2048), (64, 4096, 1024)):
        spec = _spec(R, G, S)
        for dtype in (torch.bfloat16, torch.float32):
            takes, why = cg.kernel_supports(spec, dtype)
            first = cg.pick_cluster(spec, 1)[0]
            sizes = cg.cluster_sizes(spec, dtype)
            assert sizes == tuple(c for c in cg.CLUSTER_SIZES
                                  if min(first, 4) <= c <= first)
            assert takes == all(fits(spec, c, dtype) for c in sizes)
            assert takes or "shared memory" in why


@pytest.mark.parametrize("B", [1, 16, 240, 256])
def test_mulaw256_splits_its_head_to_keep_whole_layer_stages(B):
    """The mu-law 256 recipe's categorical head is split over the cluster:
    at clusters of 8 each CTA holds 32 of the 256 classes, and its bf16
    launches keep whole layer blocks with the head's block resident, as the
    30-layer MoL model does: four at 16 streams a cluster, two at 32 (B=256).
    At clusters of 4 (16 streams; the picker's choice at B=256 before
    32-stream clusters) two layer blocks and the head do not fit, and the
    chunk ring streams a 64-class slice of w_h2 in one pass."""
    spec = SPECS["mulaw256"]()
    assert cg.split_head(spec) and not cg.split_head(SPECS["30L3S"]())
    cs, streams = cg.pick_cluster(spec, B)
    rows = 32 if streams > 16 else 16
    assert (cs, rows) == ((8, 16) if B <= 240 else (8, 32))
    plan = cg.plan_launch(spec, torch.bfloat16, B)
    assert (plan.CS, plan.spc, plan.tiles) == (cs, streams, rows // 16)
    assert cg._kernel_dims(spec, cs)["Cq"] == plan.Cq == 256 // cs
    assert not plan.chunked and plan.nstage == (4 if rows == 16 else 2)
    assert plan.nstage == _plan(SPECS["30L3S"](), cs, torch.bfloat16,
                                rows=rows).nstage
    assert plan.total <= cg.SMEM_BYTES and plan.head == 0
    four = _plan(spec, 4, torch.bfloat16)
    d = cg._kernel_dims(spec, 4)
    assert four.chunked and four.nstage == cg.RING_SLOTS
    assert _plan(spec, 4, torch.bfloat16, max_stages=2) == four
    KS, step, N, units = cg.ring_products(spec, 4, torch.bfloat16)[3]
    assert N == d["Cq"] == 64 and step == 16 * 64 * 2
    assert four.ck[3] == KS and four.passes[3] == 1
    assert four.total <= cg.SMEM_BYTES


# every plan of the heads that are not split, as before the categorical
# head was split: (stages, slot bytes, chunks, passes, shared bytes) at
# clusters of 8 and 4, bf16 then f32 (None: no ring fits)
UNSPLIT_PLANS = {
    "flagship": {(8, "bf16"): (4, 0, (0,) * 4, (0,) * 4, 221440),
                 (8, "f32"): (2, 59520, (464, 128, 128, 128), (1, 1, 1, 1), 217728),
                 (4, "bf16"): (2, 0, (0,) * 4, (0,) * 4, 231680),
                 (4, "f32"): (2, 65792, (256, 128, 128, 128), (1, 2, 1, 1), 232448)},
    "30L3S": {(8, "bf16"): (4, 0, (0,) * 4, (0,) * 4, 221568),
              (8, "f32"): (2, 59520, (464, 128, 128, 128), (1, 1, 1, 1), 217856),
              (4, "bf16"): (2, 0, (0,) * 4, (0,) * 4, 231808),
              (4, "f32"): (2, 65536, (255, 128, 128, 128), (1, 2, 1, 1), 232064)},
    "gaussian": {(8, "bf16"): (4, 0, (0,) * 4, (0,) * 4, 213632),
                 (8, "f32"): (2, 59520, (464, 128, 128, 128), (1, 1, 1, 1), 216192),
                 (4, "bf16"): (2, 0, (0,) * 4, (0,) * 4, 224000),
                 (4, "f32"): (2, 66560, (259, 128, 128, 128), (1, 2, 1, 1), 232448)},
    "512ch": {(8, "bf16"): (2, 39168, (19, 12, 16, 16), (1, 1, 1, 1), 232192),
              (8, "f32"): None,
              (4, "bf16"): (2, 31488, (7, 5, 15, 16), (1, 2, 1, 1), 231424),
              (4, "f32"): None},
}


@pytest.mark.parametrize("name", sorted(UNSPLIT_PLANS))
def test_unsplit_heads_keep_their_plans(name):
    """The MoL and Gaussian heads stay whole in every CTA: the flagship's,
    the 30-layer MoL model's, the Gaussian recipe's and the 512ch model's
    plans are the same as before the split."""
    spec = SPECS[name]()
    assert not cg.split_head(spec)
    for (cs, dt), want in UNSPLIT_PLANS[name].items():
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        if want is None:
            assert _no_plan(spec, cs, dtype), (cs, dt)
            continue
        plan = _plan(spec, cs, dtype)
        assert (plan.nstage, plan.slot_bytes, plan.ck, plan.passes,
                plan.total) == want, (cs, dt)


# bf16 at clusters of 8 and 32 rows: (activation buffers, one layer block,
# plan or None). Buffers, M = 32 rows, bf16 (2 B), each rounded up to 128 B
# (the row strides xs, gs, ss are Kin, Kog, Ksk moved to 8 mod 64):
#   [older taps | cond | newest tap] 2 M xs 2 + gated M gs 2 + head in and hidden 2 M ss 2
#   + w_in partials 4 parts (SPLIT_IN x 2 row tiles) x 2 Gq x M x 4
#   + residual M Rq 4 + skips
#   M Sq 4 + head out M Cq 4 + input M C_in 4 (a split head: candidates
#   M x 8 CTAs x 8) + first conv 2 x 8 Rq 4 + codes M 4 + L x 16 + barriers.
# mulaw256 (Gq = Rq = Sq = 16, Kin = 3 x 128 + 80 = 464, xs 520, Kog =
# Ksk = 128, gs = ss = 136, Cq = 32, 30 layers, 6 barriers):
#   66,560 + 8,704 + 2 x 8,704 + 16,384 + 2,048 + 2,048 + 4,096 + 2,048
#   + 1,024 + 128 + 512 + 128 = 121,088; a layer block (464 x 32 + 128 x
#   32) x 2 + (32 + 32) x 4 = 38,144; the head's block 128 x (16 + 32) x 2
#   + 48 x 4 = 12,480 -> 12,544; two stages and their 2 x 2 barriers:
#   2 x 38,144 + 12,544 + 121,088 - 128 + 128 = 209,920 of 232,448.
# flagship: 24 layers, 5 barriers, C_in 1 (128 B) and no candidates, Cq 32
#   (30 columns padded): 119,040 and 207,872.
# 512ch (Gq 32, Rq 64, Sq 32, Kin 3 x 512 + 80 = 1,616): its buffers alone
#   take 318,720 B.
WIDE_PLANS = {"mulaw256": (121088, 38144, (2, 209920)),
              "flagship": (119040, 38144, (2, 207872)),
              "512ch": (318720, 256640, None)}


@pytest.mark.parametrize("name", sorted(WIDE_PLANS))
def test_plans_at_32_rows(name):
    """A cluster of 32 streams (two mma row tiles) doubles every activation
    buffer: the mu-law 256 and flagship models still keep two whole layer
    blocks beside the head's at clusters of 8 (bf16), 512ch has no plan
    (its 32-row buffers alone pass a block's shared memory), and no model
    gets a 32-row chunk ring or an f32 32-row plan here."""
    spec = SPECS[name]()
    fixed, block, want = WIDE_PLANS[name]
    assert _buffers(spec, 8, torch.bfloat16, tiles=2) == (fixed, block)
    assert _buffers(spec, 8, torch.bfloat16)[1] == block
    if want is None:
        assert _no_plan(spec, 8, torch.bfloat16, 32) and fixed > cg.SMEM_BYTES
    else:
        plan = _plan(spec, 8, torch.bfloat16, 32)
        assert (plan.nstage, plan.slot_bytes, plan.ck, plan.passes,
                plan.total) == (want[0], 0, (0,) * 4, (0,) * 4, want[1])
        assert plan.tiles == 2 and plan.total <= cg.SMEM_BYTES
    assert _no_plan(spec, 8, torch.bfloat16, 32, max_stages=0)
    assert _no_plan(spec, 8, torch.float32, 32)


# (model, B) -> (CTAs, streams) a cluster: 16-stream clusters of 8 while
# they all fit the card (B <= 240); past that clusters of 4, unless their
# plan is the chunk ring and 32-stream clusters of 8 keep whole layer
# blocks (mulaw256); 512ch has no 32-row plan, and the flagship's clusters
# of 4 keep whole blocks. At B=512 both shapes take two waves.
PICKS = {B: {"mulaw256": (8, min(B, 16)) if B <= 240 else (8, 32),
             "flagship": (8, min(B, 16)) if B <= 240 else (4, 16),
             "512ch": (8, min(B, 16)) if B <= 240 else (4, 16)}
         for B in (1, 16, 128, 240, 241, 256, 480, 512)}


@pytest.mark.parametrize("name", ["mulaw256", "flagship", "512ch"])
@pytest.mark.parametrize("B", sorted(PICKS))
def test_picker_at_the_benchmark_models(B, name):
    """What ``pick_cluster`` chooses for the benchmark's bf16 models, from
    the spec's widths, B and the plans alone; the grid's waves the fewest
    the two ways give; f32 packs never take 32-stream clusters here."""
    spec = SPECS[name]()
    cs, streams = cg.pick_cluster(spec, B)
    assert (cs, streams) == PICKS[B][name]
    plan = cg.plan_launch(spec, torch.bfloat16, B)
    assert (plan.CS, plan.spc, plan.tiles) == (cs, streams, -(-streams // 16))
    assert cs in cg.cluster_sizes(spec)
    waves = lambda c, s: -(-(-(-B // s)) // (cg.RESIDENT_CTAS // c))
    assert waves(cs, streams) == (1 if B <= 480 else 2)
    assert cg.pick_cluster(spec, B, torch.float32)[1] <= 16


def _struct_fields(src):
    """(name, ints) of every field of ``struct Plan`` in a C source."""
    body = re.search(r"^struct Plan \{(.*?)^\};", src, re.S | re.M).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if decl.strip():
            assert decl.split()[0] == "int", decl
            for name in decl.strip()[3:].split(","):
                m = re.fullmatch(r"\s*(\w+)(?:\[(\d+)\])?\s*", name)
                fields.append((m.group(1), int(m.group(2) or 1)))
    return fields


def test_plan_struct_and_constants_match_the_kernel():
    """``csrc/generate.cu``'s ``struct Plan`` has the fields of ``Plan`` and
    ``_CPlan``, in order and of the same sizes, and the kernel reads every
    one of them; its constants are the planner's."""
    src = KERNEL_SRC.read_text()
    fields = _struct_fields(src)
    assert fields == [(n, getattr(t, "_length_", 1)) for n, t in cg._CPlan._fields_]
    assert tuple(n for n, _ in fields) == cg.Plan._fields
    assert ctypes.sizeof(cg._CPlan) == 4 * sum(n for _, n in fields)
    rest = src.replace(re.search(r"^struct Plan \{.*?^\};", src,
                                 re.S | re.M).group(0), "")
    for name, _ in fields:
        assert re.search(rf"\b(p\.plan|q)\.{name}\b", rest), name
    const = dict(re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src))
    const = {n: int(v) for n, v in const.items()}
    assert const["kTileRows"] == cg.TILE_ROWS
    assert const["kTileRows"] * const["kMaxTiles"] == cg.CLUSTER_STREAMS
    assert const["kThreads"] == cg.KERNEL_THREADS
    assert const["kSplitIn"] == cg.SPLIT_IN
    assert const["kBars"] == cg.BARRIERS
    assert const["kUnits"] == cg.RING_UNITS
    assert const["kSmemLimit"] == cg.SMEM_BYTES


@pytest.mark.parametrize("cs", cg.CLUSTER_SIZES)
@pytest.mark.parametrize("name", ["flagship", "512ch", "mulaw256", "gaussian"])
def test_w_in_walks_the_newest_tap_last(name, cs):
    """A bf16 CTA's w_in slice orders its depth [older taps | cond | newest
    tap]: every row before the plan's first newest-tap k-step (``ks_new``)
    holds an older tap, the conditioning or padding, and the newest tap's
    rows lie at or after it, from ``new_at`` on, which the kernel's vector
    stores reach (a multiple of 8). An f32 slice keeps the plain version's
    order [taps | cond]. One layer a stack: the order does not depend on
    the depth."""
    spec = SPECS[name]()
    spec = dataclasses.replace(spec, layers=spec.stacks)
    k, R = spec.kernel_size, spec.residual_channels
    cin = spec.cin_channels if spec.has_local_conditioning else 0
    assert cin > 0
    # each public w_in row tagged by where it comes from: 1 an older tap,
    # 2 the newest tap, 3 the conditioning (exact in bf16)
    kind = torch.tensor([1.0] * ((k - 1) * R) + [2.0] * R + [3.0] * cin)
    rows = lambda tags, v: torch.nonzero(tags == v)[:, 0].tolist()
    for dtype in (torch.bfloat16, torch.float32):
        d = cg._kernel_dims(spec, cs, dtype)
        Rp = cs * d["Rq"]
        packed = {n: torch.zeros(shape, dtype=torch.float32 if n.startswith("b_") else dtype)
                  for n, shape in cg.packed_shapes(spec).items()}
        packed["w_in"][:] = kind.to(dtype)[None, :, None]
        tags = cg.KernelPack(packed, spec, cs).slices()["w_in"][0, 0, :, 0].float()
        older = [t * Rp + c for t in range(k - 1) for c in range(R)]
        assert rows(tags, 1.0) == older
        assert rows(tags, 2.0) == list(range(d["new_at"], d["new_at"] + R))
        assert rows(tags, 3.0) == list(range(d["cond_at"], d["cond_at"] + cin))
        assert d["new_at"] % 8 == 0 and d["new_at"] + Rp <= d["Kin"]
        if dtype == torch.float32:
            assert (d["new_at"], d["cond_at"]) == ((k - 1) * Rp, k * Rp)
            continue
        assert d["cond_at"] == (k - 1) * Rp
        assert 16 * d["ks_new"] <= d["new_at"] < 16 * d["ks_new"] + 16
        assert not bool((tags[:16 * d["ks_new"]] == 2.0).any())
        if cg._plan(spec, dtype, cs, 16) is not None:
            plan = _plan(spec, cs, dtype)
            assert (plan.cond_at, plan.new_at, plan.ks_new) == (
                d["cond_at"], d["new_at"], d["ks_new"])
