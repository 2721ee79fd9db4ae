"""How the generation kernel's weights reach shared memory
(``ops/cuda_generate.ring_plan``), checked on the CPU: whole layer blocks
where two fit beside the activation buffers and the head's block, else the
chunk ring, whose chunks tile every layer block and the head's block in
whole steps and fit a block's shared memory with the buffers. The kernel
itself runs these plans on a GPU (``tests/test_torch_kernels.py``)."""
from pathlib import Path

import pytest
import torch

from wavenet_vocoder_tpu_torch.config import Config, load_config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec, spec_from_config
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg


EGS = Path(__file__).resolve().parent.parent / "egs"


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
            for k0 in range(0, KS, plan.chunk[i]):
                k1 = min(KS, k0 + plan.chunk[i])
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
    plan = cg.ring_plan(spec, cs, dtype)
    assert plan is not None and plan.chunked
    d = cg._kernel_dims(spec, cs)
    elt = 2 if dtype == torch.bfloat16 else 4
    NA, NB = 2 * d["Gq"], d["Rq"] + d["Sq"]
    block = (d["Kin"] * NA + d["Kog"] * NB) * elt + (NA + NB) * 4
    head = d["Ksk"] * (d["Sq"] + d["Cq"]) * elt + (d["Sq"] + d["Cq"]) * 4
    for copies, size in zip(_copies(spec, cs, dtype, plan), (block, head)):
        # a product's later passes copy the same bytes again
        spans = sorted({(at, at + n) for at, n, _ in copies})
        assert spans[0][0] == 0 and spans[-1][1] == size
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        for at, n, dst in copies:
            assert at % 16 == 0 and n % 16 == 0 and dst % 16 == 0 and n > 0
            assert dst + n <= plan.slot_bytes
    for (KS, step, N, units), c, passes in zip(
            cg.ring_products(spec, cs, dtype), plan.chunk, plan.passes):
        assert 1 <= c <= KS and step % 16 == 0
        assert passes * cg.RING_UNITS >= units


@pytest.mark.parametrize("name,dtype,cs", CHUNKED, ids=CHUNKED_IDS)
def test_chunk_ring_fits_shared_memory(name, dtype, cs):
    """The ring and the activation buffers fit a block's shared memory; the
    512ch model, whose layer blocks do not fit twice, streams through
    RING_SLOTS slots of 30-40 KB, in one pass of each product at clusters
    of 8 (two of w_og at clusters of 4: three tiles a warp)."""
    spec = SPECS[name]()
    assert cg.kernel_supports(spec, dtype, cs) == (True, "")
    fixed, block = cg.kernel_smem_bytes(spec, cs, dtype)
    plan = cg.ring_plan(spec, cs, dtype)
    assert plan.smem_bytes <= cg.SMEM_BYTES
    assert plan.smem_bytes >= fixed + plan.stages * plan.slot_bytes
    assert fixed + 2 * block > cg.SMEM_BYTES or dtype == torch.float32
    if name == "512ch":
        assert plan.stages == cg.RING_SLOTS == 2
        assert 30 * 1024 <= plan.slot_bytes <= 40 * 1024
        assert plan.passes == ((1, 1, 1, 1) if cs == 8 else (1, 2, 1, 1))
    if name == "ragged":
        assert plan.passes[0] == 3


@pytest.mark.parametrize("B", [1, 240, 256])
def test_flagship_keeps_whole_layer_stages(B):
    """The flagship's bf16 launches keep whole layer blocks, four at
    clusters of 8 and two at clusters of 4, the head's block resident;
    ``_max_stages=0`` forces the chunk ring, as does an f32 pack (two f32
    blocks do not fit)."""
    spec = spec_from_config(Config())
    cs, _ = cg.pick_cluster(spec, B)
    plan = cg.ring_plan(spec, cs, torch.bfloat16)
    assert not plan.chunked and plan.stages == {8: 4, 4: 2}[cs]
    assert (cs == 8) == (B <= 240)
    assert cg.ring_plan(spec, cs, torch.bfloat16, max_stages=0).chunked
    assert cg.ring_plan(spec, cs, torch.float32).chunked
    capped = cg.ring_plan(spec, cs, torch.bfloat16, max_stages=2)
    assert not capped.chunked and capped.stages == 2


def test_kernel_pack_plan_carries_the_ring():
    """The plan ints ``wn_generate`` reads end with the ring's slot bytes,
    chunks and passes; the counter names the launches that take it."""
    spec = _spec(64, 128, 64, layers=4, stacks=2, cin=4)
    model = WaveNet(spec, generator=torch.Generator().manual_seed(0))
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    kp = cg.kernel_pack(packed, spec, 8)
    ring = kp.ring_plan(256, 0)
    assert ring.chunked
    plan = list(kp.plan(16, 256, 0))
    assert plan[3] == ring.stages and plan[16] == ring.slot_bytes
    assert plan[17:21] == list(ring.chunk) and plan[21:] == list(ring.passes)
    whole = kp.ring_plan(256, -1)
    assert not whole.chunked and whole.stages == spec.layers


def test_supports_exactly_where_a_ring_fits():
    """kernel_supports takes a model where a ring fits beside the buffers
    at every cluster size the picker may choose, and says why otherwise."""
    for R, G, S in ((512, 512, 256), (2048, 4096, 2048), (64, 4096, 1024)):
        spec = _spec(R, G, S)
        for dtype in (torch.bfloat16, torch.float32):
            takes, why = cg.kernel_supports(spec, dtype)
            first = cg.pick_cluster(spec, 1)[0]
            fits = all(cg.ring_plan(spec, c, dtype) is not None
                       for c in cg.CLUSTER_SIZES if min(first, 4) <= c <= first)
            assert takes == fits
            assert takes or "shared memory" in why


@pytest.mark.parametrize("B", [1, 16, 240, 256])
def test_mulaw256_splits_its_head_to_keep_whole_layer_stages(B):
    """The mu-law 256 recipe's categorical head is split over the cluster:
    at clusters of 8 each CTA holds 32 of the 256 classes, and its bf16
    launches keep four whole layer blocks with the head's block resident,
    as the 30-layer MoL model does; at clusters of 4 (B=256) two layer
    blocks and the head still do not fit, and the chunk ring streams a
    64-class slice of w_h2 in one pass."""
    spec = SPECS["mulaw256"]()
    assert cg.split_head(spec) and not cg.split_head(SPECS["30L3S"]())
    cs, _ = cg.pick_cluster(spec, B)
    assert (cs == 8) == (B <= 240)
    plan = cg.ring_plan(spec, cs, torch.bfloat16)
    d = cg._kernel_dims(spec, cs)
    assert d["Cq"] == 256 // cs
    if cs == 8:
        assert not plan.chunked and plan.stages == 4
        assert plan.stages == cg.ring_plan(SPECS["30L3S"](), cs,
                                           torch.bfloat16).stages
    else:
        assert plan.chunked and plan.stages == cg.RING_SLOTS
        assert cg.ring_plan(spec, cs, torch.bfloat16, max_stages=2) == plan
        KS, step, N, units = cg.ring_products(spec, cs, torch.bfloat16)[3]
        assert N == d["Cq"] == 64 and step == 16 * 64 * 2
        assert plan.chunk[3] == KS and plan.passes[3] == 1
    assert plan.smem_bytes <= cg.SMEM_BYTES


# every plan of the heads that are not split, as before the categorical
# head was split: (stages, slot bytes, chunk, passes, shared bytes) at
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
    plans are the same RingPlans as before the split."""
    spec = SPECS[name]()
    assert not cg.split_head(spec)
    for (cs, dt), want in UNSPLIT_PLANS[name].items():
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        plan = cg.ring_plan(spec, cs, dtype)
        assert plan == (None if want is None else cg.RingPlan(*want)), (cs, dt)
