"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the generation kernel, the residual-stack training kernels and the log-mel
kernel.

These tests need an NVIDIA GPU and nvcc; without a CUDA device they skip.
They import nothing of JAX, so they run on a machine that has only the port:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio, mel_torch
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec, spec_from_config
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
from wavenet_vocoder_tpu_torch.ops import fused_train as ft
from wavenet_vocoder_tpu_torch.utils import profiling

EGS = Path(__file__).resolve().parent.parent / "egs"
HEADS = {
    "categorical": dict(out_channels=256, scalar_input=False),
    "mol": dict(out_channels=30, scalar_input=True,
                output_distribution="Logistic"),
    "gaussian": dict(out_channels=2, scalar_input=True,
                     output_distribution="Normal"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(seed, **kw):
    spec = WaveNetSpec(layers=4, stacks=2, residual_channels=8,
                       gate_channels=16, skip_out_channels=8, cin_channels=4,
                       gin_channels=8, **kw)
    return WaveNet(spec, generator=torch.Generator().manual_seed(seed))


# (CTAs per cluster, streams per cluster): what the picker returns at this
# width for B=3 and B=17, clusters whose CTAs own only padding (2, 8), small
# groups that leave most of a tile empty, and two row tiles of which the
# second is idle (B=3) or partly used (B=17)
CLUSTERS = {"picked": None, "1x2": (1, 2), "2x16": (2, 16), "8x5": (8, 5),
            "1x32": (1, 32), "8x32": (8, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 17])
@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "sample"])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_kernel_matches_plain(cuda, head, deterministic, dtype, cluster, B):
    """Same inputs, state and seed: codes equal, scalars within 1e-3 (the
    summation order differs; 32 steps keep AR feedback from amplifying
    rounding). B=3 is one ragged group of streams, B=17 two groups with the
    second ragged (several ragged ones for the small clusters); t0=5 checks
    the ring indexing past the start. ``generate.gaussian_launches`` counts
    the Gaussian head's launch and no other head's."""
    model = _model(10, **HEADS[head]).to(cuda)
    spec = model.spec
    dt = getattr(torch, dtype)
    packed = cg.pack_weights(model, dtype=dt)
    n = 32
    rs = np.random.RandomState(0)
    cond = torch.from_numpy(rs.randn(B, n, 4).astype(np.float32)).to(cuda, dt)
    g_gate = torch.from_numpy(rs.randn(4, B, 16).astype(np.float32)).to(cuda)
    _, rows = cg.buffer_layout(spec)
    ring0 = torch.from_numpy(rs.randn(rows, B, 8).astype(np.float32)).to(cuda, dt)
    x0 = cg.default_initial_input(spec, B, device=cuda)
    results = []
    for kernel in (True, False):
        ring, x_cur = ring0.clone(), x0.clone()
        out = torch.empty(B, n, device=cuda, dtype=(
            torch.float32 if spec.scalar_input else torch.int32))
        names = ("generate.launches", "generate.gaussian_launches")
        before = [_count(c) for c in names]
        if kernel:
            cg.generate_steps(packed, spec, ring, x_cur, out, cond, g_gate,
                              t0=5, seed=3, deterministic=deterministic,
                              _cluster=CLUSTERS[cluster])
            assert [_count(c) - b for c, b in zip(names, before)] == [
                1, int(head == "gaussian")]
        else:
            cg.generate_steps_plain(packed, spec, ring, x_cur, out, cond,
                                    g_gate, t0=5, seed=3,
                                    deterministic=deterministic)
        torch.cuda.synchronize()
        results.append((out.cpu(), ring.float().cpu(), x_cur.cpu()))
    (k_out, k_ring, k_x), (p_out, p_ring, p_x) = results
    if spec.scalar_input:
        torch.testing.assert_close(k_out, p_out, rtol=0, atol=1e-3)
    else:
        assert torch.equal(k_out, p_out)
    torch.testing.assert_close(k_ring, p_ring, rtol=0,
                               atol=1e-3 if dtype == "float32" else 0.05)
    torch.testing.assert_close(k_x, p_x, rtol=0, atol=1e-3)


# (R, G, S): the demo presets' widths, and widths off every fragment
# multiple with R odd (the wrapper pads the ring to 8 channels)
RAGGED = {"demo": (4, 4, 4), "odd": (5, 6, 3), "ragged": (12, 20, 6)}


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, (2, 16)], ids=["picked", "2x16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(RAGGED))
def test_kernel_matches_plain_at_ragged_widths(cuda, width, dtype, cluster):
    """Widths that are not fragment multiples: the kernel pads them with zero
    channels and gives the plain version's samples, ring and input."""
    R, G, S = RAGGED[width]
    spec = WaveNetSpec(layers=3, stacks=1, residual_channels=R,
                       gate_channels=G, skip_out_channels=S, cin_channels=4,
                       **HEADS["mol"])
    model = WaveNet(spec, generator=torch.Generator().manual_seed(4)).to(cuda)
    dt = getattr(torch, dtype)
    packed = cg.pack_weights(model, dtype=dt)
    B, n = 3, 32
    rs = np.random.RandomState(2)
    cond = torch.from_numpy(rs.randn(B, n, 4).astype(np.float32)).to(cuda, dt)
    _, rows = cg.buffer_layout(spec)
    ring0 = torch.from_numpy(rs.randn(rows, B, R).astype(np.float32)).to(cuda, dt)
    x0 = cg.default_initial_input(spec, B, device=cuda)
    results = []
    for kernel in (True, False):
        ring, x_cur = ring0.clone(), x0.clone()
        out = torch.empty(B, n, device=cuda)
        before = _count("generate.launches")
        if kernel:
            cg.generate_steps(packed, spec, ring, x_cur, out, cond, t0=5,
                              seed=3, deterministic=True, _cluster=cluster)
            assert _count("generate.launches") == before + 1
        else:
            cg.generate_steps_plain(packed, spec, ring, x_cur, out, cond, None,
                                    t0=5, seed=3, deterministic=True)
        torch.cuda.synchronize()
        results.append((out.cpu(), ring.float().cpu(), x_cur.cpu()))
    (k_out, k_ring, k_x), (p_out, p_ring, p_x) = results
    torch.testing.assert_close(k_out, p_out, rtol=0, atol=1e-3)
    torch.testing.assert_close(k_ring, p_ring, rtol=0,
                               atol=1e-3 if dtype == "float32" else 0.05)
    torch.testing.assert_close(k_x, p_x, rtol=0, atol=1e-3)


def _flagship(seed):
    """The mol recipe's model (128/256/128, 24 layers, cin 80)."""
    return WaveNet(spec_from_config(Config()),
                   generator=torch.Generator().manual_seed(seed))


def _run_ring(packed, spec, cond, B, n, det, cap, cluster=None, ring0=None,
              t0=0):
    """(out, ring, info, chunk-ring launches counted) of one launch."""
    _, rows = cg.buffer_layout(spec)
    dt = packed["w_first"].dtype
    ring = (torch.zeros(rows, B, spec.residual_channels, device="cuda",
                        dtype=dt) if ring0 is None else ring0.clone())
    x_cur = cg.default_initial_input(spec, B, device="cuda")
    out = torch.empty(B, n, device="cuda")
    info, before = [], _count("generate.chunked_launches")
    cg.generate_steps(packed, spec, ring, x_cur, out, cond, t0=t0, seed=9,
                      deterministic=det, _cluster=cluster, _max_stages=cap,
                      _info=info)
    torch.cuda.synchronize()
    return (out.cpu(), ring.float().cpu(), info,
            _count("generate.chunked_launches") - before)


# (model, dtype, B, steps, cluster, stages the compared launch may hold):
# the small parity model through the chunk ring (0) and a two-stage ring
# of whole layers, against its resident slices; the flagship (24 layers)
# through the chunk ring against its own whole-layer ring at B=16
# (clusters of 8, four stages) and B=256 (clusters of 4, two stages)
WEIGHT_PATHS = {
    "small.bf16.chunks": ("small", "bfloat16", 5, 24, (2, 16), 0),
    "small.bf16.stages2": ("small", "bfloat16", 5, 24, (2, 16), 2),
    "small.f32.chunks": ("small", "float32", 5, 24, (2, 16), 0),
    "small.f32.stages2": ("small", "float32", 5, 24, (2, 16), 2),
    "flagship.b16.chunks": ("flagship", "bfloat16", 16, 256, None, 0),
    "flagship.b256.chunks": ("flagship", "bfloat16", 256, 256, None, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("det", [False, True], ids=["sample", "greedy"])
@pytest.mark.parametrize("case", sorted(WEIGHT_PATHS))
def test_kernel_weight_paths_agree(cuda, case, det):
    """Weights through the chunk ring (0 stages) or a two-stage ring of
    whole layers give what the shape's own plan gives (all layers resident,
    or the flagship's whole-layer ring), bit for bit in samples and ring
    state; ``generate.chunked_launches`` counts the chunk ring's launches
    and no other."""
    name, dtype, B, n, cluster, stages = WEIGHT_PATHS[case]
    model = (_model(11, **HEADS["mol"]) if name == "small"
             else _flagship(11)).to(cuda)
    spec = model.spec
    packed = cg.pack_weights(model, dtype=getattr(torch, dtype))
    rs = np.random.RandomState(1)
    cond = torch.from_numpy(rs.randn(B, n, spec.cin_channels).astype(
        np.float32)).to(cuda, packed["w_first"].dtype)
    ref, got = (_run_ring(packed, spec, cond, B, n, det, cap, cluster)
                for cap in (-1, stages))
    whole = {"small": spec.layers, "flagship": 4 if B <= 240 else 2}[name]
    assert ref[2][0] == whole and ref[2][4] == 0 and ref[3] == 0
    assert got[2][4] == (stages == 0) and got[3] == (stages == 0)
    if stages:
        assert got[2][0] == stages
    assert float(ref[0].std()) > 0.01
    assert torch.equal(ref[0], got[0])
    assert torch.equal(ref[1], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("det", [True, False], ids=["greedy", "sample"])
def test_chunk_ring_matches_plain_at_512ch(cuda, det):
    """At the 512ch model's widths (512/512/256, cin 80; 4 layers) no layer
    block fits twice: every launch takes the chunk ring. Against the plain
    version over 32 steps from a random state, held as chip_smoke.py's
    phase 2 holds bf16 launches: a stream agrees within 2e-2 until a bf16
    rounding flip parts it, and at most a quarter of the streams part. A
    stream's samples are the same bits at clusters of 8 and of 4."""
    spec = WaveNetSpec(layers=4, stacks=2, residual_channels=512,
                       gate_channels=512, skip_out_channels=256,
                       cin_channels=80, out_channels=30, scalar_input=True)
    model = WaveNet(spec, generator=torch.Generator().manual_seed(3)).to(cuda)
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    B, n = 16, 32
    rs = np.random.RandomState(4)
    cond = torch.from_numpy(rs.randn(B, n, 80).astype(np.float32)).to(
        cuda, torch.bfloat16)
    _, rows = cg.buffer_layout(spec)
    ring0 = torch.from_numpy(rs.randn(rows, B, 512).astype(np.float32) * 0.5
                             ).to(cuda, torch.bfloat16)
    k8 = _run_ring(packed, spec, cond, B, n, det, -1, ring0=ring0, t0=5)
    k4 = _run_ring(packed, spec, cond, B, n, det, -1, (4, 16), ring0, 5)
    assert k8[2][4] == 1 and k8[3] == 1 and k4[3] == 1
    assert torch.equal(k8[0], k4[0]) and torch.equal(k8[1], k4[1])
    ring, x_cur = ring0.clone(), cg.default_initial_input(spec, B, device=cuda)
    out = torch.empty(B, n, device=cuda)
    cg.generate_steps_plain(packed, spec, ring, x_cur, out, cond, None, t0=5,
                            seed=9, deterministic=det)
    diff = (k8[0] - out.cpu()).abs()
    beyond = ~(diff <= 2e-2)
    first = torch.where(beyond.any(dim=1), beyond.int().argmax(dim=1),
                        torch.full((B,), n, dtype=torch.long))
    assert int((first < n).sum()) <= B // 4
    before = torch.arange(n)[None] < first[:, None]
    assert float(diff[before].max()) <= 2e-2
    assert float(k8[0].std()) > 0.01


@pytest.mark.cuda
def test_stream_alone_equals_stream_in_batch(cuda):
    """Stream 0 generated alone (B=1) equals stream 0 inside B=32, bit for
    bit, in bf16 sampling mode over 64 steps: a stream's output does not
    depend on which streams share its cluster."""
    model = _model(12, **HEADS["mol"]).to(cuda)
    spec = model.spec
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    n = 64
    rs = np.random.RandomState(2)
    cond = torch.from_numpy(rs.randn(32, n, 4).astype(np.float32)).to(
        cuda, torch.bfloat16)
    _, rows = cg.buffer_layout(spec)
    outs = {}
    for B, cluster in ((1, None), (32, None), (32, (2, 8))):
        ring = torch.zeros(rows, B, 8, device=cuda, dtype=torch.bfloat16)
        x_cur = cg.default_initial_input(spec, B, device=cuda)
        out = torch.empty(B, n, device=cuda)
        cg.generate_steps(packed, spec, ring, x_cur, out,
                          cond[:B].contiguous(), t0=0, seed=4,
                          _cluster=cluster)
        torch.cuda.synchronize()
        outs[(B, cluster)] = out[0].cpu()
    assert float(outs[(1, None)].std()) > 0.01
    assert torch.equal(outs[(1, None)], outs[(32, None)])
    assert torch.equal(outs[(1, None)], outs[(32, (2, 8))])


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [(3, 16), (8, 33), (8, 0)])
def test_wrapper_raises_on_bad_block_streams(cuda, cluster):
    """The override of the picker takes a cluster of 1, 2, 4 or 8 CTAs
    and 1 to 32 streams per cluster, and nothing else."""
    model = _model(0, **HEADS["mol"]).to(cuda)
    packed = cg.pack_weights(model, dtype=torch.float32)
    _, rows = cg.buffer_layout(model.spec)
    ring = torch.zeros(rows, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="_cluster"):
        cg.generate_steps(packed, model.spec, ring, torch.zeros(2, 1, device=cuda),
                          torch.empty(2, 4, device=cuda),
                          torch.zeros(2, 4, 4, device=cuda), t0=0, seed=0,
                          _cluster=cluster)


def _recipe_spec(name):
    return spec_from_config(Config().override_from_dict(json.loads(
        (EGS / f"{name}/conf/{name}_wavenet.json").read_text())))


def _mulaw256_spec():
    return _recipe_spec("mulaw256")


def _mulaw256_launch(packed, spec, cond, ring0, x0, det, cluster=None,
                     info=None):
    """(codes, ring, x_cur, split-head, chunk-ring and wide-cluster launches
    counted) of one 32-step launch from t0 = 7."""
    B, n = x0.shape[0], cond.shape[1]
    ring, x_cur = ring0.clone(), x0.clone()
    out = torch.empty(B, n, device="cuda", dtype=torch.int32)
    names = ("generate.split_head_launches", "generate.chunked_launches",
             "generate.wide_cluster_launches")
    before = [_count(c) for c in names]
    cg.generate_steps(packed, spec, ring, x_cur, out, cond, t0=7, seed=9,
                      deterministic=det, _cluster=cluster, _info=info)
    torch.cuda.synchronize()
    after = [_count(c) for c in names]
    return (out.cpu(), ring.float().cpu(), x_cur.cpu(),
            [a - b for a, b in zip(after, before)])


@pytest.mark.cuda
@pytest.mark.parametrize("det", [True, False], ids=["greedy", "sample"])
@pytest.mark.parametrize("B", [16, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mulaw256_split_head_matches_plain(cuda, dtype, B, det):
    """r9y9's mu-law 256 recipe at its published widths (30 layers in 3
    stacks, 128/256/128, one-hot 256 in, 256 classes): every launch splits
    the categorical head over the cluster (``generate.split_head_launches``).
    f32 packs: codes equal the plain version's (32 steps from t0 = 7, at
    B=16 on clusters of 8 and B=256 on clusters of 4). bf16 packs run on
    clusters of 8, at B=256 of 32 streams (two row tiles), and keep four
    (B=16) or two (B=256) whole layer blocks, not the chunk ring; their
    codes are the bits of the same launch on clusters of 1 and 16 streams,
    one CTA holding all 256 classes (no exchange); bf16 against the plain
    version parts streams at rounding ties of greedy logits, which a
    sum-order change alone reproduces on the CPU."""
    spec = _mulaw256_spec()
    model = WaveNet(spec, generator=torch.Generator().manual_seed(13)).to(cuda)
    dt = getattr(torch, dtype)
    packed = cg.pack_weights(model, dtype=dt)
    n = 32
    rs = np.random.RandomState(B)
    _, rows = cg.buffer_layout(spec)
    ring0 = torch.from_numpy(rs.randn(rows, B, 128).astype(np.float32) * 0.5
                             ).to(cuda, dt)
    cond = torch.from_numpy(rs.randn(B, n, 80).astype(np.float32)).to(cuda, dt)
    x0 = torch.nn.functional.one_hot(torch.from_numpy(
        rs.randint(0, 256, B)), 256).float().to(cuda)
    cs, streams = cg.pick_cluster(spec, B, dt)
    wide = dtype == "bfloat16" and B == 256
    assert (cs, streams) == ((8, 32) if wide else (8 if B == 16 else 4, 16))
    info = []
    k_out, k_ring, k_x, counted = _mulaw256_launch(packed, spec, cond, ring0,
                                                   x0, det, info=info)
    chunked = dtype == "float32" or cs == 4
    assert counted == [1, int(chunked), int(wide)] and info[4] == int(chunked)
    if not chunked:
        assert info[0] == (2 if wide else 4) and info[1] == 1
    assert len(set(k_out.flatten().tolist())) > 3
    assert torch.equal(k_x, torch.nn.functional.one_hot(
        k_out[:, -1].long(), 256).float())
    if dtype == "float32":
        ring, x_cur = ring0.clone(), x0.clone()
        out = torch.empty(B, n, device=cuda, dtype=torch.int32)
        cg.generate_steps_plain(packed, spec, ring, x_cur, out, cond, None,
                                t0=7, seed=9, deterministic=det)
        assert torch.equal(k_out, out.cpu())
        assert torch.equal(k_x, x_cur.cpu())
        torch.testing.assert_close(k_ring, ring.cpu(), rtol=0, atol=1e-3)
    else:
        one = _mulaw256_launch(packed, spec, cond, ring0, x0, det, (1, 16))
        assert one[3] == [1, 1, 0]
        assert torch.equal(k_out, one[0]) and torch.equal(k_ring, one[1])
        assert torch.equal(k_x, one[2])


@pytest.mark.cuda
@pytest.mark.parametrize("det", [True, False], ids=["greedy", "sample"])
@pytest.mark.parametrize("B", [256, 250])
@pytest.mark.parametrize("name", ["mol", "mulaw256"])
def test_wide_clusters_equal_two_row_tiles(cuda, name, B, det):
    """At clusters of 8, launches whose clusters own 32 streams (two mma row
    tiles; ``generate.wide_cluster_launches``) give the bits of launches
    whose clusters own 16 over the same streams: outputs, ring and x_cur
    over two carried 256-step launches from a random state, for the mol
    recipe's model and the mu-law 256 recipe's (bf16, whole-layer stages).
    At B=250 the last 32-stream cluster holds 26 streams."""
    spec = spec_from_config(Config()) if name == "mol" else _mulaw256_spec()
    model = WaveNet(spec, generator=torch.Generator().manual_seed(17)).to(cuda)
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    n = cg.DEFAULT_CHUNK
    rs = np.random.RandomState(B)
    _, rows = cg.buffer_layout(spec)
    ring0 = torch.from_numpy(rs.randn(rows, B, 128).astype(np.float32) * 0.5
                             ).to(cuda, torch.bfloat16)
    cond = torch.from_numpy(rs.randn(B, 2 * n, 80).astype(np.float32)).to(
        cuda, torch.bfloat16)
    if spec.scalar_input:
        x0 = torch.from_numpy(rs.uniform(-1, 1, (B, 1)).astype(np.float32)).to(cuda)
    else:
        x0 = torch.nn.functional.one_hot(torch.from_numpy(
            rs.randint(0, 256, B)), 256).float().to(cuda)
    names = ("generate.launches", "generate.wide_cluster_launches",
             "generate.chunked_launches")
    runs = {}
    for streams in (32, 16):
        ring, x_cur = ring0.clone(), x0.clone()
        out = torch.empty(B, 2 * n, device=cuda, dtype=(
            torch.float32 if spec.scalar_input else torch.int32))
        before, info = [_count(c) for c in names], []
        for t0 in (0, n):
            cg.generate_steps(packed, spec, ring, x_cur, out[:, t0:t0 + n],
                              cond[:, t0:t0 + n], t0=t0, seed=5,
                              deterministic=det, _cluster=(8, streams),
                              _info=info)
        torch.cuda.synchronize()
        counted = [_count(c) - b for c, b in zip(names, before)]
        assert counted == [2, 2 if streams == 32 else 0, 0]
        assert info[0] == (2 if streams == 32 else 4) and info[4] == 0
        runs[streams] = (out.cpu(), ring.float().cpu(), x_cur.cpu())
    wide, narrow = runs[32], runs[16]
    assert len(set(wide[0].flatten().tolist())) > 3
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)
    assert cg.pick_cluster(spec, B) == ((8, 32) if name == "mulaw256" else (4, 16))


# (model, dtype, B, cluster): one launch of each kernel instance the planner
# lays out: bf16 whole-layer stages at 16 and 32 rows, the bf16 chunk ring
# (512ch), f32 packs on whole stages and on the chunk ring, the split head,
# and the Gaussian recipe's 8-column head as the picker clusters it at B=16
# (8, 16) and B=256 (4, 16)
PLANNED = {
    "bf16.whole16": ("flagship", "bfloat16", 16, (8, 16)),
    "bf16.whole32": ("flagship", "bfloat16", 32, (8, 32)),
    "bf16.chunk": ("512ch", "bfloat16", 16, None),
    "f32.whole": ("small", "float32", 5, (2, 16)),
    "f32.chunk": ("flagship", "float32", 16, None),
    "split": ("mulaw256", "bfloat16", 16, None),
    "gaussian.b16": ("gaussian", "bfloat16", 16, None),
    "gaussian.b256": ("gaussian", "bfloat16", 256, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PLANNED))
def test_kernel_takes_the_planned_shared_memory(cuda, case):
    """The launch takes the shared memory its plan lays out (``_info``:
    the bytes the kernel was given, its stages or slots, whether the head's
    block is resident and whether it streams the chunk ring), and its
    counters follow the plan."""
    name, dtype, B, cluster = PLANNED[case]
    spec = {"flagship": lambda: spec_from_config(Config()),
            "512ch": lambda: WaveNetSpec(
                layers=4, stacks=2, residual_channels=512, gate_channels=512,
                skip_out_channels=256, cin_channels=80, out_channels=30,
                scalar_input=True),
            "small": lambda: _model(0, **HEADS["mol"]).spec,
            "mulaw256": _mulaw256_spec,
            "gaussian": lambda: _recipe_spec("gaussian")}[name]()
    model = WaveNet(spec, generator=torch.Generator().manual_seed(6)).to(cuda)
    dt = getattr(torch, dtype)
    packed = cg.pack_weights(model, dtype=dt)
    plan = cg.plan_launch(spec, dt, B, cluster=cluster)
    n = 8
    rs = np.random.RandomState(3)
    cin = spec.cin_channels if spec.has_local_conditioning else 0
    cond = torch.from_numpy(rs.randn(B, n, cin).astype(np.float32)).to(cuda, dt)
    _, rows = cg.buffer_layout(spec)
    ring = torch.zeros(rows, B, spec.residual_channels, device=cuda, dtype=dt)
    x_cur = cg.default_initial_input(spec, B, device=cuda)
    out = torch.empty(B, n, device=cuda, dtype=(
        torch.float32 if spec.scalar_input else torch.int32))
    g_gate = (torch.zeros(spec.layers, B, spec.gate_channels, device=cuda)
              if spec.gin_channels > 0 else None)
    names = ("generate.chunked_launches", "generate.split_head_launches",
             "generate.wide_cluster_launches", "generate.gaussian_launches")
    before, info = [_count(c) for c in names], []
    cg.generate_steps(packed, spec, ring, x_cur, out, cond, g_gate, t0=0,
                      seed=2, plan=plan, _info=info)
    torch.cuda.synchronize()
    assert info[2] == plan.total <= cg.SMEM_BYTES
    assert info[:2] == [plan.nstage, plan.head_res]
    assert info[4] == int(plan.chunked) and info[3] >= 1
    assert [_count(c) - b for c, b in zip(names, before)] == [
        int(plan.chunked), int(plan.head == 0), int(plan.tiles > 1),
        int(name == "gaussian")]
    assert (plan.tiles > 1) == (case == "bf16.whole32")
    if name == "gaussian":
        assert (plan.head, plan.Cq, plan.nstage) == (2, 8, 4 if B <= 240 else 2)
        assert (plan.CS, plan.spc) == ((8, 16) if B <= 240 else (4, 16))
    assert plan.chunked == case.endswith("chunk")
    if spec.scalar_input:
        assert bool(torch.isfinite(out).all())
    else:
        assert 0 <= int(out.min()) and int(out.max()) < spec.out_channels


@pytest.mark.cuda
@pytest.mark.parametrize("det", [True, False], ids=["greedy", "sample"])
def test_categorical_generator_runs_under_inference_mode(cuda, det):
    """The categorical kernel reads its first code from x_cur's one-hot row
    (a zero row: no input), so ``FusedGenerator`` serves it under
    ``torch.inference_mode`` (whose tensors carry no version counter):
    three carried segments give the codes and state of the same calls
    outside it, and the first launch's codes equal the plain version's."""
    spec = WaveNetSpec(layers=4, stacks=2, residual_channels=8,
                       gate_channels=16, skip_out_channels=8, cin_channels=4,
                       out_channels=256, scalar_input=False)
    model = WaveNet(spec, generator=torch.Generator().manual_seed(5)).to(cuda)
    gen = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16)
    B = 5
    c_up = torch.randn(B, 48, 4, generator=torch.Generator().manual_seed(6)
                       ).to(cuda)
    x0 = torch.nn.functional.one_hot(torch.tensor([3, 40, 0, 255, 77]),
                                     256).float().to(cuda)
    x0[2].zero_()

    def segments():
        out, state = [], None
        for a in range(0, 48, 16):
            o, state = gen(c_up=c_up[:, a:a + 16], seed=4, deterministic=det,
                           initial_input=None if state else x0, state=state,
                           return_state=True)
            out.append(o.clone())
        return torch.cat(out, 1).cpu(), state[0].clone().cpu()

    want = segments()
    with torch.inference_mode():
        got = segments()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[1], torch.nn.functional.one_hot(
        got[0][:, -1].long(), 256).float())
    _, rows = cg.buffer_layout(spec)
    ring, x_cur = torch.zeros(rows, B, 8, device=cuda), x0.clone()
    out = torch.empty(B, 16, device=cuda, dtype=torch.int32)
    cg.generate_steps_plain(gen.packed, spec, ring, x_cur, out,
                            c_up[:, :16].contiguous(), None, t0=0, seed=4,
                            deterministic=det)
    assert torch.equal(got[0][:, :16], out.cpu())


# ----------------------------------------------------------------------
# the residual-stack training kernels
# ----------------------------------------------------------------------
# (L, dilations, R, G, S, cin): the parity width, a wider one whose G,
# R+S and k*R span several 128-column tiles and end on ragged ones (G/2=144
# takes two passes of the bf16 z product, cin=20 rows are not 16-byte
# aligned), and the flagship's widths (128/256/128, cin 80) with three of
# its dilations
TRAIN_WIDTHS = {"small": (4, (1, 2, 1, 2), 16, 32, 24, 8),
                "wide": (3, (1, 2, 4), 64, 288, 80, 20),
                "flagship": (3, (1, 8, 32), 128, 256, 128, 80),
                # widths the bf16 kernels run padded with zero channels
                # (cuda_train.kernel_widths): the demo presets', and R,
                # each GLU half and S all off their multiples
                "demo": (2, (1, 2), 4, 4, 4, 80),
                "ragged": (3, (1, 2, 4), 12, 20, 5, 5)}
GRAD_NAMES = ("dx0", "dc", "dgb", "dw_in", "db_in", "dw_cond", "dw_og",
              "db_og")


def _stack_inputs(width, dtype, glob, cond, B=2, T=130, seed=0):
    L, dils, R, G, S, cin = TRAIN_WIDTHS[width]
    rs = np.random.RandomState(seed)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (rs.randn(*s) * sc).astype(np.float32)).cuda()
    x0 = t(B, T, R, sc=0.5).to(dtype)
    c = t(B, T, cin).to(dtype) if cond else None
    gb = t(L, B, G, sc=0.2) if glob else None
    w_in = t(L, 3 * R, G, sc=(3 * R) ** -0.5).to(dtype)
    w_cond = t(L, cin, G, sc=cin ** -0.5).to(dtype) if cond else None
    w_og = t(L, G // 2, R + S, sc=(G // 2) ** -0.5).to(dtype)
    b_in, b_og = t(L, G, sc=0.1), t(L, R + S, sc=0.1)
    dskips = t(B, T, S)
    return (x0, c, gb, w_in, b_in, w_cond, w_og, b_og), dskips, dils


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _count(name: str) -> int:
    """A counter of the port's tracing store (``utils.profiling``)."""
    return profiling.counters().get(name, 0)


def _launch_counts():
    return {name: tuple(_count(f"train_{name}.{k}") for k in
                        ("launches", "tc_launches", "fma_launches"))
            for name in ("fwd", "bwd")}


def _assert_launched(before, n_fwd, n_bwd, dtype):
    """n launches of each wrapper since `before`, every bf16 one counted as
    a tensor-core launch and every f32 one as an FMA launch."""
    after = _launch_counts()
    for name, n in (("fwd", n_fwd), ("bwd", n_bwd)):
        d = [a - b for a, b in zip(after[name], before[name])]
        want = [n, n, 0] if dtype == torch.bfloat16 else [n, 0, n]
        assert d == want, (name, d, want)


def _check_train_kernels(width, dt, drop, glob, cond, B, T, b0=0):
    """Forward (skips, x_l stash) and backward (all eight gradients) against
    the plain versions on the same inputs. The backward gets the plain
    forward's stash on both sides. Tolerance per output, relative to its
    largest value: f32 1e-4 (sums in another order); bf16 2e-2 (a one-ulp
    f32 difference in z can flip a bf16 rounding of gated or dz). A second
    launch of the backward repeats all eight gradients bit for bit (ordered
    sums, no atomics)."""
    tol = 1e-4 if dt == torch.float32 else 2e-2
    inputs, dskips, dils = _stack_inputs(width, dt, glob, cond, B=B, T=T)
    kw = dict(dils=dils, k=3, drop=drop, seed=-12345, b0=b0)
    before = _launch_counts()
    skips, xs = ct.train_fwd(*inputs, **kw)
    _assert_launched(before, len(dils), 0, dt)
    skips_p, xs_p = ft.fused_res_stack_fwd_plain(*inputs, **kw)
    torch.cuda.synchronize()
    assert _rel_err(skips, skips_p) <= tol
    assert _rel_err(xs, xs_p) <= tol
    x0, c, gb, w_in, b_in, w_cond, w_og, b_og = inputs
    args = (dskips, xs_p, c, gb, w_in, b_in, w_cond, w_og, b_og)
    before = _launch_counts()
    got = ct.train_bwd(*args, **kw)
    _assert_launched(before, 0, ct.BWD_LAUNCHES_PER_LAYER * len(dils), dt)
    again = ct.train_bwd(*args, **kw)
    want = ft.fused_res_stack_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, g, g2 in zip(GRAD_NAMES, got, again):
        assert (g is None and g2 is None) or torch.equal(g, g2), name
    for name, g, w in zip(GRAD_NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, w) <= tol, (name, _rel_err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("cond", [True, False], ids=["c", "no-c"])
@pytest.mark.parametrize("glob", [False, True], ids=["no-g", "g"])
@pytest.mark.parametrize("drop", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(TRAIN_WIDTHS))
def test_train_kernels_match_plain(cuda, width, dtype, drop, glob, cond):
    """B=2, T=130: the last position tile is ragged, and so is the last
    position chunk of the weight gradients (260 positions in chunks of a
    multiple of 32)."""
    _check_train_kernels(width, getattr(torch, dtype), drop, glob, cond,
                         B=2, T=130)


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [0.0, 0.05])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_kernels_match_plain_flagship_chunks(cuda, dtype, drop):
    """The flagship width at B=3, T=1001: tiles cross no batch row but the
    weight gradients' position chunks do, and 3003 positions leave a last
    chunk that is not a whole stage of 32."""
    dt = getattr(torch, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, _, R, G, S, cin = TRAIN_WIDTHS["flagship"]
    bf16 = dt == torch.bfloat16
    chunk = ct.wgrad_chunk(3 * 1001, len(ct.wgrad_tiles(3, R, G, S, cin, bf16)),
                           sms, bf16)
    assert 3003 % chunk % 32 != 0 and 1001 % chunk != 0
    _check_train_kernels("flagship", dt, drop, True, True, B=3, T=1001)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", ["small", "flagship", "ragged"])
def test_train_kernels_row_offset_matches_plain(cuda, width, dtype):
    """The dropout key's row offset b0 (a data-parallel rank's first global
    row): the kernels at b0=4 against the plain versions at b0=4, and on
    rows 4..7 against rows 4..7 of a B=8, b0=0 launch on the same inputs
    (skips, stash and the per-row gradients dx0, dc, dgb), at the kernel
    tests' tolerances."""
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    _check_train_kernels(width, dt, 0.2, True, True, B=4, T=130, b0=4)
    inputs, dskips, dils = _stack_inputs(width, dt, True, True, B=8, T=130,
                                         seed=3)
    kw = dict(dils=dils, k=3, drop=0.2, seed=-12345)
    rows = slice(4, 8)
    x0, c, gb, w_in, b_in, w_cond, w_og, b_og = inputs
    part = (x0[rows].contiguous(), c[rows].contiguous(),
            gb[:, rows].contiguous(), w_in, b_in, w_cond, w_og, b_og)
    skips8, xs8 = ct.train_fwd(*inputs, **kw)
    skips4, xs4 = ct.train_fwd(*part, **kw, b0=4)
    skips_off, _ = ct.train_fwd(*part, **kw)       # rank 0's keys
    g8 = ct.train_bwd(dskips, xs8, c, gb, w_in, b_in, w_cond, w_og, b_og,
                      **kw)
    g4 = ct.train_bwd(dskips[rows].contiguous(), xs4, part[1], part[2],
                      w_in, b_in, w_cond, w_og, b_og, **kw, b0=4)
    torch.cuda.synchronize()
    assert _rel_err(skips4, skips8[rows]) <= tol
    assert _rel_err(xs4, xs8[:, rows]) <= tol
    assert _rel_err(skips_off, skips8[rows]) > 1e-3
    for name, a, b in (("dx0", g4[0], g8[0][rows]), ("dc", g4[1], g8[1][rows]),
                       ("dgb", g4[2], g8[2][:, rows])):
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


@pytest.mark.cuda
def test_fused_stack_on_cuda_launches_kernels(cuda, monkeypatch):
    """FusedResStack on CUDA tensors goes through the kernels, never the
    plain versions."""
    def refuse(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")
    monkeypatch.setattr(ft, "fused_res_stack_fwd_plain", refuse)
    monkeypatch.setattr(ft, "fused_res_stack_bwd_plain", refuse)
    model = _model(4, **HEADS["mol"]).to(cuda)
    spec = model.spec
    x0 = torch.randn(2, 70, 8, device=cuda, requires_grad=True)
    c = torch.randn(2, 70, 4, device=cuda)
    g = torch.randn(2, 8, device=cuda)
    before = _launch_counts()
    skips = ft.fused_res_stack(x0, c, model.conv_layers, spec, g=g,
                               dtype=torch.bfloat16, dropout=0.1, seed=5)
    skips.sum().backward()
    torch.cuda.synchronize()
    _assert_launched(before, spec.layers,
                     ct.BWD_LAUNCHES_PER_LAYER * spec.layers, torch.bfloat16)
    assert x0.grad is not None and torch.isfinite(x0.grad).all()
    assert model.conv_layers[0].conv.weight_v.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stack_leaf_grads_match_plain(cuda, monkeypatch, dtype):
    """Through FusedResStack, the weight packing, the global bias and the
    dtype casts on the way back: every leaf's gradient (x0, c, g and each
    parameter of the blocks) from the kernels against the same step with
    the plain versions on the card. Per leaf, max |diff| <= tol * max |ref|
    with the kernel tests' tolerances."""
    dt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    model = _model(4, **HEADS["mol"]).to(cuda)
    rs = np.random.RandomState(1)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda)
    x0_, c_, g_, w = t(2, 70, 8), t(2, 70, 4), t(2, 8), t(2, 70, 8)
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(ft, "_impl", lambda device: (
                ft.fused_res_stack_fwd_plain, ft.fused_res_stack_bwd_plain))
        model.zero_grad(set_to_none=True)
        x0, c, g = (a.clone().requires_grad_() for a in (x0_, c_, g_))
        before = _count("train_fwd.launches"), _count("train_bwd.launches")
        skips = ft.fused_res_stack(x0, c, model.conv_layers, model.spec, g=g,
                                   dtype=dt, dropout=0.1, seed=9)
        (skips * w).sum().backward()
        torch.cuda.synchronize()
        launched = (_count("train_fwd.launches"),
                    _count("train_bwd.launches")) != before
        assert launched != plain
        leaves = {"x0": x0.grad, "c": c.grad, "g": g.grad}
        leaves.update((n, p.grad) for n, p in
                      model.conv_layers.named_parameters())
        grads.append(leaves)
    got, want = grads
    for name, ref in want.items():
        assert ref is not None and got[name] is not None, name
        assert torch.isfinite(got[name]).all(), name
        assert _rel_err(got[name], ref) <= tol, (name, _rel_err(got[name], ref))


# ----------------------------------------------------------------------
# the log-mel kernel
# ----------------------------------------------------------------------
def _sig(T, seed=0, sr=22050.0):
    rng = np.random.RandomState(seed)
    t = np.arange(T) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1330 * t) + 0.05 * rng.randn(T))
    return x.astype(np.float32)


MEL_CASES = {
    # flagship transform: ragged last block (47 frames), one short of a
    # block (12 frames), the fewest samples reflect padding takes, a batch
    "flagship_12000": (dict(), (12000,)),
    "flagship_3000": (dict(), (3000,)),
    "flagship_513": (dict(), (513,)),
    "flagship_batch": (dict(), (3, 22050)),
    "win_800": (dict(win_length=800), (12000,)),
    # other sizes: 4 hops per frame at a small n_fft, 2 hops per frame, and
    # mel bins that do not divide the threads
    "fft256_hop64": (dict(fft_size=256, hop_size=64, win_length=256,
                          num_mels=40), (2, 5000)),
    "fft512_hop256_mels100": (dict(fft_size=512, hop_size=256,
                                   win_length=512, num_mels=100), (9000,)),
    # a hop that does not divide the frame (frames read at f * hop), an odd
    # hop (4-byte fragment loads), and the full band (bins 1..511, 8 tiles)
    "hop_300": (dict(hop_size=300), (2, 9000)),
    "hop_275": (dict(hop_size=275), (9000,)),
    "full_band": (dict(fmin=0, fmax=11025), (2, 9000)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MEL_CASES))
def test_mel_kernel_matches_plain_and_host(cuda, case):
    """Log values within 1e-3 of the plain version and 2e-3 of the host f64
    path; the mel sums within 1e-5 of the largest (same f32 products, summed
    in another order)."""
    over, shape = MEL_CASES[case]
    cfg = Config(**over)
    x = np.stack([_sig(shape[-1], seed=i) for i in range(
        shape[0] if len(shape) == 2 else 1)])
    x = x if len(shape) == 2 else x[0]
    y = torch.from_numpy(x).to(cuda)
    before = _count("mel.launches")
    got = mel_torch.logmelspectrogram_cuda(y, cfg)
    torch.cuda.synchronize()
    # two launches a call: the transform and the sums of its bin tiles
    assert _count("mel.launches") == before + 2
    want = mel_torch.logmelspectrogram_torch(y, cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-3
    S = mel_torch.mel_power_torch(y, cfg).double().clamp(min=1e-10)
    assert float((10.0 ** got.double() - S).abs().max()) <= 1e-5 * float(S.max())
    rows = x if x.ndim == 2 else x[None]
    host = np.stack([audio.logmelspectrogram(r, cfg) for r in rows])
    assert np.abs(got.cpu().numpy().reshape(host.shape) - host).max() <= 2e-3


@pytest.mark.cuda
def test_mel_kernel_silence_hits_the_clamp(cuda):
    """Digital silence ahead of a tone: the silent frames sit at the 1e-10
    floor in both versions."""
    cfg = Config()
    x = np.concatenate([np.zeros(8000, np.float32), _sig(8000, 7)])
    y = torch.from_numpy(x).to(cuda)
    got = mel_torch.logmelspectrogram_cuda(y, cfg)
    want = mel_torch.logmelspectrogram_torch(y, cfg)
    assert int((got == -10.0).sum()) == int((want == -10.0).sum()) > 0
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_mel_kernel_keeps_nan_as_the_plain_version_does(cuda):
    """One NaN sample: NaN in every band of the frames that cover it, in the
    kernel as in the plain version (and jnp.maximum in the JAX package);
    elsewhere within 1e-3."""
    cfg = Config()
    x = np.stack([_sig(9000, 1), _sig(9000, 2)])
    x[1, 4000] = np.nan
    y = torch.from_numpy(x).to(cuda)
    got = mel_torch.logmelspectrogram_cuda(y, cfg)
    want = mel_torch.logmelspectrogram_torch(y, cfg)
    mask = torch.isnan(want)
    assert int(mask.sum()) == 4 * 80 and bool(mask[1].any(dim=1).sum() == 4)
    assert torch.equal(torch.isnan(got), mask)
    assert float((got[~mask] - want[~mask]).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_mel_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    cfg = Config()
    with pytest.raises(ValueError, match="reflect padding"):
        mel_torch.logmelspectrogram_cuda(torch.zeros(512, device=cuda), cfg)
    with pytest.raises(ValueError, match="multiple of 8"):
        mel_torch.logmelspectrogram_cuda(
            torch.zeros(4096, device=cuda),
            Config(fft_size=1020, hop_size=255, win_length=1020))
    with pytest.raises(ValueError, match="shared memory|a block can have"):
        mel_torch.logmelspectrogram_cuda(
            torch.zeros(20000, device=cuda),
            Config(fft_size=8192, hop_size=2048, win_length=8192))
    with pytest.raises(ValueError, match=r"\(T,\) or \(B, T\)"):
        mel_torch.logmelspectrogram_cuda(torch.zeros(1, 2, 4096, device=cuda),
                                         cfg)


# ----------------------------------------------------------------------
# a demo-preset model (4/4/4) through the entry points on the card
# ----------------------------------------------------------------------
DEMO_PRESET = "egs/mol/conf/mol_wavenet_demo.json"


@pytest.fixture
def demo_checkpoint(tmp_path):
    from wavenet_vocoder_tpu_torch.config import load_config
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, DEMO_PRESET))
    path = ckpt.save_checkpoint(str(tmp_path / "exp"),
                                create_train_state(cfg, device="cpu"),
                                global_step=1)
    (tmp_path / "exp" / "hparams.json").write_text(cfg.to_json())
    mel = tmp_path / "mels" / "utt0-feats.npy"
    mel.parent.mkdir()
    np.save(mel, np.random.RandomState(0).rand(6, 80).astype(np.float32))
    return dict(ckpt=path, mel=str(mel), hop=cfg.hop_size)


@pytest.mark.cuda
def test_demo_checkpoint_runs_the_kernel_on_the_card(cuda, demo_checkpoint,
                                                     tmp_path):
    """cli.synthesis and cli.evaluate with --engine auto launch the
    generation kernel for a 4/4/4 checkpoint; --engine scan runs the eager
    loop on the card with the CLI's generator, made on the card."""
    from scipy.io import wavfile

    from wavenet_vocoder_tpu_torch.cli import evaluate, synthesis
    d = demo_checkpoint
    for engine in ("auto", "scan"):
        before = _count("generate.launches")
        dst = str(tmp_path / f"{engine}.wav")
        synthesis.main([d["ckpt"], dst, "--conditional", d["mel"],
                        "--engine", engine])
        x = wavfile.read(dst)[1]
        assert len(x) == 6 * d["hop"] and np.isfinite(x).all()
        assert (_count("generate.launches") > before) == (engine == "auto")
    before = _count("generate.launches")
    out = str(tmp_path / "eval")
    evaluate.main([str(tmp_path / "mels"), d["ckpt"], out])
    assert sorted(os.listdir(out)) == ["eval_manifest.txt", "utt0_gen.wav"]
    assert _count("generate.launches") > before


@pytest.mark.cuda
def test_fused_bf16_step_at_demo_widths_runs_the_kernels(cuda):
    """fused_train at 4/4/4 in bf16: the training kernels run the stack at
    widths padded with zero channels, every launch on the tensor cores."""
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    cfg = Config(layers=2, stacks=1, residual_channels=4, gate_channels=4,
                 skip_out_channels=4, fused_train=True,
                 compute_dtype="bfloat16", max_time_steps=1024)
    state = create_train_state(cfg, device=cuda)
    step, _ = make_train_step(cfg)
    rs = np.random.RandomState(0)
    B, T = 2, cfg.max_time_steps
    frames = T // cfg.hop_size + 2 * cfg.cin_pad
    x = rs.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in dict(
        x=x, y=x.copy(), c=rs.randn(B, frames, 80).astype(np.float32),
        input_lengths=np.full(B, T, np.int32)).items()}
    before = _launch_counts()
    metrics = step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    _assert_launched(before, 2, 2 * ct.BWD_LAUNCHES_PER_LAYER, torch.bfloat16)


# ----------------------------------------------------------------------
# training from a dump: prefetch and the loop on the card
# ----------------------------------------------------------------------
def _np_batches(n, B=2, T=512, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32),
             "c": rs.randn(B, T // 64 + 4, 8).astype(np.float32),
             "input_lengths": rs.randint(1, T, B).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("pin", [True, False], ids=["pinned", "pageable"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_on_a_side_stream_equals_a_plain_copy(cuda, monkeypatch,
                                                       pin, depth):
    """Batches copied on the side stream (pinned when asked) equal a plain
    ``.to(device)``, in order; work queued on the consumer stream right
    after a batch is yielded reads the copied values."""
    from wavenet_vocoder_tpu_torch.data.prefetch import prefetch_to_device
    pinned = []
    real_pin = torch.Tensor.pin_memory

    def counting_pin(self, *a, **kw):
        out = real_pin(self, *a, **kw)
        pinned.append(out.is_pinned())
        return out
    monkeypatch.setattr(torch.Tensor, "pin_memory", counting_pin)
    batches = _np_batches(6)
    for i, got in enumerate(prefetch_to_device(iter(batches), depth=depth,
                                               device=cuda, pin_memory=pin)):
        # consume at once on the current stream, as a train step would
        sums = {k: v.double().sum() for k, v in got.items()}
        for k, v in batches[i].items():
            want = torch.as_tensor(v).to(cuda)
            assert got[k].device.type == "cuda" and got[k].dtype == want.dtype
            assert torch.equal(got[k], want), (i, k)
            assert float(sums[k]) == float(want.double().sum()), (i, k)
    assert pinned == ([True] * 18 if pin else [])


@pytest.mark.cuda
def test_train_loop_on_the_card_runs_the_kernels(cuda, tmp_path):
    """A 3-step ``train_loop`` at a small depth, bf16 fused: every stack
    launch is a tensor-core launch (none on the FMA kernels), and the eval
    audio comes from the generation kernel."""
    from scipy.io import wavfile

    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.loop import train_loop
    cfg = Config(layers=4, stacks=2, residual_channels=16, gate_channels=32,
                 skip_out_channels=16, cin_channels=8, num_mels=8,
                 hop_size=64, upsample_params={"upsample_scales": [4, 16]},
                 fused_train=True, compute_dtype="bfloat16", batch_size=2,
                 max_time_steps=1024, num_workers=1, checkpoint_interval=3,
                 train_eval_interval=3, test_eval_epoch_interval=1)
    rs = np.random.RandomState(0)
    for split, n in (("train_no_dev", 4), ("dev", 2)):
        d = tmp_path / "dump" / split
        d.mkdir(parents=True)
        for i in range(n):
            frames = 22 + rs.randint(0, 8)
            np.save(d / f"u{i}-wave.npy",
                    rs.uniform(-0.5, 0.5, frames * 64).astype(np.float32))
            np.save(d / f"u{i}-feats.npy",
                    rs.randn(frames, 8).astype(np.float32))
    before, gen_before = _launch_counts(), _count("generate.launches")
    out = str(tmp_path / "exp")
    state = train_loop(cfg, str(tmp_path / "dump"), out, max_steps_override=3,
                       log_interval=1)
    torch.cuda.synchronize()
    after = _launch_counts()
    L = cfg.layers
    n_dev = sum(1 for line in open(os.path.join(out, "log", "metrics.jsonl"))
                if '"dev/loss"' in line)
    # forwards: 3 train steps, the dev batches, one teacher-forced pass
    assert [a - b for a, b in zip(after["fwd"], before["fwd"])] == \
        [L * (3 + n_dev + 1)] * 2 + [0]
    assert [a - b for a, b in zip(after["bwd"], before["bwd"])] == \
        [ct.BWD_LAUNCHES_PER_LAYER * L * 3] * 2 + [0]
    assert _count("generate.launches") > gen_before
    assert state.step == 3 and next(state.model.parameters()).is_cuda
    assert os.path.exists(ckpt.checkpoint_path(out, 3, ema=True))
    for sub, step in (("train_no_dev_eval", 3), ("dev_eval", 2)):
        w = wavfile.read(os.path.join(out, "intermediate", sub,
                                      f"step{step:09d}_predicted.wav"))[1]
        assert len(w) == cfg.max_time_steps and np.isfinite(w).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", ["bwd_mask_tshift", "bwd_x_shift"])
def test_fault_builds_corrupt_the_gradients(cuda, fault, dtype):
    """The backward's fault builds (cuda_train.FAULTS: what the quality
    check builds to show that it can fail) change dx0 by more than 1e-4 of
    its largest value, and the healthy build repeats all eight gradients
    exactly (ordered sums). At the flagship width, dropout 0.3, so both
    faults act."""
    dt = getattr(torch, dtype)
    inputs, dskips, dils = _stack_inputs("flagship", dt, False, True, B=2,
                                         T=300)
    kw = dict(dils=dils, k=3, drop=0.3, seed=7)
    _, xs = ct.train_fwd(*inputs, **kw)
    x0, c, gb, w_in, b_in, w_cond, w_og, b_og = inputs
    args = (dskips, xs, c, gb, w_in, b_in, w_cond, w_og, b_og)

    def grads(name):
        ct.set_fault(name)
        try:
            return ct.train_bwd(*args, **kw)
        finally:
            ct.set_fault("none")

    ok, ok2, bad = grads("none"), grads("none"), grads(fault)
    torch.cuda.synchronize()
    for name, a, b in zip(GRAD_NAMES, ok, ok2):
        assert (a is None and b is None) or torch.equal(a, b), name
    assert torch.isfinite(bad[0]).all()
    assert _rel_err(bad[0], ok[0]) > 1e-4, fault
