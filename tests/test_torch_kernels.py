"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the generation kernel, the residual-stack training kernels and the log-mel
kernel.

These tests need an NVIDIA GPU and nvcc; without a CUDA device they skip.
They import nothing of JAX, so they run on a machine that has only the port:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""
import os

import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio, mel_torch
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
from wavenet_vocoder_tpu_torch.ops import fused_train as ft

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
# width for B=3 and B=17, clusters whose CTAs own only padding (2, 8), and
# small groups that leave most of a tile empty
CLUSTERS = {"picked": None, "1x2": (1, 2), "2x16": (2, 16), "8x5": (8, 5)}


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
    the ring indexing past the start."""
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
        before = cg.generate_steps.launches
        if kernel:
            cg.generate_steps(packed, spec, ring, x_cur, out, cond, g_gate,
                              t0=5, seed=3, deterministic=deterministic,
                              _cluster=CLUSTERS[cluster])
            assert cg.generate_steps.launches == before + 1
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
        before = cg.generate_steps.launches
        if kernel:
            cg.generate_steps(packed, spec, ring, x_cur, out, cond, t0=5,
                              seed=3, deterministic=True, _cluster=cluster)
            assert cg.generate_steps.launches == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [0, 2])
def test_kernel_weight_paths_agree(cuda, stages):
    """Weights read from global memory (0 stages) and through a two-stage
    ring in shared memory give what the resident slices give, bit for bit."""
    model = _model(11, **HEADS["mol"]).to(cuda)
    spec = model.spec
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    B, n = 5, 24
    rs = np.random.RandomState(1)
    cond = torch.from_numpy(rs.randn(B, n, 4).astype(np.float32)).to(
        cuda, torch.bfloat16)
    _, rows = cg.buffer_layout(spec)
    outs = []
    for cap in (-1, stages):
        ring = torch.zeros(rows, B, 8, device=cuda, dtype=torch.bfloat16)
        x_cur = cg.default_initial_input(spec, B, device=cuda)
        out = torch.empty(B, n, device=cuda)
        info = []
        cg.generate_steps(packed, spec, ring, x_cur, out, cond, t0=0, seed=9,
                          _cluster=(2, 16), _max_stages=cap, _info=info)
        torch.cuda.synchronize()
        assert info[0] == (spec.layers if cap < 0 else stages)
        outs.append((out.cpu(), ring.float().cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


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
@pytest.mark.parametrize("cluster", [(3, 16), (8, 17), (8, 0)])
def test_wrapper_raises_on_bad_block_streams(cuda, cluster):
    """The override of the picker takes a cluster of 1, 2, 4 or 8 CTAs
    and 1 to 16 streams per cluster, and nothing else."""
    model = _model(0, **HEADS["mol"]).to(cuda)
    packed = cg.pack_weights(model, dtype=torch.float32)
    _, rows = cg.buffer_layout(model.spec)
    ring = torch.zeros(rows, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="_cluster"):
        cg.generate_steps(packed, model.spec, ring, torch.zeros(2, 1, device=cuda),
                          torch.empty(2, 4, device=cuda),
                          torch.zeros(2, 4, 4, device=cuda), t0=0, seed=0,
                          _cluster=cluster)


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


def _launch_counts():
    return {name: (w.launches, w.tc_launches, w.fma_launches)
            for name, w in (("fwd", ct.train_fwd), ("bwd", ct.train_bwd))}


def _assert_launched(before, n_fwd, n_bwd, dtype):
    """n launches of each wrapper since `before`, every bf16 one counted as
    a tensor-core launch and every f32 one as an FMA launch."""
    after = _launch_counts()
    for name, n in (("fwd", n_fwd), ("bwd", n_bwd)):
        d = [a - b for a, b in zip(after[name], before[name])]
        want = [n, n, 0] if dtype == torch.bfloat16 else [n, 0, n]
        assert d == want, (name, d, want)


def _check_train_kernels(width, dt, drop, glob, cond, B, T):
    """Forward (skips, x_l stash) and backward (all eight gradients) against
    the plain versions on the same inputs. The backward gets the plain
    forward's stash on both sides. Tolerance per output, relative to its
    largest value: f32 1e-4 (sums in another order, weight gradients by
    atomics); bf16 2e-2 (a one-ulp f32 difference in z can flip a bf16
    rounding of gated or dz)."""
    tol = 1e-4 if dt == torch.float32 else 2e-2
    inputs, dskips, dils = _stack_inputs(width, dt, glob, cond, B=B, T=T)
    kw = dict(dils=dils, k=3, drop=drop, seed=-12345)
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
    _assert_launched(before, 0, 3 * len(dils), dt)
    want = ft.fused_res_stack_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
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
    _assert_launched(before, spec.layers, 3 * spec.layers, torch.bfloat16)
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
        before = ct.train_fwd.launches, ct.train_bwd.launches
        skips = ft.fused_res_stack(x0, c, model.conv_layers, model.spec, g=g,
                                   dtype=dt, dropout=0.1, seed=9)
        (skips * w).sum().backward()
        torch.cuda.synchronize()
        launched = (ct.train_fwd.launches, ct.train_bwd.launches) != before
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
    before = mel_torch.logmelspectrogram_cuda.launches
    got = mel_torch.logmelspectrogram_cuda(y, cfg)
    torch.cuda.synchronize()
    # two launches a call: the transform and the sums of its bin tiles
    assert mel_torch.logmelspectrogram_cuda.launches == before + 2
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
        before = cg.generate_steps.launches
        dst = str(tmp_path / f"{engine}.wav")
        synthesis.main([d["ckpt"], dst, "--conditional", d["mel"],
                        "--engine", engine])
        x = wavfile.read(dst)[1]
        assert len(x) == 6 * d["hop"] and np.isfinite(x).all()
        assert (cg.generate_steps.launches > before) == (engine == "auto")
    before = cg.generate_steps.launches
    out = str(tmp_path / "eval")
    evaluate.main([str(tmp_path / "mels"), d["ckpt"], out])
    assert sorted(os.listdir(out)) == ["eval_manifest.txt", "utt0_gen.wav"]
    assert cg.generate_steps.launches > before


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
    _assert_launched(before, 2, 6, torch.bfloat16)
