"""PyTorch port vs the JAX package: AR decoders, the fused generation path
and synthesis.

On the CPU the fused path runs the kernel's plain PyTorch version; it is held
against the JAX Pallas kernel in interpret mode with f32 weight packs, at the
tolerances of tests/test_pallas.py: categorical codes exactly equal, scalar
samples within 1e-4 (f32 rounding differs in summation order between the
frameworks). Both sides run deterministic mode (argmax / mean feedback):
sampling uses different random streams in the two packages.

The kernel itself only runs on a GPU; tests/test_torch_kernels.py holds it
against the plain version there.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.models.wavenet import (
    WaveNetSpec as JaxSpec,
    init_wavenet,
    spec_from_config as jax_spec_from_config,
)
from wavenet_vocoder_tpu.ops.generate import generate as jax_generate
from wavenet_vocoder_tpu.ops.pallas_generate import generate_pallas
from wavenet_vocoder_tpu.synthesis import (
    batch_wavegen as jax_batch_wavegen,
    pad_mel_context,
)

from wavenet_vocoder_tpu_torch import synthesis
from wavenet_vocoder_tpu_torch.compat.from_jax import state_dict_from_jax
from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.wavenet import (
    WaveNet,
    WaveNetSpec,
    spec_from_config,
)
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
from wavenet_vocoder_tpu_torch.ops.generate import generate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4

HEADS = {
    "categorical": dict(out_channels=256, scalar_input=False),
    "mol": dict(out_channels=30, scalar_input=True,
                output_distribution="Logistic"),
    "gaussian": dict(out_channels=2, scalar_input=True,
                     output_distribution="Normal"),
}
GLOBAL = dict(gin_channels=8, use_speaker_embedding=True, n_speakers=3)


def _pair(seed, **kw):
    base = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
                skip_out_channels=8, cin_channels=4)
    base.update(kw)
    jspec, tspec = JaxSpec(**base), WaveNetSpec(**base)
    params = jax.tree.map(np.asarray, init_wavenet(jax.random.PRNGKey(seed), jspec))
    model = WaveNet(tspec)
    model.load_state_dict(state_dict_from_jax(params, tspec))
    return params, jspec, model.eval()


def _inputs(jspec, B=2, T=48):
    rs = np.random.RandomState(1)
    c = rs.randn(B, T, jspec.cin_channels).astype(np.float32)
    g = np.array([0, 2], np.int32) if jspec.has_global_conditioning else None
    return c, g


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_close(jspec, ours, ref):
    if jspec.scalar_input:
        np.testing.assert_allclose(ours, ref, atol=ATOL)
    else:
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("with_g", [False, True], ids=["no_g", "g"])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_eager_decoder_matches_jax(head, with_g):
    kw = dict(HEADS[head], **(GLOBAL if with_g else {}))
    params, jspec, model = _pair(3, **kw)
    c, g = _inputs(jspec)
    ref = np.asarray(jax_generate(params, jspec, jax.random.PRNGKey(2),
                                  c=_j(c), g=_j(g),
                                  deterministic=True)["samples"])
    ours = generate(model, c=_t(c), g=_t(g), deterministic=True)["samples"].numpy()
    assert ours.shape == ref.shape
    if jspec.scalar_input:
        _assert_close(jspec, ours, ref)
    else:
        _assert_close(jspec, ours.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("case", sorted(HEADS) + ["categorical_g", "mol_g"])
def test_fused_plain_matches_jax_pallas(case):
    kw = dict(HEADS[case.split("_")[0]], **(GLOBAL if case.endswith("_g") else {}))
    params, jspec, model = _pair(4, **kw)
    c, g = _inputs(jspec, T=40)
    ref = np.asarray(generate_pallas(
        params, jspec, jax.random.PRNGKey(2), c=_j(c), g=_j(g),
        weight_dtype=jnp.float32, deterministic=True, interpret=True,
        chunk=16))
    gen = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16)
    launches = cg.generate_steps.launches
    ours = gen(c=_t(c), g=_t(g), deterministic=True).numpy()
    assert cg.generate_steps.launches == launches  # CPU: no kernel launched
    assert ours.shape == ref.shape == (2, 40)
    assert ours.dtype == (np.float32 if jspec.scalar_input else np.int32)
    _assert_close(jspec, ours, ref)


@pytest.mark.parametrize("head", ["categorical", "mol"])
def test_fused_plain_matches_eager(head):
    """Unconditional, T not a multiple of the launch block: padded and
    trimmed, and equal to the eager decoder."""
    params, jspec, model = _pair(6, cin_channels=-1, **HEADS[head])
    gen = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16)
    out = gen(T=23, deterministic=True)
    assert out.shape == (1, 23)
    ref = generate(model, T=23, deterministic=True)["samples"]
    if jspec.scalar_input:
        np.testing.assert_allclose(out.numpy(), ref[..., 0].numpy(), atol=ATOL)
    else:
        np.testing.assert_array_equal(out.numpy(), ref.argmax(-1).numpy())
    # the JAX kernel pads and trims the same way
    ref_jax = np.asarray(generate_pallas(
        params, jspec, jax.random.PRNGKey(0), T=23, weight_dtype=jnp.float32,
        chunk=16, deterministic=True, interpret=True))
    _assert_close(jspec, out.numpy(), ref_jax)


@pytest.mark.parametrize("head", sorted(HEADS))
def test_sampling_seed(head):
    """Same seed, same samples — whatever the launch block; another seed,
    other samples."""
    _, jspec, model = _pair(7, **HEADS[head])
    c, _ = _inputs(jspec, T=32)
    a = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16)
    b = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=8)
    s1, s2 = a(c=_t(c), seed=11), b(c=_t(c), seed=11)
    s3 = a(c=_t(c), seed=12)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    assert not torch.equal(s1, s3)
    if jspec.scalar_input:
        assert float(s1.abs().max()) <= 1.0 and float(s1.std()) > 0.01
    else:
        assert len(torch.unique(s1)) > 2


def test_bf16_pack_follows_f32():
    """The bf16 pack rounds weights and product inputs (and uses the exp-form
    GLU); its deterministic MoL output stays near the f32 pack's."""
    _, jspec, model = _pair(8, **HEADS["mol"])
    c, _ = _inputs(jspec, T=32)
    f32 = cg.FusedGenerator(model, weight_dtype=torch.float32, chunk=16)
    bf16 = cg.FusedGenerator(model, weight_dtype=torch.bfloat16, chunk=16)
    assert bf16.packed["w_in"].dtype == torch.bfloat16
    assert bf16.packed["b_in"].dtype == torch.float32
    a = f32(c=_t(c), deterministic=True)
    b = bf16(c=_t(c), deterministic=True)
    assert float((a - b).abs().max()) < 0.1


def test_pack_and_layout_shapes():
    _, jspec, model = _pair(0, **HEADS["categorical"])
    offs, total = cg.buffer_layout(model.spec)
    assert offs == (0, 2, 6, 8) and total == 12
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    assert {n: tuple(a.shape) for n, a in packed.items()} == \
        cg.packed_shapes(model.spec)
    assert packed["w_in"].shape == (4, 3 * 8 + 4, 16)
    assert packed["w_og"].shape == (4, 8, 8 + 8)
    assert packed["b_og"].shape == (4, 16)
    assert packed["w_h2"].shape == (8, 256)


def _mix32_np(x):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x2C1B3C6D)
        x ^= x >> np.uint32(16)
    return x


def test_hash_matches_uint32_reference():
    """The plain version's int64 hash equals wrapping uint32 arithmetic,
    which is what the kernel computes."""
    seed, t = 123456789, 70000
    rows = np.arange(300)
    key = _mix32_np(_mix32_np(_mix32_np(seed) ^ rows.astype(np.uint32))
                    ^ np.uint32(t))
    keys = cg.step_keys(seed, torch.arange(300), t)
    np.testing.assert_array_equal(keys.numpy(), key.astype(np.int64))
    draws = np.arange(5)
    bits = _mix32_np(key[:, None] ^ draws[None].astype(np.uint32)) >> np.uint32(8)
    u_ref = np.clip(bits.astype(np.float32) * np.float32(2.0 ** -24),
                    np.float32(1e-5), np.float32(1 - 1e-5))
    u = cg.uniforms(keys[:, None], torch.arange(5)[None])
    np.testing.assert_array_equal(u.numpy(), u_ref)


def test_wrapper_checks_inputs():
    _, jspec, model = _pair(0, **HEADS["mol"])
    packed = cg.pack_weights(model, dtype=torch.float32)
    _, rows = cg.buffer_layout(model.spec)
    ring = torch.zeros(rows, 2, 8)
    x_cur = torch.zeros(2, 1)
    out = torch.empty(2, 4)
    cond = torch.zeros(2, 4, 4)
    with pytest.raises(ValueError, match="shape"):
        cg.generate_steps(packed, model.spec, ring[:, :1], x_cur, out, cond,
                          t0=0, seed=0)
    with pytest.raises(TypeError, match="dtype"):
        cg.generate_steps(packed, model.spec, ring.bfloat16(), x_cur, out,
                          cond, t0=0, seed=0)
    with pytest.raises(ValueError, match="cond"):
        cg.generate_steps(packed, model.spec, ring, x_cur, out, None,
                          t0=0, seed=0)
    other = cg.pack_weights(_pair(0, **HEADS["categorical"])[2],
                            dtype=torch.float32)
    with pytest.raises(ValueError, match="w_first"):
        cg.generate_steps(other, model.spec, ring, x_cur, out, cond,
                          t0=0, seed=0)
    cg.generate_steps(packed, model.spec, ring, x_cur, out, cond, t0=0, seed=0)
    assert torch.isfinite(out).all()


# ----------------------------------------------------------------------
# the kernel-side pack and the cluster picker (what the CUDA kernel reads)
# ----------------------------------------------------------------------
WIDTHS = {
    # the parity width (R=8, G=16, S=8, cin=4: K_in=28) and the flagship's
    "small": dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
                  skip_out_channels=8, cin_channels=4),
    "flagship": dict(layers=4, stacks=2, residual_channels=128,
                     gate_channels=256, skip_out_channels=128,
                     cin_channels=80),
    # nothing divides: every slice is padded
    "ragged": dict(layers=2, stacks=1, residual_channels=24, gate_channels=40,
                   skip_out_channels=16, cin_channels=5),
    # the demo presets' widths, and odd ones: R off a multiple of 8 (the
    # kernel runs such a model on a ring padded to 8 channels)
    "demo": dict(layers=2, stacks=1, residual_channels=4, gate_channels=4,
                 skip_out_channels=4, cin_channels=80),
    "odd": dict(layers=2, stacks=1, residual_channels=5, gate_channels=6,
                skip_out_channels=3, cin_channels=3),
}


def _packed(width, dtype, seed=5):
    spec = WaveNetSpec(out_channels=30, scalar_input=True, **WIDTHS[width])
    model = WaveNet(spec, generator=torch.Generator().manual_seed(seed))
    packed = cg.pack_weights(model, dtype=dtype)
    return spec, {n: a.detach().clone() for n, a in packed.items()}


def _public_from_slices(kp, spec):
    """The kernel-side slices, unpadded and put back in the public order."""
    sl, d, CS = kp.slices(), kp.dims, kp.cluster_size
    L, k, R = spec.layers, spec.kernel_size, spec.residual_channels
    G2, S, C = spec.gate_channels // 2, spec.skip_out_channels, spec.out_channels
    cin = spec.cin_channels
    Gq, Rq, Sq = d["Gq"], d["Rq"], d["Sq"]
    Rp = CS * Rq
    cat = lambda parts: torch.cat(list(parts), dim=-1)
    # columns: CTA r holds [a-half | b-half] of gate channels r*Gq ...
    a = cat(sl["w_in"][r][..., :Gq] for r in range(CS))[..., :G2]
    b = cat(sl["w_in"][r][..., Gq:] for r in range(CS))[..., :G2]
    cols = torch.cat([a, b], dim=-1)                       # (L, Kin, G)
    rows = [cols[:, t * Rp:t * Rp + R] for t in range(k)]
    rows.append(cols[:, k * Rp:k * Rp + cin])
    res = cat(sl["w_og"][r][..., :Rq] for r in range(CS))[..., :R]
    skip = cat(sl["w_og"][r][..., Rq:] for r in range(CS))[..., :S]
    b_a = cat(sl["b_in"][r][..., :Gq] for r in range(CS))[..., :G2]
    b_b = cat(sl["b_in"][r][..., Gq:] for r in range(CS))[..., :G2]
    b_res = cat(sl["b_og"][r][..., :Rq] for r in range(CS))[..., :R]
    b_skip = cat(sl["b_og"][r][..., Rq:] for r in range(CS))[..., :S]
    return {
        "w_in": torch.cat(rows, dim=1),
        "b_in": torch.cat([b_a, b_b], dim=-1),
        "w_og": torch.cat([res, skip], dim=-1)[:, :G2],
        "b_og": torch.cat([b_res, b_skip], dim=-1),
        "w_h1": cat(sl["w_h1"][r] for r in range(CS))[:S, :S],
        "b_h1": cat(sl["b_h1"][r] for r in range(CS))[:S],
        "w_h2": sl["w_h2"][0][:S, :C], "b_h2": sl["b_h2"][0][:C],
    }


@pytest.mark.parametrize("cs", cg.CLUSTER_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_kernel_pack_slices_restore_packed(width, dtype, cs):
    """(a) Every CTA's slice, unpadded and put back in the public column
    order, equals ``packed`` exactly; everything else in the blocks is zero
    (bf16 blocks go through the mma fragment order and back)."""
    spec, packed = _packed(width, getattr(torch, dtype))
    kp = cg.kernel_pack(packed, spec, cs)
    back = _public_from_slices(kp, spec)
    for name, a in back.items():
        assert torch.equal(a, packed[name]), name
    # what is not a weight is padding: the blocks hold no other mass
    sl = kp.slices()
    for name in ("w_in", "w_og", "w_h1", "b_in", "b_og", "b_h1"):
        assert float(sl[name].float().abs().sum()) == pytest.approx(
            float(packed[name].float().abs().sum()), rel=1e-6), name
    d = kp.dims
    assert d["Kin"] % 16 == 0 and d["Kog"] % 16 == 0 and d["Ksk"] % 16 == 0
    assert all(d[n] % 8 == 0 for n in ("Gq", "Rq", "Sq", "Cp"))
    assert all(d[n] % 64 == 8 for n in ("xs", "gs", "ss"))
    assert kp.wl.shape[2] % 16 == 0 and kp.wh.shape[1] % 16 == 0
    # the first 1x1 conv as the kernel reads it: zero columns up to the
    # ring's width, a multiple of 8
    R = spec.residual_channels
    for got, name in zip(kp.first, ("w_first", "b_first")):
        assert got.shape[-1] == -(-R // 8) * 8
        assert torch.equal(got[..., :R], packed[name])
        assert not got[..., R:].any()


def test_fragment_order_is_the_mma_b_operand():
    """Lane (g, t) of n-tile nt and k-step ks holds rows 16 ks + 2t + {0, 1,
    8, 9} of column 8 nt + g, and the inverse restores the matrix."""
    m = torch.arange(48 * 24, dtype=torch.float32).reshape(48, 24)
    f = cg._fragment_order(m)
    assert torch.equal(cg._from_fragment_order(f, 48, 24), m)
    NT = 24 // 8
    for ks, nt, lane in ((0, 0, 0), (1, 2, 5), (2, 1, 31)):
        g, t = lane // 4, lane % 4
        at = ((ks * NT + nt) * 32 + lane) * 4
        want = [m[16 * ks + 2 * t + o, 8 * nt + g] for o in (0, 1, 8, 9)]
        assert f[at:at + 4].tolist() == [float(w) for w in want]


@pytest.mark.parametrize("cs", cg.CLUSTER_SIZES)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_split_product_matches_plain(width, cs):
    """(b) The kernel's decomposition in plain torch (per-CTA column
    slices, zero padding, the gate reorder, then GLU, then the w_og slices)
    gives the plain version's z, gated and y, to 1e-6 in f32."""
    spec, packed = _packed(width, torch.float32)
    kp = cg.kernel_pack(packed, spec, cs)
    sl, d = kp.slices(), kp.dims
    k, R, G = spec.kernel_size, spec.residual_channels, spec.gate_channels
    G2, S, cin = G // 2, spec.skip_out_channels, spec.cin_channels
    Gq, Rq, Sq, Rp = d["Gq"], d["Rq"], d["Sq"], cs * d["Rq"]
    rs = np.random.RandomState(11)
    B, li = 5, spec.layers - 1
    inp = torch.from_numpy(rs.randn(B, k * R + cin).astype(np.float32))
    g_gate = torch.from_numpy(rs.randn(B, G).astype(np.float32))
    # the plain version's arithmetic
    z = inp @ packed["w_in"][li] + packed["b_in"][li] + g_gate
    gated = torch.tanh(z[:, :G2]) * torch.sigmoid(z[:, G2:])
    y = gated @ packed["w_og"][li] + packed["b_og"][li]
    # the kernel's buffers: [taps of CS*Rq channels | cond | zeros]
    xin = torch.zeros(B, d["Kin"])
    for tap in range(k):
        xin[:, tap * Rp:tap * Rp + R] = inp[:, tap * R:(tap + 1) * R]
    xin[:, k * Rp:k * Rp + cin] = inp[:, k * R:]
    gt = torch.zeros(B, d["Kog"])
    z_a, z_b = torch.zeros(B, cs * Gq), torch.zeros(B, cs * Gq)
    for r in range(cs):
        zr = xin @ sl["w_in"][r, li] + sl["b_in"][r, li]
        ch = torch.arange(r * Gq, (r + 1) * Gq)
        real = ch < G2                       # the global gate skips padding
        zr[:, :Gq][:, real] += g_gate[:, ch[real]]
        zr[:, Gq:][:, real] += g_gate[:, G2 + ch[real]]
        z_a[:, ch], z_b[:, ch] = zr[:, :Gq], zr[:, Gq:]
        gt[:, ch] = torch.tanh(zr[:, :Gq]) * torch.sigmoid(zr[:, Gq:])
    assert float(gt[:, G2:].abs().sum()) == 0.0   # GLU(0, 0) = 0
    torch.testing.assert_close(torch.cat([z_a[:, :G2], z_b[:, :G2]], 1), z,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(gt[:, :G2], gated, rtol=0, atol=1e-6)
    res, skip = torch.zeros(B, cs * Rq), torch.zeros(B, cs * Sq)
    for r in range(cs):
        yr = gt @ sl["w_og"][r, li] + sl["b_og"][r, li]
        res[:, r * Rq:(r + 1) * Rq] = yr[:, :Rq]
        skip[:, r * Sq:(r + 1) * Sq] = yr[:, Rq:]
    torch.testing.assert_close(torch.cat([res[:, :R], skip[:, :S]], 1), y,
                               rtol=0, atol=1e-6)
    assert float(res[:, R:].abs().sum()) == 0.0
    assert float(skip[:, S:].abs().sum()) == 0.0


@pytest.mark.parametrize("B", [1, 3, 32, 256, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_picker_covers_every_stream(width, dtype, B):
    """(c) The picker's cluster shape puts every stream into exactly one
    cluster, stays within what the kernel is built for, and leaves room in
    shared memory for the activation buffers."""
    spec = WaveNetSpec(out_channels=30, scalar_input=True, **WIDTHS[width])
    dt = getattr(torch, dtype)
    cs, streams = cg.pick_cluster(spec, B)
    assert cs in cg.CLUSTER_SIZES and 1 <= streams <= cg.CLUSTER_STREAMS
    assert 8 * cs <= max(8, min(spec.gate_channels // 2,
                                spec.residual_channels,
                                spec.skip_out_channels))
    groups = cg.stream_groups(B, streams)
    seen = np.zeros(B, int)
    for lo, hi in groups:
        assert 0 < hi - lo <= streams
        seen[lo:hi] += 1
    assert (seen == 1).all() and len(groups) == -(-B // streams)
    fixed, block = cg.kernel_smem_bytes(spec, cs, dt)
    assert fixed <= cg.SMEM_BYTES and block > 0
    if width == "flagship":
        # 15 clusters of 8 CTAs fit an H100 at once; past that, clusters of 4
        assert (cs, streams) == (8 if B <= 240 else 4, min(B, 16))
        if dtype == "bfloat16":     # and two layers' weights fit beside them
            assert fixed + 2 * block <= cg.SMEM_BYTES


def test_kernel_pack_is_made_once_per_pack():
    spec, packed = _packed("small", torch.float32)
    kp = cg.kernel_pack(packed, spec, 2)
    assert cg.kernel_pack(packed, spec, 2) is kp
    assert cg.kernel_pack(packed, spec, 1) is not kp
    packed["b_in"].add_(1.0)            # a weight changed: the pack is remade
    kp2 = cg.kernel_pack(packed, spec, 2)
    assert kp2 is not kp
    assert torch.equal(_public_from_slices(kp2, spec)["b_in"], packed["b_in"])
    plan = list(kp2.plan(16, 256, -1))
    assert plan[:4] == [2, 16, 256, -1] and len(plan) == 16
    assert plan[14:] == [kp2.wl.shape[2], kp2.wh.shape[1]]


def _small_cfg(**kw):
    over = dict(layers=4, stacks=2, residual_channels=8, gate_channels=16,
                skip_out_channels=8, cin_channels=4, num_mels=4, hop_size=4,
                cin_pad=1, upsample_params={"upsample_scales": [2, 2]})
    over.update(kw)
    return JaxConfig(**over), Config(**over)


@pytest.mark.parametrize("input_type", ["raw", "mulaw-quantize"])
def test_synthesizer_matches_jax_batch_wavegen(input_type):
    extra = ({} if input_type == "raw"
             else dict(input_type=input_type, out_channels=256,
                       quantize_channels=256))
    jc, tc = _small_cfg(**extra)
    jspec, tspec = jax_spec_from_config(jc), spec_from_config(tc)
    params = jax.tree.map(np.asarray, init_wavenet(jax.random.PRNGKey(9), jspec))
    model = WaveNet(tspec)
    model.load_state_dict(state_dict_from_jax(params, tspec))
    mel = np.random.RandomState(2).randn(2, 6, 4).astype(np.float32)
    ref = jax_batch_wavegen(params, jc, c=pad_mel_context(mel, jc.cin_pad),
                            engine="pallas", interpret=True,
                            deterministic=True, weight_dtype=jnp.float32,
                            chunk=16)
    synth = synthesis.Synthesizer(model, tc, engine="cuda", device="cpu",
                                  weight_dtype=torch.float32, chunk=16)
    wav = synth(mel, deterministic=True)
    assert wav.shape == ref.shape == (2, 24) and wav.dtype == np.float32
    np.testing.assert_allclose(wav, ref, atol=ATOL)
    # the eager engine agrees too
    wav_scan = synthesis.Synthesizer(model, tc, engine="scan", device="cpu")(
        mel, deterministic=True)
    np.testing.assert_allclose(wav_scan, ref, atol=ATOL)


def test_wavegen_single_utterance():
    _, tc = _small_cfg()
    model = WaveNet(spec_from_config(tc), generator=torch.Generator().manual_seed(0))
    mel = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    wav = synthesis.wavegen(model, tc, c=mel, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    assert wav.shape == (20,) and np.isfinite(wav).all()


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _small_cfg()
    model = WaveNet(spec_from_config(tc))
    mel = np.zeros((1, 5, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthesis.Synthesizer(model, tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthesis.batch_wavegen(model, tc, c=mel)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthesis.wavegen(model, tc, c=mel[0])


def test_port_imports_no_jax():
    """Every module of the port imports with jax blocked, and none of them
    loads the JAX package."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import wavenet_vocoder_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
       or m.startswith("wavenet_vocoder_tpu.") or m == "wavenet_vocoder_tpu"]
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 14
