"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; without a CUDA device they skip.
They import nothing of JAX, so they run on a machine that has only the port:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, WaveNetSpec
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg

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


@pytest.mark.cuda
@pytest.mark.parametrize("block_streams", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "sample"])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_kernel_matches_plain(cuda, head, deterministic, dtype, block_streams):
    """Same inputs, state and seed: codes equal, scalars within 1e-3 (the
    summation order differs; 32 steps keep AR feedback from amplifying
    rounding). B=3 leaves a ragged last block for 2 streams per block;
    t0=5 checks the ring indexing past the start."""
    model = _model(10, **HEADS[head]).to(cuda)
    spec = model.spec
    dt = getattr(torch, dtype)
    packed = cg.pack_weights(model, dtype=dt)
    B, n = 3, 32
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
                              _block_streams=block_streams)
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


@pytest.mark.cuda
def test_wrapper_raises_on_bad_block_streams(cuda):
    model = _model(0, **HEADS["mol"]).to(cuda)
    packed = cg.pack_weights(model, dtype=torch.float32)
    _, rows = cg.buffer_layout(model.spec)
    ring = torch.zeros(rows, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="_block_streams"):
        cg.generate_steps(packed, model.spec, ring, torch.zeros(2, 1, device=cuda),
                          torch.empty(2, 4, device=cuda),
                          torch.zeros(2, 4, 4, device=cuda), t0=0, seed=0,
                          _block_streams=4)
