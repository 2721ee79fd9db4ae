"""PyTorch port vs the JAX package: log-mel extraction on the device.

The port's plain version (``logmelspectrogram_torch``) is held against the
JAX XLA path and against the JAX Pallas kernel in interpret mode (1e-4: the
same f32 arithmetic, summed in another order), and against the host f64
pipeline (2e-3, the limit of tests/test_mel_jax.py). On the CPU the kernel's
wrapper takes the plain version; the kernel itself is held against it on a
GPU in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest

import jax  # noqa: F401  (imported before torch, as the other parity tests do)
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.dsp import mel_jax
from wavenet_vocoder_tpu.dsp.mel_jax import (
    logmelspectrogram_jax,
    logmelspectrogram_pallas,
)

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio, mel_torch
from wavenet_vocoder_tpu_torch.utils import profiling
from wavenet_vocoder_tpu_torch.dsp.mel_torch import (
    logmelspectrogram_cuda,
    logmelspectrogram_torch,
)

torch.set_num_threads(1)

PARITY_TOL = 1e-4   # port vs JAX, both f32
HOST_TOL = 2e-3     # f32 device path vs the f64 host path


def _sig(T, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(T) / 22050.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1330 * t)
         + 0.05 * rng.randn(T))
    return x.astype(np.float32)


def _maxdiff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("win_length", [1024, 800])
def test_dft_constants_equal_jax_bit_for_bit(win_length):
    ours = mel_torch._dft_mats(1024, win_length)
    ref = mel_jax._dft_mats(1024, win_length)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)


def test_mel_constants_equal_jax_bit_for_bit():
    cfg = Config()
    args = (cfg.sample_rate, cfg.fft_size, cfg.num_mels, float(cfg.fmin),
            float(cfg.fmax))
    a, b = mel_torch._mel_mat(*args), mel_jax._mel_mat(*args)
    assert a.shape == (513, 80) and a.dtype == np.float32
    assert np.array_equal(a, b)


@pytest.mark.parametrize("T,seed", [(22050, 0), (3000, 4)])
def test_plain_matches_jax_xla(T, seed):
    x = _sig(T, seed)
    got = logmelspectrogram_torch(torch.from_numpy(x), Config()).numpy()
    ref = logmelspectrogram_jax(x, JaxConfig())
    assert got.dtype == np.float32
    assert _maxdiff(got, ref) < PARITY_TOL


@pytest.mark.parametrize("T,seed", [(22050, 3), (3000, 4)])
def test_plain_matches_jax_pallas_interpret(T, seed):
    # 3000 samples: shorter than one frame block, the kernel's pad tail
    x = _sig(T, seed)
    got = logmelspectrogram_torch(torch.from_numpy(x), Config()).numpy()
    ref = logmelspectrogram_pallas(x, JaxConfig(), f_blk=16, interpret=True)
    assert _maxdiff(got, ref) < PARITY_TOL


@pytest.mark.parametrize("T,seed", [(22050, 0), (3000, 4)])
def test_plain_matches_host(T, seed):
    x = _sig(T, seed)
    cfg = Config()
    got = logmelspectrogram_torch(torch.from_numpy(x), cfg).numpy()
    assert _maxdiff(got, audio.logmelspectrogram(x, cfg)) < HOST_TOL


def test_batched():
    x = np.stack([_sig(8192, 0), _sig(8192, 1)])
    cfg = Config()
    got = logmelspectrogram_torch(torch.from_numpy(x), cfg).numpy()
    ref = np.asarray(logmelspectrogram_jax(x, JaxConfig()))
    assert got.shape == (2, 33, 80)
    assert _maxdiff(got, ref) < PARITY_TOL
    for i in range(2):
        assert _maxdiff(got[i], audio.logmelspectrogram(x[i], cfg)) < HOST_TOL


def test_win_length_shorter_than_fft():
    x = _sig(12000, seed=5)
    got = logmelspectrogram_torch(torch.from_numpy(x),
                                  Config(win_length=800)).numpy()
    ref = logmelspectrogram_jax(x, JaxConfig(win_length=800))
    assert _maxdiff(got, ref) < PARITY_TOL
    assert _maxdiff(got, audio.logmelspectrogram(
        x, Config(win_length=800))) < HOST_TOL


def test_wrapper_on_cpu_tensor_is_the_plain_version():
    x = torch.from_numpy(np.stack([_sig(6000, 6), _sig(6000, 7)]))
    cfg = Config()
    before = profiling.counters().get("mel.launches")
    got = logmelspectrogram_cuda(x, cfg)
    assert torch.equal(got, logmelspectrogram_torch(x, cfg))
    assert torch.equal(logmelspectrogram_cuda(x[0], cfg), got[0])
    # no kernel launched
    assert profiling.counters().get("mel.launches") == before


def test_non_divisible_hop_takes_the_plain_path():
    # fft_size % hop_size != 0: the Pallas kernel does not define it, and the
    # JAX wrapper goes through its XLA path. A CPU tensor goes through the
    # plain version; the port's kernel reads each frame at f * hop and takes
    # it on the card (tests/test_torch_kernels.py, case hop_300)
    x = _sig(9000, seed=8)
    got = logmelspectrogram_cuda(torch.from_numpy(x),
                                 Config(hop_size=300)).numpy()
    ref = logmelspectrogram_pallas(x, JaxConfig(hop_size=300),
                                   interpret=True)
    assert got.shape == (31, 80)
    assert _maxdiff(got, ref) < PARITY_TOL
    assert _maxdiff(got, audio.logmelspectrogram(
        x, Config(hop_size=300))) < HOST_TOL


def test_too_short_for_reflect_padding_raises():
    with pytest.raises(RuntimeError, match="[Pp]adding"):
        logmelspectrogram_torch(torch.zeros(512), Config())


def test_products_run_in_full_f32_and_restore_the_flag():
    x = torch.from_numpy(_sig(4096, 9))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        seen = []
        orig = torch.sqrt

        def spy(t):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return orig(t)
        torch.sqrt = spy
        try:
            logmelspectrogram_torch(x, Config())
        finally:
            torch.sqrt = orig
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_arrays_go_to_the_card_or_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        logmelspectrogram_cuda(_sig(4096), Config())
    got = logmelspectrogram_torch(_sig(4096), Config(), device="cpu")
    assert got.shape == (17, 80)


def test_other_windows_raise():
    with pytest.raises(ValueError, match="hann"):
        logmelspectrogram_torch(torch.zeros(4096), Config(window="hamming"))
