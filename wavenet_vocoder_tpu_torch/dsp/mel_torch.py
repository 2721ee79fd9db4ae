"""Log-mel feature extraction on the device: the plain PyTorch version and
the CUDA kernel's wrapper.

The port's counterpart of ``wavenet_vocoder_tpu/dsp/mel_jax.py``. The host
pipeline (``dsp/audio.py:logmelspectrogram``) runs numpy in f64 during
offline preprocessing; this module computes the same transform where the
waveform already lies on the card (evaluation-time features,
analysis-synthesis loops):

  * the STFT is a matmul-DFT: the periodic Hann window is folded into
    real/imag DFT matrices, so ``frames @ cos`` and ``frames @ sin`` are two
    (F, n_fft) x (n_fft, n_bins) products;
  * the mel filterbank is a third product (n_bins x n_mels);
  * magnitude and log10 are elementwise.

``logmelspectrogram_torch`` does this with torch ops (unfold, matmul) and is
the kernel's plain version. ``logmelspectrogram_cuda`` launches
``csrc/mel.cu``, which does all of it in one kernel and keeps the framed
signal and the magnitudes out of device memory.

Numerics match ``dsp/audio.py`` (librosa STFT conventions: center=True,
reflect padding, periodic Hann; Slaney mel bank; log10(max(S, 1e-10))) to
f32 precision.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio as _audio

# limits of csrc/mel.cu: kFrames * n_mels <= kThreads * kMaxOut mel sums per
# block, and the block's samples, magnitudes and mel rows in shared memory
_KERNEL_FRAMES, _KERNEL_BINS, _MAX_MELS = 32, 128, 128
_MAX_SMEM = 232448


# ----------------------------------------------------------------------
# Host-side constants (made in f64 numpy, cast once)
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=8)
def _dft_mats(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT matrices, each (n_fft, 1 + n_fft//2) f32.

    frames @ cos_mat = Re(rfft(frames * win)),
    frames @ sin_mat = Im(rfft(frames * win)).
    """
    win = _audio.hann_window(win_length)
    if win_length < n_fft:  # center the window inside the frame
        lp = (n_fft - win_length) // 2
        win = np.pad(win, (lp, n_fft - win_length - lp))
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    cos_mat = (np.cos(ang) * win[:, None]).astype(np.float32)
    sin_mat = (np.sin(ang) * win[:, None]).astype(np.float32)
    return cos_mat, sin_mat


@functools.lru_cache(maxsize=8)
def _mel_mat(sample_rate: int, n_fft: int, num_mels: int,
             fmin: float, fmax: float) -> np.ndarray:
    """(n_bins, num_mels) f32 — transpose of dsp.audio.mel_filterbank."""
    return _audio.mel_filterbank(
        sample_rate, n_fft, n_mels=num_mels, fmin=fmin, fmax=fmax).T.copy()


def _resolve(cfg: Config) -> Tuple[int, int, int]:
    if cfg.window != "hann":
        raise ValueError(f"the device mel path supports the hann window only, "
                         f"got {cfg.window!r}")
    return cfg.fft_size, _audio.get_hop_size(cfg), _audio.get_win_length(cfg)


@functools.lru_cache(maxsize=8)
def _device_mats(n_fft: int, win_length: int, sample_rate: int, num_mels: int,
                 fmin: float, fmax: float, device: torch.device):
    """(cos, sin, mel) as contiguous f32 tensors on ``device``."""
    cos_np, sin_np = _dft_mats(n_fft, win_length)
    mel_np = _mel_mat(sample_rate, n_fft, num_mels, fmin, fmax)
    return tuple(torch.from_numpy(a).to(device).contiguous()
                 for a in (cos_np, sin_np, mel_np))


def _mats(cfg: Config, device: torch.device):
    n_fft, _, win_length = _resolve(cfg)
    return _device_mats(n_fft, win_length, cfg.sample_rate, cfg.num_mels,
                        float(cfg.fmin), float(cfg.fmax), device)


def _as_waveform(y, device) -> torch.Tensor:
    """(T,) or (B, T) float32 on ``device``; a tensor stays where it lies
    when no device is named, anything else goes to the card."""
    if device is None and isinstance(y, torch.Tensor):
        device = y.device
    else:
        from wavenet_vocoder_tpu_torch.synthesis import resolve_device
        device = resolve_device(device)
    y = torch.as_tensor(y).to(device=device, dtype=torch.float32)
    if y.ndim not in (1, 2):
        raise ValueError(f"waveform must be (T,) or (B, T), got {tuple(y.shape)}")
    return y


# ----------------------------------------------------------------------
# The plain PyTorch version
# ----------------------------------------------------------------------
def mel_power_torch(y: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The mel sums S before the log: (..., F, num_mels) f32 for y (..., T)
    f32 on any device. The three products run in full float32 whatever the
    process-wide TF32 flag says: a DFT done in fewer bits costs the log-mel
    two orders of magnitude of accuracy."""
    n_fft, hop, _ = _resolve(cfg)
    cos_m, sin_m, mel_m = _mats(cfg, y.device)
    pad = n_fft // 2
    # reflect padding needs at least pad + 1 samples; F.pad raises otherwise
    y = F.pad(y.reshape(-1, y.shape[-1]), (pad, pad),
              mode="reflect").reshape(*y.shape[:-1], -1)
    frames = y.unfold(-1, n_fft, hop)                    # (..., F, n_fft)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        re = frames @ cos_m
        im = frames @ sin_m
        return torch.sqrt(re * re + im * im) @ mel_m
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def logmelspectrogram_torch(y, cfg: Config, device=None) -> torch.Tensor:
    """Log10-mel with torch ops, matching ``dsp.audio.logmelspectrogram``.

    y: (T,) or (B, T) waveform (tensor or array). Returns (n_frames,
    num_mels) or (B, n_frames, num_mels) f32 on the waveform's device
    (``device`` when given; an array goes to the card).
    """
    y = _as_waveform(y, device)
    return torch.log10(torch.clamp(mel_power_torch(y, cfg), min=1e-10))


# ----------------------------------------------------------------------
# The kernel's wrapper
# ----------------------------------------------------------------------
_PTR = ctypes.c_void_p


def _kernel_fn():
    from wavenet_vocoder_tpu_torch.kernels.build import load
    fn = load("mel").wn_logmel
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 5 + [ctypes.c_int] * 7 + [_PTR]
        fn.restype = ctypes.c_int
    return fn


def logmelspectrogram_cuda(y, cfg: Config) -> torch.Tensor:
    """Log10-mel through the fused CUDA kernel (``csrc/mel.cu``).

    y: (T,) or (B, T) waveform; a tensor is used where it lies, an array is
    moved to the card. Returns (n_frames, num_mels) or (B, n_frames,
    num_mels) f32, n_frames = 1 + T // hop. Each launch adds one to
    ``logmelspectrogram_cuda.launches``.

    The kernel is defined for ``fft_size % hop_size == 0`` (true for every
    shipped preset): a frame is then a whole number of hop-sized chunks.
    A CPU tensor takes the plain version, ``logmelspectrogram_torch``, and
    only a CPU tensor does. On a CUDA tensor the kernel launches or the
    call raises: for a shape the kernel does not define (any other hop,
    where the JAX package's Pallas wrapper goes through its XLA path; call
    ``logmelspectrogram_torch`` for those) and for a kernel that does not
    build or launch. Nothing falls back.
    """
    y = _as_waveform(y, None)
    n_fft, hop, _ = _resolve(cfg)
    if y.device.type == "cpu":
        return logmelspectrogram_torch(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"no log-mel kernel for device {y.device}")
    if n_fft % hop != 0:
        raise ValueError("the log-mel kernel needs fft_size to be a multiple "
                         f"of hop_size; got {n_fft} and {hop}. Call "
                         "logmelspectrogram_torch for this shape")
    dev = y.device
    yb = (y[None] if y.ndim == 1 else y).contiguous()
    B, T = yb.shape
    n_bins, n_mels = 1 + n_fft // 2, cfg.num_mels
    if T <= n_fft // 2:
        raise ValueError(f"reflect padding by {n_fft // 2} needs more than "
                         f"{n_fft // 2} samples, got {T}")
    if hop % 8 or n_mels > _MAX_MELS:
        raise ValueError("the log-mel kernel needs a hop size that is a "
                         f"multiple of 8 and at most {_MAX_MELS} mel bins; got "
                         f"hop {hop}, {n_mels} bins")
    smem = 4 * ((_KERNEL_FRAMES - 1) * hop + n_fft
                + _KERNEL_FRAMES * _KERNEL_BINS + _KERNEL_BINS * n_mels)
    if smem > _MAX_SMEM:
        raise ValueError(f"the log-mel kernel stages {smem} bytes per block "
                         f"for fft_size {n_fft}, hop {hop}: more than the "
                         f"{_MAX_SMEM} a block can have")
    cos_m, sin_m, mel_m = _mats(cfg, dev)
    n_frames = 1 + T // hop
    out = torch.empty(B, n_frames, n_mels, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = _kernel_fn()(
            yb.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(),
            mel_m.data_ptr(), out.data_ptr(), B, T, n_frames, n_fft, hop,
            n_bins, n_mels, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
    logmelspectrogram_cuda.launches += 1
    return out[0] if y.ndim == 1 else out


logmelspectrogram_cuda.launches = 0
