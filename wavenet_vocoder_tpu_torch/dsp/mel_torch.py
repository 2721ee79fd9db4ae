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
``csrc/mel.cu``, which does all of it in one launch, over the bins the mel
matrix uses, with split-TF32 DFT products on the tensor cores; it keeps the
framed signal and the magnitudes out of device memory. Both propagate NaN
through the clamp, as ``jnp.maximum`` in the JAX package does.

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

_MAX_SMEM = 232448
# variant build, a timing aid: the products compiled out
NO_PRODUCTS = ("WN_MEL_NO_PRODUCTS",)


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


def used_bins(mel_m: np.ndarray) -> Tuple[int, int]:
    """[k0, k1): the rows of the (n_bins, n_mels) mel matrix that hold a
    non-zero weight (6..353 for the shipped presets). A bin outside adds
    exactly 0.0 to every mel sum, so the kernel computes these bins only."""
    rows = np.nonzero(np.any(mel_m != 0.0, axis=1))[0]
    if rows.size == 0:
        return 0, 1
    return int(rows[0]), int(rows[-1]) + 1


@functools.lru_cache(maxsize=8)
def _kernel_consts(n_fft: int, win_length: int, sample_rate: int,
                   num_mels: int, fmin: float, fmax: float, tile_bins: int):
    """What ``csrc/mel.cu`` reads: (k0, k1, bin tiles, the DFT matrices in
    fragment order, the mel rows of the used bins, and each band's [first,
    last + 1) used bin with a non-zero weight, counted from k0).

    The DFT matrices over bins [k0, k0 + tiles * tile_bins) (zero past k1)
    are laid out as the kernel's mma A fragments (16 bins x 8 samples) read
    them,
    which it splits into TF32 halves in registers: [tile][k-step][m-tile]
    [cos | sin][lane][a0..a3], where lane = 4 g + t holds bins 16 m-tile + g
    and + 8 of rows 8 ks + 2 t and 8 ks + 2 t + 1 (the k-step's depth is
    permuted so that a lane's two samples of a frame are adjacent):
    a0 = (2t, g), a1 = (2t, g + 8), a2 = (2t + 1, g), a3 = (2t + 1, g + 8)."""
    cos_np, sin_np = _dft_mats(n_fft, win_length)
    mel_np = _mel_mat(sample_rate, n_fft, num_mels, fmin, fmax)
    k0, k1 = used_bins(mel_np)
    tiles = -(-(k1 - k0) // tile_bins)
    width = tiles * tile_bins
    n_ks, mt = n_fft // 8, tile_bins // 16

    def fragments(m):
        full = np.zeros((n_fft, width), np.float32)
        full[:, :k1 - k0] = m[:, k0:k1]
        # rows (ks, t, pair), columns (tile, m-tile, half, g) -> (tile, ks,
        # m-tile, lane = (g, t), (pair, half))
        return full.reshape(n_ks, 4, 2, tiles, mt, 2, 8).transpose(
            3, 0, 4, 6, 1, 2, 5).reshape(tiles, n_ks, mt, 32, 4)

    frag = np.stack([fragments(cos_np), fragments(sin_np)], axis=3)
    rows = np.zeros((width, num_mels), np.float32)
    rows[:k1 - k0] = mel_np[k0:k1]
    bands = np.zeros((num_mels, 2), np.int32)
    for j in range(num_mels):
        nz = np.nonzero(rows[:, j])[0]
        if nz.size:
            bands[j] = nz[0], nz[-1] + 1
    return k0, k1, tiles, np.ascontiguousarray(frag), rows, bands


@functools.lru_cache(maxsize=8)
def _device_kernel_consts(n_fft: int, win_length: int, sample_rate: int,
                          num_mels: int, fmin: float, fmax: float,
                          tile_bins: int, device: torch.device):
    k0, k1, tiles, *consts = _kernel_consts(
        n_fft, win_length, sample_rate, num_mels, fmin, fmax, tile_bins)
    return (k0, k1, tiles, *(torch.from_numpy(a).to(device) for a in consts))


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


@functools.lru_cache(maxsize=None)
def _kernel(defines: Tuple[str, ...] = ()):
    """(launch function, layout function) of the mel library built with
    ``defines``."""
    from wavenet_vocoder_tpu_torch.kernels.build import load
    lib = load("mel", defines)
    fn = lib.wn_logmel
    fn.argtypes = [_PTR] * 6 + [ctypes.c_int] * 7 + [_PTR]
    fn.restype = ctypes.c_int
    layout = lib.wn_logmel_layout
    layout.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    layout.restype = None
    return fn, layout


def kernel_layout(n_fft: int, hop: int, n_mels: int, B: int, n_frames: int,
                  defines: Tuple[str, ...] = ()) -> Tuple[int, int, int, int]:
    """(bins a bin tile, skew, staged floats, shared-memory bytes) of one
    block of ``csrc/mel.cu`` for this shape, as the kernel lays it out
    (``wn_logmel_layout``; builds the library)."""
    out = (ctypes.c_longlong * 4)()
    _kernel(defines)[1](n_fft, hop, n_mels, B, n_frames, out)
    return tuple(int(v) for v in out)


@functools.lru_cache(maxsize=64)
def _plan(n_fft: int, hop: int, win_length: int, sample_rate: int,
          n_mels: int, fmin: float, fmax: float, B: int, T: int,
          device: torch.device, defines: Tuple[str, ...]):
    """(launch function, constants on the device, the launch's int
    arguments) for one shape, checked once."""
    if T <= n_fft // 2:
        raise ValueError(f"reflect padding by {n_fft // 2} needs more than "
                         f"{n_fft // 2} samples, got {T}")
    if n_fft % 8:
        raise ValueError("the log-mel kernel takes the DFT 8 samples deep: "
                         f"fft_size must be a multiple of 8, got {n_fft}")
    n_frames = 1 + T // hop
    tile_bins, _, _, smem = kernel_layout(n_fft, hop, n_mels, B, n_frames,
                                          defines)
    if smem > _MAX_SMEM:
        raise ValueError(f"the log-mel kernel stages {smem} bytes per block "
                         f"for fft_size {n_fft}, hop {hop}, {n_mels} mel "
                         f"bins: more than the {_MAX_SMEM} a block can have")
    _, _, tiles, *consts = _device_kernel_consts(
        n_fft, win_length, sample_rate, n_mels, fmin, fmax, tile_bins, device)
    return _kernel(defines)[0], consts, (B, T, n_frames, n_fft, hop, n_mels,
                                         tiles)


def logmelspectrogram_cuda(y, cfg: Config, *, _defines: Tuple[str, ...] = ()
                           ) -> torch.Tensor:
    """Log10-mel through the CUDA kernel (``csrc/mel.cu``).

    y: (T,) or (B, T) waveform; a tensor is used where it lies, an array is
    moved to the card. Returns (n_frames, num_mels) or (B, n_frames,
    num_mels) f32, n_frames = 1 + T // hop. Each call launches two kernels,
    the transform and the launch that adds its bin tiles' sums, and adds two
    to ``logmelspectrogram_cuda.launches``.

    The kernel computes only the bins the mel matrix uses (``used_bins``),
    with its DFT products in split TF32 on the tensor cores; any hop. A CPU
    tensor takes the plain version, ``logmelspectrogram_torch``, and only a
    CPU tensor does. On a CUDA tensor the kernel launches or the call
    raises: for a shape the kernel does not take (fft_size not a multiple of
    8, or a block's staging past shared memory; call
    ``logmelspectrogram_torch`` for those) and for a kernel that does not
    build or launch. Nothing falls back. ``_defines`` launches a variant
    build (``NO_PRODUCTS``, a timing aid).
    """
    y = _as_waveform(y, None)
    if y.device.type == "cpu":
        return logmelspectrogram_torch(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"no log-mel kernel for device {y.device}")
    n_fft, hop, win_length = _resolve(cfg)
    dev = y.device
    yb = (y[None] if y.ndim == 1 else y).contiguous()
    B, T = yb.shape
    fn, (frag, rows, bands), ints = _plan(
        n_fft, hop, win_length, cfg.sample_rate, cfg.num_mels,
        float(cfg.fmin), float(cfg.fmax), B, T, dev, tuple(_defines))
    n_frames, tiles = ints[2], ints[6]
    out = torch.empty(B, n_frames, cfg.num_mels, device=dev,
                      dtype=torch.float32)
    scratch = torch.empty(B * n_frames, tiles, cfg.num_mels, device=dev,
                          dtype=torch.float32)
    with torch.cuda.device(dev):
        err = fn(yb.data_ptr(), frag.data_ptr(), rows.data_ptr(),
                 bands.data_ptr(), out.data_ptr(), scratch.data_ptr(), *ints,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
    logmelspectrogram_cuda.launches += 2
    return out[0] if y.ndim == 1 else out


logmelspectrogram_cuda.launches = 0
