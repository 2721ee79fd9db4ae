"""Audio / DSP feature extraction — self-contained (numpy + scipy only).

A copy of ``wavenet_vocoder_tpu/dsp/audio.py`` for the PyTorch port, which
imports nothing of the JAX package.

Re-implements the reference's ``audio.py`` pipeline without librosa/nnmnkwii,
and WITHOUT the process-global hparams coupling (reference: audio.py:4 imports
the hparams singleton; here every function takes explicit parameters).

Parity targets (reference: audio.py):
  * ``load_wav`` — int16 -> float, resample, clip (audio.py:32-40)
  * ``save_wav`` — peak-normalize -> int16 (audio.py:43-45)
  * ``low_cut_filter`` — 255-tap FIR highpass (audio.py:9-29)
  * ``preemphasis`` / ``inv_preemphasis`` (audio.py:53-58, LPCNet-style)
  * ``logmelspectrogram`` — ESPnet-compatible: STFT -> Slaney mel filterbank
    -> log10(max(S, 1e-10)) (audio.py:101-109, 128-156)
  * ``start_and_end_indices`` — silence trim around mu-law code 127
    (audio.py:87-98)
  * ``adjust_time_resolution`` — frame-repeat alignment for the no-upsample
    path (audio.py:61-84)
  * ``get_hop_size`` / ``get_win_length`` — ms-or-samples resolution
    (audio.py:112-125)
  * amp/db + min-max normalize helpers (audio.py:159-173)

The STFT follows librosa conventions (center=True, periodic window padded to
n_fft) so features match the reference's numerics; the mel filterbank is the
standard Slaney-style triangular bank with area normalization (librosa
defaults, which ``librosa.filters.mel`` uses at reference audio.py:154-156).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from wavenet_vocoder_tpu_torch.config import Config


# ----------------------------------------------------------------------
# IO
# ----------------------------------------------------------------------
def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """Read a wav -> float32 in [-1, 1] at ``sample_rate``
    (reference: audio.py:32-40)."""
    from scipy.io import wavfile
    sr, x = wavfile.read(path)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 2 ** 15
    elif x.dtype == np.int32:
        x = x.astype(np.float32) / 2 ** 31
    elif x.dtype == np.uint8:
        x = (x.astype(np.float32) - 128.0) / 128.0
    else:
        x = x.astype(np.float32)
    if x.ndim == 2:  # downmix
        x = x.mean(axis=1)
    if sr != sample_rate:
        x = resample(x, sr, sample_rate)
    return np.clip(x, -1.0, 1.0)


def save_wav(wav: np.ndarray, path: str, sample_rate: int) -> None:
    """Peak-normalize and write int16 wav (reference: audio.py:43-45)."""
    from scipy.io import wavfile
    wav = np.asarray(wav, dtype=np.float32)
    wav = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(path, sample_rate, wav.astype(np.int16))


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (replaces librosa.resample, audio.py:38)."""
    from scipy.signal import resample_poly
    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


# ----------------------------------------------------------------------
# Filters
# ----------------------------------------------------------------------
def low_cut_filter(x: np.ndarray, fs: int, cutoff: float = 70.0) -> np.ndarray:
    """255-tap FIR highpass for DC removal (reference: audio.py:9-29)."""
    from scipy.signal import firwin, lfilter
    nyquist = fs // 2
    fil = firwin(255, cutoff / nyquist, pass_zero=False)
    return lfilter(fil, 1, x)


def preemphasis(x: np.ndarray, coef: float = 0.85) -> np.ndarray:
    """y[n] = x[n] - coef*x[n-1] (reference: audio.py:53-54)."""
    from scipy.signal import lfilter
    return lfilter([1.0, -coef], [1.0], x).astype(np.float32)


def inv_preemphasis(x: np.ndarray, coef: float = 0.85) -> np.ndarray:
    """Inverse IIR of :func:`preemphasis` (reference: audio.py:57-58)."""
    return inv_preemphasis_rows(x, coef=coef)[0]


def inv_preemphasis_rows(x: np.ndarray, zi: Optional[np.ndarray] = None,
                         coef: float = 0.85
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`inv_preemphasis` of every row of a block ``x`` (..., n) in one
    call, the IIR continuing from ``zi`` (..., 1), the state the previous
    block of the same rows returned (None: from rest). Returns the float32
    block and the state to pass with the next block: block after block gives
    the bits of :func:`inv_preemphasis` over the whole rows."""
    from scipy.signal import lfilter
    x = np.asarray(x)
    if zi is None:
        zi = np.zeros(x.shape[:-1] + (1,))
    y, zf = lfilter([1.0], [1.0, -coef], x, axis=-1, zi=zi)
    return y.astype(np.float32), zf


# ----------------------------------------------------------------------
# Silence handling
# ----------------------------------------------------------------------
def start_and_end_indices(quantized: np.ndarray,
                          silence_threshold: int = 2) -> Tuple[int, int]:
    """First/last index where the mu-law code leaves the 127 +/- threshold
    silence band (reference: audio.py:87-98)."""
    nonsilent = np.abs(quantized.astype(np.int64) - 127) > silence_threshold
    idx = np.nonzero(nonsilent)[0]
    if idx.size == 0:
        return 0, quantized.size - 1
    return int(idx[0]), int(idx[-1])


def trim(quantized: np.ndarray, silence_threshold: int = 2) -> np.ndarray:
    """(reference: audio.py:48-50)."""
    start, end = start_and_end_indices(quantized, silence_threshold)
    return quantized[start:end]


def trim_silence(x: np.ndarray, top_db: float = 60.0,
                 frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Energy-based leading/trailing silence trim — the equivalent of
    ``librosa.effects.trim`` used during preprocessing
    (reference: datasets/wavallin.py:35)."""
    if x.size == 0:
        return x
    n_frames = max(1, 1 + (max(x.size - frame_length, 0)) // hop_length)
    rms = np.empty(n_frames, dtype=np.float64)
    for i in range(n_frames):
        seg = x[i * hop_length:i * hop_length + frame_length]
        rms[i] = np.sqrt(np.mean(seg.astype(np.float64) ** 2) + 1e-20)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10))
    keep = db > (db.max() - top_db)
    idx = np.nonzero(keep)[0]
    if idx.size == 0:
        return x[:0]
    start = idx[0] * hop_length
    end = min(x.size, (idx[-1] + 1) * hop_length + frame_length)
    return x[start:end]


def adjust_time_resolution(quantized: np.ndarray, mel: np.ndarray,
                           silence_threshold: int = 2
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Frame-repeat mel to sample rate + silence trim — the no-upsample-net
    alignment path (reference: audio.py:61-84)."""
    assert quantized.ndim == 1 and mel.ndim == 2
    upsample_factor = quantized.size // mel.shape[0]
    mel = np.repeat(mel, upsample_factor, axis=0)
    n_pad = quantized.size - mel.shape[0]
    if n_pad != 0:
        assert n_pad > 0
        mel = np.pad(mel, [(0, n_pad), (0, 0)], mode="constant")
    start, end = start_and_end_indices(quantized, silence_threshold)
    return quantized[start:end], mel[start:end, :]


# ----------------------------------------------------------------------
# Config-resolution helpers
# ----------------------------------------------------------------------
def get_hop_size(cfg: Config) -> int:
    """(reference: audio.py:112-117)."""
    hop = cfg.hop_size
    if hop is None:
        assert cfg.frame_shift_ms is not None
        hop = int(cfg.frame_shift_ms / 1000 * cfg.sample_rate)
    return hop


def get_win_length(cfg: Config) -> int:
    """(reference: audio.py:120-125)."""
    win = cfg.win_length
    if win < 0:
        assert cfg.win_length_ms > 0
        win = int(cfg.win_length_ms / 1000 * cfg.sample_rate)
    return win


# ----------------------------------------------------------------------
# STFT + mel
# ----------------------------------------------------------------------
def hann_window(n: int) -> np.ndarray:
    """Periodic ('fftbins') Hann window, librosa/scipy convention."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


def stft(y: np.ndarray, n_fft: int, hop_length: int,
         win_length: Optional[int] = None, window: str = "hann",
         center: bool = True, pad_mode: str = "reflect") -> np.ndarray:
    """Short-time Fourier transform, librosa conventions
    (reference: audio.py:128-132 uses librosa.stft).

    Returns complex (1 + n_fft//2, n_frames).
    """
    if win_length is None:
        win_length = n_fft
    if window == "hann":
        win = hann_window(win_length)
    else:
        from scipy.signal import get_window
        win = get_window(window, win_length, fftbins=True).astype(np.float64)
    # center the window inside an n_fft frame
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        win = np.pad(win, (lp, n_fft - win_length - lp))

    y = np.asarray(y, dtype=np.float64)
    if center:
        y = np.pad(y, n_fft // 2, mode=pad_mode)
    if y.size < n_fft:
        y = np.pad(y, (0, n_fft - y.size))
    n_frames = 1 + (y.size - n_fft) // hop_length
    strides = (y.strides[0] * hop_length, y.strides[0])
    frames = np.lib.stride_tricks.as_strided(
        y, shape=(n_frames, n_fft), strides=strides)
    return np.fft.rfft(frames * win, axis=-1).T


def hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f < min_log_hz, f / f_sp,
                    min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz)
                    / logstep)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m < min_log_mel, m * f_sp,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)))


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1+n_fft//2)
    — matches librosa.filters.mel defaults (reference: audio.py:151-156)."""
    if fmax is None:
        fmax = sample_rate / 2
    assert fmax <= sample_rate // 2, (fmax, sample_rate)
    fftfreqs = np.linspace(0, sample_rate / 2, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                    n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def logmelspectrogram(y: np.ndarray, cfg: Config,
                      pad_mode: str = "reflect") -> np.ndarray:
    """ESPnet-compatible log10-mel spectrogram, shape (n_frames, num_mels)
    (reference: audio.py:101-109; note the reference returns (mel, frames)
    and transposes at the call site, datasets/wavallin.py — we return
    channels-last directly)."""
    D = stft(y, n_fft=cfg.fft_size, hop_length=get_hop_size(cfg),
             win_length=get_win_length(cfg), window=cfg.window,
             center=True, pad_mode=pad_mode)
    mel = mel_filterbank(cfg.sample_rate, cfg.fft_size, n_mels=cfg.num_mels,
                         fmin=cfg.fmin, fmax=cfg.fmax)
    S = mel @ np.abs(D)
    return np.log10(np.maximum(S, 1e-10)).T.astype(np.float32)


# ----------------------------------------------------------------------
# dB helpers (reference: audio.py:159-173)
# ----------------------------------------------------------------------
def amp_to_db(x, min_level_db: float = -100.0):
    min_level = np.exp(min_level_db / 20 * np.log(10))
    return 20 * np.log10(np.maximum(min_level, x))


def db_to_amp(x):
    return np.power(10.0, np.asarray(x) * 0.05)


def normalize(S, min_level_db: float = -100.0):
    return np.clip((S - min_level_db) / -min_level_db, 0, 1)


def denormalize(S, min_level_db: float = -100.0):
    return (np.clip(S, 0, 1) * -min_level_db) + min_level_db
