"""Feature-extraction pipeline (reference: preprocess.py + datasets/wavallin.py).

The port's counterpart of ``wavenet_vocoder_tpu/data/preprocess.py``; numpy
on the host, as there: preprocessing keeps the f64 host log-mel
(``dsp/audio.py``), and the dump directories of the two packages are
interchangeable.

Implements the dataset-plugin protocol ``build_from_path(in_dir, out_dir,
cfg, num_workers)`` (reference: preprocess.py:24, wavallin.py:17) with the
"wavallin" plugin (all wavs in one directory) and writes the pipe-delimited
``train.txt`` manifest + corpus-hours summary (reference: preprocess.py:28-37).

Per-utterance processing (reference: wavallin.py:29-109):
  load -> trim(top_db=60) -> highpass -> log-mel -> gain scale -> optional
  time-domain preprocess (e.g. preemphasis) -> reject clipped -> target encode
  per input_type -> pad by fft_size then truncate to N*hop_size so the length
  is exactly hop-divisible for upsampling.
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from glob import glob
from os.path import basename, join, splitext
from typing import Callable, List, Tuple

import numpy as np

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.ops.mulaw import mulaw, mulaw_quantize


def _process_utterance(out_dir: str, index: int, wav_path: str, text: str,
                       cfg: Config) -> Tuple[str, str, int, str]:
    """(reference: wavallin.py:29-112)."""
    wav = audio.load_wav(wav_path, cfg.sample_rate)

    # begin/end silence trim (reference: wavallin.py:35)
    wav = audio.trim_silence(wav, top_db=60, frame_length=2048, hop_length=512)

    if cfg.highpass_cutoff > 0.0:
        wav = audio.low_cut_filter(wav, cfg.sample_rate, cfg.highpass_cutoff)

    mu = cfg.quantize_channels - 1
    if cfg.is_mulaw_quantize:
        constant_values = int(mulaw_quantize(np.zeros(1), mu)[0])
        out_dtype = np.int16 if cfg.quantize_channels <= 2 ** 15 else np.int32
    elif cfg.input_type == "mulaw":
        constant_values = float(mulaw(0.0, mu))
        out_dtype = np.float32
    else:
        constant_values = 0.0
        out_dtype = np.float32

    # (N, D) log-mel of the trimmed wav (reference: wavallin.py:62)
    mel = audio.logmelspectrogram(np.asarray(wav, np.float32), cfg)

    if cfg.global_gain_scale > 0:
        wav = wav * cfg.global_gain_scale

    # time-domain preprocessing, e.g. preemphasis (reference: wavallin.py:68-70)
    if cfg.preprocess not in (None, "", "none"):
        wav = getattr(audio, cfg.preprocess)(wav)

    # reject clipped utterances (reference: wavallin.py:73-76)
    if np.abs(wav).max() > 1.0:
        print(f"Warning: abs max value exceeds 1.0: {np.abs(wav).max()} "
              f"({wav_path}) — skipping")
        return ("dummy", "dummy", -1, "dummy")
    wav = np.clip(wav, -1.0, 1.0)

    if cfg.is_mulaw_quantize:
        out = mulaw_quantize(wav, mu)
    elif cfg.input_type == "mulaw":
        out = mulaw(wav, mu)
    else:
        out = wav

    # pad then truncate to exactly N*hop samples (reference: wavallin.py:88-100)
    hop = audio.get_hop_size(cfg)
    out = np.pad(out, (0, cfg.fft_size), mode="constant",
                 constant_values=constant_values)
    N = mel.shape[0]
    assert len(out) >= N * hop
    out = out[:N * hop]
    assert len(out) % hop == 0

    name = splitext(basename(wav_path))[0]
    audio_filename = f"{name}-wave.npy"
    mel_filename = f"{name}-feats.npy"
    np.save(join(out_dir, audio_filename), out.astype(out_dtype),
            allow_pickle=False)
    np.save(join(out_dir, mel_filename), mel.astype(np.float32),
            allow_pickle=False)
    return (audio_filename, mel_filename, N, text)


def build_from_path_wavallin(in_dir: str, out_dir: str, cfg: Config,
                             num_workers: int = 1,
                             tqdm: Callable = lambda x: x) -> List[Tuple]:
    """All wavs in one directory (reference: wavallin.py:17-26)."""
    src_files = sorted(glob(join(in_dir, "*.wav")))
    if num_workers <= 1:
        return [_process_utterance(out_dir, i + 1, p, "dummy", cfg)
                for i, p in enumerate(tqdm(src_files))]
    with ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=multiprocessing.get_context("spawn")) as executor:
        futures = [executor.submit(partial(_process_utterance, out_dir, i + 1,
                                           p, "dummy", cfg))
                   for i, p in enumerate(src_files)]
        return [f.result() for f in tqdm(futures)]


DATASET_PLUGINS = {
    "wavallin": build_from_path_wavallin,
}


def preprocess(dataset_name: str, in_dir: str, out_dir: str, cfg: Config,
               num_workers: int = 1) -> None:
    """Full preprocessing entry (reference: preprocess.py:22-37)."""
    if dataset_name in ("ljspeech", "cmu_arctic", "librivox", "jsut"):
        raise ValueError(
            f"{dataset_name} is no longer supported — use the mksubset + "
            "wavallin flow instead (reference: preprocess.py:58-68)")
    if dataset_name in DATASET_PLUGINS:
        build = DATASET_PLUGINS[dataset_name]
    else:
        # extensibility parity: any importable module exposing
        # build_from_path(in_dir, out_dir, cfg, num_workers, tqdm) works as a
        # dataset plugin (reference: preprocess.py:70 importlib lookup)
        import importlib
        try:
            mod = importlib.import_module(dataset_name)
        except ImportError:
            raise ValueError(
                f"Unknown dataset plugin: {dataset_name!r} (not a built-in "
                f"{sorted(DATASET_PLUGINS)} and not an importable module)")
        build = getattr(mod, "build_from_path", None)
        if build is None:
            raise ValueError(
                f"Plugin module {dataset_name!r} lacks build_from_path")
    os.makedirs(out_dir, exist_ok=True)
    metadata = build(in_dir, out_dir, cfg, num_workers)
    write_metadata(metadata, out_dir, cfg)


def write_metadata(metadata: List[Tuple], out_dir: str, cfg: Config) -> None:
    """Write train.txt + corpus stats (reference: preprocess.py:28-37)."""
    metadata = [m for m in metadata if int(m[2]) >= 0]  # drop rejected
    with open(join(out_dir, "train.txt"), "w", encoding="utf-8") as f:
        for m in metadata:
            f.write("|".join(str(x) for x in m) + "\n")
    frames = sum(int(m[2]) for m in metadata)
    hop = audio.get_hop_size(cfg)
    hours = frames * hop / cfg.sample_rate / 3600
    print(f"Wrote {len(metadata)} utterances, {frames} frames "
          f"({hours:.2f} hours)")
    print(f"Max frames: {max((int(m[2]) for m in metadata), default=0)}")
