"""Streaming (chunked) synthesis with persistent decoder state.

The port's counterpart of ``wavenet_vocoder_tpu/streaming.py``. A production
vocoder sits behind an acoustic model that emits mel frames incrementally;
this module generates audio as frames arrive, holding the decoder's state
across calls on the device: the fused kernel's packed ring and next input
(``ops/cuda_generate.py``, engine ``"cuda"``) or the eager decoder's ring
buffers (``ops/generate.py``, engine ``"scan"``).

Exactness: chunked generation equals one offline call —
  * the ring indices key off the absolute step index, and so do the fused
    engine's random numbers (a counter hash of seed, stream, absolute step);
    the eager engine draws from one ``torch.Generator`` in step order;
  * local conditioning for each emitted block is computed from a mel window
    wide enough that the upsample network's output matches the full-sequence
    computation: the context conv needs cin_pad frames each side and the
    per-scale smoothing convs add < 1 input frame of radius per scale
    (kernel 2s+1 at stretch s), so ``cin_pad + len(scales)`` frames of
    lookahead suffice — that is the algorithmic latency of the stream;
  * the mu-law / gain / preemphasis decode chain is streamed with carried
    IIR filter state (reference decode: synthesis.py:66-86).

Verified by tests/test_torch_streaming.py: stream == offline, elementwise.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet
from wavenet_vocoder_tpu_torch.ops.mulaw import inv_mulaw, inv_mulaw_quantize
from wavenet_vocoder_tpu_torch.synthesis import (
    ENGINES,
    _seed_from,
    resolve_device,
)


class StreamingSynthesizer:
    """Feed mel frames in, get waveform samples out, chunk by chunk.

    Usage::

        stream = StreamingSynthesizer(model, cfg, generator=gen, batch=1)
        for mel_chunk in acoustic_model():        # (B, F_i, D) frames
            audio_chunk = stream.feed(mel_chunk)  # (B, n_i) float32
        tail = stream.flush()                     # final samples

    The concatenation of all returned chunks equals ``Synthesizer`` on the
    full mel (same model, engine and generator state) elementwise.

    Notes:
      * frames buffered but not yet emittable (the ``lookahead_frames``
        algorithmic latency) are generated at :meth:`flush`, which
        replicate-pads the mel tail exactly like offline inference
        (reference: evaluate.py:163-164).
      * engine ``"cuda"`` launches the kernel in steps of ``chunk`` (default:
        the hop size); emitted blocks are hop multiples, so a chunk that
        divides the hop always divides them. ``generator`` is a CPU
        generator the stream's seed is drawn from, as in ``Synthesizer``.
        Engine ``"scan"`` draws every step from ``generator``, which lies
        on the model's device.
      * :meth:`reset` rewinds ``generator`` to where it stood at
        construction, so a restarted stream repeats its random numbers.
      * g (global conditioning) is fixed per stream at construction.
    """

    def __init__(self, model: WaveNet, cfg: Config, *,
                 generator: Optional[torch.Generator] = None,
                 batch: int = 1, g: Optional[np.ndarray] = None,
                 engine: str = "cuda", chunk: Optional[int] = None,
                 weight_dtype=torch.bfloat16, deterministic: bool = False,
                 device=None):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        self.cfg = cfg
        self.engine = engine
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = model.spec
        self.batch = batch
        self._deterministic = deterministic
        self._generator = generator
        self._gen_state = None if generator is None else generator.get_state()
        self._g = None if g is None else torch.as_tensor(
            np.asarray(g), device=self.device)
        self.hop = audio.get_hop_size(cfg)
        s = self.spec
        if s.upsample_conditional_features:
            # conv-pipeline radius in mel frames: cin_pad for the context
            # conv + <1 frame per smoothing conv (see module docstring)
            self._extra = len(s.upsample_scales)
            self.lookahead_frames = s.cin_pad + self._extra
        else:
            self._extra = 0
            self.lookahead_frames = 0
        self._gen = None
        if engine == "cuda":
            from wavenet_vocoder_tpu_torch.ops.cuda_generate import FusedGenerator
            self._gen = FusedGenerator(self.model, weight_dtype=weight_dtype,
                                       chunk=chunk or self.hop)
        elif chunk is not None:
            raise TypeError("engine='scan' takes no chunk")
        self.reset()

    def reset(self) -> None:
        """Drop all buffered mel and decoder state; start a new stream."""
        self._mel: Optional[np.ndarray] = None  # padded frames accumulated
        self._n_raw = 0           # raw mel frames received
        self._emitted = 0         # output frames already generated
        self._state = None        # decoder carry
        self._preemph_carry = np.zeros(self.batch, np.float64)
        self._final = False
        if self._generator is not None:
            self._generator.set_state(self._gen_state)
        if self.engine == "cuda":
            self._seed = _seed_from(self._generator)

    # ------------------------------------------------------------------
    @property
    def algorithmic_latency_samples(self) -> int:
        """Samples of right-context the stream waits for before emitting."""
        return self.lookahead_frames * self.hop

    def feed(self, mel: Optional[np.ndarray]) -> np.ndarray:
        """Add mel frames (B, F, D); return newly decodable audio (B, n)."""
        if self._final:
            raise RuntimeError("stream is finished; call reset()")
        cp = self.spec.cin_pad
        if mel is not None:
            mel = np.asarray(mel, np.float32)
            if mel.ndim != 3 or mel.shape[0] != self.batch:
                raise ValueError(f"mel must be ({self.batch}, F, D), "
                                 f"got {mel.shape}")
            if self._mel is None:
                # left replicate pad, as offline pad_mel_context does
                pad = np.repeat(mel[:, :1], cp, axis=1)
                self._mel = np.concatenate([pad, mel], axis=1)
            else:
                self._mel = np.concatenate([self._mel, mel], axis=1)
            self._n_raw += mel.shape[1]
        if self._mel is None:
            return np.zeros((self.batch, 0), np.float32)
        # output frame f depends on padded frames [f - extra, f + 2*cin_pad
        # + extra]; emit only frames whose window is fully available
        avail = self._mel.shape[1]
        ready = avail - 2 * cp - self._extra
        return self._emit(max(ready, self._emitted))

    def flush(self) -> np.ndarray:
        """Right-pad the mel tail (replicate) and emit everything left."""
        if self._final:
            return np.zeros((self.batch, 0), np.float32)
        self._final = True
        if self._mel is None:
            return np.zeros((self.batch, 0), np.float32)
        cp = self.spec.cin_pad
        if cp:
            pad = np.repeat(self._mel[:, -1:], cp, axis=1)
            self._mel = np.concatenate([self._mel, pad], axis=1)
        return self._emit(self._n_raw)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _conditioning(self, a: int, b: int) -> torch.Tensor:
        """Exact local conditioning for output frames [a, b).

        Runs the upsample net on the padded-frame window
        [A, B) = [a - extra, b + 2*cin_pad + extra) clamped to the data;
        clamped edges coincide with the true sequence edges, where the
        smoothing convs' zero padding matches the offline computation.
        """
        cp = self.spec.cin_pad
        A = max(0, a - self._extra)
        B_end = min(self._mel.shape[1], b + 2 * cp + self._extra)
        win = torch.as_tensor(self._mel[:, A:B_end], device=self.device)
        if self.spec.upsample_conditional_features:
            # cond frames cover [A, B_end - 2*cp)
            cond = self.model.upsample_conditioning(win)
        else:
            # no upsample net: features repeat to the sample rate
            # (reference: synthesis.py:128-146)
            cond = torch.repeat_interleave(win, self.hop, dim=1)
        lo = (a - A) * self.hop
        return cond[:, lo:lo + (b - a) * self.hop]

    def _emit(self, ready: int) -> np.ndarray:
        a, b = self._emitted, ready
        if b <= a:
            return np.zeros((self.batch, 0), np.float32)
        c_up = self._conditioning(a, b)
        T = (b - a) * self.hop
        if self.engine == "cuda":
            # ring state carried through the fused kernel; the same seed
            # across segments continues the offline sampling sequence
            samples, self._state = self._gen(
                T=T, c_up=c_up, g=self._g, state=self._state,
                return_state=True, log_scale_min=self.cfg.log_scale_min,
                deterministic=self._deterministic, seed=self._seed)
        else:
            from wavenet_vocoder_tpu_torch.ops.generate import generate
            out = generate(self.model, T=T, c_up=c_up, g=self._g,
                           state=self._state, return_state=True,
                           log_scale_min=self.cfg.log_scale_min,
                           deterministic=self._deterministic,
                           generator=self._generator)
            samples, self._state = out["samples"], out["state"]
        self._emitted = b
        return self._decode(samples.cpu().numpy())

    def _decode(self, samples: np.ndarray) -> np.ndarray:
        """Streaming version of synthesis._decode: the inverse-preemphasis
        IIR carries its one-sample state across chunks."""
        cfg = self.cfg
        mu = cfg.quantize_channels - 1
        if cfg.is_mulaw_quantize:
            codes = samples if samples.ndim == 2 else np.argmax(samples, -1)
            wav = np.asarray(inv_mulaw_quantize(codes, mu), np.float64)
        elif cfg.input_type == "mulaw":
            x = samples if samples.ndim == 2 else samples[..., 0]
            wav = np.asarray(inv_mulaw(x, mu), np.float64)
        else:
            wav = (samples if samples.ndim == 2 else samples[..., 0]
                   ).astype(np.float64)
        if cfg.postprocess == "inv_preemphasis":
            from scipy.signal import lfilter
            coef = 0.85  # dsp.audio.inv_preemphasis default (synthesis._decode
            # calls it with defaults; reference: audio.py:57-58)
            rows = []
            for i in range(self.batch):
                y, _ = lfilter([1.0], [1.0, -coef], wav[i],
                               zi=self._preemph_carry[i:i + 1] * coef)
                self._preemph_carry[i] = y[-1]
                rows.append(y)
            wav = np.stack(rows)
        elif cfg.postprocess not in (None, "", "none"):
            raise ValueError(
                f"postprocess {cfg.postprocess!r} is not streamable")
        if cfg.global_gain_scale > 0:
            wav = wav / cfg.global_gain_scale
        return wav.astype(np.float32)
