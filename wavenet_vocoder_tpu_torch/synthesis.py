"""Waveform synthesis: mel -> samples -> inverse transforms.

The port's counterpart of ``wavenet_vocoder_tpu/synthesis.py``
(reference: synthesis.py:42-188). Engines:

  * ``"cuda"`` — the fused generation kernel through
    :class:`ops.cuda_generate.FusedGenerator` (its plain PyTorch version when
    the model lies on the CPU);
  * ``"scan"`` — the eager step-loop decoder (``ops/generate.py``).

Entry points run on ``cuda`` unless the caller passes ``device``; without a
GPU and without ``device`` they raise rather than drop to the CPU.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet
from wavenet_vocoder_tpu_torch.ops.mulaw import inv_mulaw, inv_mulaw_quantize

ENGINES = ("cuda", "scan")


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises if no GPU is present and
    no device was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda")


def _seed_from(generator: Optional[torch.Generator]) -> int:
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                             device=gen.device).item())


def pad_mel_context(c: np.ndarray, cin_pad: int) -> np.ndarray:
    """Replicate-pad mel (B, T_mel, D) by cin_pad frames on both ends
    (reference: evaluate.py:163-164)."""
    if cin_pad <= 0:
        return c
    return np.concatenate([np.repeat(c[:, :1], cin_pad, axis=1), c,
                           np.repeat(c[:, -1:], cin_pad, axis=1)], axis=1)


def _decode(cfg: Config, samples) -> np.ndarray:
    """Head samples -> float waveform (B, T) (reference: synthesis.py:66-86).

    Accepts one-hot (B, T, C) or integer codes (B, T) for the categorical
    head, and (B, T, 1) or (B, T) scalars for the mixture heads."""
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    samples = np.asarray(samples)
    mu = cfg.quantize_channels - 1
    if cfg.is_mulaw_quantize:
        codes = samples if samples.ndim == 2 else np.argmax(samples, axis=-1)
        wav = np.asarray(inv_mulaw_quantize(codes, mu), dtype=np.float64)
    elif cfg.input_type == "mulaw":
        x = samples if samples.ndim == 2 else samples[..., 0]
        wav = np.asarray(inv_mulaw(x, mu))
    else:
        wav = samples if samples.ndim == 2 else samples[..., 0]
    if cfg.postprocess not in (None, "", "none"):
        wav = np.stack([getattr(audio, cfg.postprocess)(w) for w in wav])
    if cfg.global_gain_scale > 0:
        wav = wav / cfg.global_gain_scale
    return wav.astype(np.float32)


class Synthesizer:
    """Pack-once serving wrapper: move the model to the device and pack the
    kernel's weights at construction, then generate per request."""

    def __init__(self, model: WaveNet, cfg: Config, *, engine: str = "cuda",
                 weight_dtype=torch.bfloat16, device=None, **engine_kwargs):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        self.cfg = cfg
        self.engine = engine
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = model.spec
        self._gen = None
        if engine == "cuda":
            from wavenet_vocoder_tpu_torch.ops.cuda_generate import FusedGenerator
            self._gen = FusedGenerator(self.model, weight_dtype=weight_dtype,
                                       **engine_kwargs)
        elif engine_kwargs:
            raise TypeError(f"engine='scan' takes no engine_kwargs, "
                            f"got {sorted(engine_kwargs)}")

    @torch.no_grad()
    def __call__(self, c=None, *,
                 g: Optional[np.ndarray] = None, T: Optional[int] = None,
                 initial_input: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = False,
                 pad_context: bool = True) -> np.ndarray:
        """mel (B, T_mel, D) [without cin_pad context when pad_context]
        -> (B, T) float32 waveforms. The mel is an array or a tensor; a
        tensor already on the synthesizer's device is used where it lies."""
        cfg = self.cfg
        if c is not None:
            if not isinstance(c, torch.Tensor):
                c = np.asarray(c, np.float32)
            c = torch.as_tensor(c, dtype=torch.float32, device=self.device)
            if pad_context and cfg.cin_pad > 0:
                c = torch.cat([c[:, :1].expand(-1, cfg.cin_pad, -1), c,
                               c[:, -1:].expand(-1, cfg.cin_pad, -1)], dim=1)
            if T is None and cfg.upsample_conditional_features:
                T = (c.shape[1] - 2 * cfg.cin_pad) * audio.get_hop_size(cfg)
        if g is not None:
            g = torch.as_tensor(np.asarray(g), device=self.device)
        if self.engine == "cuda":
            samples = self._gen(T=T, c=c, g=g, initial_input=initial_input,
                                log_scale_min=cfg.log_scale_min,
                                deterministic=deterministic,
                                seed=_seed_from(generator))
        else:
            from wavenet_vocoder_tpu_torch.ops.generate import generate
            samples = generate(self.model, T=T, c=c, g=g,
                               initial_input=initial_input,
                               log_scale_min=cfg.log_scale_min,
                               deterministic=deterministic,
                               generator=generator)["samples"]
        return _decode(cfg, samples)


def batch_wavegen(model: WaveNet, cfg: Config, *,
                  c: Optional[np.ndarray] = None,
                  g: Optional[np.ndarray] = None,
                  T: Optional[int] = None,
                  initial_input: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  engine: str = "cuda", device=None,
                  deterministic: bool = False,
                  **engine_kwargs) -> np.ndarray:
    """Generate a batch of waveforms (reference: synthesis.py:42-86).

    c: (B, T_mel, D) mel ALREADY including the cin_pad context frames
    (use :func:`pad_mel_context`); length = (T_mel - 2*cin_pad) * hop.
    Returns (B, T) float32 waveforms.
    """
    synth = Synthesizer(model, cfg, engine=engine, device=device,
                        **engine_kwargs)
    return synth(c, g=g, T=T, initial_input=initial_input,
                 generator=generator, deterministic=deterministic,
                 pad_context=False)


def _initial_input(cfg: Config, spec, initial_value: Optional[float]
                   ) -> Optional[torch.Tensor]:
    """Reference initial-value semantics (synthesis.py:147-161): a mu-law code
    for categorical models, a raw float otherwise; None keeps the default."""
    if initial_value is None:
        return None
    if cfg.is_mulaw_quantize:
        code = int(initial_value)
        if not 0 <= code < cfg.quantize_channels:
            raise ValueError(f"initial mu-law code {code} out of range")
        x = torch.zeros(1, spec.out_channels)
        x[0, code] = 1.0
        return x
    return torch.full((1, 1), float(initial_value))


def wavegen(model: WaveNet, cfg: Config, *, length: Optional[int] = None,
            c: Optional[np.ndarray] = None, g=None,
            initial_value: Optional[float] = None,
            generator: Optional[torch.Generator] = None,
            engine: str = "cuda", device=None,
            deterministic: bool = False) -> np.ndarray:
    """Single-utterance generation (reference: synthesis.py:101-188).

    c: (T_mel, D) mel WITHOUT cin_pad context (added here), or
    sample-resolution features when no upsample net is configured.
    """
    init_in = _initial_input(cfg, model.spec, initial_value)
    g_arr = None if g is None else np.asarray([g])
    c_in = None
    if c is not None:
        c = np.asarray(c, dtype=np.float32)
        if c.ndim != 2:
            raise ValueError(f"c must be (T_mel, D), got {c.shape}")
        if not cfg.upsample_conditional_features:
            # repeat features to sample resolution (reference: synthesis.py:128-146)
            c = np.repeat(c, audio.get_hop_size(cfg), axis=0)
            if length is not None:
                c = c[:length]
            length = c.shape[0]
            c_in = c[None]
        else:
            c_in = pad_mel_context(c[None], cfg.cin_pad)
    elif length is None:
        raise ValueError("length is required without conditioning")
    wav = batch_wavegen(model, cfg, c=c_in, g=g_arr, T=length,
                        initial_input=init_in, generator=generator,
                        engine=engine, device=device,
                        deterministic=deterministic)
    return wav[0]
