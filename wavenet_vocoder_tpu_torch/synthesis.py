"""Waveform synthesis: mel -> samples -> inverse transforms.

The port's counterpart of ``wavenet_vocoder_tpu/synthesis.py``
(reference: synthesis.py:42-188). Engines:

  * ``"cuda"`` — the fused generation kernel through
    :class:`ops.cuda_generate.FusedGenerator` (its plain PyTorch version when
    the model lies on the CPU);
  * ``"scan"`` — the eager step-loop decoder (``ops/generate.py``).

With the fused generator on one device a batch is generated in segments of
``SEGMENT_STEPS`` steps, each carrying the generator's state to the next,
and each segment is fetched and decoded while the card generates the next:
the same launches, and the bits of one call and one decode of the batch.

Entry points run on ``cuda`` unless the caller passes ``device``; without a
GPU and without ``device`` they raise rather than drop to the CPU.

``mesh`` (a ``parallel.Mesh``): utterances are split over its ``data`` axis,
one shard per device, with no communication between them (the JAX
package's utterance sharding). Deterministic outputs equal the unsharded
run's; sampled shard i draws with the base seed + i.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet
from wavenet_vocoder_tpu_torch.ops.mulaw import inv_mulaw, inv_mulaw_codes
from wavenet_vocoder_tpu_torch.utils import profiling

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


# steps of a batch fetched and decoded at a time while the card generates the
# steps after them (rounded up to the generator's chunk)
SEGMENT_STEPS = 4096


def _decode_segment(cfg: Config, samples, zi: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Head samples of columns [a, b) of a batch -> float waveform (B, b - a)
    and the state to pass with columns [b, ...): ``zi`` is the inverse
    pre-emphasis's per-row state that columns [..., a) returned (None at
    a = 0). Segment after segment gives the bits of :func:`_decode` of the
    whole batch. Other postprocess filters carry no state: whole rows only.

    Accepts one-hot (B, T, C) or integer codes (B, T) for the categorical
    head, and (B, T, 1) or (B, T) scalars for the mixture heads, as host
    arrays."""
    samples = np.asarray(samples)
    mu = cfg.quantize_channels - 1
    if cfg.is_mulaw_quantize:
        with profiling.span("synth.inv_mulaw"):
            codes = samples if samples.ndim == 2 else np.argmax(samples, axis=-1)
            wav = inv_mulaw_codes(codes, mu)
    elif cfg.input_type == "mulaw":
        x = samples if samples.ndim == 2 else samples[..., 0]
        wav = np.asarray(inv_mulaw(x, mu))
    else:
        wav = samples if samples.ndim == 2 else samples[..., 0]
    if cfg.postprocess == "inv_preemphasis":
        wav, zi = audio.inv_preemphasis_rows(wav, zi)
    elif cfg.postprocess not in (None, "", "none"):
        wav = np.stack([getattr(audio, cfg.postprocess)(w) for w in wav])
    if cfg.global_gain_scale > 0:
        wav = wav / cfg.global_gain_scale
    return wav.astype(np.float32), zi


def _decode(cfg: Config, samples) -> np.ndarray:
    """Head samples -> float waveform (B, T) (reference: synthesis.py:66-86),
    as :func:`_decode_segment` takes them."""
    return _decode_segment(cfg, samples)[0]


class Synthesizer:
    """Pack-once serving wrapper: move the model to the device and pack the
    kernel's weights at construction, then generate per request."""

    def __init__(self, model: WaveNet, cfg: Config, *, engine: str = "cuda",
                 weight_dtype=torch.bfloat16, device=None, mesh=None,
                 **engine_kwargs):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        self.cfg = cfg
        self.engine = engine
        if mesh is not None and device is None:
            device = mesh.axis_devices("data")[0]
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = model.spec
        self._gen = None
        self._replicas = None
        # the segmented path's side stream and two pinned staging buffers
        self._copier = None
        self._staging = [None, None]
        if engine == "cuda":
            from wavenet_vocoder_tpu_torch.ops.cuda_generate import FusedGenerator
            self._gen = FusedGenerator(self.model, weight_dtype=weight_dtype,
                                       mesh=mesh, **engine_kwargs)
        elif engine_kwargs:
            raise TypeError(f"engine='scan' takes no engine_kwargs, "
                            f"got {sorted(engine_kwargs)}")
        elif mesh is not None:
            import copy
            self._replicas = [
                (d, self.model if d == self.device
                 else copy.deepcopy(self.model).to(d))
                for d in (torch.device(d) for d in mesh.axis_devices("data"))]

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
            seed = _seed_from(generator)
            if self._gen.mesh is None:
                return self._in_segments(c, g, T, initial_input,
                                         deterministic, seed)
            samples = self._gen(T=T, c=c, g=g, initial_input=initial_input,
                                log_scale_min=cfg.log_scale_min,
                                deterministic=deterministic, seed=seed)
        elif self._replicas is None:
            from wavenet_vocoder_tpu_torch.ops.generate import generate
            samples = generate(self.model, T=T, c=c, g=g,
                               initial_input=initial_input,
                               log_scale_min=cfg.log_scale_min,
                               deterministic=deterministic,
                               generator=generator)["samples"]
        else:
            samples = self._scan_sharded(c, g, T, initial_input, generator,
                                         deterministic)
        # the wait for the card and the copy to the host, then the host's
        # decode (the scan engine, and the fused generator over a mesh)
        with profiling.span("synth.fetch"):
            samples = samples.cpu().numpy()
        with profiling.span("synth.decode"):
            return _decode(cfg, samples)

    def _in_segments(self, c, g, T, initial_input, deterministic, seed):
        """The fused generator's batch as consecutive segments of
        ``SEGMENT_STEPS`` steps, each carrying the generator's state to the
        next (the launches, steps and seed of one call). A segment is
        fetched and decoded once the next is queued, so the host decodes
        while the card generates; the result has the bits of one call and
        one :func:`_decode`. Counters ``synth.segments`` and
        ``synth.overlapped_segments`` (those decoded while a later segment
        was queued)."""
        cfg, gen = self.cfg, self._gen
        with profiling.span("generate.condition"):
            c_up = self.model.upsample_conditioning(c)
        if c_up is not None:
            T = c_up.shape[1] if T is None else T
            if c_up.shape[1] != T:
                raise ValueError(f"conditioning covers {c_up.shape[1]} "
                                 f"samples, T is {T}")
        if T is None:
            raise ValueError("T required without conditioning")
        chunk = gen.chunk
        T_pad = -(-T // chunk) * chunk
        if c_up is not None and T_pad != T:
            # the last frame repeated to whole chunks, as one call pads it
            c_up = torch.cat(
                [c_up, c_up[:, -1:].expand(-1, T_pad - T, -1)], dim=1)
        # the other postprocess filters carry no state: one segment
        seg = (-(-SEGMENT_STEPS // chunk) * chunk
               if cfg.postprocess in (None, "", "none", "inv_preemphasis")
               else T_pad)
        state, zi, wav, queued = None, None, None, None
        for k, a in enumerate(range(0, T_pad, seg)):
            out, state = gen(T=min(seg, T_pad - a), g=g,
                             c_up=None if c_up is None else c_up[:, a:a + seg],
                             initial_input=initial_input, state=state,
                             return_state=True, deterministic=deterministic,
                             seed=seed)
            launched = None
            if out.device.type == "cuda":
                launched = torch.cuda.Event()
                launched.record(torch.cuda.current_stream(out.device))
            if wav is None:
                wav = np.empty((out.shape[0], T), np.float32)
                self._stage(out, seg)
            if queued is not None:
                zi = self._fetch_and_decode(wav, zi, *queued)
                profiling.count("synth.overlapped_segments")
            queued = (k, a, out, launched)
        self._fetch_and_decode(wav, zi, *queued)
        return wav

    def _stage(self, out, seg: int) -> None:
        """On the card, the side stream and the two pinned staging buffers
        of one segment of ``seg`` steps like ``out``: made on a first use,
        grown with B, reused across calls."""
        if out.device.type != "cuda":
            return
        if self._copier is None:
            self._copier = torch.cuda.Stream(device=out.device)
        need = out.shape[0] * seg * out.element_size()
        self._staging = [
            buf if buf is not None and buf.numel() >= need else
            torch.empty(need, dtype=torch.uint8, pin_memory=True)
            for buf in self._staging]

    def _fetch_and_decode(self, wav, zi, k, a, out, launched):
        """Segment k, ``out`` (columns [a, ...) of ``wav``), to the host and
        decoded into ``wav``, the inverse pre-emphasis continuing from
        ``zi``; returns the state after it. On the card the copy runs on the
        side stream once the event ``launched`` (after the segment's
        launches) has passed, into staging buffer k % 2."""
        with profiling.span("synth.fetch"):
            if launched is None:
                samples = out.numpy()
            else:
                buf = self._staging[k % 2]
                host = buf[:out.numel() * out.element_size()].view(
                    out.dtype).view(out.shape)
                with torch.cuda.stream(self._copier):
                    self._copier.wait_event(launched)
                    host.copy_(out, non_blocking=True)
                self._copier.synchronize()
                samples = host.numpy()
        with profiling.span("synth.decode"):
            part, zi = _decode_segment(self.cfg,
                                       samples[:, :wav.shape[1] - a], zi)
        wav[:, a:a + part.shape[1]] = part
        profiling.count("synth.segments")
        return zi

    def _scan_sharded(self, c, g, T, initial_input, generator,
                      deterministic):
        """The eager decoder on each shard's device in turn; shard i samples
        from a generator seeded with the base seed + i."""
        from wavenet_vocoder_tpu_torch.ops.generate import generate
        n = len(self._replicas)
        B = next((a.shape[0] for a in (c, g, initial_input) if a is not None),
                 1)
        if B % n:
            raise ValueError(f"batch {B} not divisible by the mesh's data "
                             f"axis ({n}); pad the utterance batch")
        seed, Bs = _seed_from(generator), B // n
        outs = []
        for i, (d, model) in enumerate(self._replicas):
            part = lambda a: None if a is None else torch.as_tensor(
                a)[i * Bs:(i + 1) * Bs].to(d)
            gen = torch.Generator(device=d).manual_seed(seed + i)
            outs.append(generate(model, T=T, c=part(c), g=part(g),
                                 initial_input=part(initial_input),
                                 log_scale_min=self.cfg.log_scale_min,
                                 deterministic=deterministic,
                                 generator=gen)["samples"].to(self.device))
        return torch.cat(outs)


def batch_wavegen(model: WaveNet, cfg: Config, *,
                  c: Optional[np.ndarray] = None,
                  g: Optional[np.ndarray] = None,
                  T: Optional[int] = None,
                  initial_input: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  engine: str = "cuda", device=None,
                  deterministic: bool = False, mesh=None,
                  **engine_kwargs) -> np.ndarray:
    """Generate a batch of waveforms (reference: synthesis.py:42-86).

    c: (B, T_mel, D) mel ALREADY including the cin_pad context frames
    (use :func:`pad_mel_context`); length = (T_mel - 2*cin_pad) * hop.
    mesh: utterances split over its ``data`` axis (B must divide).
    Returns (B, T) float32 waveforms.
    """
    synth = Synthesizer(model, cfg, engine=engine, device=device, mesh=mesh,
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
