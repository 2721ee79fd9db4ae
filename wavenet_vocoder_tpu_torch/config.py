"""Configuration system: a frozen dataclass replacing the reference's
process-global mutable HParams singleton (reference: hparams.py:8-127,
wavenet_vocoder/tfcompat/hparam.py).

A copy of ``wavenet_vocoder_tpu/config.py`` for the PyTorch port: the port
imports nothing of the JAX package, so it keeps its own Config. The key set,
defaults and override syntax are identical, so one preset JSON drives both.

Design notes:
  * Config is an immutable value passed explicitly to every function.
  * The key set deliberately mirrors the reference's ``hparams.py`` so that a
    user of the reference can bring their preset JSON files unchanged
    (reference: hparams.py:8-127).
  * Overrides are layered exactly like the reference CLIs do
    (reference: train.py:1052-1057): defaults -> ``--preset`` JSON ->
    ``--hparams "k=v,..."`` comma DSL (reference: tfcompat/hparam.py:36-43).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def _default_upsample_params() -> Dict[str, Any]:
    return {"upsample_scales": [4, 4, 4, 4]}


def _default_optimizer_params() -> Dict[str, Any]:
    return {"lr": 1e-3, "eps": 1e-8, "weight_decay": 0.0}


def _default_lr_schedule_kwargs() -> Dict[str, Any]:
    return {"anneal_rate": 0.5, "anneal_interval": 200000}


@dataclass(frozen=True)
class Config:
    """Full configuration. Field names/defaults mirror reference hparams.py:8-127."""

    name: str = "wavenet_vocoder"

    # -- Input representation (reference: hparams.py:20-21) --
    # raw [-1,1] | mulaw [-1,1] | mulaw-quantize [0, mu]
    input_type: str = "raw"
    quantize_channels: int = 65536

    # -- Audio / DSP (reference: hparams.py:27-47) --
    preprocess: str = ""
    postprocess: str = ""
    global_gain_scale: float = 1.0
    sample_rate: int = 22050
    silence_threshold: int = 2
    num_mels: int = 80
    fmin: int = 125
    fmax: int = 7600
    fft_size: int = 1024
    hop_size: int = 256
    frame_shift_ms: Optional[float] = None
    win_length: int = 1024
    win_length_ms: float = -1.0
    window: str = "hann"
    highpass_cutoff: float = 70.0

    # -- Output distribution for scalar input (reference: hparams.py:51-52) --
    output_distribution: str = "Logistic"  # Logistic | Normal
    log_scale_min: float = -16.0

    # -- Model architecture (reference: hparams.py:58-76) --
    out_channels: int = 10 * 3
    layers: int = 24
    stacks: int = 4
    residual_channels: int = 128
    gate_channels: int = 256
    skip_out_channels: int = 128
    dropout: float = 0.0
    kernel_size: int = 3

    # Local conditioning (negative disables)
    cin_channels: int = 80
    cin_pad: int = 2
    upsample_conditional_features: bool = True
    upsample_net: str = "ConvInUpsampleNetwork"
    upsample_params: Dict[str, Any] = field(default_factory=_default_upsample_params)

    # Global conditioning (negative disables)
    gin_channels: int = -1
    n_speakers: int = 7
    use_speaker_embedding: bool = True

    # -- Data loader (reference: hparams.py:85-86) --
    # pin_memory: batches go to the card from pinned host memory
    # (data/prefetch.py); the JAX package accepts and ignores it.
    pin_memory: bool = True
    num_workers: int = 2

    # -- Training (reference: hparams.py:91-124) --
    batch_size: int = 8
    optimizer: str = "Adam"
    optimizer_params: Dict[str, Any] = field(default_factory=_default_optimizer_params)
    lr_schedule: str = "step_learning_rate_decay"
    lr_schedule_kwargs: Dict[str, Any] = field(default_factory=_default_lr_schedule_kwargs)
    max_train_steps: int = 1000000
    nepochs: int = 2000
    clip_thresh: float = -1
    max_time_sec: Optional[float] = None
    max_time_steps: Optional[int] = 10240
    exponential_moving_average: bool = True
    ema_decay: float = 0.9999
    checkpoint_interval: int = 100000
    train_eval_interval: int = 100000
    test_eval_epoch_interval: int = 50
    save_optimizer_state: bool = True

    # -- Additions of the JAX package (no reference equivalent); one
    # preset JSON loads in both packages. remat/remat_policy: recompute
    # each block of the plain layer loop in the backward ("dots" keeps the
    # products' outputs). --
    compute_dtype: str = "bfloat16"
    remat: bool = False
    fused_train: bool = False
    remat_policy: str = ""
    # Mesh shape spec for training, e.g. {"data": -1} (fill all devices).
    mesh_axes: Dict[str, int] = field(default_factory=lambda: {"data": -1})
    # Random seed for param init / data shuffling.
    seed: int = 1234

    # ------------------------------------------------------------------
    # Derived properties
    # ------------------------------------------------------------------
    @property
    def is_mulaw_quantize(self) -> bool:
        return is_mulaw_quantize(self.input_type)

    @property
    def is_scalar_input(self) -> bool:
        return is_scalar_input(self.input_type)

    @property
    def upsample_scales(self) -> Tuple[int, ...]:
        return tuple(self.upsample_params.get("upsample_scales", []))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def values(self) -> Dict[str, Any]:
        """Plain-dict dump (reference: hparam.py:609-620, tojson.py:26)."""
        return dataclasses.asdict(self)

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.values(), **json_kw)

    # ------------------------------------------------------------------
    # Layered override construction
    # ------------------------------------------------------------------
    def override_from_dict(self, d: Dict[str, Any]) -> "Config":
        """Typed override (reference: hparam.py:546-563). Unknown keys error."""
        known = {f.name: f for f in dataclasses.fields(self)}
        out: Dict[str, Any] = {}
        for k, v in d.items():
            if k not in known:
                raise ValueError(f"Unknown config key: {k!r}")
            out[k] = _coerce(k, v, getattr(self, k))
        return self.replace(**out)

    def parse_json(self, json_text: str) -> "Config":
        """Override from a JSON preset (reference: hparam.py:573-589)."""
        return self.override_from_dict(json.loads(json_text))

    def parse(self, spec: str) -> "Config":
        """Override from the ``k=v,k2=[1,2]`` comma DSL
        (reference: hparam.py:36-43, 523-544)."""
        if not spec:
            return self
        return self.override_from_dict(parse_values(spec))


# ----------------------------------------------------------------------
# Input-type predicates (reference: wavenet_vocoder/util.py:5-25)
# ----------------------------------------------------------------------
_VALID_INPUT_TYPES = ("raw", "mulaw", "mulaw-quantize")


def _check_input_type(s: str) -> None:
    if s not in _VALID_INPUT_TYPES:
        raise ValueError(f"input_type must be one of {_VALID_INPUT_TYPES}, got {s!r}")


def is_mulaw_quantize(s: str) -> bool:
    _check_input_type(s)
    return s == "mulaw-quantize"


def is_mulaw(s: str) -> bool:
    _check_input_type(s)
    return s == "mulaw"


def is_raw(s: str) -> bool:
    _check_input_type(s)
    return s == "raw"


def is_scalar_input(s: str) -> bool:
    return is_raw(s) or is_mulaw(s)


# ----------------------------------------------------------------------
# "k=v,..." DSL parser (reference: tfcompat/hparam.py:36-43, 523-544)
# ----------------------------------------------------------------------
# Grammar: assignments separated by commas; values may be scalars, quoted
# strings, [lists] or {dicts}; commas inside brackets/braces don't split.
_ASSIGN_RE = re.compile(
    r"""
    \s*(?P<name>[a-zA-Z_]\w*)\s*=\s*
    (?P<value>
        \{[^\}]*\}          # dict literal
      | \[[^\]]*\]          # list literal
      | "(?:[^"\\]|\\.)*"   # double-quoted string
      | '(?:[^'\\]|\\.)*'   # single-quoted string
      | [^,]*               # bare scalar
    )
    \s*(?:,|$)
    """,
    re.VERBOSE,
)


def parse_values(spec: str) -> Dict[str, Any]:
    pos = 0
    out: Dict[str, Any] = {}
    while pos < len(spec):
        m = _ASSIGN_RE.match(spec, pos)
        if m is None or m.start() != pos:
            raise ValueError(f"Malformed hparams string at: {spec[pos:]!r}")
        name, raw = m.group("name"), m.group("value").strip()
        out[name] = _parse_scalar(raw)
        pos = m.end()
    return out


def _parse_scalar(raw: str) -> Any:
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw  # bare string


def _coerce(key: str, value: Any, current: Any) -> Any:
    """Type-check/coerce an override against the current value
    (reference: hparam.py:142-205 type enforcement)."""
    if value is None or current is None:
        return value
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() in ("true", "1")
        return bool(value)
    if isinstance(current, int) and not isinstance(current, bool):
        if isinstance(value, float) and not value.is_integer():
            raise ValueError(f"Config key {key!r} expects int, got {value!r}")
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, str):
        if not isinstance(value, str):
            raise ValueError(f"Config key {key!r} expects str, got {value!r}")
        return value
    if isinstance(current, dict):
        if not isinstance(value, dict):
            raise ValueError(f"Config key {key!r} expects dict, got {value!r}")
        merged = dict(current)
        merged.update(value)
        return merged
    return value


# ----------------------------------------------------------------------
# CLI-facing helpers
# ----------------------------------------------------------------------
def load_config(preset: Optional[str] = None, overrides: str = "",
                base: Optional[Config] = None) -> Config:
    """defaults -> preset JSON file -> 'k=v' overrides
    (reference: train.py:1052-1057)."""
    cfg = base or Config()
    if preset:
        with open(preset) as f:
            cfg = cfg.parse_json(f.read())
    cfg = cfg.parse(overrides)
    if cfg.name != "wavenet_vocoder":
        raise ValueError(
            f"config name must be 'wavenet_vocoder', got {cfg.name!r} "
            "(reference: train.py:1058)")
    _check_input_type(cfg.input_type)
    return cfg


def discover_preset(checkpoint_path: str,
                    preset: Optional[str] = None) -> Optional[str]:
    """When no preset is given, look for ``hparams.json`` next to the
    checkpoint — the reference dumps its effective config there at train time
    and auto-reloads it at eval (reference: train.py:1065-1067,
    evaluate.py:120-124)."""
    if preset is not None:
        return preset
    cand = os.path.join(os.path.dirname(os.path.abspath(checkpoint_path)),
                        "hparams.json")
    return cand if os.path.exists(cand) else None


def config_debug_string(cfg: Config) -> str:
    """Pretty dump (reference: hparams.py:130-133)."""
    values = cfg.values()
    lines = ["  %s: %s" % (k, values[k]) for k in sorted(values)]
    return "Hyperparameters:\n" + "\n".join(lines)
