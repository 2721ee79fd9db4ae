"""Benchmark of the port on one card: batched synthesis, training, streaming.

The port's counterpart of the repository's root ``bench.py`` (the JAX
package's bench), with the same ``BENCH_*`` variables, modes and JSON
records (the same ``metric`` names and ``detail`` keys):

    python -m wavenet_vocoder_tpu_torch.bench                    # synthesis
    BENCH_MODE=train python -m wavenet_vocoder_tpu_torch.bench   # training
    BENCH_MODE=latency python -m wavenet_vocoder_tpu_torch.bench # streaming

Synthesis (the default): generated audio-seconds per wall-second for
``BENCH_MODEL`` in {flagship, 30L3S, 512ch} with random weights from seed 0,
B=``BENCH_BATCH`` (256) and ``BENCH_RT_BATCH`` (128) utterances of
``BENCH_SECONDS`` (1) s, through ``FusedGenerator`` (bf16 pack, sampling;
``BENCH_ENGINE=scan``: the eager decoder); the compact flagship train record
(``BENCH_TRAIN_BATCH``, 64) rides along unless ``BENCH_TRAIN=0``.
Train: samples/s of ``Config(fused_train=True)`` at ``BENCH_BATCH`` (32),
crop 10240, with MFU against the card's bf16 peak from the analytic count
(``utils/flops.py``); ``BENCH_PIPELINE=1`` feeds it from the port's
``DataLoader`` and ``prefetch_to_device`` off a synthetic dump.
Latency: first-audio latency and per-stream real-time factor of
``StreamingSynthesizer(engine="cuda")`` at B=1, 4-frame segments.

Every record names the card and its power limit. Without a card the bench
raises, unless ``BENCH_DEVICE=cpu``: then it runs the same control flow on
the CPU (at whatever sizes the variables ask for) and prints every timing
field as null, with ``"device": "cpu"``.

The TPU options of the JAX bench that have no counterpart here
(``BENCH_VARIANT`` or ``BENCH_SPLIT_TAPS`` other than the fused kernel,
``BENCH_UNROLL``, ``BENCH_VMEM_MB``) raise. ``BENCH_REMAT`` and
``BENCH_REMAT_POLICY`` go to ``Config(remat=, remat_policy=)`` as in the
JAX bench: recomputation in the backward of the plain layer loop
(``BENCH_FUSED=0``); the fused kernels ignore it.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
from wavenet_vocoder_tpu_torch.utils import flops as flops_lib
from wavenet_vocoder_tpu_torch.utils.profiling import power_limit, sync

# BENCH_MODEL: the published big configs beside the flagship (reference
# docs/content/index.md:126-128, tests/test_misc.py:9)
MODELS = {
    "flagship": {},
    "30L3S": {"layers": 30, "stacks": 3},
    "512ch": {"residual_channels": 512, "gate_channels": 512,
              "skip_out_channels": 256},
}
MODEL_NAMES = {"flagship": "24L/4S MoL 128/256/128",
               "30L3S": "30L/3S MoL 128/256/128 (rf 6139)",
               "512ch": "24L/4S MoL 512/512/256"}
# reference wall-clock anchor: ~1.26 steps/s at 8 x 10240 samples on GPU
# (docs/content/index.md "100k steps (~22 hours)")
REFERENCE_TRAIN_SAMPLES_PER_S = 1.26 * 8 * 10240
# The JAX bench's TPU options: (variable, the values that select what the
# port has, why the port has nothing else)
UNPORTED = (
    ("BENCH_VARIANT", ("", "fused"), "the port has one generation kernel, "
     "the fused one (csrc/generate.cu); the TPU kernel's variants are VMEM "
     "layouts"),
    ("BENCH_SPLIT_TAPS", ("", "0"), "split_taps is a variant of the TPU "
     "kernel; the port has the fused kernel only"),
    ("BENCH_UNROLL", ("", "1"), "unrolling the TPU kernel's layer loop has "
     "no counterpart in csrc/generate.cu"),
    ("BENCH_VMEM_MB", ("",), "the scoped-VMEM limit is a TPU compiler "
     "setting"),
)


def _config(**over) -> Config:
    """The Config every mode builds on (tests shrink it here)."""
    return Config(**over)


def _env(name: str, default):
    raw = os.environ.get(name, "")
    return type(default)(raw) if raw != "" else default


def refuse_unported() -> None:
    """Raise for a TPU option of the JAX bench that the port lacks."""
    for name, ported, why in UNPORTED:
        value = os.environ.get(name, "")
        if value not in ported:
            raise NotImplementedError(f"{name}={value!r}: {why}")


def bench_device() -> torch.device:
    """The card, or the CPU when ``BENCH_DEVICE=cpu``; raises without a
    card otherwise."""
    want = os.environ.get("BENCH_DEVICE", "")
    if want == "cpu":
        return torch.device("cpu")
    if want not in ("", "cuda"):
        raise ValueError(f"BENCH_DEVICE={want!r}: 'cuda' (default) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench measures the card "
                           "(BENCH_DEVICE=cpu runs its control flow on the "
                           "CPU, with no timings)")
    return torch.device("cuda")


class _Clock:
    """Rounds a measured number on the card; None (no timing) on the CPU."""

    def __init__(self, device: torch.device):
        self.timed = device.type == "cuda"

    def __call__(self, value, digits: int):
        return round(value, digits) if self.timed else None


def _device_fields(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": power_limit()}


def _make_synthetic_dump(root, cfg, n_utts=48, seed=0):
    """On-disk dump dir (the *-wave.npy / *-feats.npy glob layout) so the
    pipeline bench exercises the REAL DataLoader: npy read, length-bucket
    sampling, hop-aligned crop, collate, prefetch. The JAX bench's dump,
    byte for byte."""
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    hop = cfg.hop_size
    min_samples = cfg.max_time_steps + 2 * cfg.cin_pad * hop
    for i in range(n_utts):
        frames = (min_samples // hop) + 2 + rs.randint(0, 20)
        T = frames * hop
        wave = rs.uniform(-0.5, 0.5, T).astype(np.float32)
        feats = rs.randn(frames, cfg.num_mels).astype(np.float32)
        np.save(os.path.join(root, f"synth{i:04d}-wave.npy"), wave)
        np.save(os.path.join(root, f"synth{i:04d}-feats.npy"), feats)
    return root


def train_batch(cfg: Config, B: int) -> dict:
    """The JAX bench's constant training batch, numpy from seed 0."""
    T = cfg.max_time_steps
    frames = T // cfg.hop_size + 2 * cfg.cin_pad
    rs = np.random.RandomState(0)
    x = rs.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    return {"x": x, "y": x.copy(),
            "c": rs.randn(B, frames, cfg.num_mels).astype(np.float32),
            "input_lengths": np.full(B, T, np.int32)}


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _timed_blocks(step, n_blocks: int, n_iters: int):
    """n_blocks blocks of n_iters steps, each ended by a synchronise; the
    seconds per step of each block and the last step's metrics."""
    times, m = [], None
    for _ in range(n_blocks):
        sync()
        t0 = time.perf_counter()
        for _ in range(n_iters):
            m = step()
        sync(m["loss"])
        times.append((time.perf_counter() - t0) / n_iters)
    return times, m


def bench_train(device: torch.device) -> dict:
    """BENCH_MODE=train: training samples/s on the flagship MoL config, with
    model FLOPs and MFU. BENCH_PIPELINE=1 feeds the step from the port's
    DataLoader (threaded collate) through prefetch_to_device off an on-disk
    synthetic dump, so host-side input cost is measured, not hidden."""
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    clock = _Clock(device)
    pipeline = bool(_env("BENCH_PIPELINE", 0))
    B = _env("BENCH_BATCH", 32)
    fused = bool(_env("BENCH_FUSED", 1))
    cfg = _config(remat=bool(_env("BENCH_REMAT", 0)),
                  remat_policy=os.environ.get("BENCH_REMAT_POLICY", ""),
                  fused_train=fused, dropout=_env("BENCH_DROPOUT", 0.0),
                  batch_size=B, num_workers=4)
    T = cfg.max_time_steps
    batch = _on(train_batch(cfg, B), device)
    state = create_train_state(cfg, device=device)
    train_step, _ = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    m = train_step(state, batch, gen)              # warm-up
    loss = float(m["loss"])

    spec = spec_from_config(cfg)
    # nothing sees inside the ctypes kernels: the analytic fwd+bwd count
    step_flops = flops_lib.train_flops_per_sample(spec) * B * T
    flops_src = "analytic_3x_forward"
    peak = None
    if clock.timed:
        peak = flops_lib.device_peak_flops(device)
        if os.environ.get("BENCH_PEAK_TFLOPS"):
            peak = float(os.environ["BENCH_PEAK_TFLOPS"]) * 1e12

    n_iters = _env("BENCH_ITERS", 10)
    n_blocks = _env("BENCH_BLOCKS", 3)
    if pipeline:
        from wavenet_vocoder_tpu_torch.data import DataLoader, WaveNetDataset
        from wavenet_vocoder_tpu_torch.data.prefetch import prefetch_to_device
        root = os.environ.get("BENCH_DATA_DIR") or os.path.join(
            tempfile.gettempdir(), f"wn_bench_dump_b{cfg.num_mels}")
        if not os.path.exists(os.path.join(root, "synth0000-wave.npy")):
            _make_synthetic_dump(root, cfg)
        ds = WaveNetDataset(root, cfg)
        loader = DataLoader(ds, cfg, batch_size=B, num_workers=4)

        def batches():
            # cycle epochs so n_iters isn't bounded by the synthetic corpus
            while True:
                yield from loader

        it = prefetch_to_device(batches(), depth=2, device=device)
        m = train_step(state, next(it), gen)       # warm the pipeline path
        sync(m["loss"])
        times, m = _timed_blocks(lambda: train_step(state, next(it), gen),
                                 n_blocks, n_iters)
    else:
        times, m = _timed_blocks(lambda: train_step(state, batch, gen),
                                 n_blocks, n_iters)
    loss = float(m["loss"])
    dt = float(np.median(times))
    value = B * T / dt
    achieved = step_flops / dt
    record = {
        "metric": "training_samples_per_sec_per_chip",
        "value": clock(value, 1),
        "unit": "samples/s/chip",
        "vs_baseline": clock(value / REFERENCE_TRAIN_SAMPLES_PER_S, 4),
        "detail": {"batch": B, "crop": T, "step_s": clock(dt, 4),
                   "step_s_min": clock(min(times), 4),
                   "step_s_max": clock(max(times), 4),
                   "blocks": n_blocks, "iters_per_block": n_iters,
                   "steps_per_s": clock(1.0 / dt, 2), "loss": round(loss, 3),
                   "pipeline": "real_dataloader" if pipeline
                   else "constant_batch",
                   "step_tflops": round(step_flops / 1e12, 3),
                   "flops_source": flops_src,
                   "achieved_tflops_per_s": clock(achieved / 1e12, 2),
                   "mfu": clock(achieved / peak, 4) if peak else None,
                   "peak_tflops": round(peak / 1e12) if peak else None,
                   # XLA's bytes-accessed count has no counterpart here
                   "step_gbytes": None, "hbm_floor_s": None,
                   "hbm_bound_frac": None,
                   **_device_fields(device)},
    }
    print(json.dumps(record), flush=True)
    return record


def measure_train_compact(device: torch.device) -> dict:
    """A few timed fused-train steps of the flagship at B=BENCH_TRAIN_BATCH
    (64) for the default bench record: training samples/s and MFU ride
    along with the synthesis headline."""
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    clock = _Clock(device)
    B = _env("BENCH_TRAIN_BATCH", 64)
    cfg = _config(fused_train=True, batch_size=B)
    T = cfg.max_time_steps
    batch = _on(train_batch(cfg, B), device)
    state = create_train_state(cfg, device=device)
    train_step, _ = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    m = train_step(state, batch, gen)              # warm-up
    loss = float(m["loss"])
    n_iters = _env("BENCH_TRAIN_ITERS", 5)
    n_blocks = _env("BENCH_TRAIN_BLOCKS", 3)
    times, m = _timed_blocks(lambda: train_step(state, batch, gen), n_blocks,
                             n_iters)
    loss = float(m["loss"])
    dt = float(np.median(times))
    step_flops = flops_lib.train_flops_per_sample(spec_from_config(cfg)) * B * T
    peak = flops_lib.device_peak_flops(device) if clock.timed else None
    return {
        "metric": "training_samples_per_sec_per_chip",
        "value": clock(B * T / dt, 1),
        "vs_baseline": clock(B * T / dt / REFERENCE_TRAIN_SAMPLES_PER_S, 2),
        "batch": B, "crop": T, "step_s": clock(dt, 4),
        "step_s_min": clock(min(times), 4),
        "step_s_max": clock(max(times), 4),
        "blocks": n_blocks, "iters_per_block": n_iters,
        "loss": round(loss, 3),
        "mfu": clock(step_flops / dt / peak, 4) if peak else None,
        "path": "fused_cuda",
    }


def bench_latency(device: torch.device) -> dict:
    """BENCH_MODE=latency: small-batch streaming numbers on the generation
    kernel — first-audio latency and steady-state per-stream real-time
    factor. Knobs: BENCH_BATCH (streams, 1), BENCH_SEG_FRAMES (mel frames
    fed per call, 4 = 1024 samples), BENCH_SECONDS (2)."""
    from wavenet_vocoder_tpu_torch.streaming import StreamingSynthesizer
    clock = _Clock(device)
    cfg = _config()
    model = WaveNet(spec_from_config(cfg),
                    generator=torch.Generator().manual_seed(0))
    B = _env("BENCH_BATCH", 1)
    seg_frames = _env("BENCH_SEG_FRAMES", 4)
    seconds = _env("BENCH_SECONDS", 2.0)
    hop = cfg.hop_size
    frames = int(seconds * cfg.sample_rate) // hop
    rs = np.random.RandomState(0)
    mel = rs.randn(B, frames, cfg.num_mels).astype(np.float32)

    stream = StreamingSynthesizer(model, cfg,
                                  generator=torch.Generator().manual_seed(1),
                                  batch=B, engine="cuda", device=device)
    print("# latency bench: weights packed", file=sys.stderr)

    def run_stream():
        stream.reset()
        t0 = time.perf_counter()
        t_first = None
        n = 0
        for i in range(0, frames, seg_frames):
            out = stream.feed(mel[:, i:i + seg_frames])   # host copy: waits
            n += out.shape[1]
            if t_first is None and n > 0:
                t_first = time.perf_counter() - t0
        n += stream.flush().shape[1]
        return t_first, time.perf_counter() - t0, n

    run_stream()  # warm-up: both segment shapes (feed + flush)
    print("# latency bench: warmed up; measuring", file=sys.stderr)
    t_first, wall, n = run_stream()
    audio_s = n / cfg.sample_rate
    per_stream_rt = audio_s / wall
    record = {
        "metric": "streaming_latency_per_stream_realtime_x",
        "value": clock(per_stream_rt, 3),
        "unit": "x realtime per stream",
        "vs_baseline": clock(per_stream_rt / 1.0, 3),
        "detail": {
            "streams": B,
            "first_audio_latency_ms": clock(t_first * 1e3, 1),
            "algorithmic_latency_ms": round(
                (cfg.cin_pad + len(cfg.upsample_params["upsample_scales"]))
                * hop / cfg.sample_rate * 1e3, 1),
            "segment_samples": seg_frames * hop,
            "total_audio_s": round(audio_s, 2),
            "wall_s": clock(wall, 3),
            "aggregate_audio_sec_per_s": clock(B * per_stream_rt, 2),
            "model": MODEL_NAMES["flagship"],
            "engine": "cuda+carry",
            **_device_fields(device),
        },
    }
    print(json.dumps(record), flush=True)
    return record


def bench_synthesis(device: torch.device) -> dict:
    """The default mode: batched sampling throughput of BENCH_MODEL."""
    from wavenet_vocoder_tpu_torch.synthesis import pad_mel_context
    clock = _Clock(device)
    model_name = os.environ.get("BENCH_MODEL", "flagship")
    if model_name not in MODELS:
        raise ValueError(f"BENCH_MODEL={model_name!r}: one of {list(MODELS)}")
    cfg = _config(**MODELS[model_name])
    model = WaveNet(spec_from_config(cfg),
                    generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()

    B = _env("BENCH_BATCH", 256)
    # second measurement: a batch that keeps each stream above real time
    # (0 disables)
    B_rt = _env("BENCH_RT_BATCH", 128)
    seconds = _env("BENCH_SECONDS", 1.0)
    hop = cfg.hop_size
    frames = int(seconds * cfg.sample_rate) // hop
    T = frames * hop

    rs = np.random.RandomState(0)
    mel = rs.randn(B, frames, cfg.num_mels).astype(np.float32)
    c = torch.as_tensor(pad_mel_context(mel, cfg.cin_pad), device=device)

    engine = os.environ.get("BENCH_ENGINE", "cuda")
    if engine == "cuda":
        from wavenet_vocoder_tpu_torch.ops.cuda_generate import (
            DEFAULT_CHUNK, FusedGenerator)
        chunk = _env("BENCH_CHUNK", DEFAULT_CHUNK)
        mesh = None
        if _env("BENCH_MESH", 0):
            # the utterances split over all local cards (one card: the
            # wrapper's overhead only)
            from wavenet_vocoder_tpu_torch.parallel import make_mesh
            mesh = make_mesh({"data": -1})
        gen = FusedGenerator(model, weight_dtype=torch.bfloat16, chunk=chunk,
                             mesh=mesh)           # pack weights ONCE
        print(f"# cuda engine: bf16 pack, chunk {chunk} (B={B})",
              file=sys.stderr)

        def run(seed, c_arr):
            # the copy to the host waits for the device
            return gen(c=c_arr, seed=seed).cpu().numpy()
    elif engine == "scan":
        from wavenet_vocoder_tpu_torch.ops.generate import generate

        def run(seed, c_arr):
            g = torch.Generator(device=device).manual_seed(seed)
            out = generate(model, c=c_arr, generator=g,
                           log_scale_min=cfg.log_scale_min)
            return out["samples"].cpu().numpy()
    else:
        raise ValueError(f"BENCH_ENGINE={engine!r}: 'cuda' or 'scan'")

    n_iters = _env("BENCH_ITERS", 3)

    def measure(c_arr):
        """Per-iter wall times (each run ends in a host copy, so every iter
        is a real sync): the median is the headline, min/max the spread."""
        run(0, c_arr)  # warm-up
        ts = []
        for i in range(n_iters):
            t0 = time.perf_counter()
            s = run(i + 1, c_arr)
            ts.append(time.perf_counter() - t0)
        if not (np.isfinite(s).all() and s.std() > 0.01):
            raise RuntimeError(f"degenerate output: std {s.std()}")
        return ts

    times = measure(c)
    dt = float(np.median(times))
    value = B * T / cfg.sample_rate / dt

    rt_detail = None
    if B_rt and B_rt != B:
        mel_rt = (mel[:B_rt] if B_rt <= B else
                  rs.randn(B_rt, frames, cfg.num_mels).astype(np.float32))
        c_rt = torch.as_tensor(pad_mel_context(mel_rt, cfg.cin_pad),
                               device=device)
        times_rt = measure(c_rt)
        dt_rt = float(np.median(times_rt))
        rt_detail = {
            "batch": B_rt,
            "audio_sec_per_sec": clock(B_rt * T / cfg.sample_rate / dt_rt, 2),
            "per_stream_realtime_x": clock(T / cfg.sample_rate / dt_rt, 2),
            "wall_s_min": clock(min(times_rt), 3),
            "wall_s_max": clock(max(times_rt), 3),
        }
    train_detail = None
    if _env("BENCH_TRAIN", 1):
        # the compact train record rides along; a failure there is reported
        # in the record and does not lose the synthesis metric
        try:
            train_detail = measure_train_compact(device)
        except Exception as e:  # noqa: BLE001 - reported in the record
            traceback.print_exc()
            train_detail = {"error": f"{type(e).__name__}: {e}"}
    record = {
        "metric": "batched_synthesis_audio_sec_per_sec_per_chip",
        "value": clock(value, 4),
        "unit": "audio-sec/s/chip",
        "vs_baseline": clock(value / 1.0, 4),    # 1x real time per chip
        "detail": {
            "batch": B, "samples_per_utt": T,
            "samples_per_sec": clock(B * T / dt, 1),
            "per_stream_realtime_x": clock(T / cfg.sample_rate / dt, 2),
            "per_stream_realtime_x_best": clock(
                T / cfg.sample_rate / min(times), 3),
            "wall_s_per_iter": clock(dt, 3),
            "wall_s_min": clock(min(times), 3),
            "wall_s_max": clock(max(times), 3),
            "iters": n_iters,
            "realtime_batch": rt_detail,
            "training": train_detail,
            "model": MODEL_NAMES[model_name],
            "engine": engine,
            **_device_fields(device),
        },
    }
    print(json.dumps(record), flush=True)
    return record


def main() -> dict:
    """Run the mode ``BENCH_MODE`` names; print and return its record."""
    refuse_unported()
    device = bench_device()
    mode = os.environ.get("BENCH_MODE", "")
    if mode == "train":
        return bench_train(device)
    if mode == "latency":
        return bench_latency(device)
    return bench_synthesis(device)


if __name__ == "__main__":
    main()
