"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--out report.json]

Phases (each failure ends the run with a non-zero exit):
  1. build    — nvcc-compile the four kernel sources, the two variant
                builds of the generation kernel that phase 4 times and the
                training kernels with their products compiled out (phase 7),
                all in parallel, and print the seconds;
  2. kernel   — at the flagship width (24 layers, 128/256/128, cin=80), hold
                the generation kernel against its plain PyTorch version for
                the categorical, MoL and Gaussian heads, f32 and bf16 packs,
                deterministic and sampling mode (same hash): at B=4 over
                512 steps, and at the serving batches B=32 and B=256 through
                the cluster shape serving picks for each (see TOL below);
  3. serving  — the flagship MoL ``Synthesizer(engine="cuda")`` with random
                weights from a seed serves 1 s mel requests (B=32 three times,
                then B=256) in bf16 sampling mode; the launch counter must
                rise and the audio must be finite with std > 0.01; a small
                model's deterministic output is held against the eager
                decoder through the same entry point;
  4. timing   — the kernel at the serving shape (B=256, one launch of 256
                steps) beside its plain version and its bound; a sweep of
                cluster size x streams per cluster at B=1, 32 and 256; the
                served shapes again with the products compiled out (barriers,
                gathers, prefetches and sampler only; results not checked),
                and the clock stamps of one step, phase by phase;
  5. train-kernel — at the flagship width, the residual-stack training
                kernels (csrc/train_fwd.cu, csrc/train_bwd.cu) against their
                plain versions: skips and all eight gradients, at B=2,
                T=3000 (f32 and bf16, dropout 0 and 0.05, one bf16 row with a
                global-conditioning bias) and at the training path's shape
                B=8, T=10240 (f32 and bf16); see TRAIN_TOL. bf16 runs the
                tensor-core kernels, f32 the FMA-tile kernels;
  6. training — ``create_train_state(Config(fused_train=True))`` and
                ``train_step`` at B=8 on bench.py's batch: one step through
                the kernels and one through the plain versions from the same
                state agree in loss, gradient norm and every parameter's
                gradient (see STEP_TOL); then 10 kernel steps, whose launch
                counts are the kernels' launches on the main path, lower
                the loss; every one of their launches must be a tensor-core
                launch (``.tc_launches``);
  7. train-timing — median step time and samples/s at B=8 and B=32 (CUDA
                events), a torch.profiler breakdown of one B=8 step by
                kernel, and each training kernel's time per step at B=8
                (bf16) beside its plain version, its bound and share of
                bound, its time with the products compiled out, and a cuBLAS
                yardstick (the same products as bf16 ``torch.matmul`` calls,
                each timed alone, summed; the port never calls them); a
                ``[summary]`` line repeats the training numbers just before
                the result lines;
  8. mel-kernel — at the flagship transform (n_fft 1024, hop 256, 80 mel
                bins), the log-mel kernel (csrc/mel.cu) against its plain
                version and the host f64 pipeline, for a 30 s waveform, 3,000
                samples, batches of 32 x 1 s and 8 x 1 s, win_length 800, hop
                300, the full band (fmin 0, fmax 11025) and a batch with one
                NaN sample (equal NaN masks) (see MEL_TOL); its time on the
                30 s waveform, on both batches and on the 3,000 samples
                (device time from torch.profiler, and per call with the
                host's time) beside the plain version, a cuFFT yardstick
                (torch.stft -> mel -> log10; the port never calls it) and
                the bound of what the function needs (a real FFT a frame
                and the mel weights in FP32, against the bytes it moves),
                with the bounds of its matrix-product DFT beside it. The
                kernels line gives the 8 x 1 s batch, the
                shape phase 9 launches;
  9. evaluation — in a temporary directory: 8 wav files of 1 s,
                ``cli.preprocess`` makes the dump dir, a flagship model's
                state is saved with ``save_checkpoint`` and ``hparams.json``,
                ``cli.evaluate`` and ``cli.synthesis`` read both and write
                audio; then the analysis-synthesis loop: the same waveforms
                through ``logmelspectrogram_cuda`` on the card and its
                features through ``Synthesizer(engine="cuda")``. The launch
                counts of this phase are the mel kernel's launches on the
                main path;
 10. streaming — ``StreamingSynthesizer(engine="cuda")`` on the flagship
                model (bf16 pack, sampling, B=4, 1 s of mel in chunks of 8
                frames) equals the offline ``Synthesizer`` from the same seed
                exactly; decoder segments with carried state equal one call;
                a small f32 model streamed through "cuda" agrees with the
                "scan" engine.

The line before the last two is a JSON object ``{"kernels": [...]}``; then
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12    # H100 SXM float32 rate outside the tensor cores
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
KERNEL_SOURCE = "wavenet_vocoder_tpu_torch/csrc/generate.cu"
REPLACES = "wavenet_vocoder_tpu/ops/pallas_generate.py:172"
TRAIN_KERNELS = {
    "wn_train_fwd": ("wavenet_vocoder_tpu_torch/csrc/train_fwd.cu",
                     "wavenet_vocoder_tpu/ops/pallas_train.py:353"),
    "wn_train_bwd": ("wavenet_vocoder_tpu_torch/csrc/train_bwd.cu",
                     "wavenet_vocoder_tpu/ops/pallas_train.py:799"),
}
MEL_KERNEL = ("wavenet_vocoder_tpu_torch/csrc/mel.cu",
              "wavenet_vocoder_tpu/dsp/mel_jax.py:134")
SOURCES = ("generate", "train_fwd", "train_bwd", "mel")


class PhaseError(RuntimeError):
    pass


def fail(msg: str) -> None:
    raise PhaseError(msg)


def gpu_name_and_limit() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi: no output"


def cuda_time_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------------
# phase 1: build
# ----------------------------------------------------------------------
def phase_build(report):
    """One nvcc per source and variant, all started together, then load each."""
    from concurrent.futures import ThreadPoolExecutor

    from wavenet_vocoder_tpu_torch.dsp import mel_torch as mt
    from wavenet_vocoder_tpu_torch.kernels import build
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    jobs = [(name, ()) for name in SOURCES]
    jobs += [("generate", cg.NO_PRODUCTS), ("generate", cg.TRACE),
             ("train_fwd", ct.NO_PRODUCTS), ("train_bwd", ct.NO_PRODUCTS),
             ("mel", mt.NO_PRODUCTS)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        for _ in pool.map(lambda job: build._compile(*job), jobs):
            pass
    for job in jobs:
        build.load(*job)
    secs = time.perf_counter() - t0
    print(f"[build] csrc/{{{','.join(SOURCES)}}}.cu, two variants of "
          f"generate.cu and the no-products train_fwd.cu, train_bwd.cu and "
          f"mel.cu: nvcc and load {secs:.1f}s")
    report["build_s"] = secs


# ----------------------------------------------------------------------
# phase 2: kernel vs plain at flagship width
# ----------------------------------------------------------------------
KERNEL_B, KERNEL_T = 4, 512
SERVE_BATCHES = (32, 32, 32, 256)
# The serving batches, each run by the cluster shape the serving path picks
# for it (``pick_cluster``: 16 streams a cluster, of 8 CTAs at B=32 and of 4
# at B=256), for one launch of DEFAULT_CHUNK steps; bf16 packs are held over
# CHECK_STEPS single steps and then over one CHECK_STEPS-step launch from
# the same state.
CHECK_BATCHES = (32, 256)
CHECK_STEPS = 32
# Tolerances. Kernel and plain version do the same arithmetic in another
# summation order. f32 packs: the whole AR run must agree (codes exactly,
# scalars within 1e-3). bf16 packs round every product input to bf16, so an
# f32 difference of one ulp sometimes moves a value across a bf16 rounding
# boundary, and AR feedback turns that into another trajectory. So bf16 is
# held (a) step by step: each step starts both sides from the plain
# version's state and compares that one step's output (codes exactly,
# scalars within 2e-2); over all of a head's single steps at most
# BF16_MAX_FLIPS may differ (an argmax near a tie flips: about 1 in 1000
# of deterministic steps on an H100); (b) at the serving batches, over one
# multi-step launch from the same state, where over all of a head's
# launches at most BF16_MAX_PARTED of the streams may leave the tolerance (a
# flip, then chaos: up to 16% of streams in 32 deterministic steps), and
# the error is taken over each stream's steps before it does. A fault in
# the state carried between steps parts nearly every stream. At B=4 the
# 512-step bf16 run's first diverging step is printed, not held.
TOL = {"float32": 1e-3, "bfloat16": 2e-2}
BF16_MAX_FLIPS = 1 / 512
BF16_MAX_PARTED = 1 / 4
HEADS = {"mol": {},
         "categorical": dict(input_type="mulaw-quantize", out_channels=256),
         "gaussian": dict(out_channels=2, output_distribution="Normal")}


def _flagship_model(device, seed, **over):
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
    cfg = Config(**over)
    model = WaveNet(spec_from_config(cfg),
                    generator=torch.Generator().manual_seed(seed))
    return cfg, model.to(device).eval()


def _new_state(spec, x0, dtype, n):
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    _, rows = cg.buffer_layout(spec)
    B = x0.shape[0]
    ring = torch.zeros(rows, B, spec.residual_channels, dtype=dtype,
                       device=x0.device)
    out = torch.empty(B, n, device=x0.device, dtype=(
        torch.float32 if spec.scalar_input else torch.int32))
    return ring, x0.clone(), out


def _trajectory(fn, packed, spec, cond, x0, dtype, T, det, seed=7):
    """(B, T) outputs of one AR run from zero state."""
    import torch
    ring, x_cur, out = _new_state(spec, x0, dtype, T)
    fn(packed, spec, ring, x_cur, out, cond, None, t0=0, seed=seed,
       deterministic=det)
    torch.cuda.synchronize()
    return out


def _stepwise(packed, spec, cond, x0, dtype, T, det, seed=7):
    """(B, T) |kernel - plain| of single steps from the plain run's state,
    and the plain run's (ring, x_cur) after step T-1."""
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    ring, x_cur, out_p = _new_state(spec, x0, dtype, 1)
    out_k = out_p.clone()
    diffs = []
    for j in range(T):
        ring_k, x_k = ring.clone(), x_cur.clone()
        c = cond[:, j:j + 1]
        cg.generate_steps(packed, spec, ring_k, x_k, out_k, c, None, t0=j,
                          seed=seed, deterministic=det)
        cg.generate_steps_plain(packed, spec, ring, x_cur, out_p, c, None,
                                t0=j, seed=seed, deterministic=det)
        diffs.append((out_k.float() - out_p.float()).abs()[:, 0])
    torch.cuda.synchronize()
    return torch.stack(diffs, dim=1), ring, x_cur


def _multistep(packed, spec, ring, x_cur, cond, t0, det, seed=7):
    """(B, n) |kernel - plain| of one n-step launch on each side from the
    same (ring, x_cur) at step t0; n = cond.shape[1]."""
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    outs = []
    for fn in (cg.generate_steps, cg.generate_steps_plain):
        r, x, out = _new_state(spec, x_cur, ring.dtype, cond.shape[1])
        r.copy_(ring)
        fn(packed, spec, r, x, out, cond, None, t0=t0, seed=seed,
           deterministic=det)
        outs.append(out.float())
    torch.cuda.synchronize()
    return (outs[0] - outs[1]).abs()


def _before_parting(diff, tol):
    """Per stream, the steps before the first one beyond tol: (max |diff|
    over them, streams that part, earliest parting step or None). NaN
    counts as beyond."""
    import torch
    beyond = ~(diff <= tol)
    n = diff.shape[1]
    first = torch.where(beyond.any(dim=1), beyond.int().argmax(dim=1),
                        torch.full_like(beyond[:, 0], n, dtype=torch.long))
    keep = torch.arange(n, device=diff.device)[None] < first[:, None]
    err = float(diff[keep].max()) if keep.any() else 0.0
    parted = int((first < n).sum())
    return err, parted, (int(first.min()) if parted else None)


def _check(packed, spec, cond, x0, dtype, dname, T, det, serving):
    """One row of phase 2 and the reasons it fails (empty when it holds)."""
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    tol = TOL[dname] if spec.scalar_input else 0.0
    B = x0.shape[0]
    row = dict(B=B, dtype=dname, deterministic=det, tol=tol,
               cluster=cg.pick_cluster(spec, B))
    bad = []
    if dname == "float32" or not serving:
        a = _trajectory(cg.generate_steps, packed, spec, cond, x0, dtype, T,
                        det)
        b = _trajectory(cg.generate_steps_plain, packed, spec, cond, x0,
                        dtype, T, det)
        if not a.float().isfinite().all():
            bad.append("kernel output not finite")
        diff = (a.float() - b.float()).abs()
        err, parted, first = _before_parting(diff, tol)
        row.update(run_steps=T, run_err=err, run_parted=parted,
                   first_diverging=first)
        if dname == "float32" and parted:
            bad.append(f"f32 run parts at step {first}")
    if dname == "bfloat16":
        n1 = CHECK_STEPS if serving else T
        step, ring, x_cur = _stepwise(packed, spec, cond[:, :n1], x0, dtype,
                                      n1, det)
        flips = int((~(step <= tol)).sum())
        ok = step[step <= tol]
        row.update(step_err=float(ok.max()) if ok.numel() else 0.0,
                   step_flips=flips, stream_steps=step.numel())
        if serving:
            diff = _multistep(packed, spec, ring, x_cur,
                              cond[:, n1:n1 + CHECK_STEPS], n1, det)
            err, parted, first = _before_parting(diff, tol)
            row.update(multi_steps=CHECK_STEPS, multi_err=err,
                       multi_parted=parted, multi_first_parting=first)
    return row, bad


def _describe(row):
    parts = [f"B={row['B']:<3d} {row['dtype']:8s} "
             f"{'det' if row['deterministic'] else 'sample':6s} "
             f"cluster {row['cluster'][0]}x{row['cluster'][1]} "
             f"tol {row['tol']}:"]
    if "run_steps" in row:
        parts.append(f"{row['run_steps']}-step run max|diff| "
                     f"{row['run_err']:.3g}, {row['run_parted']}/{row['B']} "
                     f"streams part (first at step {row['first_diverging']})")
    if "step_err" in row:
        parts.append(f"single steps max|diff| {row['step_err']:.3g}, "
                     f"{row['step_flips']}/{row['stream_steps']} beyond")
    if "multi_steps" in row:
        parts.append(f"{row['multi_steps']}-step launch max|diff| "
                     f"{row['multi_err']:.3g}, {row['multi_parted']}/"
                     f"{row['B']} streams part (first at step "
                     f"{row['multi_first_parting']})")
    return " ".join(parts[:1]) + " " + "; ".join(parts[1:])


def phase_kernel(report):
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = [(KERNEL_B, KERNEL_T, False)] + [
        (B, cg.DEFAULT_CHUNK, True) for B in CHECK_BATCHES]
    rows, failures = [], []
    for head, over in HEADS.items():
        _, model = _flagship_model("cuda", 1, **over)
        spec = model.spec
        for B, T, serving in shapes:
            g = torch.Generator(device="cuda").manual_seed(2)
            cond32 = torch.randn(B, T, spec.cin_channels, device="cuda",
                                 generator=g)
            x0 = cg.default_initial_input(spec, B, device="cuda")
            for dname in ("float32", "bfloat16"):
                dtype = getattr(torch, dname)
                packed = cg.pack_weights(model, dtype=dtype)
                cond = cond32.to(dtype).contiguous()
                for det in (True, False):
                    row, bad = _check(packed, spec, cond, x0, dtype, dname,
                                      T, det, serving)
                    row["head"] = head
                    rows.append(row)
                    line = f"[kernel] {head:11s} {_describe(row)}"
                    print(line, flush=True)
                    failures += [f"{b}: {line}" for b in bad]
        bf16 = [r for r in rows if r["head"] == head
                and r["dtype"] == "bfloat16"]
        flips = sum(r["step_flips"] for r in bf16)
        steps = sum(r["stream_steps"] for r in bf16)
        parted = sum(r["multi_parted"] for r in bf16 if "multi_parted" in r)
        streams = sum(r["B"] for r in bf16 if "multi_parted" in r)
        line = (f"[kernel] {head:11s} bf16 in all: {flips}/{steps} single "
                f"steps beyond tol (limit {BF16_MAX_FLIPS:.4g}), {parted}/"
                f"{streams} streams part in the {CHECK_STEPS}-step launches "
                f"(limit {BF16_MAX_PARTED:.4g})")
        print(line, flush=True)
        if flips > BF16_MAX_FLIPS * steps or parted > BF16_MAX_PARTED * streams:
            failures.append(line)
    report["kernel_vs_plain"] = rows
    # the served path: MoL head, bf16 pack, the serving batches
    served = [r for r in rows if r["head"] == "mol"
              and r["dtype"] == "bfloat16" and r["B"] in CHECK_BATCHES]
    report["max_abs_err"] = max(max(r["step_err"], r["multi_err"])
                                for r in served)
    report["bf16_flips"] = sum(r["step_flips"] for r in served)
    report["bf16_stream_steps"] = sum(r["stream_steps"] for r in served)
    report["f32_max_abs_err"] = max(r["run_err"] for r in rows
                                    if r["dtype"] == "float32")
    print(f"[kernel] served path (MoL, bf16, B in {CHECK_BATCHES}): max|diff|"
          f" {report['max_abs_err']:.3g}, {report['bf16_flips']}/"
          f"{report['bf16_stream_steps']} single steps beyond tol; f32 "
          f"packs max|diff| {report['f32_max_abs_err']:.3g}")
    if failures:
        fail("kernel disagrees with plain version:\n" + "\n".join(failures))


# ----------------------------------------------------------------------
# phase 3: serving through the user entry point
# ----------------------------------------------------------------------
def phase_serving(report, batches):
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    from wavenet_vocoder_tpu_torch.synthesis import Synthesizer

    # a small model through the same entry point agrees with the eager
    # decoder (deterministic, f32 pack)
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
    small = Config(layers=4, stacks=2, residual_channels=16, gate_channels=32,
                   skip_out_channels=16)
    sm = WaveNet(spec_from_config(small),
                 generator=torch.Generator().manual_seed(3))
    mel_s = np.random.RandomState(4).randn(2, 2, small.num_mels).astype(np.float32)
    fused = Synthesizer(sm, small, engine="cuda", weight_dtype=torch.float32)(
        mel_s, deterministic=True)
    eager = Synthesizer(sm, small, engine="scan")(mel_s, deterministic=True)
    err_small = float(np.abs(fused - eager).max())
    print(f"[serve] small model, cuda engine vs eager decoder: "
          f"max|diff| {err_small:.3g} over {fused.shape} (tol 1e-3)")
    if not err_small <= 1e-3:
        fail("cuda engine disagrees with the eager decoder")

    cfg, model = _flagship_model("cuda", 0)
    synth = Synthesizer(model, cfg, engine="cuda")
    hop = cfg.hop_size
    frames = cfg.sample_rate // hop
    T = frames * hop
    rs = np.random.RandomState(0)
    cg.generate_steps.launches = 0
    requests = []
    for i, B in enumerate(batches):
        mel = rs.randn(B, frames, cfg.num_mels).astype(np.float32)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        wav = synth(mel, generator=torch.Generator().manual_seed(i))
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dev_ms = start.elapsed_time(end)
        audio_s = B * T / cfg.sample_rate
        ok = (wav.shape == (B, T) and np.isfinite(wav).all()
              and float(wav.std()) > 0.01)
        r = dict(B=B, T=T, wall_s=wall, audio_s_per_s=audio_s / wall,
                 device_ms=dev_ms, per_step_us=dev_ms * 1e3 / T,
                 std=float(wav.std()))
        requests.append(r)
        print(f"[serve] request {i}: B={B} T={T} wall {wall:.3f}s "
              f"{r['audio_s_per_s']:.2f} audio-s/s, per step "
              f"{r['per_step_us']:.1f}us (device events), std {r['std']:.3f}")
        if not ok:
            fail(f"request {i}: bad output shape/values {wav.shape}")
    launches = cg.generate_steps.launches
    print(f"[serve] kernel launches during serving: {launches}")
    if launches <= 0:
        fail("serving did not launch the generation kernel")
    report["serving"] = requests
    report["launches"] = launches
    return model


# ----------------------------------------------------------------------
# phase 4: timing at the serving shape
# ----------------------------------------------------------------------
def bound_ms(spec, packed, B, n, dtype_bytes, peak_flops):
    """Least time for one launch: every input read once and every output
    written once over HBM bandwidth, against the launch's operations over
    the peak rate of the pack dtype."""
    from wavenet_vocoder_tpu_torch.ops.cuda_generate import buffer_layout
    _, rows = buffer_layout(spec)
    L, k, R, G, S = (spec.layers, spec.kernel_size, spec.residual_channels,
                     spec.gate_channels, spec.skip_out_channels)
    kin = k * R + spec.cin_channels
    macs = (spec.in_channels * R + L * (kin * G + G // 2 * (R + S))
            + S * S + S * spec.out_channels)
    flops = 2.0 * B * n * macs
    weights = sum(a.numel() * a.element_size() for a in packed.values())
    nbytes = (weights + B * n * spec.cin_channels * dtype_bytes
              + 2 * rows * B * R * dtype_bytes + 2 * B * spec.in_channels * 4
              + B * n * 4)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_timing(report, model):
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    spec = model.spec
    B, n = 256, cg.DEFAULT_CHUNK
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(5)
    cond = torch.randn(B, n, spec.cin_channels, device="cuda",
                       generator=g).to(torch.bfloat16)
    x0 = cg.default_initial_input(spec, B, device="cuda")
    _, rows = cg.buffer_layout(spec)
    ring = torch.zeros(rows, B, spec.residual_channels, dtype=torch.bfloat16,
                       device="cuda")
    out = torch.empty(B, n, device="cuda")

    def launch(fn):
        fn(packed, spec, ring, x0.clone(), out, cond, None, t0=0, seed=1,
           deterministic=False)

    saved = cg.generate_steps.launches
    ms = cuda_time_ms(lambda: launch(cg.generate_steps), iters=5)
    plain_ms = cuda_time_ms(lambda: launch(cg.generate_steps_plain),
                            iters=1, warmup=1)
    b_ms, b_by, flops, nbytes = bound_ms(spec, packed, B, n, 2, PEAK_BF16_FLOPS)
    picked = cg.pick_cluster(spec, B)
    print(f"[time] kernel B={B} n={n} bf16 cluster {picked[0]}x{picked[1]}: "
          f"{ms:.3f} ms/launch ({ms * 1e3 / n:.1f} us/step); plain "
          f"{plain_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}; "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")

    def timed(Bs, **kw):
        ring_b = ring if Bs == B else ring[:, :Bs].contiguous()
        info = []

        def go():
            cg.generate_steps(packed, spec, ring_b, x0[:Bs].clone(), out[:Bs],
                              cond[:Bs], None, t0=0, seed=1, _info=info, **kw)
        return cuda_time_ms(go, iters=3), info

    # cluster size x streams per cluster
    sweep = []
    for Bs in (1, 32, 256):
        for cs in (2, 4, 8):
            for streams in (8, 16):
                if streams > max(Bs, 8) or (Bs == 256 and streams == 8):
                    continue
                t, info = timed(Bs, _cluster=(cs, streams))
                sweep.append(dict(B=Bs, cluster_size=cs, streams=streams,
                                  ms=t, us_per_step=t * 1e3 / n,
                                  stages=info[0], resident_clusters=info[3]))
                print(f"[time] sweep B={Bs} cluster {cs}x{streams}: {t:.3f} "
                      f"ms/launch ({t * 1e3 / n:.1f} us/step); {info[0]} "
                      f"layers' weights in shared memory, the card holds "
                      f"{info[3]} such clusters at once")
    # what a step's time is made of: the served shapes with the products
    # compiled out, and one step's clock stamps
    no_products = {}
    for Bs in (32, 256):
        full, _ = timed(Bs)
        bare, _ = timed(Bs, _defines=cg.NO_PRODUCTS)
        no_products[Bs] = dict(ms=full, no_products_ms=bare)
        print(f"[time] B={Bs} served shape: {full * 1e3 / n:.1f} us/step; "
              f"with the products compiled out {bare * 1e3 / n:.1f} us/step "
              f"(barriers, gathers, prefetches, sampler)")
    L = spec.layers
    stamps = torch.zeros(4 * L + 5, dtype=torch.int64, device="cuda")
    cg.generate_steps(packed, spec, ring[:, :32].contiguous(), x0[:32].clone(),
                      out[:32, :64], cond[:32, :64].contiguous(), None, t0=0,
                      seed=1, _defines=cg.TRACE, _trace=stamps)
    torch.cuda.synchronize()
    st = stamps.tolist()
    gaps = [b - a for a, b in zip(st, st[1:])]
    med = lambda xs: sorted(xs)[len(xs) // 2]
    names = ("wait for the newest tap", "w_in product + GLU + send",
             "wait for gated", "w_og product + residual, skip + send")
    per_layer = [med([gaps[1 + 4 * l + i] for l in range(1, L)])
                 for i in range(4)]
    trace = dict(step_start=gaps[0], per_layer=dict(zip(names, per_layer)),
                 head=gaps[1 + 4 * L:], total=st[-1] - st[0])
    print(f"[time] one step of B=32 in clock cycles (CTA 0, thread 0): start "
          f"{gaps[0]}; per layer (median of {L - 1}): "
          + ", ".join(f"{n} {c}" for n, c in zip(names, per_layer))
          + f"; head {gaps[1 + 4 * L]} + {gaps[2 + 4 * L]}, sampler "
          f"{gaps[3 + 4 * L]}; step {trace['total']}")
    cg.generate_steps.launches = saved   # timing launches are not the path's
    report["timing"] = dict(B=B, n=n, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, flops=flops, bytes=nbytes,
                            cluster=picked, sweep=sweep,
                            no_products=no_products, trace=trace)
    return dict(name="wn_generate", route="cuda", source=KERNEL_SOURCE,
                replaces=REPLACES, launches=report["launches"],
                max_abs_err=report["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                bf16_flips=report["bf16_flips"],
                bf16_stream_steps=report["bf16_stream_steps"],
                f32_max_abs_err=report["f32_max_abs_err"])


# ----------------------------------------------------------------------
# phase 5: the training kernels against their plain versions
# ----------------------------------------------------------------------
# Tolerance per output, relative to its largest value. f32: 1e-4 — the same
# f32 arithmetic summed in another order (weight gradients by atomics, in an
# order that changes from run to run). bf16: 2e-2 — a one-ulp f32 difference
# in z can move gated or dz across a bf16 rounding boundary ("flips": the
# elements beyond 1e-3 of the largest value, printed).
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_ROWS = [  # (B, T, dtype, dropout, global-conditioning bias)
    (2, 3000, "float32", 0.0, False), (2, 3000, "float32", 0.05, False),
    (2, 3000, "bfloat16", 0.0, False), (2, 3000, "bfloat16", 0.05, False),
    (2, 3000, "bfloat16", 0.0, True),
    (8, 10240, "float32", 0.0, False), (8, 10240, "bfloat16", 0.0, False)]
GRAD_NAMES = ("dx0", "dc", "dgb", "dw_in", "db_in", "dw_cond", "dw_og",
              "db_og")


def _stack_case(model, B, T, dtype, glob, seed):
    import torch

    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    spec = model.spec
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, device="cuda", generator=g)
    with torch.no_grad():
        w_in, b_in, w_cond, w_og, b_og = ft.pack_block_weights(
            model.conv_layers, spec, dtype)
    x0 = (0.5 * rn(B, T, spec.residual_channels)).to(dtype)
    c = rn(B, T, spec.cin_channels).to(dtype)
    gb = 0.2 * rn(spec.layers, B, spec.gate_channels) if glob else None
    inputs = (x0, c, gb) + tuple(a.contiguous() for a in
                                 (w_in, b_in, w_cond, w_og, b_og))
    return inputs, rn(B, T, spec.skip_out_channels)


def _compare(name, got, want, tol):
    import torch
    scale = float(want.float().abs().max())
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    flips = int((diff > 1e-3 * scale).sum())
    ok = bool(torch.isfinite(got).all()) and err <= tol * scale
    return dict(name=name, max_abs_err=err, ref_max=scale,
                rel=err / max(scale, 1e-30), flips=flips, ok=ok)


def phase_train_kernel(report):
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    _, model = _flagship_model("cuda", 11)
    spec = model.spec
    kw0 = dict(dils=spec.dilations, k=spec.kernel_size)
    rows, failures = [], []
    for i, (B, T, dname, drop, glob) in enumerate(TRAIN_ROWS):
        dtype = getattr(torch, dname)
        inputs, dskips = _stack_case(model, B, T, dtype, glob, seed=20 + i)
        kw = dict(kw0, drop=drop, seed=-777 + i)
        with torch.no_grad():
            skips, xs = ct.train_fwd(*inputs, **kw)
            skips_p, xs_p = ft.fused_res_stack_fwd_plain(*inputs, **kw)
            torch.cuda.synchronize()
            outs = [_compare("skips", skips, skips_p, TRAIN_TOL[dname])]
            del skips, xs, skips_p
            _, c, gb, w_in, b_in, w_cond, w_og, b_og = inputs
            args = (dskips, xs_p, c, gb, w_in, b_in, w_cond, w_og, b_og)
            got = ct.train_bwd(*args, **kw)
            want = ft.fused_res_stack_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
        for name, a, b in zip(GRAD_NAMES, got, want):
            if b is not None:
                outs.append(_compare(name, a, b, TRAIN_TOL[dname]))
        del got, want, args, xs_p, inputs
        torch.cuda.empty_cache()
        row = dict(B=B, T=T, dtype=dname, dropout=drop, gb=glob,
                   tol=TRAIN_TOL[dname], outputs=outs)
        rows.append(row)
        line = (f"[train-kernel] B={B} T={T} {dname} drop={drop} "
                f"gb={'yes' if glob else 'no'} tol {TRAIN_TOL[dname]}: "
                + ", ".join(f"{o['name']} {o['rel']:.2e}"
                            + (f" ({o['flips']} flips)" if dname == "bfloat16"
                               else "") for o in outs))
        print(line, flush=True)
        failures += [f"{o['name']}: {line}" for o in outs if not o["ok"]]
    report["train_kernel_vs_plain"] = rows
    path = {r["dtype"]: r for r in rows if r["B"] == 8}
    # at the path's shape: the largest error over the kernel's outputs,
    # absolute and relative to each output's largest value
    err = {}
    for dname, tag in (("bfloat16", ""), ("float32", "_f32")):
        outs = path[dname]["outputs"]
        for key, sel in (("fwd", outs[:1]), ("bwd", outs[1:])):
            err[key + tag] = max(o["max_abs_err"] for o in sel)
            err[key + tag + "_rel"] = max(o["rel"] for o in sel)
    report["train_path_err"] = err
    if failures:
        fail("training kernels disagree with their plain versions:\n"
             + "\n".join(failures))


# ----------------------------------------------------------------------
# phase 6: the training path through the user entry points
# ----------------------------------------------------------------------
TRAIN_STEPS = 10
# kernel step vs plain step from one state, in f32 and in bf16 (the path):
# the loss and the global gradient norm, relative; each parameter's
# gradient, max |diff| relative to its own largest value (leaf_grad_errors),
# where a gradient that is dropped or sent to another leaf is off by ~1.
# The leaf limits sit above the upsample net's one-channel filters: weight
# norm leaves their weight_v only the small part of dW that lies across v,
# so the kernels' differences in dc (f32 ~1e-6, bf16 ~3e-3) come out there
# at ~7e-3 in f32 and ~5e-2 in bf16 of the leaf's largest value.
STEP_TOL = {"float32": {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 2e-2},
            "bfloat16": {"loss": 1e-4, "grad_norm": 1e-3, "leaf": 0.1}}


def train_batch(cfg, B):
    """bench.py's training batch (bench.py:78-85), made with numpy."""
    import numpy as np
    T = cfg.max_time_steps
    frames = T // cfg.hop_size + 2 * cfg.cin_pad
    rs = np.random.RandomState(0)
    x = rs.uniform(-0.5, 0.5, (B, T, 1)).astype(np.float32)
    return {"x": x, "y": x.copy(),
            "c": rs.randn(B, frames, cfg.num_mels).astype(np.float32),
            "input_lengths": np.full(B, T, np.int32)}


def _plain_stack():
    """The fused stack's plain versions in place of the kernels, for a
    CUDA tensor too (for this comparison only)."""
    from unittest import mock

    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    return mock.patch.object(ft, "_impl", lambda device: (
        ft.fused_res_stack_fwd_plain, ft.fused_res_stack_bwd_plain))


def leaf_grad_errors(model, ref_model):
    """max |grad - ref grad| / max |ref grad| for every parameter of
    ``model``. No scale is taken below 1e-6 of the largest of all leaves:
    first_conv.weight_v (one input channel) has a gradient that weight
    norm's projection makes 0 up to rounding, ~1e-9 of the largest, whose
    noise differs between any two runs."""
    ref = {n: p.grad.float() for n, p in ref_model.named_parameters()}
    scale = {n: float(g.abs().max()) for n, g in ref.items()}
    floor = 1e-6 * max(scale.values())
    out = {}
    for name, p in model.named_parameters():
        err = float((p.grad.float() - ref[name]).abs().max())
        out[name] = (err / max(scale[name], floor) if math.isfinite(err)
                     else float("inf"))
    return out


def _kernel_vs_plain_step(cfg, batch, dname):
    """One train step through the kernels and one through the plain
    versions from the same fresh state; returns the kernel's state and step
    and what they agree on. Fails the phase past STEP_TOL[dname]."""
    import copy

    import torch

    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    tol = STEP_TOL[dname]
    state = create_train_state(cfg)
    train_step, _ = make_train_step(cfg)
    plain = create_train_state(cfg, model=copy.deepcopy(state.model))
    m_k = train_step(state, batch)
    with _plain_stack():
        m_p = train_step(plain, batch)
    torch.cuda.synchronize()
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    norm_k, norm_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
    # the step leaves each parameter's gradient in .grad (no clipping in
    # this config): held leaf by leaf, so a dropped or mis-routed gradient
    # of a small leaf shows, which the global norm would hide
    leaves = leaf_grad_errors(state.model, plain.model)
    top = sorted(leaves.items(), key=lambda kv: -kv[1])[:5]
    agree = dict(loss_kernel=loss_k, loss_plain=loss_p,
                 loss_rel=abs(loss_k - loss_p) / abs(loss_p),
                 grad_norm_kernel=norm_k, grad_norm_plain=norm_p,
                 grad_norm_rel=abs(norm_k - norm_p) / abs(norm_p),
                 leaf_rel=leaves, worst_leaf=top[0][0], tol=tol)
    B, T = batch["x"].shape[:2]
    print(f"[training] B={B} T={T} {dname}, one step from one state: loss "
          f"kernel {loss_k:.6f} plain {loss_p:.6f} (rel "
          f"{agree['loss_rel']:.2e}, tol {tol['loss']}); grad norm kernel "
          f"{norm_k:.6f} plain {norm_p:.6f} (rel {agree['grad_norm_rel']:.2e},"
          f" tol {tol['grad_norm']}); {len(leaves)} parameter gradients, max "
          f"|diff| / max |ref|, tol {tol['leaf']}, worst: "
          + ", ".join(f"{n} {v:.2e}" for n, v in top), flush=True)
    del plain, m_p
    torch.cuda.empty_cache()
    if not (agree["loss_rel"] <= tol["loss"]
            and agree["grad_norm_rel"] <= tol["grad_norm"]
            and top[0][1] <= tol["leaf"]):
        fail(f"kernel and plain training steps disagree ({dname})")
    return state, train_step, agree


def phase_training(report):
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(fused_train=True)
    B = cfg.batch_size
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in train_batch(cfg, B).items()}
    _, _, agree_f32 = _kernel_vs_plain_step(
        Config(fused_train=True, compute_dtype=""), batch, "float32")
    torch.cuda.empty_cache()
    state, train_step, agree = _kernel_vs_plain_step(cfg, batch, "bfloat16")

    wrappers = {"wn_train_fwd": ct.train_fwd, "wn_train_bwd": ct.train_bwd}
    for w in wrappers.values():
        w.launches = w.tc_launches = w.fma_launches = 0
    losses = []
    for _ in range(TRAIN_STEPS):
        losses.append(float(train_step(state, batch)["loss"]))
    launches = {n: w.launches for n, w in wrappers.items()}
    tc_launches = {n: w.tc_launches for n, w in wrappers.items()}
    L = state.model.spec.layers
    expected = {"wn_train_fwd": L * TRAIN_STEPS,
                "wn_train_bwd": 3 * L * TRAIN_STEPS}
    print(f"[training] {TRAIN_STEPS} kernel steps: losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + f"; launches {launches} (expected {expected}), of them on the "
          f"tensor cores {tc_launches}", flush=True)
    report["training"] = dict(agree=agree, agree_f32=agree_f32,
                              losses=losses, launches=launches,
                              tc_launches=tc_launches)
    if launches != expected:
        fail(f"training launched {launches}, expected {expected}")
    if tc_launches != expected:
        fail(f"bf16 training launches not all on the tensor-core kernels: "
             f"{tc_launches} of {expected}")
    if not np.isfinite(losses).all():
        fail("training loss not finite")
    if not np.mean(losses[5:]) < losses[0]:
        fail(f"loss did not fall: mean of steps 6-10 {np.mean(losses[5:])}"
             f" vs step 1 {losses[0]}")
    return state, train_step, launches


# ----------------------------------------------------------------------
# phase 7: training step and kernel times
# ----------------------------------------------------------------------
def train_bounds(spec, B, T, nbytes):
    """MACs per position of the forward and the backward (with its z
    recompute) from the spec, and the least time of each at B x T: the
    larger of its operations at the bf16 tensor-core rate and its bytes
    (``nbytes``: each input read once, each output written once) at HBM
    rate."""
    L, k, R, G, S = (spec.layers, spec.kernel_size, spec.residual_channels,
                     spec.gate_channels, spec.skip_out_channels)
    cin, G2 = spec.cin_channels, G // 2
    z = (k * R + cin) * G
    fwd = L * (z + G2 * (R + S))
    bwd = L * (z + (R + S) * G2 + k * R * G + cin * G + G2 * (R + S)
               + k * G * R + G * cin)
    out = {}
    for name, macs in (("wn_train_fwd", fwd), ("wn_train_bwd", bwd)):
        flops = 2.0 * macs * B * T
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes[name] / PEAK_HBM_BYTES
        out[name] = dict(macs_per_position=macs, flops=flops,
                         bytes=nbytes[name],
                         bound_ms=max(t_ops, t_bytes) * 1e3,
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes")
    return out


def _step_times(train_step, state, batch, n):
    import torch
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


# the training kernels' names, tensor-core kernels first (each FMA kernel's
# name is a prefix of its counterpart's)
TRAIN_KERNEL_NAMES = ("fwd_tc", "bwd_dz_tc", "bwd_wgrad_tc", "bwd_dx_tc",
                      "fwd_layer", "bwd_dz", "bwd_wgrad", "bwd_dx")


def cublas_yardstick_ms(spec, B, T):
    """The training kernels' products as bf16 ``torch.matmul`` calls at the
    same shapes, each timed alone (CUDA events), times the layers, summed per
    kernel. A mark of what the card's library reaches on these shapes; the
    port never calls it (no one call computes the stack)."""
    import torch
    L, k, R, G, S = (spec.layers, spec.kernel_size, spec.residual_channels,
                     spec.gate_channels, spec.skip_out_channels)
    cin, G2, P = spec.cin_channels, G // 2, B * T
    # (M, K, N, transposed A): A (M x K) @ B (K x N); a transposed A is the
    # transpose of a position-major (K x M) tensor, as the weight gradients
    # read their inputs
    shapes = {"wn_train_fwd": [(P, k * R + cin, G, False),
                               (P, G2, R + S, False)],
              "wn_train_bwd": [(P, k * R + cin, G, False),
                               (P, R + S, G2, False), (k * R, P, G, True),
                               (cin, P, G, True), (G2, P, R + S, True),
                               (P, k * G, R, False), (P, G, cin, False)]}
    out = {}
    for name, prods in shapes.items():
        total = 0.0
        for M, K, N, trans in prods:
            bf = dict(device="cuda", dtype=torch.bfloat16)
            a = (torch.randn(K, M, **bf).t() if trans
                 else torch.randn(M, K, **bf))
            b = torch.randn(K, N, **bf)
            total += L * cuda_time_ms(lambda: torch.matmul(a, b), iters=10)
            del a, b
        out[name] = total
    torch.cuda.empty_cache()
    return out


def _profile_step(train_step, state, batch):
    """Device time of one train step by kernel, from a torch.profiler trace:
    (groups {name: ms}, busy ms, step ms by CUDA events), or None when the
    profiler records no device activity. Kernels run on one stream, so the
    sum of their durations is the device's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((k for k in TRAIN_KERNEL_NAMES if k in e.name),
                    e.name[:60])
        groups[name] = groups.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not groups:
        return None
    return groups, sum(groups.values()), start.elapsed_time(end)


def phase_train_timing(report, state, train_step):
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    cfg = Config(fused_train=True)
    T = cfg.max_time_steps
    wrappers = (ct.train_fwd, ct.train_bwd)
    saved = [(w.launches, w.tc_launches, w.fma_launches) for w in wrappers]
    steps = {}
    for B in (8, 32):
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in train_batch(cfg, B).items()}
        _step_times(train_step, state, batch, 1)          # warm-up
        t = _step_times(train_step, state, batch, 5)
        med = float(np.median(t))
        steps[B] = dict(step_ms=t, median_ms=med,
                        samples_per_s=B * T / (med / 1e3))
        print(f"[train-time] B={B} T={T}: step median {med:.1f} ms (min "
              f"{min(t):.1f}, max {max(t):.1f}), "
              f"{steps[B]['samples_per_s']:.0f} samples/s", flush=True)
        if B == cfg.batch_size:
            prof = _profile_step(train_step, state, batch)
            if prof is None:
                print("[train-time] the profiler recorded no device activity")
            else:
                groups, busy, wall = prof
                top = sorted(groups.items(), key=lambda kv: -kv[1])[:12]
                steps[B]["profile"] = dict(kernels_ms=groups, busy_ms=busy,
                                           step_ms=wall)
                print(f"[train-time] B={B} profiled step {wall:.1f} ms: device "
                      f"busy {busy:.1f} ms (idle {1 - busy / wall:.1%}); "
                      + ", ".join(f"{k} {v:.1f}" for k, v in top), flush=True)
        del batch
        torch.cuda.empty_cache()

    model, spec = state.model, state.model.spec
    B = cfg.batch_size
    inputs, dskips = _stack_case(model, B, T, torch.bfloat16, False, seed=40)
    kw = dict(dils=spec.dilations, k=spec.kernel_size)
    with torch.no_grad():
        _, xs = ct.train_fwd(*inputs, **kw)
        x0, c, gb, w_in, b_in, w_cond, w_og, b_og = inputs
        args = (dskips, xs, c, gb, w_in, b_in, w_cond, w_og, b_og)
        timed = lambda fn: cuda_time_ms(fn, iters=10)
        ms = {"wn_train_fwd": timed(lambda: ct.train_fwd(*inputs, **kw)),
              "wn_train_bwd": timed(lambda: ct.train_bwd(*args, **kw))}
        nop = dict(kw, _defines=ct.NO_PRODUCTS)
        no_products = {
            "wn_train_fwd": timed(lambda: ct.train_fwd(*inputs, **nop)),
            "wn_train_bwd": timed(lambda: ct.train_bwd(*args, **nop))}
        plain = {"wn_train_fwd": cuda_time_ms(
                     lambda: ft.fused_res_stack_fwd_plain(*inputs, **kw),
                     iters=1),
                 "wn_train_bwd": cuda_time_ms(
                     lambda: ft.fused_res_stack_bwd_plain(*args, **kw),
                     iters=1)}
    nb = lambda a: 0 if a is None else a.numel() * a.element_size()
    weights = sum(nb(a) for a in inputs[3:])
    acts = nb(x0) + nb(c)
    grads = (nb(x0) * 2 + nb(c) * 2        # dx0, dc in f32
             + sum(nb(a) * (4 // a.element_size()) for a in inputs[3:]))
    nbytes = {"wn_train_fwd": acts + weights + B * T * spec.skip_out_channels
              * 4 + nb(xs),
              "wn_train_bwd": nb(dskips) + nb(xs) + nb(c) + weights + grads}
    bounds = train_bounds(spec, B, T, nbytes)
    del inputs, dskips, args, xs
    torch.cuda.empty_cache()
    yard = cublas_yardstick_ms(spec, B, T)
    for w, counts in zip(wrappers, saved):
        w.launches, w.tc_launches, w.fma_launches = counts
    for name in TRAIN_KERNELS:
        b = bounds[name]
        print(f"[train-time] {name} B={B} T={T} bf16: {ms[name]:.3f} ms/step"
              f" ({b['bound_ms'] / ms[name]:.1%} of bound, "
              f"{b['flops'] / ms[name] / 1e9:.1f} TFLOP/s); products "
              f"compiled out {no_products[name]:.3f} ms; cuBLAS yardstick "
              f"{yard[name]:.3f} ms; plain {plain[name]:.3f} ms; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; "
              f"{b['flops'] / 1e12:.3f} TFLOP, {b['bytes'] / 1e9:.3f} GB; "
              f"{b['macs_per_position']} MACs per position)", flush=True)
    report["train_timing"] = dict(steps=steps, kernel_ms=ms, plain_ms=plain,
                                  no_products_ms=no_products,
                                  cublas_yardstick_ms=yard, bounds=bounds)
    return ms, plain, bounds


def train_kernel_lines(report, launches, ms, plain, bounds):
    err, tt = report["train_path_err"], report["train_timing"]
    lines = []
    for name, (source, replaces) in TRAIN_KERNELS.items():
        key = "fwd" if name == "wn_train_fwd" else "bwd"
        lines.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=err[key], ms=ms[name],
            plain_ms=plain[name], bound_ms=bounds[name]["bound_ms"],
            bound_by=bounds[name]["bound_by"], library_ms=None,
            max_rel_err=err[key + "_rel"],
            f32_max_abs_err=err[key + "_f32"],
            f32_max_rel_err=err[key + "_f32_rel"],
            tc_launches=report["training"]["tc_launches"][name],
            no_products_ms=tt["no_products_ms"][name],
            cublas_yardstick_ms=tt["cublas_yardstick_ms"][name]))
    return lines


# ----------------------------------------------------------------------
# phase 8: the log-mel kernel against its plain version and the host path
# ----------------------------------------------------------------------
# Kernel and plain version compute the same sums, the kernel's DFT in split
# TF32 (three tensor-core passes, f32 accuracy) and in another summation
# order. The mel sums S are held relative to the largest (1e-5); log10 turns
# a relative difference in S into an absolute one, so the log values of
# signals with a noise floor are held at 1e-3. Both are held against the host
# f64 pipeline at 2e-3, the limit of the JAX package's own tests. The NaN
# case is held by equal NaN masks (kernel, plain, host) and by the limits
# everywhere else.
MEL_TOL = {"log": 1e-3, "S": 1e-5, "host": 2e-3}
MEL_CASES = [  # (name, config overrides, batch or None, samples)
    ("30 s", {}, None, 661500), ("3000 samples", {}, None, 3000),
    ("32 x 1 s", {}, 32, 22050), ("8 x 1 s", {}, 8, 22050),
    ("win_length 800", {"win_length": 800}, None, 12000),
    ("hop 300", {"hop_size": 300}, 2, 22050),
    ("full band", {"fmin": 0, "fmax": 11025}, 2, 22050),
    ("NaN sample", {}, 2, 22050)]
NAN_AT = (1, 9000)   # (row, sample) set to NaN in the NaN case
# timed: the bench shape, the serving request's shape, the shape the
# evaluation phase launches (the one on the kernels line), one frame tile;
# the build with the products compiled out at the first two
MEL_MAIN = "8 x 1 s"
MEL_TIMED = ("30 s", "32 x 1 s", MEL_MAIN, "3000 samples")
MEL_VARIANTS_AT = ("30 s", MEL_MAIN)
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core rate


def mel_signal(T, seed):
    """Two sines plus a 0.05 noise floor, made with numpy from a seed."""
    import numpy as np
    rng = np.random.RandomState(seed)
    t = np.arange(T) / 22050.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1330 * t) + 0.05 * rng.randn(T))
    return x.astype(np.float32)


def mel_bound(cfg, B, T):
    """Least time for the log-mel of (B, T) samples on this card, from what
    the function needs: a real-input FFT of each frame (2.5 n_fft log2
    n_fft operations, half a complex FFT's 5 N log2 N) and the mel
    matrix's non-zero weights (a multiply and an add each), at the FP32
    rate, against the signal, the used bins' mel rows and the output moved
    once at HBM rate. Beside it, labelled, the bounds of the work a
    matrix-product DFT does: all bins in FP32 (the bound PRs 1-5 reported)
    and the used bins in three TF32 passes with the dense mel product in
    FP32 (the work of csrc/mel.cu)."""
    import math

    import numpy as np

    from wavenet_vocoder_tpu_torch.dsp import mel_torch as mt
    n_fft, n_mels = cfg.fft_size, cfg.num_mels
    n_bins = 1 + n_fft // 2
    mel_m = mt._mel_mat(cfg.sample_rate, n_fft, n_mels, float(cfg.fmin),
                        float(cfg.fmax))
    k0, k1 = mt.used_bins(mel_m)
    used = k1 - k0
    frames = B * (1 + T // cfg.hop_size)
    io = B * T + frames * n_mels
    flops = frames * (2.5 * n_fft * math.log2(n_fft)
                      + 2.0 * int(np.count_nonzero(mel_m)))
    nbytes = 4 * (io + used * n_mels)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    fp32_ms = max(2.0 * frames * (2 * n_fft * n_bins + n_bins * n_mels)
                  / PEAK_FP32_FLOPS,
                  4 * (io + 2 * n_fft * n_bins + n_bins * n_mels)
                  / PEAK_HBM_BYTES) * 1e3
    tf32_ms = max(3 * 2.0 * frames * 2 * n_fft * used / PEAK_TF32_FLOPS
                  + 2.0 * frames * used * n_mels / PEAK_FP32_FLOPS,
                  4 * (io + 4 * n_fft * used + used * n_mels)
                  / PEAK_HBM_BYTES) * 1e3
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes, frames=frames, used_bins=[k0, k1],
                matmul_dft_fp32_bound_ms=fp32_ms,
                matmul_dft_3xtf32_bound_ms=tf32_ms)


def stft_yardstick(cfg, device):
    """torch.stft (cuFFT; periodic Hann, center=True, reflect padding) ->
    magnitude -> mel product -> clamp -> log10: the same function through
    library calls, timed beside the kernel. The port never calls it."""
    import torch

    from wavenet_vocoder_tpu_torch.dsp import mel_torch as mt
    n_fft, hop, win_length = mt._resolve(cfg)
    window = torch.hann_window(win_length, periodic=True, device=device)
    mel_m = mt._mats(cfg, device)[2]

    def fn(y):
        spec = torch.stft(y, n_fft, hop_length=hop, win_length=win_length,
                          window=window, center=True, pad_mode="reflect",
                          return_complex=True)
        S = spec.abs().transpose(-1, -2) @ mel_m
        return torch.log10(torch.clamp(S, min=1e-10))
    return fn


def device_ms(fn, n=20):
    """Device time per call of fn: the summed time of the CUDA kernels it
    launches (torch.profiler, CUDA activity), without the host's time
    between them. The log-mel kernel's wrapper costs more host time than
    the card spends on it, so its time per call (``call_ms``) is the
    wrapper's; the three ways are compared on device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages())
    return us / 1e3 / n


def phase_mel_kernel(report):
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.dsp import audio
    from wavenet_vocoder_tpu_torch.dsp import mel_torch as mt
    rows, failures, timing = [], [], {}
    for i, (name, over, batch, T) in enumerate(MEL_CASES):
        cfg = Config(**over)
        x = np.stack([mel_signal(T, 100 * i + j) for j in range(batch or 1)])
        if name == "NaN sample":
            x[NAN_AT] = np.nan
        y = torch.from_numpy(x if batch else x[0]).cuda()
        got = mt.logmelspectrogram_cuda(y, cfg)
        torch.cuda.synchronize()
        want = mt.logmelspectrogram_torch(y, cfg)
        S = mt.mel_power_torch(y, cfg).double()
        host = np.stack([audio.logmelspectrogram(r, cfg) for r in x])
        nan = torch.isnan(want)
        keep = ~nan
        S_c = S.clamp(min=1e-10)[keep]
        got_np = got.cpu().numpy().reshape(host.shape)
        want_np = want.cpu().numpy().reshape(host.shape)
        keep_np = keep.cpu().numpy().reshape(host.shape)
        row = dict(
            name=name, shape=list(got.shape), clamped=int((S < 1e-10).sum()),
            nan=int(nan.sum()),
            nan_masks_equal=bool(torch.equal(torch.isnan(got), nan)
                                 and np.array_equal(np.isnan(host),
                                                    ~keep_np)),
            log_err=float((got - want)[keep].abs().max()),
            S_rel=float((10.0 ** got.double()[keep] - S_c).abs().max()
                        / S_c.max()),
            host_err=float(np.abs(got_np - host)[keep_np].max()),
            plain_host_err=float(np.abs(want_np - host)[keep_np].max()))
        ok = (bool(torch.isfinite(got[keep]).all()) and got.shape == want.shape
              and row["nan_masks_equal"]
              and (row["nan"] > 0) == (name == "NaN sample")
              and row["log_err"] <= MEL_TOL["log"]
              and row["S_rel"] <= MEL_TOL["S"]
              and row["host_err"] <= MEL_TOL["host"]
              and row["plain_host_err"] <= MEL_TOL["host"])
        line = (f"[mel-kernel] {name}: {row['shape']} log |kernel - plain| "
                f"{row['log_err']:.3g} (tol {MEL_TOL['log']}), S rel "
                f"{row['S_rel']:.3g} (tol {MEL_TOL['S']}), vs host f64: "
                f"kernel {row['host_err']:.3g} plain "
                f"{row['plain_host_err']:.3g} (tol {MEL_TOL['host']}), "
                f"{row['clamped']} elements at the 1e-10 clamp, {row['nan']} "
                f"NaN, NaN masks equal: {row['nan_masks_equal']}")
        print(line, flush=True)
        if not ok:
            failures.append(line)
        if name in MEL_TIMED:
            yard = stft_yardstick(cfg, y.device)
            yard_err = float((yard(y) - want).abs().max())
            kern = lambda d=(): mt.logmelspectrogram_cuda(y, cfg, _defines=d)
            plain = lambda: mt.logmelspectrogram_torch(y, cfg)
            t = dict(ms=device_ms(kern), plain_ms=device_ms(plain),
                     yardstick_ms=device_ms(lambda: yard(y)),
                     call_ms=cuda_time_ms(kern, iters=20),
                     plain_call_ms=cuda_time_ms(plain, iters=20),
                     yardstick_call_ms=cuda_time_ms(lambda: yard(y), iters=20),
                     yardstick_err=yard_err, **mel_bound(cfg, batch or 1, T))
            if name in MEL_VARIANTS_AT:
                t["no_products_ms"] = device_ms(lambda: kern(mt.NO_PRODUCTS))
                print(f"[mel-variants] {name}: device ms per call: this "
                      f"kernel {t['ms']:.4f}, products compiled out "
                      f"{t['no_products_ms']:.4f}", flush=True)
            timing[name] = t
            print(f"[mel-time] {name} ({t['frames']} frames), device ms "
                  f"per call (per call with the host): kernel {t['ms']:.4f} "
                  f"({t['call_ms']:.4f}), {t['bound_ms'] / t['ms']:.1%} of "
                  f"the lower bound; plain {t['plain_ms']:.4f} "
                  f"({t['plain_call_ms']:.4f}); cuFFT yardstick "
                  f"{t['yardstick_ms']:.4f} ({t['yardstick_call_ms']:.4f}; "
                  f"log vs plain {yard_err:.3g}); bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}; real FFT and mel weights, "
                  f"{t['flops'] / 1e6:.1f} MFLOP, {t['bytes'] / 1e6:.2f} MB); "
                  f"matrix-product DFT bounds: FP32 all bins "
                  f"{t['matmul_dft_fp32_bound_ms']:.4f}, 3xTF32 over bins "
                  f"{t['used_bins'][0]}..{t['used_bins'][1] - 1} "
                  f"{t['matmul_dft_3xtf32_bound_ms']:.4f}", flush=True)
        rows.append(row)
    report["mel_kernel_vs_plain"] = rows
    report["mel_timing"] = timing
    if failures:
        fail("log-mel kernel disagrees:\n" + "\n".join(failures))


# ----------------------------------------------------------------------
# phase 9: the evaluation leg through the CLIs
# ----------------------------------------------------------------------
EVAL_UTTS = 8


def _read_wav(path):
    from scipy.io import wavfile
    return wavfile.read(path)[1].astype("float32") / 32768.0


def phase_evaluation(report):
    import os
    import tempfile

    import numpy as np
    import torch
    from scipy.io import wavfile

    from wavenet_vocoder_tpu_torch.cli import evaluate, preprocess, synthesis
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.dsp import audio
    from wavenet_vocoder_tpu_torch.dsp import mel_torch as mt
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    from wavenet_vocoder_tpu_torch.synthesis import Synthesizer
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state)
    cfg = Config()
    sr, hop = cfg.sample_rate, cfg.hop_size
    cg.generate_steps.launches = 0
    mt.logmelspectrogram_cuda.launches = 0
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wav_dir, dump = os.path.join(tmp, "wavs"), os.path.join(tmp, "dump")
        exp, out = os.path.join(tmp, "exp"), os.path.join(tmp, "eval")
        os.makedirs(wav_dir)
        for i in range(EVAL_UTTS):
            # at half scale: save_wav would normalise the peak to 1.0, and
            # preprocessing rejects what its high-pass filter lifts above 1
            wavfile.write(os.path.join(wav_dir, f"utt{i}.wav"), sr,
                          (mel_signal(sr, 900 + i) * 16384).astype(np.int16))
        preprocess.main(["wavallin", wav_dir, dump, "--num-workers", "1"])
        state = create_train_state(cfg)
        path = ckpt.save_checkpoint(exp, state, global_step=0)
        with open(os.path.join(exp, "hparams.json"), "w") as f:
            f.write(cfg.to_json())
        del state
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        evaluate.main([dump, path, out, "--batch-size", str(EVAL_UTTS)])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        feats = [np.load(os.path.join(dump, f"utt{i}-feats.npy"))
                 for i in range(EVAL_UTTS)]
        stds = []
        for i in range(EVAL_UTTS):
            for kind in ("gen", "ref"):
                w = _read_wav(os.path.join(out, f"utt{i}_{kind}.wav"))
                if len(w) != feats[i].shape[0] * hop or not np.isfinite(w).all():
                    fail(f"utt{i}_{kind}.wav: {len(w)} samples, expected "
                         f"{feats[i].shape[0] * hop}, or not finite")
                if kind == "gen":
                    stds.append(float(w.std()))
        names = open(os.path.join(out, "eval_manifest.txt")).read().split()
        if len(names) != EVAL_UTTS or min(stds) <= 0.01:
            fail(f"cli.evaluate: manifest {names}, gen std {stds}")
        launches_eval = cg.generate_steps.launches
        print(f"[evaluation] cli.evaluate: {EVAL_UTTS} utterances of "
              f"{feats[0].shape[0]} frames in one batch, {eval_s:.2f} s, "
              f"{launches_eval} generation launches, gen std min "
              f"{min(stds):.3f}", flush=True)

        dst = os.path.join(tmp, "one.wav")
        t0 = time.perf_counter()
        synthesis.main([path, dst, "--conditional",
                        os.path.join(dump, "utt0-feats.npy")])
        synth_s = time.perf_counter() - t0
        w = _read_wav(dst)
        if (len(w) != feats[0].shape[0] * hop or not np.isfinite(w).all()
                or float(w.std()) <= 0.01):
            fail(f"cli.synthesis: {len(w)} samples, std {w.std()}")
        print(f"[evaluation] cli.synthesis: {len(w)} samples in "
              f"{synth_s:.2f} s, std {w.std():.3f}", flush=True)

        # analysis-synthesis: waveform -> log-mel on the card -> waveform.
        # The waveforms as preprocessing saw them (read, high-pass filtered;
        # the silence trim leaves these stationary signals whole).
        x = np.stack([audio.low_cut_filter(
            audio.load_wav(os.path.join(wav_dir, f"utt{i}.wav"), sr), sr,
            cfg.highpass_cutoff).astype(np.float32)
            for i in range(EVAL_UTTS)])
        model, _, _ = synthesis.load_params_and_config(path, None, "")
        synth = Synthesizer(model, cfg, engine="cuda")
        y = torch.from_numpy(x).cuda()
        if tuple(y.shape) != (EVAL_UTTS, sr):
            fail(f"preprocessing changed the waveforms' length: {y.shape}")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        mel = mt.logmelspectrogram_cuda(y, cfg)
        ev[1].record()
        wav = synth(mel, generator=torch.Generator().manual_seed(5))
        ev[2].record()
        torch.cuda.synchronize()
        mel_ms, gen_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        launches = dict(wn_logmel=mt.logmelspectrogram_cuda.launches,
                        wn_generate=cg.generate_steps.launches)
        mel_np = mel.cpu().numpy()
        plain_err = float((mel - mt.logmelspectrogram_torch(y, cfg)
                           ).abs().max())
        dump_err = max(float(np.abs(mel_np[i] - feats[i]).max())
                       if mel_np[i].shape == feats[i].shape else float("inf")
                       for i in range(EVAL_UTTS))
        host_err = max(float(np.abs(
            mel_np[i] - audio.logmelspectrogram(x[i], cfg)).max())
            for i in range(EVAL_UTTS))
        print(f"[evaluation] analysis-synthesis, {EVAL_UTTS} x {x.shape[1]} "
              f"samples: log-mel kernel {mel_ms:.3f} ms, generation "
              f"{gen_ms / 1e3:.2f} s; features vs the dump dir's "
              f"{dump_err:.3g}, vs host f64 {host_err:.3g} (tol "
              f"{MEL_TOL['host']}), vs plain {plain_err:.3g} (tol "
              f"{MEL_TOL['log']}); audio {wav.shape} std {wav.std():.3f}; "
              f"launches over the phase {launches}", flush=True)
        if not (dump_err <= MEL_TOL["host"] and host_err <= MEL_TOL["host"]
                and plain_err <= MEL_TOL["log"]):
            fail("log-mel on the card disagrees with the dump dir's features")
        if not (wav.shape == (EVAL_UTTS, mel_np.shape[1] * hop)
                and np.isfinite(wav).all() and float(wav.std()) > 0.01):
            fail(f"analysis-synthesis audio {wav.shape} std {wav.std()}")
    if launches["wn_logmel"] <= 0 or launches_eval <= 0 \
            or launches["wn_generate"] <= launches_eval:
        fail(f"the evaluation leg did not launch its kernels: {launches}")
    report["evaluation"] = dict(
        evaluate_s=eval_s, synthesis_s=synth_s, mel_ms=mel_ms, gen_ms=gen_ms,
        launches=launches, dump_err=dump_err, host_err=host_err,
        plain_err=plain_err, total_s=time.perf_counter() - t_phase)
    return launches


# ----------------------------------------------------------------------
# phase 10: streaming through the kernel with carried state
# ----------------------------------------------------------------------
STREAM_B, STREAM_FEED = 4, 8


def _feed_all(stream, mel, n):
    import numpy as np
    outs = [stream.feed(mel[:, i:i + n]) for i in range(0, mel.shape[1], n)]
    return np.concatenate(outs + [stream.flush()], axis=1)


def phase_streaming(report):
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    from wavenet_vocoder_tpu_torch.streaming import StreamingSynthesizer
    from wavenet_vocoder_tpu_torch.synthesis import Synthesizer, pad_mel_context
    cfg, model = _flagship_model("cuda", 0)
    hop = cfg.hop_size
    frames = cfg.sample_rate // hop
    T = frames * hop
    mel = np.random.RandomState(21).randn(
        STREAM_B, frames, cfg.num_mels).astype(np.float32)
    gen = lambda: torch.Generator().manual_seed(33)
    offline = Synthesizer(model, cfg, engine="cuda")(mel, generator=gen())

    stream = StreamingSynthesizer(model, cfg, generator=gen(), batch=STREAM_B,
                                  engine="cuda")
    before = cg.generate_steps.launches
    t0 = time.perf_counter()
    streamed = _feed_all(stream, mel, STREAM_FEED)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = cg.generate_steps.launches - before

    # Same kernel, same carried state, random numbers keyed on the absolute
    # step: the streamed audio must equal the offline audio exactly.
    exact = np.array_equal(streamed, offline)
    differing = (int((streamed != offline).sum())
                 if streamed.shape == offline.shape else -1)
    print(f"[streaming] flagship bf16 sampling B={STREAM_B}, {frames} frames "
          f"fed {STREAM_FEED} at a time (lookahead "
          f"{stream.lookahead_frames} frames): {streamed.shape} in "
          f"{stream_s:.2f} s, {launches} launches of {hop} steps; equal to "
          f"the offline audio exactly: {exact} ({differing} of "
          f"{STREAM_B * T} samples differ)", flush=True)
    if not exact:
        fail("streamed audio differs from the offline audio")
    if not (np.isfinite(streamed).all() and float(streamed.std()) > 0.01):
        fail("streamed audio not finite or silent")

    # decoder segments with carried state equal one call, on one conditioning
    fg = stream._gen
    with torch.no_grad():
        c_up = model.upsample_conditioning(torch.as_tensor(
            pad_mel_context(mel[:, :16], cfg.cin_pad), device="cuda")).float()
    whole = fg(c_up=c_up, seed=9)
    a, st = fg(c_up=c_up[:, :5 * hop], seed=9, return_state=True)
    b, st = fg(c_up=c_up[:, 5 * hop:], seed=9, state=st, return_state=True)
    torch.cuda.synchronize()
    carry_exact = bool(torch.equal(torch.cat([a, b], dim=1), whole))
    print(f"[streaming] FusedGenerator, {5 * hop} + {11 * hop} steps with "
          f"carried state equal one call of {16 * hop}: {carry_exact}",
          flush=True)
    if not carry_exact or st[2] != 16 * hop:
        fail("carried decoder state does not reproduce one long call")

    # a small f32 model: the kernel's stream against the eager decoder's
    small = Config(layers=4, stacks=2, residual_channels=16, gate_channels=32,
                   skip_out_channels=16, hop_size=16,
                   upsample_params={"upsample_scales": [4, 4]})
    sm = WaveNet(spec_from_config(small),
                 generator=torch.Generator().manual_seed(3))
    mel_s = np.random.RandomState(4).randn(2, 12, small.num_mels
                                           ).astype(np.float32)
    outs = {}
    for engine, kw in (("cuda", dict(weight_dtype=torch.float32)),
                       ("scan", {})):
        s = StreamingSynthesizer(sm, small, batch=2, engine=engine,
                                 deterministic=True, **kw)
        outs[engine] = _feed_all(s, mel_s, 3)
    err = float(np.abs(outs["cuda"] - outs["scan"]).max())
    print(f"[streaming] small f32 model, deterministic, 12 frames fed 3 at a "
          f"time: cuda engine vs scan engine max|diff| {err:.3g} over "
          f"{outs['cuda'].shape} (tol 1e-3)", flush=True)
    if not (outs["cuda"].shape == (2, 12 * 16) and err <= 1e-3):
        fail("streamed cuda engine disagrees with the streamed eager decoder")
    report["streaming"] = dict(
        exact=bool(exact), samples=STREAM_B * T, stream_s=stream_s,
        launches=launches, carry_exact=carry_exact, small_err=err)


def mel_kernel_line(report, launches):
    # time, plain time and bound at the shape the main path launched
    t, long = report["mel_timing"][MEL_MAIN], report["mel_timing"]["30 s"]
    rows = report["mel_kernel_vs_plain"]
    return dict(
        name="wn_logmel", route="cuda", source=MEL_KERNEL[0],
        replaces=MEL_KERNEL[1], launches=launches["wn_logmel"],
        max_abs_err=max(r["log_err"] for r in rows), ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["yardstick_ms"],
        library="yardstick: torch.stft (cuFFT) -> abs -> mel matmul -> "
                "clamp -> log10",
        matmul_dft_fp32_bound_ms=t["matmul_dft_fp32_bound_ms"],
        matmul_dft_3xtf32_bound_ms=t["matmul_dft_3xtf32_bound_ms"],
        call_ms=t["call_ms"], plain_call_ms=t["plain_call_ms"],
        library_call_ms=t["yardstick_call_ms"],
        no_products_ms=t["no_products_ms"],
        max_S_rel_err=max(r["S_rel"] for r in rows),
        max_host_err=max(r["host_err"] for r in rows),
        shape=MEL_MAIN, bench30s_ms=long["ms"],
        bench30s_plain_ms=long["plain_ms"], bench30s_bound_ms=long["bound_ms"],
        batch32_ms=report["mel_timing"]["32 x 1 s"]["ms"],
        batch32_plain_ms=report["mel_timing"]["32 x 1 s"]["plain_ms"],
        batch32_bound_ms=report["mel_timing"]["32 x 1 s"]["bound_ms"],
        nan_masks_equal=all(r["nan_masks_equal"] for r in rows))


def summary_line(report) -> str:
    """The training numbers of this run on one line, next to the result."""
    tr, tt = report["training"], report["train_timing"]
    parts = []
    for B, s in tt["steps"].items():
        parts.append(f"B={B} step median {s['median_ms']:.1f} ms (min "
                     f"{min(s['step_ms']):.1f}, max {max(s['step_ms']):.1f}),"
                     f" {s['samples_per_s']:.0f} samples/s")
        if "profile" in s:
            p = s["profile"]
            parts.append(f"B={B} profiled step {p['step_ms']:.1f} ms, device "
                         f"busy {p['busy_ms']:.1f} ms")
    for name, ms in tt["kernel_ms"].items():
        share = tt["bounds"][name]["bound_ms"] / ms
        parts.append(f"{name} {ms:.3f} ms ({share:.1%} of bound; products "
                     f"out {tt['no_products_ms'][name]:.3f}, cuBLAS yardstick "
                     f"{tt['cublas_yardstick_ms'][name]:.3f}, plain "
                     f"{tt['plain_ms'][name]:.3f})")
    for dname, agree in (("f32", tr["agree_f32"]), ("bf16", tr["agree"])):
        parts.append(f"kernel vs plain {dname} step: loss rel "
                     f"{agree['loss_rel']:.2e}, grad norm rel "
                     f"{agree['grad_norm_rel']:.2e}, worst leaf "
                     f"{agree['worst_leaf']} "
                     f"{agree['leaf_rel'][agree['worst_leaf']]:.2e}")
    parts.append(f"10-step loss {tr['losses'][0]:.4f} -> {tr['losses'][-1]:.4f}")
    for name, t in report["mel_timing"].items():
        parts.append(f"log-mel {name}: kernel {t['ms']:.4f} ms of device "
                     f"time (plain {t['plain_ms']:.4f}, cuFFT yardstick "
                     f"{t['yardstick_ms']:.4f}, bound {t['bound_ms']:.4f})")
    ev, st = report["evaluation"], report["streaming"]
    parts.append(f"evaluation leg {ev['total_s']:.1f} s (cli.evaluate "
                 f"{ev['evaluate_s']:.2f} s, analysis-synthesis log-mel "
                 f"{ev['mel_ms']:.3f} ms + generation {ev['gen_ms'] / 1e3:.2f}"
                 f" s), launches {ev['launches']}")
    parts.append(f"stream equals offline exactly: {st['exact']} "
                 f"({st['samples']} samples)")
    return "[summary] " + "; ".join(parts) + f"; total {report['total_s']:.1f} s"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the full report as JSON here")
    args = ap.parse_args()
    try:
        import torch
        import wavenet_vocoder_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    if "jax" in sys.modules or "wavenet_vocoder_tpu" in sys.modules:
        print("chip_smoke: the port pulled in JAX", file=sys.stderr)
        return 4
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    report = {}
    batches = SERVE_BATCHES
    t_start = time.perf_counter()
    try:
        phase = "build"
        phase_build(report)
        phase = "kernel"
        phase_kernel(report)
        phase = "serving"
        model = phase_serving(report, batches)
        phase = "timing"
        kernel_line = phase_timing(report, model)
        del model
        torch.cuda.empty_cache()
        phase = "train-kernel"
        phase_train_kernel(report)
        phase = "training"
        state, train_step, launches = phase_training(report)
        phase = "train-timing"
        ms, plain, bounds = phase_train_timing(report, state, train_step)
        train_lines = train_kernel_lines(report, launches, ms, plain, bounds)
        del state, train_step
        torch.cuda.empty_cache()
        phase = "mel-kernel"
        phase_mel_kernel(report)
        phase = "evaluation"
        eval_launches = phase_evaluation(report)
        phase = "streaming"
        phase_streaming(report)
        mel_line = mel_kernel_line(report, eval_launches)
    except PhaseError as e:
        print(f"chip_smoke: phase {phase} failed: {e}", file=sys.stderr)
        return 1
    report["total_s"] = time.perf_counter() - t_start
    gpu = gpu_name_and_limit()
    report["gpu"] = gpu
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    if "jax" in sys.modules or "wavenet_vocoder_tpu" in sys.modules:
        print("chip_smoke: the port pulled in JAX", file=sys.stderr)
        return 4
    print(summary_line(report))
    print(json.dumps({"kernels": [kernel_line] + train_lines + [mel_line]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
