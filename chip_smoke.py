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
                B=8, T=10240 (f32 and bf16); and at the quality net's widths
                (12 layers, 64/128/64, cin 40) at B=8, T=4096 (f32 and bf16,
                dropout 0 and 0.05); see TRAIN_TOL. Every row launches the
                backward twice: all eight gradients bitwise equal. bf16 runs
                the tensor-core kernels, f32 the FMA-tile kernels;
  6. training — ``create_train_state(Config(fused_train=True))`` and
                ``train_step`` at B=8 on bench.py's batch: one step through
                the kernels and one through the plain versions from the same
                state agree in loss, gradient norm and every parameter's
                gradient (see STEP_TOL); then 10 kernel steps, whose launch
                counts are the kernels' launches on the main path, lower
                the loss; every one of their launches must be a tensor-core
                launch (``train_*.tc_launches``); then each training path (the
                kernels and the layer loop, dropout 0.05) takes 2 steps
                twice from one state, batch and generator: loss,
                parameters, optimizer state and EMA bitwise equal; and the
                ops torch warns of under ``use_deterministic_algorithms``
                (warn only; a check, never the main path) are printed;
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
  9. evaluation — under build/chip_smoke_eval: 8 wav files of 1 s,
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
                "scan" engine;
 11. loop     — training from a dump on disk: a synthetic dump under build/
                (48 train and 8 dev utterances in the *-wave.npy /
                *-feats.npy layout, numpy from a seed) and the flagship
                ``Config(fused_train=True)`` (bf16, B=8, crop 10240);
                ``python -m wavenet_vocoder_tpu_torch.cli.train`` in a
                subprocess for 30 steps (checkpoints at 15 and 30, eval audio
                at 30, dev audio every epoch): logged losses finite and
                falling, checkpoints with the EMA twin and hparams.json, eval
                wavs at the crop's length, every stack launch on the
                tensor-core kernels (the CLI prints its counters), eval audio
                through the generation kernel; the step-30 checkpoint loads
                and ``cli.synthesis --engine auto`` makes an utterance from
                it. In process: step times (CUDA events between consecutive
                steps, median of steps 5-30) with ``prefetch_to_device`` and
                with the loader fed straight into ``train_step``, beside
                phase 7's synthetic-batch step, and the profiled device-idle
                share of one loop step (``[loop-time]``); the first 3 f32
                losses (dropout 0) from the step-30 checkpoint with and
                without prefetch agree within 1e-5 relative.
 12. multi-device — at the flagship width: (a) the training kernels with
                the dropout key's row offset (b0=4; B=4, T=3000, dropout
                0.05, bf16 and f32) against their plain versions at b0=4,
                and against rows 4..7 of a B=8 launch at b0=0 (TRAIN_TOL);
                (b) two ranks on the one card (gloo, both on cuda:0: a check
                of the data-parallel step, not a way to train), 4 rows each
                of a B=8 batch with unequal lengths, 3 bf16 steps at dropout
                0.05, against one process at B=8: the ranks' parameters
                bitwise equal; the losses, the first step's grad norm (the
                later ones within 10x) and every parameter's gradient from
                one state within phase 6's bf16 STEP_TOL (the parameters'
                drift after 3 steps is printed); every stack launch on the
                tensor cores; (c) ``cli.train
                --distributed`` through NCCL at world size 1 (torchrun's
                variables in its environment) for 10 steps on phase 11's
                dump, its step beside phases 7 and 11's; (d) a mesh record
                listing cuda:0 twice: B=32 x 1 s synthesis sharded equals
                unsharded in every sample (deterministic), and shard i
                equals its rows alone with seed + i (sampling); (e)
                ``cli.evaluate --distributed`` in two gloo processes on
                phase 9's dump and checkpoint: disjoint manifests whose
                union is one process's list, deterministic audio equal to
                one process's. The other processes are this script started
                again (``--md-rank``, ``--run-module``), each failing if it
                imported JAX; the kernels line counts (b)-(e)'s launches as
                ``multi_device_launches``.
 13. bench    — the generation kernel at the bench's two published big
                models, 30L3S (30 layers, 3 stacks) and 512ch (512/512/256),
                bf16, against its plain version as phase 2 holds it at
                B=32 and B=256, and one 256-step launch at B=256 timed
                beside its plain version and bound; r9y9's mu-law 256
                recipe (its categorical head split over the cluster) timed
                the same way at B=256 and B=16, with the plan each launch
                took and its counters; then ``python -m
                wavenet_vocoder_tpu_torch.bench`` in subprocesses: synthesis
                at the flagship (B=256 and 128, with the compact B=64 train
                record), 30L3S and 512ch (B=256, one timed iteration;
                512ch also B=128, with one step's clock stamps a layer),
                training at B=32 from a constant batch and from the loader
                (BENCH_PIPELINE=1), and streaming latency. Each JSON record
                must have a finite value, the card's name and no error;
                every run must launch its kernels (training on the tensor
                cores); the flagship's B=256 value must lie within 25% of
                phase 3's B=256 request. The kernels line counts the runs'
                launches as ``bench_launches`` and gives the big models'
                launch times (``ms_30L3S``, ``bound_ms_512ch``,
                ``ms_512ch.b128``, ``ms_mulaw256.b16``, ...);
 14. quality  — the sampled-audio quality net: one backward of the stack at
                the quality model's widths in the healthy build twice (all
                eight gradients bitwise equal) and in each fault build (dx0
                moved by more than 1e-4 of its largest value); then
                ``wavenet_vocoder_tpu_torch.scripts.quality_check`` for the
                QUALITY_HEADS (mulaw256; see there) at 1500 steps on the
                kernels, which must pass the JAX script's thresholds
                (``quality_launches`` on the kernels line); then the same
                check of mulaw256 on the bwd_x_shift fault build, which
                must fail (exit 1): the net can fail on the port.
 15. parallel-optim — (a) each of the 11 optimizers ``make_optimizer``
                maps: one update from the gradients of a flagship fused
                bf16 B=8 step, on the card in f32 against the CPU in f64
                (OPT_TOL of the largest update), then OPT_STEPS flagship
                steps on the tensor-core kernels (finite, the last loss
                below the first; host ms a step); (b) remat on the
                flagship's plain layer loop (bf16, B=8, T=10240): off,
                whole and "dots" with deterministic cuDNN, loss bitwise
                equal and gradients within 1e-6, peak memory and step time
                each; (c) two gloo ranks on the card with the model axis 2
                (``chip_smoke.py --tp-rank``): two f32 plain SGD steps,
                then two bf16 fused ones on the kernels with gathered
                weights, each against one process within STEP_TOL (losses,
                grad norms, first-step gradients, the parameters' updates;
                whole), the ranks' parameters bitwise equal; (d)
                ``entry.dryrun_multichip(4)``, four gloo ranks sharing the
                card, every rank launching the training and generation
                kernels. ``[tail]`` lines for each; the kernels line counts
                the phase's launches as ``phase15_launches``.

 16. slice-11 — (a) the flagship ``Config(fused_train=True)`` in bf16, B=8,
                on the tensor-core kernels: 2 steps, ``save_checkpoint``
                (which must write the JAX package's layout: keystr paths
                and 2N + 2 optax leaves of Adam's state), reloaded into a
                fresh state; step 3 after the reload against step 3
                without it: loss, grad norm, every gradient and the state
                after it bitwise equal; (c) the eager
                decoder in bf16 (``generate(dtype=torch.bfloat16)``),
                flagship deterministic, B=32: 32 single steps from its own
                state against the f32 decoder and against the kernel with
                the bf16 pack: head outputs and samples within phase 2's
                bf16 step limit, a sample beyond it only at a near tie of
                the mixture's argmax (see _bf16_scan); 32-step runs from
                zero printed beside; (b) two gloo ranks on the card
                (``chip_smoke.py --syn-rank``) with the flagship's blocks
                cut over the model axis 2, deterministic, B=4 x 22 mel
                frames: the kernel engine's samples equal the whole
                model's bit for bit (equal packs), the scan engine's over
                SYN_SCAN_T steps within 1e-3, the ranks' outputs bitwise
                equal; (d) ``egs/run_common_torch.sh`` stages 0-3 in
                build/chip_smoke_recipe with ``conf/mol_wavenet.json`` on
                the corpus of ``scripts/make_speech_corpus.py`` (24
                utterances), ``--max-train-steps`` RECIPE_STEPS, every CLI
                as ``chip_smoke.py --run-module``: each stage's seconds
                and launches, a ``*_gen.wav`` for every dev and eval
                utterance, training and generation kernels launched.
                ``[tail] 16`` lines; the kernels line counts the phase's
                launches as ``phase16_launches``.
 17. quality-grads — the quality net's mol config (B=8, T=4096, dropout
                0.05) at its fresh state and after Q_TRAIN_STEPS steps on
                the kernels: each parameter's gradient on Q_BATCHES batches
                of its pool through the kernels, the fused stack's plain
                versions and the layer loop in bf16, against the layer loop
                in f32 (TF32 off); per leaf e(kernels) <= Q_RATIO x e(plain
                versions) + Q_SLACK, with e(layer loop) and the mean cosine
                of each error with the reference printed; the kernels line
                counts the phase's launches as ``phase17_launches``.

The line before the last two is a JSON object ``{"kernels": [...]}``; then
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

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
    from wavenet_vocoder_tpu_torch.utils.profiling import gpu_name_and_limit
    return gpu_name_and_limit()


def peak(kind: str) -> float:
    """The published H100 SXM rate ("bf16", "tf32", "fp32" FLOP/s, "hbm"
    bytes/s) that every bound here is stated against: utils/flops.py's
    table, which the bench's MFU reads too."""
    from wavenet_vocoder_tpu_torch.utils.flops import H100_SXM
    return H100_SXM[kind]


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
    jobs += [("train_bwd", d) for d in ct.FAULTS.values() if d]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        for _ in pool.map(lambda job: build._compile(*job), jobs):
            pass
    for job in jobs:
        build.load(*job)
    secs = time.perf_counter() - t0
    print(f"[build] csrc/{{{','.join(SOURCES)}}}.cu, two variants of "
          f"generate.cu, the no-products train_fwd.cu, train_bwd.cu and "
          f"mel.cu, and the two fault builds of train_bwd.cu: nvcc and load "
          f"{secs:.1f}s")
    report["build_s"] = secs


# ----------------------------------------------------------------------
# phase 2: kernel vs plain at flagship width
# ----------------------------------------------------------------------
KERNEL_B, KERNEL_T = 4, 512
SERVE_BATCHES = (32, 32, 32, 256)
# The serving batches, each run by the cluster shape the serving path plans
# for it (``plan_launch``: 16 streams a cluster, of 8 CTAs at B=32 and of 4
# at B=256; the mu-law 256 model's bf16 packs 32 streams a cluster of 8 at
# B=256), for one launch of DEFAULT_CHUNK steps; bf16 packs are held over
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


def _shape(plan):
    """(CTAs, streams) a cluster of a ``cuda_generate.Plan``."""
    return plan.CS, plan.spc


def _check(packed, spec, cond, x0, dtype, dname, T, det, serving):
    """One row of phase 2 and the reasons it fails (empty when it holds)."""
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    tol = TOL[dname] if spec.scalar_input else 0.0
    B = x0.shape[0]
    row = dict(B=B, dtype=dname, deterministic=det, tol=tol,
               cluster=_shape(cg.plan_launch(spec, dtype, B)))
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


def _bf16_verdict(rows, tag):
    """Phase 2's limits over all of one model's bf16 rows: prints the line
    and returns it where the limits fail, else None."""
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    flips = sum(r["step_flips"] for r in bf16)
    steps = sum(r["stream_steps"] for r in bf16)
    parted = sum(r["multi_parted"] for r in bf16 if "multi_parted" in r)
    streams = sum(r["B"] for r in bf16 if "multi_parted" in r)
    line = (f"{tag} bf16 in all: {flips}/{steps} single steps beyond tol "
            f"(limit {BF16_MAX_FLIPS:.4g}), {parted}/{streams} streams part "
            f"in the {CHECK_STEPS}-step launches (limit "
            f"{BF16_MAX_PARTED:.4g})")
    print(line, flush=True)
    if flips > BF16_MAX_FLIPS * steps or parted > BF16_MAX_PARTED * streams:
        return line
    return None


def _check_model(model, shapes, dnames, tag, label):
    """Phase 2's rows for one model: each (B, T, serving) shape, pack dtype
    and sampling mode, each row labelled with ``label``. Returns (rows,
    failures), the bf16 limits over all rows included."""
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    spec = model.spec
    packs = {d: cg.pack_weights(model, dtype=getattr(torch, d))
             for d in dnames}
    rows, failures = [], []
    for B, T, serving in shapes:
        g = torch.Generator(device="cuda").manual_seed(2)
        cond32 = torch.randn(B, T, spec.cin_channels, device="cuda",
                             generator=g)
        x0 = cg.default_initial_input(spec, B, device="cuda")
        for dname in dnames:
            dtype = getattr(torch, dname)
            cond = cond32.to(dtype).contiguous()
            for det in (True, False):
                row, bad = _check(packs[dname], spec, cond, x0, dtype, dname,
                                  T, det, serving)
                row.update(label)
                rows.append(row)
                line = f"{tag} {_describe(row)}"
                print(line, flush=True)
                failures += [f"{b}: {line}" for b in bad]
    verdict = _bf16_verdict(rows, tag)
    return rows, failures + ([verdict] if verdict else [])


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
        mine, bad = _check_model(model, shapes, ("float32", "bfloat16"),
                                 f"[kernel] {head:11s}", dict(head=head))
        rows += mine
        failures += bad
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
    _set_launches({"generate.launches": 0, "generate.tap_last_launches": 0})
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
    launches = _launches("generate.launches")
    tap_last = _launches("generate.tap_last_launches")
    print(f"[serve] kernel launches during serving: {launches}, {tap_last} "
          f"of them walking the newest tap last")
    if launches <= 0:
        fail("serving did not launch the generation kernel")
    if tap_last != launches:
        fail(f"{tap_last} of {launches} bf16 serving launches walked the "
             f"newest tap last")
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
    t_ops, t_bytes = flops / peak_flops, nbytes / peak("hbm")
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


# the generation kernel's launch counters (``generate.<name>``)
_GENERATE_COUNTERS = ("launches", "chunked_launches", "split_head_launches",
                      "wide_cluster_launches", "tap_last_launches")


def _launch_inputs(spec, B, n):
    """(cond, x0, ring, out) of one n-step bf16 launch at B from zero
    state, cond drawn from seed 5."""
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    g = torch.Generator(device="cuda").manual_seed(5)
    cond = torch.randn(B, n, spec.cin_channels, device="cuda",
                       generator=g).to(torch.bfloat16)
    x0 = cg.default_initial_input(spec, B, device="cuda")
    _, rows = cg.buffer_layout(spec)
    ring = torch.zeros(rows, B, spec.residual_channels, dtype=torch.bfloat16,
                       device="cuda")
    return cond, x0, ring, torch.empty(B, n, device="cuda", dtype=(
        torch.float32 if spec.scalar_input else torch.int32))


def _time_launch(tag, packed, spec, inputs, iters, cluster=None):
    """One sampling launch on ``inputs`` (_launch_inputs) timed beside its
    plain version and its bound, printed after ``tag``, on the picker's
    cluster shape or ``cluster``. The timing launches are not counted. A
    categorical model's launches carry one x_cur on, as a stream does: a
    fresh one-hot x_cur is checked on the host first."""
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    cond, x0, ring, out = inputs
    B, n = out.shape
    x_cat = x0.clone()

    def launch(fn, **kw):
        fn(packed, spec, ring, x0.clone() if spec.scalar_input else x_cat,
           out, cond, None, t0=0, seed=1, deterministic=False, **kw)

    names = [f"generate.{n}" for n in _GENERATE_COUNTERS]
    saved = {n: _launches(n) for n in names}
    ms = cuda_time_ms(lambda: launch(cg.generate_steps, _cluster=cluster),
                      iters=iters)
    plain_ms = cuda_time_ms(lambda: launch(cg.generate_steps_plain),
                            iters=1, warmup=1)
    _set_launches(saved)
    b_ms, b_by, flops, nbytes = bound_ms(spec, packed, B, n, 2, peak("bf16"))
    cs = cluster or _shape(cg.plan_launch(spec, packed["w_first"].dtype, B))
    print(f"{tag} B={B} n={n} bf16 cluster {cs[0]}x{cs[1]}: {ms:.3f} "
          f"ms/launch ({ms * 1e3 / n:.1f} us/step); plain {plain_ms:.1f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return dict(B=B, n=n, ms=ms, us_per_step=ms * 1e3 / n, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                cluster=cs)


# the phases of a layer between WN_TRACE's stamps (csrc/generate.cu)
LAYER_PHASES = ("stage waits", "on-hand k-steps",
                "wait for the newest tap (left)",
                "newest-tap k-steps + GLU + send", "wait for gated",
                "w_og product + residual, skip + send")


def _step_cycles(tag, packed, spec, inputs):
    """The clock stamps of one step (the last of a 64-step launch; CTA 0,
    thread 0; the WN_TRACE build) on ``inputs`` (_launch_inputs), printed
    after ``tag``: the step's start, each phase of a layer (LAYER_PHASES,
    median over layers 1..L-1; the on-hand k-steps are warp 0's before it
    waits for the newest tap, which one row tile does before its walk), the
    head and the sampler, in cycles."""
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    cond, x0, ring, out = inputs
    L, P = spec.layers, len(LAYER_PHASES)
    stamps = torch.zeros(P * L + 5, dtype=torch.int64, device="cuda")
    cg.generate_steps(packed, spec, ring.contiguous(), x0.clone(),
                      out[:, :64], cond[:, :64].contiguous(), None, t0=0,
                      seed=1, _defines=cg.TRACE, _trace=stamps)
    torch.cuda.synchronize()
    st = stamps.tolist()
    gaps = [b - a for a, b in zip(st, st[1:])]
    med = lambda xs: sorted(xs)[len(xs) // 2]
    per_layer = [med([gaps[1 + P * l + i] for l in range(1, L)])
                 for i in range(P)]
    trace = dict(step_start=gaps[0],
                 per_layer=dict(zip(LAYER_PHASES, per_layer)),
                 layer=sum(per_layer), head=gaps[1 + P * L:],
                 total=st[-1] - st[0])
    print(f"{tag} in clock cycles (CTA 0, thread 0): start {gaps[0]}; per "
          f"layer (median of {L - 1}): "
          + ", ".join(f"{n} {c}" for n, c in zip(LAYER_PHASES, per_layer))
          + f" (a layer {trace['layer']}); head {gaps[1 + P * L]} + "
          f"{gaps[2 + P * L]}, sampler {gaps[3 + P * L]}; step "
          f"{trace['total']}", flush=True)
    return trace


def phase_timing(report, model):
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    spec = model.spec
    B, n = 256, cg.DEFAULT_CHUNK
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    cond, x0, ring, out = inputs = _launch_inputs(spec, B, n)
    saved = {f"generate.{n}": _launches(f"generate.{n}")
             for n in _GENERATE_COUNTERS}
    timing = _time_launch("[time] kernel", packed, spec, inputs, iters=5)

    def timed(Bs, **kw):
        ring_b = ring if Bs == B else ring[:, :Bs].contiguous()
        info = []

        def go():
            cg.generate_steps(packed, spec, ring_b, x0[:Bs].clone(), out[:Bs],
                              cond[:Bs], None, t0=0, seed=1, _info=info, **kw)
        return cuda_time_ms(go, iters=3), info

    # cluster size x streams per cluster (32: two row tiles, where whole
    # layer blocks fit beside their buffers)
    sweep = []
    for Bs in (1, 32, 256):
        for cs in (2, 4, 8):
            for streams in (8, 16, 32):
                if streams > max(Bs, 8) or (Bs == 256 and streams == 8):
                    continue
                try:
                    plan = cg.plan_launch(spec, torch.bfloat16, Bs,
                                          cluster=(cs, streams))
                except ValueError:    # no 32-row plan
                    continue
                t, info = timed(Bs, plan=plan)
                sweep.append(dict(B=Bs, cluster_size=cs, streams=streams,
                                  ms=t, us_per_step=t * 1e3 / n,
                                  stages=plan.nstage, resident_clusters=info[3]))
                print(f"[time] sweep B={Bs} cluster {cs}x{streams}: {t:.3f} "
                      f"ms/launch ({t * 1e3 / n:.1f} us/step); {plan.nstage} "
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
    trace = _step_cycles("[time] one step of B=32", packed, spec,
                         (cond[:32], x0[:32], ring[:, :32], out[:32]))
    # timing launches are not the path's
    _set_launches(saved)
    report["timing"] = dict(timing, sweep=sweep, no_products=no_products,
                            trace=trace)
    return dict(name="wn_generate", route="cuda", source=KERNEL_SOURCE,
                replaces=REPLACES, launches=report["launches"],
                max_abs_err=report["max_abs_err"], ms=timing["ms"],
                plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                bound_by=timing["bound_by"], library_ms=None,
                bf16_flips=report["bf16_flips"],
                bf16_stream_steps=report["bf16_stream_steps"],
                f32_max_abs_err=report["f32_max_abs_err"])


# ----------------------------------------------------------------------
# phase 5: the training kernels against their plain versions
# ----------------------------------------------------------------------
# Tolerance per output, relative to its largest value. f32: 1e-4 — the same
# f32 arithmetic summed in another order (the weight and bias gradients in a
# fixed order of their own: position chunks, then groups of 32 positions).
# bf16: 2e-2 — a one-ulp f32 difference in z can move gated or dz across a
# bf16 rounding boundary ("flips": the elements beyond 1e-3 of the largest
# value, printed). Every row also launches the backward twice: all eight
# gradients must repeat bit for bit.
TRAIN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_ROWS = [  # (model, B, T, dtype, dropout, global-conditioning bias)
    ("flagship", 2, 3000, "float32", 0.0, False),
    ("flagship", 2, 3000, "float32", 0.05, False),
    ("flagship", 2, 3000, "bfloat16", 0.0, False),
    ("flagship", 2, 3000, "bfloat16", 0.05, False),
    ("flagship", 2, 3000, "bfloat16", 0.0, True),
    ("flagship", 8, 10240, "float32", 0.0, False),
    ("flagship", 8, 10240, "bfloat16", 0.0, False),
    # the quality net's widths and batch (12 layers, 64/128/64, cin 40;
    # synthetic_e2e.make_config), at its dropout 0.05 and mulaw256's 0.0
    ("quality", 8, 4096, "float32", 0.0, False),
    ("quality", 8, 4096, "float32", 0.05, False),
    ("quality", 8, 4096, "bfloat16", 0.0, False),
    ("quality", 8, 4096, "bfloat16", 0.05, False)]
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


def _quality_model(device, seed):
    """The quality net's mol model (scripts/synthetic_e2e.make_config), its
    weights from ``seed``."""
    import torch

    from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
    from wavenet_vocoder_tpu_torch.scripts.synthetic_e2e import make_config
    model = WaveNet(spec_from_config(make_config("mol")),
                    generator=torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _equal(a, b):
    """Both absent, or the same shape and bits."""
    import torch
    return (a is None and b is None) or (
        a is not None and b is not None and torch.equal(a, b))


def phase_train_kernel(report):
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    models = {"flagship": _flagship_model("cuda", 11)[1],
              "quality": _quality_model("cuda", 11)}
    rows, failures = [], []
    for i, (mname, B, T, dname, drop, glob) in enumerate(TRAIN_ROWS):
        model = models[mname]
        spec = model.spec
        dtype = getattr(torch, dname)
        inputs, dskips = _stack_case(model, B, T, dtype, glob, seed=20 + i)
        kw = dict(dils=spec.dilations, k=spec.kernel_size, drop=drop,
                  seed=-777 + i)
        with torch.no_grad():
            skips, xs = ct.train_fwd(*inputs, **kw)
            skips_p, xs_p = ft.fused_res_stack_fwd_plain(*inputs, **kw)
            torch.cuda.synchronize()
            outs = [_compare("skips", skips, skips_p, TRAIN_TOL[dname])]
            del skips, xs, skips_p
            _, c, gb, w_in, b_in, w_cond, w_og, b_og = inputs
            args = (dskips, xs_p, c, gb, w_in, b_in, w_cond, w_og, b_og)
            got = ct.train_bwd(*args, **kw)
            again = ct.train_bwd(*args, **kw)
            want = ft.fused_res_stack_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
        unequal = [n for n, a, b in zip(GRAD_NAMES, got, again)
                   if not _equal(a, b)]
        for name, a, b in zip(GRAD_NAMES, got, want):
            if b is not None:
                outs.append(_compare(name, a, b, TRAIN_TOL[dname]))
        del got, again, want, args, xs_p, inputs
        torch.cuda.empty_cache()
        row = dict(model=mname, B=B, T=T, dtype=dname, dropout=drop, gb=glob,
                   tol=TRAIN_TOL[dname], outputs=outs,
                   repeat_bitwise=not unequal)
        rows.append(row)
        line = (f"[train-kernel] {mname} B={B} T={T} {dname} drop={drop} "
                f"gb={'yes' if glob else 'no'} tol {TRAIN_TOL[dname]}: "
                + ", ".join(f"{o['name']} {o['rel']:.2e}"
                            + (f" ({o['flips']} flips)" if dname == "bfloat16"
                               else "") for o in outs)
                + "; two backward launches bitwise equal: "
                + ("all eight" if not unequal else f"NOT {unequal}"))
        print(line, flush=True)
        failures += [f"{o['name']}: {line}" for o in outs if not o["ok"]]
        failures += [f"{n} does not repeat: {line}" for n in unequal]
    report["train_kernel_vs_plain"] = rows
    path = {r["dtype"]: r for r in rows
            if r["model"] == "flagship" and r["B"] == 8}
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
    """The bench's training batch (the root bench.py's), numpy from seed 0."""
    from wavenet_vocoder_tpu_torch.bench import train_batch
    return train_batch(cfg, B)


def _plain_stack():
    """The fused stack's plain versions in place of the kernels, for a
    CUDA tensor too (for these comparisons only; the quality spread's arm
    "fused-plain")."""
    from wavenet_vocoder_tpu_torch.scripts.quality_spread import plain_stack
    return plain_stack()


def leaf_grad_errors(model, ref_model):
    """max |grad - ref grad| / max |ref grad| for every parameter of
    ``model``. No scale is taken below 1e-6 of the largest of all leaves:
    first_conv.weight_v (one input channel) has a gradient that weight
    norm's projection makes 0 up to rounding, ~1e-9 of the largest, whose
    noise differs between any two runs."""
    return grad_errors({n: p.grad for n, p in model.named_parameters()},
                       {n: p.grad for n, p in ref_model.named_parameters()})


def grad_scale_floor(ref):
    """1e-6 of the largest of the gradients ``ref`` (name -> tensor)."""
    return 1e-6 * max(float(g.abs().max()) for g in ref.values())


def grad_errors(grads, ref):
    """leaf_grad_errors on gradients by name."""
    floor = grad_scale_floor(ref)
    out = {}
    for name, r in ref.items():
        err = float((grads[name].float() - r.float()).abs().max())
        out[name] = (err / max(float(r.abs().max()), floor)
                     if math.isfinite(err) else float("inf"))
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


REPEAT_STEPS, REPEAT_DROP = 2, 0.05


def _state_tensors(state):
    """Every tensor a train state carries: parameters, optimizer state, EMA."""
    import torch
    out = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt {i} {k}": v for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    out.update({f"ema {n}": v for n, v in (state.ema or {}).items()})
    return out


def _repeat_steps(cfg, batch):
    """REPEAT_STEPS train steps twice from one state, batch and generator
    seed: the names of the losses and state tensors that differ in any bit
    (none, on a repeatable step), and the number compared."""
    import copy

    import torch

    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    start = create_train_state(cfg)
    train_step, _ = make_train_step(cfg)
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, model=copy.deepcopy(start.model))
        gen = torch.Generator().manual_seed(5)
        losses = torch.stack([train_step(state, batch, gen)["loss"]
                              for _ in range(REPEAT_STEPS)])
        runs.append(dict(_state_tensors(state), loss=losses))
    a, b = runs
    return [k for k in a if not _equal(a[k], b[k])], len(a)


def _nondeterministic_ops(cfg, batch):
    """The warnings of one train step under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the ops
    torch knows no deterministic form of (a check only; the main path
    never sets the flag)."""
    import warnings

    import torch

    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    state = create_train_state(cfg)
    train_step, _ = make_train_step(cfg)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train_step(state, batch, torch.Generator().manual_seed(5))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0][:160] for w in caught
                   if "deterministic" in str(w.message)})


def phase_training(report):
    import dataclasses

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

    wrappers = {"wn_train_fwd": "train_fwd", "wn_train_bwd": "train_bwd"}
    _set_launches({k: 0 for k in TRAIN_COUNTERS})
    losses = []
    for _ in range(TRAIN_STEPS):
        losses.append(float(train_step(state, batch)["loss"]))
    launches = {n: _launches(w + ".launches") for n, w in wrappers.items()}
    tc_launches = {n: _launches(w + ".tc_launches")
                   for n, w in wrappers.items()}
    L = state.model.spec.layers
    expected = {"wn_train_fwd": L * TRAIN_STEPS,
                "wn_train_bwd": ct.BWD_LAUNCHES_PER_LAYER * L * TRAIN_STEPS}
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
    # repeatability: each training path twice from one state, batch and
    # generator (dropout on, so the mask and the generator take part)
    repeat, ops = {}, {}
    for path, fused in (("kernels", True), ("layer loop", False)):
        rcfg = dataclasses.replace(cfg, fused_train=fused, dropout=REPEAT_DROP)
        differ, n = _repeat_steps(rcfg, batch)
        ops[path] = _nondeterministic_ops(rcfg, batch)
        repeat[path] = dict(differ=differ, compared=n, warned_ops=ops[path])
        torch.cuda.empty_cache()
        print(f"[training] repeat, {path}: B={B} bf16 dropout {REPEAT_DROP},"
              f" {REPEAT_STEPS} steps twice from one state, batch and "
              f"generator: loss, {n - 1} parameter, optimizer and EMA "
              f"tensors bitwise equal: "
              + ("all" if not differ else f"NOT {differ[:6]} "
                 f"({len(differ)} differ)")
              + f"; under use_deterministic_algorithms(warn_only) the step "
              f"warns of {ops[path] or 'no op'}", flush=True)
    report["training"]["repeat"] = repeat
    bad = {p: r["differ"] for p, r in repeat.items() if r["differ"]}
    if bad:
        fail(f"training steps are not repeatable: {bad}")
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
        t_ops, t_bytes = flops / peak("bf16"), nbytes[name] / peak("hbm")
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


def _profile_step(step):
    """Device time of one call of ``step()`` by kernel, from a
    torch.profiler trace: (groups {name: ms}, busy ms, step ms by CUDA
    events), or None when the profiler records no device activity. Busy
    time is the union of the device's activity intervals (a prefetch copies
    on a second stream, under the kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
    groups, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((k for k in TRAIN_KERNEL_NAMES if k in e.name),
                    e.name[:60])
        groups[name] = groups.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    if not groups:
        return None
    busy, last = 0.0, None
    for a, b in sorted(spans):
        if last is None or a > last:
            busy += b - a
            last = b
        elif b > last:
            busy += b - last
            last = b
    return groups, busy / 1e3, start.elapsed_time(end)


def phase_train_timing(report, state, train_step):
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    cfg = Config(fused_train=True)
    T = cfg.max_time_steps
    saved = {k: _launches(k) for k in TRAIN_COUNTERS}
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
            prof = _profile_step(lambda: train_step(state, batch))
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
    _set_launches(saved)
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
    t_ops, t_bytes = flops / peak("fp32"), nbytes / peak("hbm")
    fp32_ms = max(2.0 * frames * (2 * n_fft * n_bins + n_bins * n_mels)
                  / peak("fp32"),
                  4 * (io + 2 * n_fft * n_bins + n_bins * n_mels)
                  / peak("hbm")) * 1e3
    tf32_ms = max(3 * 2.0 * frames * 2 * n_fft * used / peak("tf32")
                  + 2.0 * frames * used * n_mels / peak("fp32"),
                  4 * (io + 4 * n_fft * used + used * n_mels)
                  / peak("hbm")) * 1e3
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


@contextlib.contextmanager
def _work_dir(name):
    """build/<name> under the checkout, emptied first and kept after."""
    import os
    import shutil
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    yield work


def _read_wav(path):
    from scipy.io import wavfile
    return wavfile.read(path)[1].astype("float32") / 32768.0


def phase_evaluation(report):
    import os

    import numpy as np
    import torch
    from scipy.io import wavfile

    from wavenet_vocoder_tpu_torch.cli import evaluate, preprocess, synthesis
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.dsp import audio
    from wavenet_vocoder_tpu_torch.dsp import mel_torch as mt
    from wavenet_vocoder_tpu_torch.synthesis import Synthesizer
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state)
    cfg = Config()
    sr, hop = cfg.sample_rate, cfg.hop_size
    _set_launches({"generate.launches": 0})
    _set_launches({"mel.launches": 0})
    t_phase = time.perf_counter()
    # under build/, kept after the phase: phase 12 evaluates its dump again
    with _work_dir("chip_smoke_eval") as tmp:
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
        launches_eval = _launches("generate.launches")
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
        launches = dict(wn_logmel=_launches("mel.launches"),
                        wn_generate=_launches("generate.launches"))
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
        plain_err=plain_err, total_s=time.perf_counter() - t_phase,
        dump=dump, checkpoint=path)
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
    before = _launches("generate.launches")
    t0 = time.perf_counter()
    streamed = _feed_all(stream, mel, STREAM_FEED)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = _launches("generate.launches") - before

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


# ----------------------------------------------------------------------
# phase 11: training from a dump on disk
# ----------------------------------------------------------------------
LOOP_STEPS = 30
LOOP_UTTS = {"train_no_dev": (48, 0), "dev": (8, 1)}   # (utterances, seed)
LOOP_REL_TOL = 1e-5
LOOP_TIMEOUT_S = 600


def _run_cli(args, tag):
    """``python -m`` a CLI of the port from the repo root; its output, or
    the phase fails with the end of it."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m"] + args, cwd=root, env=env,
                          capture_output=True, text=True,
                          timeout=LOOP_TIMEOUT_S)
    if proc.returncode != 0:
        fail(f"{tag} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-3000:]}")
    return proc.stdout


def _forever(loader):
    while True:
        yield from loader


def _loop_steps(train_step, state, batches, n, gen):
    """n steps fed from ``batches``; (ms of each step after the first, from
    CUDA events recorded after consecutive steps, so waits on the host
    count; the losses as floats, fetched at the end)."""
    import torch
    events, losses = [], []
    for _ in range(n):
        m = train_step(state, next(batches), gen)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return ms, [float(v) for v in losses]


def _read_metrics(path):
    out = {}
    with open(path) as f:
        for line in f:
            m = json.loads(line)
            out.setdefault(m["tag"], {})[m["step"]] = m["value"]
    return out


def phase_loop(report):
    import os
    import shutil

    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.bench import _make_synthetic_dump
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.data.prefetch import prefetch_to_device
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.loop import get_data_loaders
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    t_phase = time.perf_counter()
    cfg = Config(fused_train=True, checkpoint_interval=15,
                 train_eval_interval=LOOP_STEPS, test_eval_epoch_interval=1)
    B, T, L = cfg.batch_size, cfg.max_time_steps, cfg.layers
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_loop")
    shutil.rmtree(work, ignore_errors=True)
    dump, exp = os.path.join(work, "dump"), os.path.join(work, "exp")
    for split, (n, seed) in LOOP_UTTS.items():
        _make_synthetic_dump(os.path.join(dump, split), cfg, n, seed)
    preset = os.path.join(work, "preset.json")
    with open(preset, "w") as f:
        f.write(cfg.to_json())

    # the CLI, as a user runs it
    t0 = time.perf_counter()
    out = _run_cli(["wavenet_vocoder_tpu_torch.cli.train", "--dump-root", dump,
                    "--checkpoint-dir", exp, "--preset", preset,
                    "--max-train-steps", str(LOOP_STEPS)], "cli.train")
    cli_s = time.perf_counter() - t0
    line = [x for x in out.splitlines() if x.startswith("[train] trace ")]
    if not line:
        fail("cli.train printed no trace line:\n" + out[-2000:])
    trace = json.loads(line[-1][len("[train] trace "):])
    c = trace["counters"]
    counts = {n: {k: c.get(f"{n}.{k}", 0) for k in
                  ("launches", "tc_launches", "fma_launches")}
              for n in ("train_fwd", "train_bwd", "generate")}
    metrics = _read_metrics(os.path.join(exp, "log", "metrics.jsonl"))
    logged = [metrics["train/loss"][k] for k in sorted(metrics["train/loss"])]
    n_dev = len(metrics.get("dev/loss", {}))
    # forwards: the train steps, the dev batches, one teacher-forced pass
    want = {"train_fwd": L * (LOOP_STEPS + n_dev + 1),
            "train_bwd": ct.BWD_LAUNCHES_PER_LAYER * L * LOOP_STEPS}
    tail = logged[1:][-5:]
    print(f"[loop] cli.train, {LOOP_STEPS} steps from the dump in "
          f"{cli_s:.1f} s: logged losses (steps "
          f"{sorted(metrics['train/loss'])}) "
          + " ".join(f"{v:.4f}" for v in logged)
          + f"; {n_dev} dev batches; launches {counts} (expected "
          f"tensor-core {want}, FMA 0)", flush=True)
    if not np.isfinite(logged).all() or not np.mean(tail) < logged[0]:
        fail(f"cli.train losses not finite or not falling: {logged}")
    for name, n in want.items():
        c = counts[name]
        if c["tc_launches"] != n or c["launches"] != n or c["fma_launches"]:
            fail(f"{name}: {c}, expected {n} tensor-core launches and no "
                 "FMA launch")
    if counts["generate"]["launches"] <= 0:
        fail("the eval audio did not launch the generation kernel")
    print("[loop] cli.train spans (count, mean ms): "
          + ", ".join(f"{k} {v['count']} {v['mean_ms']:.3f}"
                      for k, v in trace["spans"].items()), flush=True)
    report["loop_spans"] = trace["spans"]
    for step in (15, LOOP_STEPS):
        for ema in (False, True):
            if not os.path.exists(ckpt.checkpoint_path(exp, step, ema=ema)):
                fail(f"missing {ckpt.checkpoint_path(exp, step, ema=ema)}")
    if not os.path.exists(os.path.join(exp, "hparams.json")):
        fail("no hparams.json beside the checkpoints")
    inter = os.path.join(exp, "intermediate")
    dev_steps = sorted({int(f[4:13]) for f in os.listdir(
        os.path.join(inter, "dev_eval")) if f.endswith("_predicted.wav")})
    wavs = [("train_no_dev_eval", LOOP_STEPS)] + [("dev_eval", s)
                                                  for s in dev_steps]
    for sub, step in wavs:
        for kind in ("predicted", "target"):
            w = _read_wav(os.path.join(inter, sub,
                                       f"step{step:09d}_{kind}.wav"))
            if len(w) != T or not np.isfinite(w).all():
                fail(f"{sub} step {step} {kind}: {len(w)} samples, "
                     f"expected {T}")
    if not dev_steps:
        fail("no dev-phase eval audio")

    # the step-30 checkpoint: loads, and synthesises through the CLI
    path = ckpt.checkpoint_path(exp, LOOP_STEPS, ema=True)
    model, counters = ckpt.load_model(path, spec_from_config(cfg))
    if counters["global_step"] != LOOP_STEPS:
        fail(f"checkpoint counters {counters}")
    del model
    mel = os.path.join(dump, "dev", "synth0000-feats.npy")
    dst = os.path.join(work, "synth.wav")
    t0 = time.perf_counter()
    _run_cli(["wavenet_vocoder_tpu_torch.cli.synthesis", path, dst,
              "--conditional", mel, "--engine", "auto"], "cli.synthesis")
    synth_s = time.perf_counter() - t0
    w = _read_wav(dst)
    frames = np.load(mel).shape[0]
    print(f"[loop] step-{LOOP_STEPS} checkpoint loads; cli.synthesis "
          f"--engine auto: {len(w)} samples ({frames} frames) in "
          f"{synth_s:.1f} s, std {w.std():.3f}", flush=True)
    if len(w) != frames * cfg.hop_size or not np.isfinite(w).all():
        fail(f"cli.synthesis from the loop's checkpoint: {len(w)} samples")

    # in process: step times with and without prefetch, the idle share
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = create_train_state(cfg)
    train_step, _ = make_train_step(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    loader = get_data_loaders(dump, cfg)["train_no_dev"]
    feeds = {"prefetch": lambda: prefetch_to_device(_forever(loader),
                                                    depth=2),
             "no_prefetch": lambda: _forever(loader)}
    runs = {name: [] for name in feeds}
    # in turns, so that drift over the runs falls on both
    for name in ("prefetch", "no_prefetch", "no_prefetch", "prefetch"):
        ms, losses = _loop_steps(train_step, state, feeds[name](), LOOP_STEPS,
                                 gen)
        if not np.isfinite(losses).all():
            fail(f"{name} run: losses not finite")
        runs[name].append(dict(step_ms=ms, losses=losses))
    times, profiles = {}, {}
    for name, feed in feeds.items():
        # ms[k] is step k+2's time: steps 5-30 are ms[3:]
        steady = [t for r in runs[name] for t in r["step_ms"][3:]]
        times[name] = dict(runs=runs[name], median_ms=float(np.median(steady)),
                           min_ms=min(steady), max_ms=max(steady))
        batches = feed()
        next(batches)   # the loader (and the prefetch queue) under way
        prof = _profile_step(lambda: train_step(state, next(batches), gen))
        profiles[name] = None if prof is None else dict(
            kernels_ms=prof[0], busy_ms=prof[1], step_ms=prof[2],
            idle=1.0 - prof[1] / prof[2])
        del batches
    synth7 = report["train_timing"]["steps"][B]["median_ms"]
    gpu = gpu_name_and_limit()
    prof_txt = "; ".join(
        f"{name} {p['step_ms']:.1f} ms, device busy {p['busy_ms']:.1f} ms "
        f"(idle {p['idle']:.1%})" if p is not None
        else f"{name}: no device activity recorded"
        for name, p in profiles.items())
    print(f"[loop-time] {gpu}: B={B} T={T} bf16 loop step median (steps "
          f"5-{LOOP_STEPS} of two runs each, in turns) with "
          f"prefetch_to_device(depth=2) {times['prefetch']['median_ms']:.1f} "
          f"ms (min {times['prefetch']['min_ms']:.1f}, max "
          f"{times['prefetch']['max_ms']:.1f}), loader straight into "
          f"train_step {times['no_prefetch']['median_ms']:.1f} ms (min "
          f"{times['no_prefetch']['min_ms']:.1f}, max "
          f"{times['no_prefetch']['max_ms']:.1f}), phase 7 synthetic batch "
          f"{synth7:.1f} ms; one profiled loop step: {prof_txt}", flush=True)
    del state, train_step
    torch.cuda.empty_cache()

    # stream ordering: f32, dropout 0, from the step-30 checkpoint, the
    # first 3 losses with and without prefetch
    # (one loader thread: with more, the crop draws of the two runs could
    # come in another order)
    cfg32 = cfg.replace(compute_dtype="", dropout=0.0, num_workers=1)
    step32, _ = make_train_step(cfg32)
    first = {}
    for name, feed in (("prefetch", lambda ld: prefetch_to_device(
            _forever(ld), depth=2)), ("no_prefetch", _forever)):
        st = create_train_state(cfg32)
        ckpt.load_checkpoint(ckpt.checkpoint_path(exp, LOOP_STEPS), st)
        ld = get_data_loaders(dump, cfg32)["train_no_dev"]
        first[name] = _loop_steps(step32, st, feed(ld), 3, None)[1]
        del st
    rel = max(abs(a - b) / abs(b) for a, b in zip(first["prefetch"],
                                                  first["no_prefetch"]))
    print(f"[loop] f32 from the step-{LOOP_STEPS} checkpoint, first 3 "
          f"losses with prefetch {first['prefetch']} and without "
          f"{first['no_prefetch']}: max rel {rel:.2e} (tol {LOOP_REL_TOL})",
          flush=True)
    if not rel <= LOOP_REL_TOL:
        fail("prefetch and no-prefetch losses disagree")
    torch.cuda.empty_cache()
    report["loop"] = dict(
        cli_s=cli_s, logged_losses=logged, n_dev=n_dev, launches=counts,
        expected=want, dev_eval_steps=dev_steps, synth_s=synth_s,
        times=times, synthetic_step_ms=synth7, gpu=gpu, profiles=profiles,
        f32_first_losses=first, f32_rel=rel,
        total_s=time.perf_counter() - t_phase)
    return counts


# ----------------------------------------------------------------------
# phase 12: multi-device
# ----------------------------------------------------------------------
# (a) the training kernels with the dropout key's row offset
MD_KERNEL_B, MD_KERNEL_T, MD_B0, MD_DROP = 4, 3000, 4, 0.05
# (b) two ranks on the card: rows of a global batch of 8, unequal lengths
MD_RANKS, MD_STEPS, MD_SEED = 2, 3, 4242
MD_LENGTHS = (10240, 9001, 10240, 7777, 10240, 8888, 10240, 6666)
# (c) cli.train --distributed at world size 1
MD_NCCL_STEPS = 10
# (d) utterance-sharded synthesis: two shards of 16 streams on one card
MD_SYNTH_B, MD_SYNTH_SEED = 32, 99
# (e) cli.evaluate over two processes, batches of 4 (as the one process)
MD_EVAL_BATCH = 4
MD_TIMEOUT_S = 240
_PORT_KERNELS = ("train_fwd", "train_bwd", "generate")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


TRAIN_COUNTERS = tuple(f"{n}.{k}" for n in ("train_fwd", "train_bwd")
                       for k in ("launches", "tc_launches", "fma_launches"))


def _launches(name: str) -> int:
    """A launch counter of the port's tracing store
    (``utils.profiling.counters``), e.g. ``generate.launches``."""
    from wavenet_vocoder_tpu_torch.utils import profiling
    return profiling.counters().get(name, 0)


def _set_launches(values: dict) -> None:
    """Set the store's counters named in ``values`` to their values: a
    phase takes its timing launches back out of the path's counts."""
    from wavenet_vocoder_tpu_torch.utils import profiling
    now = profiling.counters()
    for name, v in values.items():
        profiling.count(name, v - now.get(name, 0))


def kernel_counts():
    """Every kernel wrapper's launch counters of the port, by name."""
    out = {n: {k: _launches(f"{n}.{k}")
               for k in ("launches", "tc_launches", "fma_launches")}
           for n in ("train_fwd", "train_bwd")}
    out["generate"] = dict(launches=_launches("generate.launches"))
    out["logmel"] = dict(launches=_launches("mel.launches"))
    return out


def zero_kernel_counts():
    _set_launches(dict({k: 0 for k in TRAIN_COUNTERS},
                       **{"generate.launches": 0, "mel.launches": 0}))


def _add_counts(total, counts):
    for name in _PORT_KERNELS:
        for k, v in counts.get(name, {}).items():
            total[name][k] = total[name].get(k, 0) + v


def _self_cmd(*args):
    return [sys.executable, os.path.abspath(__file__)] + list(args)


def _spawn(cmds, tag, env=None):
    """Run processes of this script together; their outputs, or the phase
    fails: when one exits with an error (the others are stopped at once,
    rather than left waiting on a collective) or passes MD_TIMEOUT_S."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(env or os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    logs = [tempfile.TemporaryFile("w+") for _ in cmds]
    procs = [subprocess.Popen(c, cwd=root, env=env, stdout=log,
                              stderr=subprocess.STDOUT, text=True)
             for c, log in zip(cmds, logs)]
    deadline = time.perf_counter() + MD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            fail(f"{tag} exited {p.returncode} (killed past {MD_TIMEOUT_S} s "
                 f"or beside a failed process if negative):\n{out[-3000:]}")
    return outs


def _launch_line(out, tag):
    line = [x for x in out.splitlines()
            if x.startswith("[run-module] kernel launches ")]
    if not line:
        fail(f"{tag}: no kernel launch line:\n{out[-2000:]}")
    return json.loads(line[-1][len("[run-module] kernel launches "):])


def run_module(argv):
    """``--run-module [-m] MOD ARGS``: run a CLI module of the port as
    ``python -m`` would, print its kernel launches, and exit 4 if it
    imported JAX."""
    import runpy
    if argv and argv[0] == "-m":        # as a stand-in for ``python``
        argv = argv[1:]
    sys.argv = list(argv)
    code = 0
    try:
        runpy.run_module(argv[0], run_name="__main__", alter_sys=True)
    except SystemExit as e:     # the module's exit code, after the counts
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    print("[run-module] kernel launches " + json.dumps(kernel_counts()),
          flush=True)
    if "jax" in sys.modules or "wavenet_vocoder_tpu" in sys.modules:
        print("chip_smoke: the port pulled in JAX", file=sys.stderr)
        return 4
    return code


def md_batch(cfg):
    """phase 6's batch (bench.py's) at B=8, with unequal valid lengths."""
    import numpy as np
    b = train_batch(cfg, 8)
    b["input_lengths"] = np.asarray(MD_LENGTHS, np.int32)
    return b


def md_steps(group, rank, world, out_dir, tag):
    """MD_STEPS bf16 train steps of the flagship (fused, dropout 0.05) on
    this rank's rows of md_batch, every rank drawing the same dropout seed
    per step; writes the initial parameters, the first step's gradients and
    the final parameters to out_dir and returns the losses, norms and
    launches."""
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.parallel import replicate_global
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(fused_train=True, dropout=MD_DROP)
    state = create_train_state(cfg)
    if group is not None:
        replicate_global(state)     # rank 0's state on every rank
    step, _ = make_train_step(cfg, group=group)
    params = lambda: {k: p.detach().cpu() for k, p in
                      state.model.named_parameters()}
    torch.save(params(), os.path.join(out_dir, f"{tag}.init.pt"))
    batch = md_batch(cfg)
    n = len(batch["x"]) // world
    local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    counted = lambda: {n_: [_launches(n_ + ".launches"),
                            _launches(n_ + ".tc_launches")]
                       for n_ in ("train_fwd", "train_bwd")}
    before = counted()
    losses, norms = [], []
    for i in range(MD_STEPS):
        m = step(state, local, torch.Generator().manual_seed(MD_SEED + i))
        if i == 0:
            torch.save({k: p.grad.detach().cpu() for k, p in
                        state.model.named_parameters()},
                       os.path.join(out_dir, f"{tag}.grads.pt"))
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    torch.save(params(), os.path.join(out_dir, f"{tag}.params.pt"))
    launched = {n_: [a - b for a, b in zip(now, before[n_])]
                for n_, now in counted().items()}
    return dict(losses=[float(v) for v in losses],
                grad_norms=[float(v) for v in norms], launched=launched,
                L=state.model.spec.layers, T=cfg.max_time_steps)


def md_rank_worker(rank, port, out_dir):
    """One of phase 12 (b)'s ranks: gloo on cuda:0 beside the other."""
    import torch.distributed as dist

    from wavenet_vocoder_tpu_torch.parallel import initialize_distributed
    initialize_distributed(f"127.0.0.1:{port}", MD_RANKS, rank,
                           local_device_ids="0", backend="gloo",
                           timeout_s=MD_TIMEOUT_S)
    res = md_steps(dist.group.WORLD, rank, MD_RANKS, out_dir, f"rank{rank}")
    res["jax_loaded"] = ("jax" in sys.modules
                         or "wavenet_vocoder_tpu" in sys.modules)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _md_kernels(report):
    """(a): the training kernels at b0 against their plain versions at b0,
    and against rows b0.. of a launch over all 8 rows at b0=0."""
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    from wavenet_vocoder_tpu_torch.ops import fused_train as ft
    _, model = _flagship_model("cuda", 12)
    spec = model.spec
    B, T, b0 = MD_KERNEL_B, MD_KERNEL_T, MD_B0
    rows_out, failures = [], []
    for i, dname in enumerate(("bfloat16", "float32")):
        dtype, tol = getattr(torch, dname), TRAIN_TOL[dname]
        inputs, dskips = _stack_case(model, B + b0, T, dtype, False,
                                     seed=60 + i)
        x0, c, gb, w_in, b_in, w_cond, w_og, b_og = inputs
        rows = slice(b0, b0 + B)
        part = (x0[rows].contiguous(), c[rows].contiguous(), None, w_in,
                b_in, w_cond, w_og, b_og)
        kw = dict(dils=spec.dilations, k=spec.kernel_size, drop=MD_DROP,
                  seed=-4242 + i)
        with torch.no_grad():
            skips, _ = ct.train_fwd(*part, **kw, b0=b0)
            skips_p, xs_p = ft.fused_res_stack_fwd_plain(*part, **kw, b0=b0)
            skips_all, xs_all = ct.train_fwd(*inputs, **kw)
            args = (dskips[rows].contiguous(), xs_p, part[1], None, w_in,
                    b_in, w_cond, w_og, b_og)
            got = ct.train_bwd(*args, **kw, b0=b0)
            want = ft.fused_res_stack_bwd_plain(*args, **kw, b0=b0)
            got_all = ct.train_bwd(dskips, xs_all, c, None, w_in, b_in,
                                   w_cond, w_og, b_og, **kw)
            torch.cuda.synchronize()
        outs = [_compare("skips", skips, skips_p, tol)]
        outs += [_compare(n, a, b, tol) for n, a, b in
                 zip(GRAD_NAMES, got, want) if b is not None]
        rows8 = [_compare("skips vs rows of B=8", skips, skips_all[rows], tol),
                 _compare("dx0 vs rows of B=8", got[0], got_all[0][rows], tol),
                 _compare("dc vs rows of B=8", got[1], got_all[1][rows], tol)]
        line = (f"[multi-device] (a) {dname} B={B} T={T} dropout {MD_DROP} "
                f"b0={b0}, tol {tol}: kernel vs plain "
                + ", ".join(f"{o['name']} {o['rel']:.2e}" for o in outs)
                + "; kernel at b0 vs rows " + f"{b0}..{b0 + B - 1} of a B="
                f"{B + b0} b0=0 launch: "
                + ", ".join(f"{o['name'].split()[0]} {o['rel']:.2e}"
                            for o in rows8))
        print(line, flush=True)
        failures += [f"{o['name']}: {line}" for o in outs + rows8
                     if not o["ok"]]
        rows_out.append(dict(dtype=dname, tol=tol, vs_plain=outs,
                             vs_rows=rows8))
        del inputs, dskips, got, want, got_all, xs_all, xs_p
        torch.cuda.empty_cache()
    report["kernels_b0"] = rows_out
    if failures:
        fail("the training kernels at a row offset disagree:\n"
             + "\n".join(failures))


def _md_ranks(report, work, total):
    """(b): two gloo ranks on the card against one process at B=8."""
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    port = _free_port()
    t0 = time.perf_counter()
    _spawn([_self_cmd("--md-rank", str(r), "--md-port", str(port),
                      "--md-dir", work) for r in range(MD_RANKS)],
           "phase 12 (b) ranks")
    ranks_s = time.perf_counter() - t0
    res = [json.load(open(os.path.join(work, f"rank{r}.json")))
           for r in range(MD_RANKS)]
    single = md_steps(None, 0, 1, work, "single")
    for r in res:
        _add_counts(total, {k: dict(launches=v[0], tc_launches=v[1])
                            for k, v in r["launched"].items()})
    load = lambda tag, kind: torch.load(os.path.join(work,
                                                     f"{tag}.{kind}.pt"))
    p0, p1, ps = (load(t, "params") for t in ("rank0", "rank1", "single"))
    unequal = [k for k in p0 if not torch.equal(p0[k], p1[k])]
    g0, gs = load("rank0", "grads"), load("single", "grads")
    # phase 6's leaf measure on the first step's (all-reduced) gradients
    gscale = {n: float(g.abs().max()) for n, g in gs.items()}
    floor = 1e-6 * max(gscale.values())
    grad_rel = {n: float((g0[n] - g).abs().max()) / max(gscale[n], floor)
                for n, g in gs.items()}
    # every parameter is held by its gradient from one state (above, phase
    # 6's measure). What the parameters drifted apart after MD_STEPS steps
    # is printed, not held: Adam divides each gradient by its own size, so
    # the bf16 noise of small gradients moves elements by up to ~0.2 lr
    # (8-21% of some leaves' update, run to run), and a leaf whose gradient
    # is below the floor (the last layer's unused residual output;
    # first_conv.weight_v, whose gradient weight norm projects out) moves by
    # Adam's reading of rounding noise alone
    p_init = load("single", "init")
    noise = sorted(n for n in ps if gscale[n] < floor)
    update_rel = {n: float((p0[n] - p).norm())
                  / max(float((p - p_init[n]).norm()), 1e-30)
                  for n, p in ps.items() if n not in noise}
    param_rel = {n: float((p0[n] - p).abs().max())
                 / max(float(p.abs().max()), 1e-30) for n, p in ps.items()}
    tol = STEP_TOL["bfloat16"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(res[0]["losses"],
                                                    single["losses"])]
    norm_rel = [abs(a - b) / abs(b) for a, b in zip(res[0]["grad_norms"],
                                                    single["grad_norms"])]
    L = single["L"]
    want = {"train_fwd": [L * MD_STEPS] * 2,
            "train_bwd": [ct.BWD_LAUNCHES_PER_LAYER * L * MD_STEPS] * 2}
    worst_g = max(grad_rel.items(), key=lambda kv: kv[1])
    top_u = sorted(update_rel.items(), key=lambda kv: -kv[1])[:4]
    worst_u = top_u[0]
    worst_p = max(param_rel.items(), key=lambda kv: kv[1])
    print(f"[multi-device] (b) {MD_RANKS} gloo ranks on cuda:0, 4 rows each "
          f"of B=8 T={single['T']} (lengths {list(MD_LENGTHS)}), bf16, "
          f"dropout {MD_DROP}, {MD_STEPS} steps in {ranks_s:.1f} s: losses "
          f"{[round(v, 6) for v in res[0]['losses']]} (one process "
          f"{[round(v, 6) for v in single['losses']]}, rel "
          f"{max(loss_rel):.2e}, tol {tol['loss']}); grad norm rel by step "
          f"{[f'{v:.2e}' for v in norm_rel]} (tol {tol['grad_norm']} at step "
          f"1, from one state; x10 after, at weights that carry the earlier "
          f"updates' bf16 noise); step-1 gradients "
          f"worst leaf {worst_g[0]} {worst_g[1]:.2e} (tol {tol['leaf']}); "
          f"parameters after {MD_STEPS} steps (not held), |diff| / |update| "
          f"(L2) worst " + ", ".join(f"{n} {v:.2e}" for n, v in top_u)
          + f" (gradient below the floor: {noise}), max "
          f"|diff| / max |p| worst {worst_p[0]} {worst_p[1]:.2e}; ranks' "
          f"parameters bitwise equal: "
          f"{not unequal} ({len(p0)} tensors); launches rank0 "
          f"{res[0]['launched']} rank1 {res[1]['launched']} one process "
          f"{single['launched']} ([all, tensor-core], expected {want} per "
          f"run at half or whole batch)", flush=True)
    if any(r["jax_loaded"] for r in res):
        fail("a rank imported JAX")
    if unequal:
        fail(f"the ranks' parameters differ: {unequal[:5]}")
    for r in res + [single]:
        if r["launched"] != want:
            fail(f"launches {r['launched']}, expected all on the tensor "
                 f"cores {want}")
    if not (max(loss_rel) <= tol["loss"] and norm_rel[0] <= tol["grad_norm"]
            and max(norm_rel) <= 10 * tol["grad_norm"]
            and worst_g[1] <= tol["leaf"]):
        fail("two ranks disagree with one process beyond STEP_TOL")
    return dict(losses=res[0]["losses"], single_losses=single["losses"],
                loss_rel=max(loss_rel), grad_norm_rel=norm_rel,
                worst_grad_leaf=worst_g, worst_update_leaf=worst_u,
                worst_param_leaf=worst_p,
                ranks_equal=not unequal, launched=[r["launched"] for r in res],
                single_launched=single["launched"], ranks_s=ranks_s)


def _md_nccl(report, work, total):
    """(c): cli.train --distributed through NCCL at world size 1, torchrun's
    variables in its environment, on phase 11's dump."""
    import numpy as np

    from wavenet_vocoder_tpu_torch.config import load_config
    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    loop = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_loop")
    dump, preset = os.path.join(loop, "dump"), os.path.join(loop,
                                                            "preset.json")
    exp = os.path.join(work, "exp_nccl")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="1", RANK="0",
               LOCAL_RANK="0")
    t0 = time.perf_counter()
    out = _spawn([_self_cmd(
        "--run-module", "wavenet_vocoder_tpu_torch.cli.train", "--distributed",
        "--dump-root", dump, "--checkpoint-dir", exp, "--preset", preset,
        "--max-train-steps", str(MD_NCCL_STEPS))], "phase 12 (c) cli.train",
        env=env)[0]
    cli_s = time.perf_counter() - t0
    counts = _launch_line(out, "phase 12 (c)")
    _add_counts(total, counts)
    metrics = _read_metrics(os.path.join(exp, "log", "metrics.jsonl"))
    losses = [metrics["train/loss"][k] for k in sorted(metrics["train/loss"])]
    step_ms = 1e3 * metrics["train/step_time_s"][MD_NCCL_STEPS]
    _, counters = ckpt.load_params(ckpt.latest_path(exp),
                                   spec_from_config(load_config(preset)))
    synth7 = report["train_timing"]["steps"][8]["median_ms"]
    loop11 = report["loop"]["times"]["prefetch"]["median_ms"]
    gpu = gpu_name_and_limit()
    print(f"[multi-device] (c) {gpu}: cli.train --distributed (NCCL, world "
          f"size 1, torchrun's variables) {MD_NCCL_STEPS} steps from phase "
          f"11's dump in {cli_s:.1f} s: 'distributed: process 0/1' "
          f"{'printed' if 'distributed: process 0/1' in out else 'MISSING'};"
          f" logged losses {[round(v, 4) for v in losses]}; step "
          f"{MD_NCCL_STEPS} {step_ms:.1f} ms on the host's clock (phase 7 "
          f"synthetic B=8 step {synth7:.1f} ms, phase 11 loop step "
          f"{loop11:.1f} ms); checkpoint at step {counters['global_step']}; "
          f"launches {counts}", flush=True)
    if "distributed: process 0/1" not in out:
        fail("cli.train did not join the process group")
    if (not np.isfinite(losses).all()
            or counters["global_step"] != MD_NCCL_STEPS):
        fail(f"cli.train --distributed: losses {losses}, checkpoint "
             f"{counters}")
    return dict(cli_s=cli_s, losses=losses, step_ms=step_ms,
                synthetic_step_ms=synth7, loop_step_ms=loop11, gpu=gpu,
                launches=counts)


def _md_synthesis(report):
    """(d): a mesh record listing cuda:0 twice: sharded == unsharded in
    deterministic mode, shard i == its rows alone with seed + i sampled."""
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    from wavenet_vocoder_tpu_torch.parallel import Mesh
    from wavenet_vocoder_tpu_torch.synthesis import Synthesizer
    cfg, model = _flagship_model("cuda", 13)
    devs = np.empty(2, dtype=object)
    devs[:] = [torch.device("cuda", 0)] * 2
    mesh = Mesh(("data",), devs)
    frames = cfg.sample_rate // cfg.hop_size
    rs = np.random.RandomState(14)
    mel = rs.randn(MD_SYNTH_B, frames, cfg.num_mels).astype(np.float32)
    t0 = time.perf_counter()
    one = Synthesizer(model, cfg, engine="cuda")
    two = Synthesizer(model, cfg, engine="cuda", mesh=mesh)
    det1 = one(mel, deterministic=True)
    det2 = two(mel, deterministic=True)
    det_equal = int((det1 == det2).all(axis=1).sum())
    c = torch.from_numpy(mel).cuda()
    c = torch.cat([c[:, :1].expand(-1, cfg.cin_pad, -1), c,
                   c[:, -1:].expand(-1, cfg.cin_pad, -1)], dim=1)
    shard = MD_SYNTH_B // 2
    sampled = cg.FusedGenerator(model, mesh=mesh)(c=c, seed=MD_SYNTH_SEED)
    gen = cg.FusedGenerator(model)
    alone = [gen(c=c[i * shard:(i + 1) * shard], seed=MD_SYNTH_SEED + i)
             for i in range(2)]
    torch.cuda.synchronize()
    samp_equal = [bool(torch.equal(sampled[i * shard:(i + 1) * shard], a))
                  for i, a in enumerate(alone)]
    secs = time.perf_counter() - t0
    print(f"[multi-device] (d) mesh [cuda:0, cuda:0], flagship bf16 pack, "
          f"B={MD_SYNTH_B} x {det1.shape[1]} samples: deterministic "
          f"sharded == unsharded in {det_equal}/{MD_SYNTH_B} utterances "
          f"(every sample); sampling, shard i == its rows alone with seed + "
          f"i: {samp_equal}; {secs:.1f} s", flush=True)
    if det_equal != MD_SYNTH_B or not all(samp_equal):
        fail("sharded synthesis differs from unsharded")
    if not (np.isfinite(det2).all() and float(det2.std()) > 0.0):
        fail("sharded synthesis audio is not finite")
    return dict(det_equal=det_equal, samp_equal=samp_equal, s=secs,
                samples=int(det1.shape[1]))


def _md_evaluation(report, work, total):
    """(e): cli.evaluate --distributed over two gloo processes on the card
    with phase 9's dump and checkpoint, against one process."""
    import numpy as np

    from wavenet_vocoder_tpu_torch.cli import evaluate
    ev = report["evaluation"]
    dump, path = ev["dump"], ev["checkpoint"]
    out2, out1 = os.path.join(work, "eval2"), os.path.join(work, "eval1")
    common = ["--batch-size", str(MD_EVAL_BATCH), "--deterministic"]
    port = _free_port()
    t0 = time.perf_counter()
    outs = _spawn([_self_cmd(
        "--run-module", "wavenet_vocoder_tpu_torch.cli.evaluate", dump, path,
        out2, *common, "--coordinator-address", f"127.0.0.1:{port}",
        "--num-processes", "2", "--process-id", str(i),
        "--local-device-ids", "0", "--dist-backend", "gloo")
        for i in range(2)], "phase 12 (e) cli.evaluate")
    two_s = time.perf_counter() - t0
    for i, out in enumerate(outs):
        _add_counts(total, _launch_line(out, f"phase 12 (e) process {i}"))
    evaluate.main([dump, path, out1] + common)
    lists = [open(os.path.join(out2, f"eval_manifest.proc{i}.txt")).read()
             .split() for i in range(2)]
    whole = open(os.path.join(out1, "eval_manifest.txt")).read().split()
    disjoint = not set(lists[0]) & set(lists[1])
    complete = sorted(lists[0] + lists[1]) == sorted(whole)
    same = [n for n in whole if np.array_equal(
        _read_wav(os.path.join(out1, n)), _read_wav(os.path.join(out2, n)))]
    print(f"[multi-device] (e) cli.evaluate --distributed, 2 gloo processes "
          f"on cuda:0, batches of {MD_EVAL_BATCH}, deterministic: manifests "
          f"{[len(x) for x in lists]} utterances, disjoint {disjoint}, union "
          f"== one process's {len(whole)}: {complete}; audio equal to one "
          f"process in {len(same)}/{len(whole)} utterances; {two_s:.1f} s",
          flush=True)
    if not (disjoint and complete and len(same) == len(whole)
            and len(whole) == EVAL_UTTS):
        fail("distributed evaluation is not the one-process evaluation "
             "split in two")
    return dict(manifests=lists, disjoint=disjoint, complete=complete,
                equal=len(same), s=two_s)


def phase_multi_device(report):
    """Phase 12; returns the launches of rows 1-3 over (b)-(e)."""
    import torch
    t_phase = time.perf_counter()
    _md_kernels(report)
    torch.cuda.empty_cache()
    total = {n: {} for n in _PORT_KERNELS}
    with _work_dir("chip_smoke_md") as work:
        zero_kernel_counts()
        ranks = _md_ranks(report, work, total)
        torch.cuda.empty_cache()
        nccl = _md_nccl(report, work, total)
        synth = _md_synthesis(report)
        torch.cuda.empty_cache()
        evals = _md_evaluation(report, work, total)
        # this process's launches: (b)'s one process, (d), (e)'s one
        # process; the other processes' were added as they reported them
        _add_counts(total, kernel_counts())
    report["multi_device"] = dict(
        ranks=ranks, nccl=nccl, synthesis=synth, evaluation=evals,
        launches=total, total_s=time.perf_counter() - t_phase)
    print(f"[multi-device] phase 12 in {report['multi_device']['total_s']:.1f}"
          f" s; launches of (b)-(e) {total}", flush=True)
    for name in _PORT_KERNELS:
        if total[name].get("launches", 0) <= 0:
            fail(f"phase 12 launched no {name}")
    return total


# ----------------------------------------------------------------------
# phase 13: the bench
# ----------------------------------------------------------------------
BENCH_AGREE = 0.25          # flagship B=256 value vs phase 3's, relative
BENCH_TIMEOUT_S = 600
# the bench's runs: (tag, BENCH_* variables). Flagship synthesis with the
# compact B=64 train record, the two published big models (512ch timed
# once at B=256 only: an iteration takes ~15 s, its weights being read
# from global memory every step), training at B=32 from a constant batch
# and from the loader, and streaming.
BENCH_RUNS = (
    ("synthesis flagship", {}),
    ("synthesis 30L3S", {"BENCH_MODEL": "30L3S", "BENCH_TRAIN": "0"}),
    ("synthesis 512ch", {"BENCH_MODEL": "512ch", "BENCH_TRAIN": "0",
                         "BENCH_ITERS": "1", "BENCH_RT_BATCH": "0"}),
    ("train B=32", {"BENCH_MODE": "train", "BENCH_BATCH": "32"}),
    ("train B=32 pipeline", {"BENCH_MODE": "train", "BENCH_BATCH": "32",
                             "BENCH_PIPELINE": "1"}),
    ("latency", {"BENCH_MODE": "latency"}),
)
BIG_MODELS = ("30L3S", "512ch")


def _big_models(report):
    """The generation kernel at the bench's two published big models (bf16
    pack, MoL, seed 1) against its plain version as phase 2 holds it at the
    serving batches, and one 256-step launch at B=256 timed as phase 4 times
    the flagship's; 512ch also at B=128, with one step's clock stamps.
    Returns {model or model.bB: timing}."""
    import torch

    from wavenet_vocoder_tpu_torch.bench import MODELS
    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    rows, timing, failures = [], {}, []
    for name in BIG_MODELS:
        model = WaveNet(spec_from_config(Config(**MODELS[name])),
                        generator=torch.Generator().manual_seed(1))
        model = model.to("cuda").eval()
        tag = f"[bench-kernel] {name:6s}"
        names = ("launches", "chunked_launches", "wide_cluster_launches",
                 "tap_last_launches")
        before = [_launches(f"generate.{n}") for n in names]
        mine, bad = _check_model(
            model, [(B, cg.DEFAULT_CHUNK, True) for B in CHECK_BATCHES],
            ("bfloat16",), tag, dict(model=name))
        rows += mine
        failures += bad
        # 512ch's layer blocks never fit two stages, 30L3S's always do: the
        # first streams every launch through the chunk ring, the second none;
        # neither takes 32-stream clusters (512ch has no room for them,
        # 30L3S's clusters of 4 keep whole layer blocks)
        launched, chunked, wide, tap_last = (_launches(f"generate.{n}") - b
                                             for n, b in zip(names, before))
        print(f"{tag} {launched} launches, {chunked} through the chunk ring, "
              f"{wide} on 32-stream clusters, {tap_last} walking the newest "
              f"tap last", flush=True)
        if tap_last != launched:
            failures.append(f"{name}: {tap_last} of {launched} bf16 launches "
                            f"walked the newest tap last")
        if chunked != (launched if name == "512ch" else 0):
            failures.append(f"{name}: {chunked} of {launched} launches took "
                            f"the chunk ring")
        if wide:
            failures.append(f"{name}: {wide} of {launched} launches on "
                            f"32-stream clusters")
        packed = cg.pack_weights(model, dtype=torch.bfloat16)
        timing[name] = _time_launch(
            tag, packed, model.spec,
            _launch_inputs(model.spec, 256, cg.DEFAULT_CHUNK), iters=3)
        if name == "512ch":
            # the served cell's batch (clusters of 8) beside B=256 (clusters
            # of 4): both stream their weights through the chunk ring
            inputs = _launch_inputs(model.spec, 128, cg.DEFAULT_CHUNK)
            timing["512ch.b128"] = _time_launch(tag, packed, model.spec,
                                                inputs, iters=3)
            timing["512ch.b128"]["trace"] = _step_cycles(
                f"{tag} one step of B=128", packed, model.spec, inputs)
        del model, packed
        torch.cuda.empty_cache()
    timing.update(_mulaw256_launches(rows, failures))
    report["bench_kernel_vs_plain"] = rows
    if failures:
        fail("generation kernel disagrees with its plain version:\n"
             + "\n".join(failures))
    return timing


def _mulaw256_launches(rows, failures):
    """r9y9's mu-law 256 recipe (egs/mulaw256; 30 layers in 3 stacks,
    128/256/128, a 256-way categorical head split over the cluster), seed 1:
    against its plain version as phase 2 holds a model (f32 and bf16 packs,
    B=16 on clusters of 8, B=256 on 32-stream clusters of 8 (bf16) and on
    clusters of 4 (f32); its rows and failures appended to ``rows`` and
    ``failures``), then one bf16 256-step launch at B=256 (two row tiles,
    two whole layer blocks) and B=16 (four whole layer blocks) timed as the
    30L3S line is, with the plan each took (``_info``) and the launch
    counters, the bytes the launch took held to the plan's, and B=256 again
    on 16-stream clusters of 4 (the chunk ring).
    Returns {mulaw256.bB: timing}."""
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import WaveNet, spec_from_config
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "egs/mulaw256/conf/mulaw256_wavenet.json")) as f:
        cfg = Config().override_from_dict(json.load(f))
    model = WaveNet(spec_from_config(cfg),
                    generator=torch.Generator().manual_seed(1)).to("cuda").eval()
    spec = model.spec
    mine, bad = _check_model(
        model, [(B, cg.DEFAULT_CHUNK, True) for B in (16, 256)],
        ("float32", "bfloat16"), "[bench-kernel] mulaw256", dict(model="mulaw256"))
    rows += mine
    failures += bad
    packed = cg.pack_weights(model, dtype=torch.bfloat16)
    timing = {}
    for B in (256, 16):
        tag = f"[bench-kernel] mulaw256 B={B}"
        inputs = _launch_inputs(spec, B, cg.DEFAULT_CHUNK)
        cond, x0, ring, out = inputs
        names = _GENERATE_COUNTERS
        before = [_launches(f"generate.{n}") for n in names]
        plan, info = cg.plan_launch(spec, torch.bfloat16, B), []
        cg.generate_steps(packed, spec, ring.clone(), x0.clone(), out, cond,
                          t0=0, seed=1, plan=plan, _info=info)
        torch.cuda.synchronize()
        counts = dict(zip(names, (_launches(f"generate.{n}") - b
                                  for n, b in zip(names, before))))
        print(f"{tag} plan: {plan.nstage} "
              f"{'chunk slots' if plan.chunked else 'stages'}, head resident "
              f"{plan.head_res}, {plan.total} B of shared memory (the launch "
              f"took {info[2]}), {info[3]} clusters at once; counters {counts}",
              flush=True)
        if (counts["split_head_launches"] != 1 or counts["chunked_launches"] != 0
                or counts["wide_cluster_launches"] != (B > 240)
                or counts["tap_last_launches"] != 1 or info[2] != plan.total):
            fail(f"mulaw256 B={B}: counters {counts}, {info[2]} B of shared "
                 f"memory against the plan's {plan.total}")
        timing[f"mulaw256.b{B}"] = dict(
            _time_launch(tag, packed, spec, inputs, iters=3),
            plan=[plan.nstage, plan.head_res, plan.total, info[3],
                  int(plan.chunked)], counters=counts)
        if B > 240:
            # the cluster shape the picker took before 32-stream clusters
            timing[f"mulaw256.b{B}.4x16"] = _time_launch(
                tag, packed, spec, inputs, iters=3, cluster=(4, 16))
    del model, packed
    torch.cuda.empty_cache()
    return timing


def _bench_run(tag, over, dump):
    """``python -m wavenet_vocoder_tpu_torch.bench`` with the variables
    ``over`` (this script's --run-module, which adds the launch counts):
    (its record, its launches, seconds). Fails on a missing record, a value
    that is missing or not finite, another device or an error."""
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(over, BENCH_DATA_DIR=dump,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            _self_cmd("--run-module", "wavenet_vocoder_tpu_torch.bench"),
            cwd=root, env=env, capture_output=True, text=True,
            timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"bench {tag}: past {BENCH_TIMEOUT_S} s")
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bench {tag} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-3000:]}")
    recs = [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith('{"metric"')]
    if len(recs) != 1:
        fail(f"bench {tag}: {len(recs)} records:\n{proc.stdout[-2000:]}")
    rec, d = recs[0], recs[0]["detail"]
    bad = []
    if not (isinstance(rec.get("value"), (int, float))
            and math.isfinite(rec["value"])):
        bad.append(f"value {rec.get('value')!r}")
    if d.get("device") != torch.cuda.get_device_name(0):
        bad.append(f"device {d.get('device')!r}")
    for where in (rec, d, d.get("training") or {},
                  d.get("realtime_batch") or {}):
        if "error" in where:
            bad.append(f"error {where['error']}")
    if bad:
        fail(f"bench {tag}: " + "; ".join(bad) + f"\n{json.dumps(rec)}")
    return rec, _launch_line(proc.stdout, f"bench {tag}"), secs


def _need(counts, names, tag):
    """Every kernel in ``names`` launched; every training launch a
    tensor-core launch."""
    for name in names:
        c = counts.get(name, {})
        if c.get("launches", 0) <= 0:
            fail(f"bench {tag} launched no {name}: {counts}")
        if "tc_launches" in c and c["tc_launches"] != c["launches"]:
            fail(f"bench {tag}: {name} ran off the tensor cores: {c}")


def phase_bench(report):
    """Phase 13; returns the launches of the bench runs by kernel."""
    import torch
    t_phase = time.perf_counter()
    timing = _big_models(report)
    torch.cuda.empty_cache()
    runs = {}
    total = {n: {} for n in _PORT_KERNELS}
    with _work_dir("chip_smoke_bench") as work:
        for tag, over in BENCH_RUNS:
            rec, counts, secs = _bench_run(tag, over,
                                           os.path.join(work, "dump"))
            mode = over.get("BENCH_MODE", "synthesis")
            _need(counts, {"synthesis": ("generate",),
                           "train": ("train_fwd", "train_bwd"),
                           "latency": ("generate",)}[mode], tag)
            if tag == "synthesis flagship":
                _need(counts, ("train_fwd", "train_bwd"), tag)
            _add_counts(total, counts)
            runs[tag] = dict(record=rec, launches=counts, s=secs)
            d = rec["detail"]
            extra = ""
            if mode == "synthesis":
                rt = d["realtime_batch"]
                extra = (f"B={d['batch']} x {d['samples_per_utt']} samples, "
                         f"wall {d['wall_s_per_iter']} s (min "
                         f"{d['wall_s_min']}, max {d['wall_s_max']}), "
                         f"{d['per_stream_realtime_x']}x per stream")
                if rt:
                    extra += (f"; B={rt['batch']}: {rt['audio_sec_per_sec']} "
                              f"audio-s/s, {rt['per_stream_realtime_x']}x per "
                              f"stream")
                if d["training"]:
                    tr = d["training"]
                    extra += (f"; train B={tr['batch']}: {tr['value']} "
                              f"samples/s, step {tr['step_s']} s (min "
                              f"{tr['step_s_min']}, max {tr['step_s_max']}),"
                              f" MFU {tr['mfu']}")
            elif mode == "train":
                extra = (f"B={d['batch']} {d['pipeline']}: step "
                         f"{d['step_s']} s (min {d['step_s_min']}, max "
                         f"{d['step_s_max']}), {d['step_tflops']} TFLOP a "
                         f"step, {d['achieved_tflops_per_s']} TFLOP/s, MFU "
                         f"{d['mfu']} of {d['peak_tflops']} TFLOP/s")
            else:
                extra = (f"first audio {d['first_audio_latency_ms']} ms, "
                         f"{d['total_audio_s']} s of audio in {d['wall_s']} "
                         f"s, segments of {d['segment_samples']} samples")
            print(f"[bench] {tag}: {rec['metric']} {rec['value']} "
                  f"{rec['unit']}; {extra}; {d['device']}, "
                  f"{d['power_limit']}; launches {counts}; {secs:.1f} s",
                  flush=True)
    flag = runs["synthesis flagship"]["record"]
    served = [r for r in report["serving"] if r["B"] == 256][-1]
    ratio = flag["value"] / served["audio_s_per_s"]
    print(f"[bench] flagship B=256: bench {flag['value']} audio-s/s, phase 3 "
          f"{served['audio_s_per_s']:.4f} audio-s/s (ratio {ratio:.3f}, "
          f"limit 1 +- {BENCH_AGREE})", flush=True)
    report["bench"] = dict(models=timing, runs=runs, launches=total,
                           phase3_ratio=ratio,
                           total_s=time.perf_counter() - t_phase)
    if abs(ratio - 1.0) > BENCH_AGREE:
        fail(f"the bench's flagship B=256 value {flag['value']} and phase "
             f"3's {served['audio_s_per_s']:.4f} differ by more than "
             f"{BENCH_AGREE:.0%}: one of them is not synchronised")
    return total


# ----------------------------------------------------------------------
# phase 14: the sampled-audio quality check
# ----------------------------------------------------------------------
# The heads phase 14 holds to the JAX script's thresholds. mulaw256 passed
# in every run on the card; mol and gaussian pass in a minority of runs on
# both the kernels and the plain layer loop (ROADMAP Queue C: an open fault
# of the port until shown otherwise), so they are run by hand and recorded
# in PERF.md.
QUALITY_HEADS = ("mulaw256",)
# The negative control: the same check of mulaw256 with the backward built
# with bwd_x_shift (every layer's x_l read one position late) must fail.
QUALITY_FAULT = ("mulaw256", "bwd_x_shift")
QUALITY_TIMEOUT_S = 900


def _fault_gradients(report):
    """One backward of the stack at the quality model's widths (12 layers,
    64/128/64, cin 40; B=8, T=4096, bf16, dropout 0.05) in the healthy
    build twice and in each fault build: all eight gradients repeat exactly
    in the healthy build (ordered sums); each fault moves dx0 by more than
    1e-4 of its largest value."""
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
    from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
    from wavenet_vocoder_tpu_torch.scripts.synthetic_e2e import make_config
    spec = spec_from_config(make_config("mol"))
    L, R, G, S, cin = (spec.layers, spec.residual_channels,
                       spec.gate_channels, spec.skip_out_channels,
                       spec.cin_channels)
    B, T, bf = 8, 4096, torch.bfloat16
    rs = np.random.RandomState(0)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (rs.randn(*s) * sc).astype(np.float32)).cuda()
    x0, c = t(B, T, R, sc=0.5).to(bf), t(B, T, cin).to(bf)
    w_in = t(L, 3 * R, G, sc=(3 * R) ** -0.5).to(bf)
    w_cond = t(L, cin, G, sc=cin ** -0.5).to(bf)
    w_og = t(L, G // 2, R + S, sc=(G // 2) ** -0.5).to(bf)
    b_in, b_og, dskips = t(L, G, sc=0.1), t(L, R + S, sc=0.1), t(B, T, S)
    kw = dict(dils=spec.dilations, k=spec.kernel_size, drop=0.05, seed=7)
    _, xs = ct.train_fwd(x0, c, None, w_in, b_in, w_cond, w_og, b_og, **kw)

    def grads(fault):
        ct.set_fault(fault)
        try:
            return ct.train_bwd(dskips, xs, c, None, w_in, b_in, w_cond,
                                w_og, b_og, **kw)
        finally:
            ct.set_fault("none")

    ok, ok2 = grads("none"), grads("none")
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    names = GRAD_NAMES
    unequal = [n for n, a, b in zip(names, ok, ok2) if not _equal(a, b)]
    exact = not unequal
    out = dict(healthy_unequal=unequal, healthy_exact=exact, faults={})
    print(f"[quality] fault builds, one backward at the quality model's "
          f"widths (B={B}, T={T}, bf16, dropout 0.05): healthy twice, all "
          f"eight gradients bitwise equal {exact}"
          + (f" (NOT {unequal})" if unequal else ""), flush=True)
    bad = [] if exact else [f"the healthy build does not repeat {unequal}"]
    for fault in ("bwd_mask_tshift", "bwd_x_shift"):
        g = grads(fault)
        diff = {n: rel(a, b) for n, a, b in zip(names, g, ok) if b is not None}
        out["faults"][fault] = diff
        print(f"[quality] fault {fault}: rel change "
              + ", ".join(f"{n} {v:.2e}" for n, v in diff.items()),
              flush=True)
        if not diff["dx0"] > 1e-4:
            bad.append(f"{fault} moves dx0 by only {diff['dx0']:.2e}")
    report["fault_gradients"] = out
    if bad:
        fail("fault builds: " + "; ".join(bad))


def _quality_run(heads, fault):
    """``quality_check`` for ``heads`` with the backward's ``fault`` in a
    subprocess (this script's --run-module, which adds the launch counts):
    (exit code, {head: record}, launches, seconds, output's tail). Fails
    past QUALITY_TIMEOUT_S or where a head gave no record."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    tag = "quality check" + ("" if fault == "none" else f" ({fault})")
    with _work_dir("chip_smoke_quality") as work:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(_self_cmd(
                "--run-module", "wavenet_vocoder_tpu_torch.scripts.quality_check",
                "--heads", ",".join(heads), "--fault", fault, "--out-dir",
                work), cwd=root, env=env, capture_output=True, text=True,
                timeout=QUALITY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"{tag} past {QUALITY_TIMEOUT_S} s")
        secs = time.perf_counter() - t0
    records = {}
    for x in proc.stdout.splitlines():
        if x.startswith('{"head"'):
            rec = json.loads(x)
            records[rec["head"]] = rec
        if x.startswith(("loss-drop check", "rollouts:", "step ")):
            print(f"[quality] {x}", flush=True)
    tail = f"{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}"
    for head, rec in records.items():
        print(f"[quality] {head}, fault {rec['fault']}: loss "
              f"{rec['loss_first']} -> {rec['loss_final']}, F0 "
              f"{rec['f0_gen']} Hz (target {rec['f0_ref']}), mel corr "
              f"{rec['mel_corr']} (margin {rec['mel_margin']}), rollouts "
              f"{rec['rollouts']}; train {rec['train_s']} s, generation "
              f"{rec['gen_s']} s; exit {proc.returncode}", flush=True)
    if sorted(records) != sorted(heads):
        fail(f"{tag} exited {proc.returncode} with heads "
             f"{sorted(records)}:\n{tail}")
    counts = _launch_line(proc.stdout, tag)
    _need(counts, ("train_fwd", "train_bwd", "generate"), tag)
    return proc.returncode, records, counts, secs, tail


def phase_quality(report):
    """Phase 14; returns the healthy quality check's launches by kernel."""
    t_phase = time.perf_counter()
    _fault_gradients(report)
    rc, heads, counts, secs, tail = _quality_run(QUALITY_HEADS, "none")
    if rc != 0:
        fail(f"quality check exited {rc}:\n{tail}")
    print(f"[quality] phase 14: {', '.join(heads)} pass the JAX script's "
          f"thresholds in {secs:.1f} s; launches {counts}", flush=True)
    # the negative control; its launches are not the path's
    head, fault = QUALITY_FAULT
    frc, frecs, _, fsecs, ftail = _quality_run((head,), fault)
    print(f"[quality] negative control: {head} with {fault} exits {frc} in "
          f"{fsecs:.1f} s (must be 1: the net fails the faulted build)",
          flush=True)
    if (frc != 1 or frecs[head]["fault"] != fault
            or f"\n{head}: FAIL (" not in ftail):
        fail(f"the quality net does not fail {head} under {fault} (exit "
             f"{frc}):\n{ftail}")
    report["quality"] = dict(heads=heads, launches=counts, s=secs,
                             negative_control=dict(head=head, fault=fault,
                                                   rc=frc, s=fsecs,
                                                   record=frecs[head]),
                             total_s=time.perf_counter() - t_phase)
    return counts


# ----------------------------------------------------------------------
# phase 15: the optimizers, remat, tensor parallelism and the dry run
# ----------------------------------------------------------------------
# every name make_optimizer maps, with a learning rate that moves the
# flagship's bf16 weights in 20 steps (the Config's 1e-3 where it does)
OPT_LR = {"Adam": 1e-3, "AdamW": 1e-3, "Adamax": 1e-3, "NAdam": 1e-3,
          "RAdam": 1e-3, "SGD": 1e-2, "RMSprop": 1e-3, "Adagrad": 5e-2,
          "Adadelta": 1.0, "Lamb": 1e-3, "Adafactor": 1e-2}
OPT_STEPS = 20
OPT_TOL = 1e-5          # one update, card vs CPU f64, of the largest update
REMAT_STEPS = 3
TP_RANKS, TP_STEPS, TP_B = 2, 2, 4
# (c) steps with SGD: its update is lr x the gradient, so the parameters are
# held as the gradients are (Adam's update of a gradient that is rounding
# noise is a full step of random sign; the optimizers are (a)'s)
TP_OPT = dict(optimizer="SGD", optimizer_params={"lr": 1e-2})


def _params_after_one_update(name, params, grads, device, dtype):
    """One update of optimizer ``name`` (make_optimizer's mapping, fresh
    state) on copies of ``params`` with ``grads``, on device in dtype."""
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training.train_state import make_optimizer
    ps = [torch.nn.Parameter(p.detach().to(device, dtype).clone())
          for p in params]
    for p, g in zip(ps, grads):
        p.grad = g.detach().to(device, dtype).clone()
    opt, _ = make_optimizer(Config(optimizer=name, optimizer_params={
        "lr": OPT_LR[name], "momentum": 0.9 if name == "SGD" else 0.0}), ps)
    opt.step()
    return [p.detach() for p in ps]


def _optimizers(report):
    """(a): each optimizer's update on the card against the CPU in f64, then
    OPT_STEPS flagship steps on the tensor-core kernels."""
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    cfg = Config(fused_train=True)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in train_batch(cfg, cfg.batch_size).items()}
    state = create_train_state(cfg)
    step, _ = make_train_step(cfg)
    step(state, batch)           # the gradients of one bf16 fused B=8 step
    params = list(state.model.parameters())
    grads = [p.grad.detach().clone() for p in params]
    out = {}
    for name in OPT_LR:
        gpu = _params_after_one_update(name, params, grads, "cuda",
                                       torch.float32)
        ref = _params_after_one_update(name, params, grads, "cpu",
                                       torch.float64)
        worst = 0.0
        for p0, a, b in zip(params, gpu, ref):
            p0 = p0.detach().cpu().double()
            upd = float((b - p0).abs().max())
            # an f32 parameter holds its update to half an ulp of itself
            ulp = float(p0.abs().max()) * 2.0 ** -24
            err = float((a.cpu().double() - b).abs().max())
            worst = max(worst, (err - ulp) / max(upd, 1e-30))
        o_cfg = Config(fused_train=True, optimizer=name, optimizer_params={
            "lr": OPT_LR[name], "momentum": 0.9 if name == "SGD" else 0.0})
        st = create_train_state(o_cfg)          # the init of cfg.seed
        o_step, _ = make_train_step(o_cfg)
        losses, ms = [], []
        for i in range(OPT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = o_step(st, batch)
            losses.append(float(m["loss"]))          # synchronises
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = dict(update_err=worst, losses=losses,
                         host_ms=float(np.median(ms[5:])),
                         optimizer=type(st.optimizer).__name__)
        print(f"[tail] 15 (a) {name} ({out[name]['optimizer']}, lr "
              f"{OPT_LR[name]}): one update card f32 vs CPU f64, max |diff| "
              f"(less half an f32 ulp of the parameter) / max |update| "
              f"{worst:.2e} (tol {OPT_TOL}); {OPT_STEPS} steps loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; step median "
              f"{out[name]['host_ms']:.1f} ms (steps 6-{OPT_STEPS}, host "
              f"clock around a synchronised step)", flush=True)
        del st
        if not worst <= OPT_TOL:
            fail(f"{name}: the card's update differs from the CPU's by "
                 f"{worst:.2e} of the largest update")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"{name}: {OPT_STEPS} steps did not lower the loss: "
                 f"{losses}")
    report["optimizers"] = out
    del state, params, grads
    torch.cuda.empty_cache()
    return out


def _remat(report):
    """(b): the flagship's plain layer loop, bf16, B=8, T=10240, with remat
    off, whole and "dots": loss bitwise equal, gradients within 1e-6 of the
    largest value (deterministic cuDNN), peak memory and step time."""
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    out, ref = {}, None
    cfg0 = Config()
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in train_batch(cfg0, cfg0.batch_size).items()}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for tag, remat, policy in (("off", False, ""), ("whole", True, ""),
                                   ("dots", True, "dots")):
            cfg = Config(remat=remat, remat_policy=policy)
            state = create_train_state(cfg)     # the init of cfg.seed
            step, _ = make_train_step(cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, losses = [], []
            for i in range(REMAT_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(state, batch)
                losses.append(m["loss"].detach().clone())
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    grads = {n: p.grad.detach().float().clone()
                             for n, p in state.model.named_parameters()}
            peak = torch.cuda.max_memory_allocated()
            res = dict(loss=float(losses[0]), peak_gb=peak / 1e9,
                       step_ms=float(np.median(ms[1:])), ms=ms)
            if ref is None:
                ref = (losses[0], grads)
            else:
                scale = max(float(g.abs().max()) for g in ref[1].values())
                res["loss_equal"] = bool(torch.equal(losses[0], ref[0]))
                res["grad_err"] = max(
                    float((grads[n] - g).abs().max()) for n, g in
                    ref[1].items()) / scale
            out[tag] = res
            print(f"[tail] 15 (b) remat {tag}: flagship plain loop bf16 B=8 "
                  f"T=10240, loss {res['loss']:.6f}"
                  + ("" if tag == "off" else
                     f" (bitwise equal to off: {res['loss_equal']}; "
                     f"gradients max |diff| / max |grad| "
                     f"{res['grad_err']:.2e}, tol 1e-6)")
                  + f"; peak memory {res['peak_gb']:.2f} GB "
                  f"(max_memory_allocated); step median {res['step_ms']:.1f}"
                  f" ms", flush=True)
            del state, step, grads, losses
            torch.cuda.empty_cache()
            if tag != "off" and not (res["loss_equal"]
                                     and res["grad_err"] <= 1e-6):
                fail(f"remat {tag} changes the loss or the gradients")
    report["remat"] = out
    return out


def _gathered(model, groups, grads=False):
    """Every parameter (or its gradient) of a cut model, whole, on the CPU."""
    from wavenet_vocoder_tpu_torch.models.layers import all_gather_slices
    from wavenet_vocoder_tpu_torch.parallel.sharding import (
        wavenet_param_shardings)
    rules = wavenet_param_shardings(model)
    out = {}
    for n, p in model.named_parameters():
        t = (p.grad if grads else p).detach()
        if groups is not None and rules[n] is not None:
            t = all_gather_slices(t, rules[n], groups.model)
        out[n] = t.float().cpu()
    return out


def tp_steps(groups, out_dir, tag):
    """TP_STEPS f32 steps of the flagship's plain layer loop, then TP_STEPS
    bf16 steps of its fused stack (each from the init of cfg.seed, SGD), on
    TP_B rows of phase 6's batch; the blocks cut over the model group when
    ``groups`` is given. Writes each leg's first-step gradients and final
    parameters (whole) to out_dir; returns losses, norms and launches."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    # deterministic convolutions: one process repeats itself, and what
    # differs is the ranks' summation order
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for leg in ("plain f32", "fused bf16"):
            res[leg] = _tp_leg(leg, groups, out_dir, tag)
    return res


def _tp_leg(leg, groups, out_dir, tag):
    """One leg of tp_steps: its losses, norms and launches."""
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.parallel.sharding import shard_train_state
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    cfg = (Config(compute_dtype="", **TP_OPT) if leg == "plain f32"
           else Config(fused_train=True, **TP_OPT))
    state = create_train_state(cfg)
    if groups is None:
        torch.save(_gathered(state.model, None),
                   os.path.join(out_dir, f"{tag}.{leg[:5]}.init.pt"))
    else:
        shard_train_state(state, groups)
    step, _ = make_train_step(cfg, group=None if groups is None
                              else groups.data)
    batch = train_batch(cfg, TP_B)
    before = (_launches("train_fwd.launches"),
              _launches("train_bwd.launches"))
    losses, norms = [], []
    for i in range(TP_STEPS):
        m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            torch.save(_gathered(state.model, groups, grads=True),
                       os.path.join(out_dir, f"{tag}.{leg[:5]}.grads.pt"))
    torch.save(_gathered(state.model, groups),
               os.path.join(out_dir, f"{tag}.{leg[:5]}.params.pt"))
    res = dict(losses=losses, grad_norms=norms, launched={
        "train_fwd": _launches("train_fwd.launches") - before[0],
        "train_bwd": _launches("train_bwd.launches") - before[1]})
    del state, step
    torch.cuda.empty_cache()
    return res


def tp_rank_worker(rank, port, out_dir):
    """One of phase 15 (c)'s ranks: gloo on cuda:0, the model axis 2."""
    import torch.distributed as dist

    from wavenet_vocoder_tpu_torch.parallel import initialize_distributed
    from wavenet_vocoder_tpu_torch.parallel.distributed import (
        parallel_groups)
    initialize_distributed(f"127.0.0.1:{port}", TP_RANKS, rank,
                           local_device_ids="0", backend="gloo",
                           timeout_s=MD_TIMEOUT_S)
    res = tp_steps(parallel_groups(TP_RANKS), out_dir, f"rank{rank}")
    res["jax_loaded"] = ("jax" in sys.modules
                         or "wavenet_vocoder_tpu" in sys.modules)
    with open(os.path.join(out_dir, f"tp{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _tensor_parallel(report, work, total):
    """(c): two gloo ranks on the card with the model axis 2 against one
    process, within phase 6's STEP_TOL."""
    import torch
    port = _free_port()
    t0 = time.perf_counter()
    _spawn([_self_cmd("--tp-rank", str(r), "--md-port", str(port),
                      "--md-dir", work) for r in range(TP_RANKS)],
           "phase 15 (c) ranks")
    ranks_s = time.perf_counter() - t0
    res = [json.load(open(os.path.join(work, f"tp{r}.json")))
           for r in range(TP_RANKS)]
    if any(r["jax_loaded"] for r in res):
        fail("a phase 15 (c) rank imported JAX")
    single = tp_steps(None, work, "single")
    out = {}
    for leg, one in single.items():
        tol = STEP_TOL["float32" if "f32" in leg else "bfloat16"]
        got = res[0][leg]
        load = lambda tag, kind: torch.load(os.path.join(
            work, f"{tag}.{leg[:5]}.{kind}.pt"))
        gs, g0 = load("single", "grads"), load("rank0", "grads")
        scale = {n: float(g.abs().max()) for n, g in gs.items()}
        floor = 1e-6 * max(scale.values())
        grad_rel = {n: float((g0[n] - g).abs().max()) / max(scale[n], floor)
                    for n, g in gs.items()}
        ps, p0, p1 = (load(t, "params") for t in ("single", "rank0", "rank1"))
        # the parameters by the same measure, on their updates
        init = load("single", "init")
        upd = {n: float((p - init[n]).abs().max()) for n, p in ps.items()}
        ufloor = 1e-6 * max(upd.values())
        param_rel = {n: float((p0[n] - p).abs().max()) / max(upd[n], ufloor)
                     for n, p in ps.items()}
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                        one["losses"])]
        norm_rel = [abs(a - b) / abs(b) for a, b in zip(got["grad_norms"],
                                                        one["grad_norms"])]
        equal = all(torch.equal(p0[n], p1[n]) for n in p0)
        wg = max(grad_rel.items(), key=lambda kv: kv[1])
        wp = max(param_rel.items(), key=lambda kv: kv[1])
        out[leg] = dict(loss_rel=loss_rel, grad_norm_rel=norm_rel,
                        worst_grad_leaf=wg, worst_param_leaf=wp,
                        ranks_equal=equal, launched=[r[leg]["launched"]
                                                     for r in res],
                        single_launched=one["launched"])
        print(f"[tail] 15 (c) tensor parallel, {leg}: {TP_RANKS} gloo ranks "
              f"on cuda:0 (model axis {TP_RANKS}) vs one process, flagship "
              f"B={TP_B} T=10240, {TP_STEPS} steps: loss rel "
              f"{[f'{v:.2e}' for v in loss_rel]} (tol {tol['loss']}), grad "
              f"norm rel {[f'{v:.2e}' for v in norm_rel]} (tol "
              f"{tol['grad_norm']} at step 1, x10 after); step-1 gradients "
              f"worst leaf {wg[0]} {wg[1]:.2e} (tol {tol['leaf']}); "
              f"parameters after {TP_STEPS} SGD steps, max |diff| / max "
              f"|update| worst {wp[0]} {wp[1]:.2e} (tol {tol['leaf']}); "
              f"ranks' "
              f"gathered parameters bitwise equal {equal}; launches "
              f"{out[leg]['launched']} (one process "
              f"{one['launched']}); ranks took {ranks_s:.1f} s", flush=True)
        if not (max(loss_rel) <= tol["loss"]
                and norm_rel[0] <= tol["grad_norm"]
                and max(norm_rel) <= 10 * tol["grad_norm"]
                and wg[1] <= tol["leaf"] and wp[1] <= tol["leaf"] and equal):
            fail(f"tensor parallelism ({leg}) disagrees with one process "
                 "beyond STEP_TOL")
        for r in res:
            _add_counts(total, {k: dict(launches=v) for k, v in
                                r[leg]["launched"].items()})
    if not all(v > 0 for v in res[0]["fused bf16"]["launched"].values()):
        fail("the tensor-parallel fused leg launched no training kernel")
    report["tensor_parallel"] = out
    return out


def _dryrun(report, total):
    """(d): entry.dryrun_multichip(4), four gloo ranks sharing the card."""
    from wavenet_vocoder_tpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    res = dryrun_multichip(4)
    secs = time.perf_counter() - t0
    launched = [r["launches"] for r in res["ranks"]]
    for c in launched:
        _add_counts(total, {k: dict(launches=v) for k, v in c.items()})
    print(f"[tail] 15 (d) dryrun_multichip(4): backend {res['backend']}, "
          f"mesh {res['mesh']}, loss {res['loss']:.4f}, fused loss "
          f"{res['fused_loss']:.4f}, synthesis {res['synth']}; launches by "
          f"rank {launched}; {secs:.1f} s", flush=True)
    if res["backend"] != "gloo" or not all(
            c["train_fwd"] > 0 and c["train_bwd"] > 0 and c["generate"] > 0
            for c in launched):
        fail(f"dryrun_multichip(4) did not run its kernels on every rank: "
             f"{launched}")
    report["dryrun"] = dict(res, s=secs)
    return res


def phase_parallel_optim(report):
    """Phase 15; returns its launches by kernel (this process's and its
    subprocesses')."""
    import torch
    t0 = time.perf_counter()
    zero_kernel_counts()
    _optimizers(report)
    _remat(report)
    total = {k: dict(v) for k, v in kernel_counts().items()}
    with _work_dir("chip_smoke_tp") as work:
        _tensor_parallel(report, work, total)
    torch.cuda.empty_cache()
    _dryrun(report, total)
    report["phase15_s"] = time.perf_counter() - t0
    print(f"[tail] phase 15 in {report['phase15_s']:.1f} s; launches "
          f"{total}", flush=True)
    for k in ("train_fwd", "train_bwd", "generate"):
        if not total[k]["launches"]:
            fail(f"phase 15 launched no {k}")
    return total


# ----------------------------------------------------------------------
# phase 16: checkpoints in the JAX layout, synthesis on a cut model, the
# bf16 eager decoder and the recipe at the flagship preset
# ----------------------------------------------------------------------
CKPT_B = 8
SYN_RANKS, SYN_B, SYN_FRAMES = 2, 4, 22     # 22 mel frames: 0.255 s
SYN_SCAN_T = 64         # the scan engine's steps (a cut: PERF.md section 4)
SYN_SCAN_TOL = 1e-3     # generation's f32 limit (TOL["float32"])
BF16_SCAN_B, BF16_SCAN_T = 32, CHECK_STEPS
RECIPE_UTTS = 24
RECIPE_STEPS = 60
RECIPE_PRESET = "conf/mol_wavenet.json"


def _ckpt_round_trip(report, work):
    """(a): two fused bf16 steps, save, load into a fresh state; step 3
    with and without the reload gives the same bits: loss, grad norm, every
    parameter's gradient, and the state after it (the reload is exact and
    the step repeatable)."""
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    cfg = Config(fused_train=True)
    batch = train_batch(cfg, CKPT_B)
    state = create_train_state(cfg)
    step, _ = make_train_step(cfg)
    for _ in range(2):
        step(state, batch)
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(work, state, global_step=2)
    save_s = time.perf_counter() - t0
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        count = int(z["opt_0"])
    n = len(manifest["param_paths"])
    keystr = all(p.startswith("['") for p in manifest["param_paths"])
    fresh = create_train_state(Config(fused_train=True, seed=1))
    t0 = time.perf_counter()
    ckpt.load_checkpoint(path, fresh)
    load_s = time.perf_counter() - t0
    tol = STEP_TOL["bfloat16"]
    m_a, m_b = step(state, batch), step(fresh, batch)
    grads_equal = all(_equal(p.grad, q.grad) for p, q in zip(
        state.model.parameters(), fresh.model.parameters()))
    after_a, after_b = _state_tensors(state), _state_tensors(fresh)
    state_differ = [k for k in after_a if not _equal(after_a[k], after_b[k])]
    bitwise = (grads_equal and not state_differ
               and _equal(m_a["loss"], m_b["loss"])
               and _equal(m_a["grad_norm"], m_b["grad_norm"]))
    leaf = leaf_grad_errors(fresh.model, state.model)
    worst = max(leaf.items(), key=lambda kv: kv[1])
    loss_rel = abs(float(m_b["loss"]) - float(m_a["loss"])) / abs(
        float(m_a["loss"]))
    norm_rel = abs(float(m_b["grad_norm"]) - float(m_a["grad_norm"])) / abs(
        float(m_a["grad_norm"]))
    out = dict(n_params=n, n_opt=manifest["n_opt"], keystr=keystr,
               adam_count=count, loss_rel=loss_rel, grad_norm_rel=norm_rel,
               worst_leaf=worst, save_s=save_s, load_s=load_s,
               mb=os.path.getsize(path) / 2 ** 20, bitwise=bitwise,
               grads_equal=grads_equal, state_differ=state_differ)
    print(f"[tail] 16 (a) checkpoint: flagship fused bf16 B={CKPT_B}, 2 "
          f"steps, saved ({out['mb']:.1f} MB, {save_s:.2f} s) with {n} "
          f"keystr paths {keystr} and {manifest['n_opt']} optax leaves "
          f"(2N+2 = {2 * n + 2}, Adam count {count}); reloaded into a "
          f"fresh state ({load_s:.2f} s); step 3 after the reload vs "
          f"without: loss rel {loss_rel:.2e} (tol {tol['loss']}), grad norm "
          f"rel {norm_rel:.2e} (tol {tol['grad_norm']}), worst leaf "
          f"gradient {worst[0]} {worst[1]:.2e} (tol {tol['leaf']}); "
          f"bitwise equal (loss, grad norm, gradients, state after): "
          f"{bitwise}" + (f" (gradients equal {grads_equal}, state tensors "
                          f"differing {state_differ[:4]})" if not bitwise
                          else ""), flush=True)
    if not (keystr and manifest["n_opt"] == 2 * n + 2 and count == 2):
        fail("the checkpoint is not in the JAX layout with Adam's state")
    if not (loss_rel <= tol["loss"] and norm_rel <= tol["grad_norm"]
            and worst[1] <= tol["leaf"]):
        fail("step 3 after the checkpoint's reload disagrees beyond STEP_TOL")
    if not bitwise:
        fail("step 3 after the checkpoint's reload is not bitwise equal to "
             "step 3 without it")
    report["ckpt_round_trip"] = out
    del state, fresh
    torch.cuda.empty_cache()


def syn_rank_worker(rank, port, out_dir):
    """(b)'s ranks: gloo on cuda:0 with the model axis 2; the flagship
    whole and cut, synthesised in deterministic mode by both engines."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from wavenet_vocoder_tpu_torch.config import Config
    from wavenet_vocoder_tpu_torch.models.wavenet import (
        WaveNet, spec_from_config)
    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    from wavenet_vocoder_tpu_torch.ops.generate import generate
    from wavenet_vocoder_tpu_torch.parallel import initialize_distributed
    from wavenet_vocoder_tpu_torch.parallel.distributed import (
        parallel_groups)
    from wavenet_vocoder_tpu_torch.parallel.sharding import shard_params_tp
    initialize_distributed(f"127.0.0.1:{port}", SYN_RANKS, rank,
                           local_device_ids="0", backend="gloo",
                           timeout_s=MD_TIMEOUT_S)
    groups = parallel_groups(SYN_RANKS)
    cfg = Config()
    models = [WaveNet(spec_from_config(cfg), generator=torch.Generator(
        ).manual_seed(cfg.seed)).cuda().eval() for _ in range(2)]
    whole, cut = models
    shard_params_tp(cut, groups)
    c = torch.from_numpy(np.random.RandomState(5).randn(
        SYN_B, SYN_FRAMES + 2 * cfg.cin_pad, cfg.num_mels).astype(
        np.float32)).cuda()
    res, t0 = {}, time.perf_counter()
    gens = [cg.FusedGenerator(m) for m in models]
    res["pack_equal"] = all(torch.equal(gens[0].packed[k], gens[1].packed[k])
                            for k in gens[0].packed)
    before = _launches("generate.launches")
    k_whole, k_cut = (g(c=c, deterministic=True) for g in gens)
    res["kernel_launches"] = _launches("generate.launches") - before
    res["kernel_equal"] = bool(torch.equal(k_whole, k_cut))
    res["kernel_samples"] = int(k_cut.shape[1])
    res["kernel_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        c_up = whole.upsample_conditioning(c)[:, :SYN_SCAN_T]
    s_whole, s_cut = (generate(m, T=SYN_SCAN_T, c_up=c_up,
                               deterministic=True)["samples"]
                      for m in models)
    res["scan_err"] = float((s_whole - s_cut).abs().max())
    res["scan_s"] = time.perf_counter() - t0
    res["jax_loaded"] = ("jax" in sys.modules
                         or "wavenet_vocoder_tpu" in sys.modules)
    torch.save({"kernel": k_cut.cpu(), "scan": s_cut.cpu()},
               os.path.join(out_dir, f"syn{rank}.pt"))
    with open(os.path.join(out_dir, f"syn{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _cut_synthesis(report, work, total):
    """(b): two gloo ranks on the card, the flagship's blocks cut over the
    model axis 2: the kernel engine's samples equal the whole model's bit
    for bit, the scan engine's within SYN_SCAN_TOL; the ranks equal."""
    import torch
    port = _free_port()
    t0 = time.perf_counter()
    _spawn([_self_cmd("--syn-rank", str(r), "--md-port", str(port),
                      "--md-dir", work) for r in range(SYN_RANKS)],
           "phase 16 (b) ranks")
    secs = time.perf_counter() - t0
    res = [json.load(open(os.path.join(work, f"syn{r}.json")))
           for r in range(SYN_RANKS)]
    outs = [torch.load(os.path.join(work, f"syn{r}.pt"))
            for r in range(SYN_RANKS)]
    ranks_equal = all(torch.equal(outs[0][k], o[k]) for o in outs[1:]
                      for k in outs[0])
    r0 = res[0]
    scan_errs = [f"{r['scan_err']:.2e}" for r in res]
    print(f"[tail] 16 (b) cut-model synthesis: {SYN_RANKS} gloo ranks on "
          f"cuda:0 (model axis {SYN_RANKS}), flagship deterministic, B="
          f"{SYN_B}: kernel engine (bf16 pack) {r0['kernel_samples']} "
          f"samples, packs equal {[r['pack_equal'] for r in res]}, cut == "
          f"whole bit for bit {[r['kernel_equal'] for r in res]} "
          f"({r0['kernel_s']:.1f} s); scan engine {SYN_SCAN_T} steps, max "
          f"|cut - whole| {scan_errs} (tol "
          f"{SYN_SCAN_TOL}; {r0['scan_s']:.1f} s); ranks' outputs bitwise "
          f"equal {ranks_equal}; launches {[r['kernel_launches'] for r in res]}"
          f"; {secs:.1f} s", flush=True)
    if any(r["jax_loaded"] for r in res):
        fail("a phase 16 (b) rank imported JAX")
    if not (all(r["pack_equal"] and r["kernel_equal"] for r in res)
            and all(r["scan_err"] <= SYN_SCAN_TOL for r in res)
            and ranks_equal):
        fail("synthesis of the cut model differs from the whole model's")
    for r in res:
        _add_counts(total, {"generate": dict(launches=r["kernel_launches"])})
    report["cut_synthesis"] = dict(ranks=res, ranks_equal=ranks_equal, s=secs)


def _bf16_scan(report):
    """(c): the eager decoder in bf16 (JAX's semantics: every activation,
    the ring buffers and the fed-back input in bf16) against phase 2's
    bf16 step limits: single steps from its own state against the f32
    decoder and against the kernel with the bf16 pack (the eager ring
    buffers are the kernel's ring, layer after layer). Held: the head's
    outputs within 2e-2 of the f32 decoder's largest; every sample within
    2e-2, except where the mixture's argmax is a near tie in the bf16
    decoder's own outputs (top two within 2 x the largest difference of a
    mixture logit between the bf16 and f32 decoders); the share of such
    flips is printed beside phase 2's 1/512 (a budget set for two
    versions that round at the same points; not held here). 32-step runs
    from zero against both are printed: they part by design."""
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
    from wavenet_vocoder_tpu_torch.ops.generate import generate
    _, model = _flagship_model("cuda", 0)
    spec = model.spec
    nr_mix = spec.out_channels // 3
    c = torch.from_numpy(np.random.RandomState(6).randn(
        BF16_SCAN_B, 2 + 2 * spec.cin_pad, spec.cin_channels).astype(
        np.float32)).cuda()
    with torch.no_grad():
        c_up = model.upsample_conditioning(c)[:, :BF16_SCAN_T]
    tol, bf = TOL["bfloat16"], torch.bfloat16
    packed = cg.pack_weights(model, dtype=bf)
    t0 = time.perf_counter()
    before = _launches("generate.launches")
    state, logits, margins = None, [], []
    diffs = {"f32 decoder": [], "bf16 pack kernel": []}
    for j in range(BF16_SCAN_T):
        kw = dict(T=1, c_up=c_up[:, j:j + 1], deterministic=True,
                  state=state, return_state=True, output="both")
        a, b = generate(model, dtype=bf, **kw), generate(model, **kw)
        logits.append((a["logits"][:, 0], b["logits"][:, 0]))
        top = a["logits"][:, 0, :nr_mix].topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        diffs["f32 decoder"].append(
            (a["samples"] - b["samples"]).abs()[:, 0, 0])
        x_cur, buffers, _ = state or (
            None, [torch.zeros(BF16_SCAN_B, (spec.kernel_size - 1) * d,
                               spec.residual_channels, device="cuda")
                   for d in spec.dilations], 0)
        if x_cur is None:
            x_cur = cg.default_initial_input(spec, BF16_SCAN_B, device="cuda")
        ring = torch.cat([buf.transpose(0, 1) for buf in buffers]).to(bf)
        k_out = torch.empty(BF16_SCAN_B, 1, device="cuda")
        cg.generate_steps(
            packed, spec, ring.contiguous(),
            x_cur.clone(memory_format=torch.contiguous_format), k_out,
            c_up[:, j:j + 1].to(bf).clone(
                memory_format=torch.contiguous_format), None, t0=j, seed=7,
            deterministic=True)
        diffs["bf16 pack kernel"].append(
            (a["samples"][:, 0, 0] - k_out[:, 0]).abs())
        state = a["state"]
    torch.cuda.synchronize()
    lb = torch.stack([x for x, _ in logits], dim=1)
    lf = torch.stack([y for _, y in logits], dim=1)
    logit_err = float((lb - lf).abs().max()) / float(lf.abs().max())
    delta = float((lb - lf)[..., :nr_mix].abs().max())
    tie = torch.stack(margins, dim=1) <= 2 * delta
    out = dict(launches=_launches("generate.launches") - before,
               scan_s=time.perf_counter() - t0, logit_rel=logit_err,
               tie_margin=2 * delta, ties=int(tie.sum()))
    run = dict(T=BF16_SCAN_T, c_up=c_up, deterministic=True)
    scan_bf = generate(model, dtype=bf, **run)["samples"][..., 0]
    runs = {"f32 decoder": generate(model, **run)["samples"][..., 0],
            "bf16 pack kernel": cg.FusedGenerator(
                model, weight_dtype=bf, chunk=BF16_SCAN_T)(**run)}
    bad = [] if logit_err <= tol else ["head outputs"]
    print(f"[tail] 16 (c) bf16 eager decoder: flagship deterministic, B="
          f"{BF16_SCAN_B}, {BF16_SCAN_T} single steps from its own state: "
          f"head outputs vs the f32 decoder's max |diff| / max |output| "
          f"{logit_err:.2e} (tol {tol}); near ties (mixture top two within "
          f"{2 * delta:.3e}) at {out['ties']} of {tie.numel()} steps",
          flush=True)
    for tag, d in diffs.items():
        step = torch.stack(d, dim=1)
        beyond = ~(step <= tol)
        flips = int(beyond.sum())
        unexplained = int((beyond & ~tie).sum())
        ok = step[~beyond]
        err, parted, first = _before_parting((scan_bf - runs[tag]).abs(),
                                             tol)
        out[tag] = dict(step_err=float(ok.max()) if ok.numel() else 0.0,
                        step_flips=flips, unexplained=unexplained,
                        steps=step.numel(), run_err=err, run_parted=parted,
                        run_first_parting=first)
        v = out[tag]
        print(f"[tail] 16 (c) vs the {tag}: samples max |diff| "
              f"{v['step_err']:.2e} (tol {tol}); {flips} of {v['steps']} "
              f"beyond, all at near ties: {unexplained == 0} (phase 2's "
              f"budget {BF16_MAX_FLIPS * v['steps']:.1f}, not held); one "
              f"{BF16_SCAN_T}-step run from zero (not held): max |diff| "
              f"before parting {err:.2e}, streams parted {parted}/"
              f"{BF16_SCAN_B}, first at step {first}", flush=True)
        if unexplained or v["step_err"] > tol:
            bad.append(tag)
    if bad or not out["launches"]:
        fail(f"the bf16 eager decoder leaves phase 2's bf16 step limits: "
             f"{bad}")
    report["bf16_scan"] = out
    return out["launches"]


def _recipe(report, work, total):
    """(d): egs/run_common_torch.sh stages 0-3 with the mol_wavenet.json
    preset on the speech-shaped corpus, each stage timed; every CLI runs
    through ``--run-module`` so that its launches are counted."""
    import shutil
    root = os.path.dirname(os.path.abspath(__file__))
    wavs = os.path.join(work, "wavs")
    subprocess.run([sys.executable, os.path.join(root, "scripts",
                                                 "make_speech_corpus.py"),
                    wavs, "--n", str(RECIPE_UTTS)], check=True,
                   capture_output=True)
    recipe = os.path.join(work, "mol")
    shutil.copytree(os.path.join(root, "egs", "mol", "conf"),
                    os.path.join(recipe, "conf"))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               preset=RECIPE_PRESET,
               PYTHON=f"{sys.executable} {os.path.abspath(__file__)} "
                      "--run-module",
               train_args=f"--max-train-steps {RECIPE_STEPS}")
    stages, counts = {}, {k: 0 for k in _PORT_KERNELS}
    for stage in range(4):
        t0 = time.perf_counter()
        proc = subprocess.run(
            ["bash", "-c", ". " + os.path.join(root, "egs",
                                               "run_common_torch.sh")
             + f" --stage {stage} --stop-stage {stage} --db-root {wavs}"
             " --num-workers 1"],
            cwd=recipe, env=env, capture_output=True, text=True,
            timeout=LOOP_TIMEOUT_S)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"recipe stage {stage} exited {proc.returncode}:\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        launched = {k: 0 for k in _PORT_KERNELS}
        for line in proc.stdout.splitlines():
            if line.startswith("[run-module] kernel launches "):
                c = json.loads(line[len("[run-module] kernel launches "):])
                for k in _PORT_KERNELS:
                    launched[k] += c[k]["launches"]
                _add_counts(total, c)
        for k in _PORT_KERNELS:
            counts[k] += launched[k]
        stages[stage] = dict(s=secs, launches=launched)
        print(f"[tail] 16 (d) recipe stage {stage}: {secs:.1f} s, launches "
              f"{launched}", flush=True)
    expdir = os.path.join(recipe, "exp", "ljspeech_mol_wavenet")
    missing = {}
    for split in ("dev", "eval"):
        utts = [f for f in os.listdir(os.path.join(recipe, "dump", "norm",
                                                   split))
                if f.endswith("-feats.npy")]
        gen = os.listdir(os.path.join(expdir, "generated", split))
        n_gen = sum(f.endswith("_gen.wav") for f in gen)
        if not utts or n_gen < len(utts):
            missing[split] = (len(utts), n_gen)
        stages.setdefault("wavs", {})[split] = (len(utts), n_gen)
    print(f"[tail] 16 (d) recipe egs/mol {RECIPE_PRESET}, {RECIPE_UTTS} "
          f"utterances, {RECIPE_STEPS} train steps: stages "
          f"{[round(stages[s]['s'], 1) for s in range(4)]} s, "
          f"(utterances, *_gen.wav) {stages['wavs']}, launches {counts}",
          flush=True)
    if missing:
        fail(f"recipe stage 3 left utterances without *_gen.wav: {missing}")
    if not (counts["train_fwd"] and counts["train_bwd"]
            and counts["generate"]):
        fail(f"the recipe launched no training or generation kernel: {counts}")
    report["recipe"] = dict(stages=stages, launches=counts)


def phase_slice11(report):
    """Phase 16; returns its launches by kernel (this process's and its
    subprocesses')."""
    import torch
    t0 = time.perf_counter()
    zero_kernel_counts()
    with _work_dir("chip_smoke_ckpt") as work:
        _ckpt_round_trip(report, work)
    _bf16_scan(report)
    total = {k: dict(v) for k, v in kernel_counts().items()}
    torch.cuda.empty_cache()
    with _work_dir("chip_smoke_cut") as work:
        _cut_synthesis(report, work, total)
    with _work_dir("chip_smoke_recipe") as work:
        _recipe(report, work, total)
    report["phase16_s"] = time.perf_counter() - t0
    print(f"[tail] phase 16 in {report['phase16_s']:.1f} s; launches "
          f"{total}", flush=True)
    for k in ("train_fwd", "train_bwd", "generate"):
        if not total[k]["launches"]:
            fail(f"phase 16 launched no {k}")
    return total


# ----------------------------------------------------------------------
# phase 17: the gradients at the quality net's shapes, path by path
# ----------------------------------------------------------------------
# The quality net's mol config (synthetic_e2e.make_config: 12 layers in 2
# stacks, 64/128/64, cin 40, B=8, T=4096, dropout 0.05) at its fresh state
# and after Q_TRAIN_STEPS steps on the kernels (the script's training); the
# gradients of the first Q_BATCHES batches of its pool, batch i's dropout
# seed drawn from a generator seeded Q_GEN_SEED + i in every path: (i) the
# kernels in bf16, (ii) the fused stack's plain versions in bf16 (the
# kernels' arithmetic in torch ops), (iii) the layer loop in bf16, (iv) the
# layer loop in f32 with TF32 off, the reference. Per leaf, over the
# batches: e = the largest max |g - g_ref| / max |g_ref| (grad_errors), and
# the mean of cos(g - g_ref, g_ref), which a systematic error moves away
# from 0 (printed for the leaves of 64 elements or more). Held: e(i) <= Q_RATIO * e(ii) + Q_SLACK for every leaf whose
# reference gradient reaches the floor of grad_errors (1e-6 of the largest
# leaf's; below it, first_conv.weight_v: zero but for rounding, printed).
Q_BATCHES, Q_TRAIN_STEPS, Q_GEN_SEED = 4, 300, 3
Q_RATIO, Q_SLACK = 1.5, 1e-3
Q_PATHS = ("kernels bf16", "fused plain bf16", "layer loop bf16",
           "layer loop f32")


def _path_grads(cfg, model, batch, seed, path):
    """Each parameter's gradient (f32, by name) of one train step on
    ``path`` from ``model``'s weights, the step's dropout seed drawn from a
    generator seeded ``seed``; and the loss."""
    import copy
    import dataclasses

    import torch

    from wavenet_vocoder_tpu_torch.training.train_state import (
        create_train_state, make_train_step)
    loop = path.startswith("layer loop")
    cfg = cfg.replace(fused_train=not loop,
                      compute_dtype="" if path.endswith("f32") else
                      cfg.compute_dtype)
    model = copy.deepcopy(model)
    model.spec = dataclasses.replace(model.spec, fused_train=not loop)
    state = create_train_state(cfg, model=model)
    step, _ = make_train_step(cfg)
    with _plain_stack() if path == "fused plain bf16" else contextlib.nullcontext():
        m = step(state, batch, torch.Generator().manual_seed(seed))
    return ({n: p.grad.detach().float().clone()
             for n, p in state.model.named_parameters()}, float(m["loss"]))


def phase_quality_grads(report):
    """Phase 17; returns its launches by kernel."""
    import numpy as np
    import torch

    from wavenet_vocoder_tpu_torch.data.prefetch import to_device
    from wavenet_vocoder_tpu_torch.scripts import synthetic_e2e as se
    from wavenet_vocoder_tpu_torch.training.train_state import create_train_state
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zero_kernel_counts()
    cfg = se.make_config("mol")
    train_data, _, _ = se.build_corpus(cfg)
    pool = se.batch_pool(cfg, train_data, np.random.RandomState(1))
    batches = [to_device(b, "cuda", pin_memory=False)
               for b in pool[:Q_BATCHES]]
    fresh = create_train_state(cfg).model
    trained = se.train(cfg, train_data, Q_TRAIN_STEPS, torch.device("cuda"))[0].model
    out, bad = {}, []
    for tag, model in (("fresh", fresh), (f"{Q_TRAIN_STEPS} steps", trained)):
        errs = {p: {} for p in Q_PATHS[:3]}
        cosines = {p: {} for p in Q_PATHS[:3]}
        losses = {p: [] for p in Q_PATHS}
        noise = set()
        for i, batch in enumerate(batches):
            g = {}
            for path in Q_PATHS:
                g[path], loss = _path_grads(cfg, model, batch, Q_GEN_SEED + i,
                                            path)
                losses[path].append(loss)
            ref = g["layer loop f32"]
            floor = grad_scale_floor(ref)
            noise |= {n for n, r in ref.items() if float(r.abs().max()) < floor}
            for path in Q_PATHS[:3]:
                for n, e in grad_errors(g[path], ref).items():
                    errs[path][n] = max(errs[path].get(n, 0.0), e)
                    d = (g[path][n] - ref[n]).flatten().double()
                    r = ref[n].flatten().double()
                    den = float(d.norm() * r.norm())
                    cos = float(d @ r) / den if den > 0 else 0.0
                    cosines[path][n] = cosines[path].get(n, 0.0) + cos / Q_BATCHES
        ek, ep, el = (errs[p] for p in Q_PATHS[:3])
        held = [n for n in ek if n not in noise]
        over = [n for n in held if not ek[n] <= Q_RATIO * ep[n] + Q_SLACK]
        worst = sorted(held, key=lambda n: -(ek[n] - Q_RATIO * ep[n]))[:5]
        # (a leaf of a few elements has a cosine near +-1 whatever its error)
        big = {n for n, p in fresh.named_parameters() if p.numel() >= 64}
        biased = {p: max(((n, c) for n, c in cosines[p].items() if n in big),
                         key=lambda kv: abs(kv[1])) for p in Q_PATHS[:3]}
        out[tag] = dict(e=errs, mean_cos=cosines, losses=losses,
                        noise_leaves=sorted(noise), over=over)
        print(f"[quality-grads] mol at the quality net's shapes (B=8, "
              f"T=4096, bf16, dropout 0.05), {tag}, {Q_BATCHES} batches of "
              f"the pool: losses "
              + ", ".join(f"{p} {np.mean(v):.5f}" for p, v in losses.items())
              + f"; e(kernels) <= {Q_RATIO} e(fused plain) + {Q_SLACK} on "
              f"{len(held) - len(over)} of {len(held)} leaves; closest: "
              + ", ".join(f"{n} {ek[n]:.2e} vs {ep[n]:.2e} (loop bf16 "
                          f"{el[n]:.2e})" for n in worst)
              + "; largest |mean cos(g - ref, ref)| of a leaf of 64 "
              "elements or more: "
              + ", ".join(f"{p} {n} {c:+.3f}" for p, (n, c) in biased.items())
              + (f"; below the floor (not held): "
                 + ", ".join(f"{n} {ek[n]:.1e} vs {ep[n]:.1e}"
                             for n in sorted(noise)) if noise else ""),
              flush=True)
        print("[quality-grads] " + tag + ", largest e by path: "
              + "; ".join(f"{p} " + ", ".join(
                  f"{n} {v:.2e}" for n, v in sorted(
                      errs[p].items(), key=lambda kv: -kv[1])[:4])
                  for p in Q_PATHS[:3]), flush=True)
        bad += [f"{tag} {n}: e(kernels) {ek[n]:.3e} > {Q_RATIO} x "
                f"{ep[n]:.3e} + {Q_SLACK}" for n in over]
    total = {k: dict(v) for k, v in kernel_counts().items()}
    report["quality_grads"] = dict(states=out, launches=total,
                                   s=time.perf_counter() - t0)
    print(f"[tail] phase 17 in {report['quality_grads']['s']:.1f} s; "
          f"launches {total}", flush=True)
    if bad:
        fail("the kernels' gradients at the quality net's shapes are off "
             "beyond their plain versions': " + "; ".join(bad))
    for k in ("train_fwd", "train_bwd"):
        if not total[k]["launches"]:
            fail(f"phase 17 launched no {k}")
    return total


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
    lp = report["loop"]
    prof = lp["profiles"]["prefetch"]
    idle = prof["idle"] if prof is not None else float("nan")
    parts.append(f"loop from a dump: cli.train {LOOP_STEPS} steps in "
                 f"{lp['cli_s']:.1f} s, losses {lp['logged_losses'][0]:.4f}"
                 f" -> {lp['logged_losses'][-1]:.4f}; step median with "
                 f"prefetch {lp['times']['prefetch']['median_ms']:.1f} ms, "
                 f"without {lp['times']['no_prefetch']['median_ms']:.1f} ms "
                 f"(phase 7 synthetic {lp['synthetic_step_ms']:.1f} ms), "
                 f"idle {idle:.1%}; f32 prefetch vs not rel "
                 f"{lp['f32_rel']:.2e}")
    md = report["multi_device"]
    rk = md["ranks"]
    parts.append(f"multi-device: 2 gloo ranks on one card vs one process "
                 f"loss rel {rk['loss_rel']:.2e}, grad norm rel "
                 f"{max(rk['grad_norm_rel']):.2e}, ranks bitwise equal "
                 f"{rk['ranks_equal']}; cli.train over NCCL (world 1) step "
                 f"{md['nccl']['step_ms']:.1f} ms; sharded synthesis equal "
                 f"{md['synthesis']['det_equal']}/{MD_SYNTH_B}; evaluation "
                 f"shards {[len(x) for x in md['evaluation']['manifests']]}"
                 f" equal {md['evaluation']['equal']}/{EVAL_UTTS}; phase "
                 f"{md['total_s']:.1f} s")
    bn = report["bench"]
    for tag, run in bn["runs"].items():
        rec = run["record"]
        mfu = rec["detail"].get("mfu")
        parts.append(f"bench {tag} {rec['value']} {rec['unit']}"
                     + (f" (MFU {mfu})" if mfu is not None else ""))
    tr = bn["runs"]["synthesis flagship"]["record"]["detail"]["training"]
    parts.append(f"bench compact train B={tr['batch']} {tr['value']} "
                 f"samples/s (MFU {tr['mfu']}); flagship vs phase 3 "
                 f"{bn['phase3_ratio']:.3f}")
    for name, t in bn["models"].items():
        parts.append(f"generate {name} B={t['B']} {t['us_per_step']:.1f} "
                     f"us/step ({t['bound_ms'] / t['ms']:.1%} of bound)")
    for head, rec in report["quality"]["heads"].items():
        parts.append(f"quality {head}: corr {rec['mel_corr']} F0 "
                     f"{rec['f0_gen']} Hz loss {rec['loss_first']} -> "
                     f"{rec['loss_final']}")
    nc = report["quality"]["negative_control"]
    rec = nc["record"]
    parts.append(f"quality {nc['head']} under {nc['fault']}: exit {nc['rc']},"
                 f" corr {rec['mel_corr']} F0 {rec['f0_gen']} Hz loss "
                 f"{rec['loss_first']} -> {rec['loss_final']}")
    for name, o in report["optimizers"].items():
        parts.append(f"{name} update err {o['update_err']:.1e}, 20-step loss "
                     f"{o['losses'][0]:.3f} -> {o['losses'][-1]:.3f}, step "
                     f"{o['host_ms']:.1f} ms")
    for tag, r in report["remat"].items():
        parts.append(f"remat {tag}: peak {r['peak_gb']:.2f} GB, step "
                     f"{r['step_ms']:.1f} ms")
    for leg, t in report["tensor_parallel"].items():
        parts.append(f"TP {leg}: loss rel {max(t['loss_rel']):.1e}, grad "
                     f"norm rel {t['grad_norm_rel'][0]:.1e}")
    parts.append(f"dryrun_multichip(4) {report['dryrun']['s']:.1f} s; phase "
                 f"15 {report['phase15_s']:.1f} s")
    ck, bs = report["ckpt_round_trip"], report["bf16_scan"]
    parts.append(f"checkpoint round trip step 3 loss rel {ck['loss_rel']:.1e}"
                 f", grad norm rel {ck['grad_norm_rel']:.1e}")
    parts.append(f"cut-model synthesis kernel equal "
                 f"{all(r['kernel_equal'] for r in report['cut_synthesis']['ranks'])}"
                 f", scan err {max(r['scan_err'] for r in report['cut_synthesis']['ranks']):.1e}")
    for tag in ("f32 decoder", "bf16 pack kernel"):
        v = bs[tag]
        parts.append(f"bf16 eager decoder vs {tag}: step err "
                     f"{v['step_err']:.1e}, {v['step_flips']}/{v['steps']} "
                     f"beyond ({v['unexplained']} not at near ties)")
    st = report["recipe"]["stages"]
    parts.append(f"recipe stages {[round(st[s]['s'], 1) for s in range(4)]} "
                 f"s; phase 16 {report['phase16_s']:.1f} s")
    parts.append("repeat bitwise: phase 5 "
                 f"{all(r['repeat_bitwise'] for r in report['train_kernel_vs_plain'])}"
                 ", phase 6 " + ", ".join(
                     f"{p} {not r['differ']}"
                     for p, r in report["training"]["repeat"].items())
                 + f", phase 16 (a) {ck['bitwise']}")
    qg = report["quality_grads"]
    parts.append(f"phase 17 {qg['s']:.1f} s: e(kernels) within "
                 f"{Q_RATIO} e(fused plain) + {Q_SLACK} on every held leaf "
                 + ", ".join(f"({t}: {len(v['over'])} over)"
                             for t, v in qg["states"].items()))
    return "[summary] " + "; ".join(parts) + f"; total {report['total_s']:.1f} s"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the full report as JSON here")
    # what phase 12 starts this script as, in processes of their own
    ap.add_argument("--md-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--md-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--md-dir", help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--syn-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--run-module", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
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
    if args.run_module:
        return run_module(args.run_module)
    if args.md_rank is not None:
        return md_rank_worker(args.md_rank, args.md_port, args.md_dir)
    if args.tp_rank is not None:
        return tp_rank_worker(args.tp_rank, args.md_port, args.md_dir)
    if args.syn_rank is not None:
        return syn_rank_worker(args.syn_rank, args.md_port, args.md_dir)
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
        phase = "loop"
        loop_launches = phase_loop(report)
        kernel_line["loop_launches"] = loop_launches["generate"]["launches"]
        for line in train_lines:
            key = line["name"][3:]          # wn_train_fwd -> train_fwd
            line["loop_launches"] = loop_launches[key]["launches"]
            line["loop_tc_launches"] = loop_launches[key]["tc_launches"]
        phase = "multi-device"
        md = phase_multi_device(report)
        kernel_line["multi_device_launches"] = md["generate"]["launches"]
        for line in train_lines:
            key = line["name"][3:]
            line["multi_device_launches"] = md[key]["launches"]
            line["multi_device_tc_launches"] = md[key]["tc_launches"]
        torch.cuda.empty_cache()
        phase = "bench"
        bench = phase_bench(report)
        phase = "quality"
        quality = phase_quality(report)
        for line, key in ((kernel_line, "generate"), (train_lines[0], "train_fwd"),
                          (train_lines[1], "train_bwd"), (mel_line, "logmel")):
            for tag, counts in (("bench", bench), ("quality", quality)):
                c = counts.get(key, {})
                line[f"{tag}_launches"] = c.get("launches", 0)
                if "tc_launches" in c:
                    line[f"{tag}_tc_launches"] = c["tc_launches"]
        for name, t in report["bench"]["models"].items():
            kernel_line[f"ms_{name}"] = t["ms"]
            kernel_line[f"plain_ms_{name}"] = t["plain_ms"]
            kernel_line[f"bound_ms_{name}"] = t["bound_ms"]
            kernel_line[f"bound_by_{name}"] = t["bound_by"]
        torch.cuda.empty_cache()
        phase = "parallel-optim"
        p15 = phase_parallel_optim(report)
        for line, key in ((kernel_line, "generate"),
                          (train_lines[0], "train_fwd"),
                          (train_lines[1], "train_bwd"), (mel_line, "logmel")):
            line["phase15_launches"] = p15.get(key, {}).get("launches", 0)
        torch.cuda.empty_cache()
        phase = "slice-11"
        p16 = phase_slice11(report)
        for line, key in ((kernel_line, "generate"),
                          (train_lines[0], "train_fwd"),
                          (train_lines[1], "train_bwd"), (mel_line, "logmel")):
            line["phase16_launches"] = p16.get(key, {}).get("launches", 0)
        torch.cuda.empty_cache()
        phase = "quality-grads"
        p17 = phase_quality_grads(report)
        for line, key in ((kernel_line, "generate"),
                          (train_lines[0], "train_fwd"),
                          (train_lines[1], "train_bwd"), (mel_line, "logmel")):
            line["phase17_launches"] = p17.get(key, {}).get("launches", 0)
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
