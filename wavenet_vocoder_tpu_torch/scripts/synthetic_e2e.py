"""End-to-end quality check of the port on synthetic audio.

The port's counterpart of the repository's ``scripts/synthetic_e2e.py``.
Builds a corpus of harmonic tones with per-utterance F0, trains a mid-size
WaveNet conditioned on log-mel on the fused training kernels, then free-runs
the generation kernel from a HELD-OUT utterance's mel and checks that the
generated waveform's dominant frequency and log-mel structure match that
utterance — i.e. the model actually uses its conditioning. The corpus, the
batches, the model and the thresholds are the JAX script's; its batches equal
the JAX script's bit for bit.

Covers the three output heads of the reference recipes
(egs/{mulaw256,mol,gaussian}): --head selects the categorical mu-law-256
head, the discretized mixture of logistics on raw audio, or the single
Gaussian. --fault builds the training backward with a deliberate gradient
bug (``ops/cuda_train.FAULTS``); such a run must FAIL.

    python -m wavenet_vocoder_tpu_torch.scripts.synthetic_e2e \\
        [--steps N] [--head mulaw256|mol|gaussian] [--fault F] [--xla]

It runs on the card; ``--device cpu`` runs the plain versions (tests).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.data.prefetch import to_device
from wavenet_vocoder_tpu_torch.dsp import audio as dsp
from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
from wavenet_vocoder_tpu_torch.ops import cuda_train
from wavenet_vocoder_tpu_torch.ops.mulaw import mulaw_quantize
from wavenet_vocoder_tpu_torch.synthesis import (
    batch_wavegen,
    pad_mel_context,
    resolve_device,
)
from wavenet_vocoder_tpu_torch.training.train_state import (
    create_train_state,
    make_train_step,
)

# corpus: 8 train F0s and one held-out UTTERANCE at a trained F0 (new phases
# and content; tests conditioning use without asking for F0 interpolation)
TRAIN_F0S = (110, 147, 196, 220, 262, 330, 392, 440)
F0_TEST = 220.0
TRAIN_SECONDS = 2.0
HELD_OUT_SECONDS = 1.5     # length of the held-out utterance and the decoys
POOL_SIZE = 24             # batches staged on the device
N_ROLLOUTS = 3
MEL_CORR_MIN = {"mulaw256": 0.85, "mol": 0.90, "gaussian": 0.90}
HEADS = ("mulaw256", "mol", "gaussian")
# head-specific keys mirror the three reference recipes; dropout: mol and
# gaussian train at the reference WaveNet class default 0.05 (which exercises
# the kernels' counter-hash mask and makes bwd_mask_tshift injectable),
# mulaw256 at its recipe's 0.0
HEAD_CFG = {
    "mulaw256": dict(input_type="mulaw-quantize", quantize_channels=256,
                     out_channels=256, dropout=0.0),
    "mol": dict(input_type="raw", quantize_channels=65536,
                out_channels=10 * 3, output_distribution="Logistic",
                log_scale_min=-16.0, dropout=0.05),
    "gaussian": dict(input_type="raw", quantize_channels=65536,
                     out_channels=2, output_distribution="Normal",
                     log_scale_min=-16.0, dropout=0.05),
}


def make_utterance(f0: float, sr: int, seconds: float, rs) -> np.ndarray:
    t = np.arange(int(sr * seconds)) / sr
    x = np.zeros_like(t)
    for h, amp in ((1, 1.0), (2, 0.5), (3, 0.25)):
        x += amp * np.sin(2 * np.pi * f0 * h * t + rs.uniform(0, 6.28))
    # slow amplitude modulation so mels vary over time
    x *= 0.35 * (0.6 + 0.4 * np.sin(2 * np.pi * 2.0 * t))
    return x.astype(np.float32)


def dominant_f0(x: np.ndarray, sr: int) -> float:
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    freqs = np.fft.rfftfreq(len(x), 1 / sr)
    lo = freqs > 60
    return float(freqs[lo][np.argmax(spec[lo])])


def mel_correlation(mel_a: np.ndarray, mel_b: np.ndarray,
                    trim: int = 4) -> float:
    """Mean per-frame Pearson correlation between two log-mel spectrograms
    (frames trimmed to skip generator warm-up). Correlation rather than a
    distance: sampled audio has a broadband noise floor that clean tones
    lack, so distances measure the floor and correlation the harmonic
    structure."""
    n = min(mel_a.shape[0], mel_b.shape[0]) - trim
    a, b = mel_a[trim:n], mel_b[trim:n]
    a = a - a.mean(axis=1, keepdims=True)
    b = b - b.mean(axis=1, keepdims=True)
    num = (a * b).sum(axis=1)
    den = np.sqrt((a * a).sum(axis=1) * (b * b).sum(axis=1)) + 1e-9
    return float(np.mean(num / den))


def make_config(head: str, sr: int = 16000, lr: float = 5e-4,
                xla: bool = False) -> Config:
    """12L/2S, 64/128/64, 40 mels, B=8, T=4096; the fused training kernels
    unless ``xla`` (the plain layer loop)."""
    return Config(
        sample_rate=sr, fft_size=512, hop_size=128, win_length=512,
        num_mels=40, fmin=60, fmax=7600, cin_channels=40, cin_pad=2,
        layers=12, stacks=2, residual_channels=64, gate_channels=128,
        skip_out_channels=64, max_time_steps=4096,
        upsample_conditional_features=True,
        upsample_params={"upsample_scales": [4, 4, 8]},
        batch_size=8, lr_schedule="", fused_train=not xla,
        optimizer_params={"lr": lr, "eps": 1e-8, "weight_decay": 0.0},
        **HEAD_CFG[head])


def featurize(wav: np.ndarray, cfg: Config):
    """(target, mel): the head's target (clipped audio, or mu-law codes)
    cut to whole frames, and its log-mel (host numpy)."""
    mel = dsp.logmelspectrogram(wav, cfg)
    if cfg.is_scalar_input:
        target = np.clip(wav, -1, 1).astype(np.float32)
    else:
        target = mulaw_quantize(np.clip(wav, -1, 1), cfg.quantize_channels - 1)
    hop = cfg.hop_size
    n = min(len(target) // hop, mel.shape[0])
    return target[:n * hop], mel[:n]


def build_corpus(cfg: Config):
    """(train_data, test_wav, test_mel): the featurized training tones, and
    the held-out utterance with its log-mel."""
    sr = cfg.sample_rate
    rs = np.random.RandomState(0)
    train_data = [featurize(make_utterance(f, sr, TRAIN_SECONDS, rs), cfg)
                  for f in TRAIN_F0S]
    test_wav = make_utterance(F0_TEST, sr, HELD_OUT_SECONDS,
                              np.random.RandomState(99))
    _, test_mel = featurize(test_wav, cfg)
    return train_data, test_wav, test_mel


def sample_batch(cfg: Config, train_data, step_rs) -> dict:
    """One batch of random crops (numpy), drawn from ``step_rs``."""
    T = cfg.max_time_steps
    hop = cfg.hop_size
    frames = T // hop
    scalar = cfg.is_scalar_input
    eye = np.eye(256, dtype=np.float32)
    xs, ys, cs = [], [], []
    for _ in range(cfg.batch_size):
        target, mel = train_data[step_rs.randint(len(train_data))]
        max_s = mel.shape[0] - frames - cfg.cin_pad
        s = step_rs.randint(cfg.cin_pad, max_s)
        seg = target[s * hop:(s + frames) * hop]
        if scalar:
            xs.append(seg[:, None])
            ys.append(seg[:, None])
        else:
            xs.append(eye[seg])
            ys.append(seg)
        cs.append(mel[s - cfg.cin_pad:s + frames + cfg.cin_pad])
    y = np.stack(ys)
    return {"x": np.stack(xs).astype(np.float32),
            "y": y.astype(np.float32) if scalar else y.astype(np.int32),
            "c": np.stack(cs).astype(np.float32),
            "input_lengths": np.full(cfg.batch_size, T, np.int32)}


def batch_pool(cfg: Config, train_data, srs, n: int = POOL_SIZE) -> list:
    """The pool of n random-crop batches (numpy) drawn from ``srs``; the
    training loop then cycles it in the order ``srs.randint(n)`` gives."""
    return [sample_batch(cfg, train_data, srs) for _ in range(n)]


def score(wavs, test_wav, sr: int, hop: int, f0_tol: float,
          mel_corr_min: float):
    """Per rollout (ok, corr, f0, margin, wav) and the reference F0: the
    generated log-mel (128 mels / 1024 fft, finer than the model's) must
    correlate with the held-out target at least ``mel_corr_min`` and more
    than with every decoy (training F0s more than 30 Hz away), and its
    dominant F0 (after 2000 samples of warm-up) must be within ``f0_tol``
    of the target's."""
    f0_ref = dominant_f0(test_wav, sr)
    mcfg = Config(sample_rate=sr, fft_size=1024, hop_size=hop,
                  win_length=1024, num_mels=128, fmin=60, fmax=7600)
    target_m = dsp.logmelspectrogram(test_wav, mcfg)
    decoys = [f for f in TRAIN_F0S if abs(f - F0_TEST) > 30]
    decoy_m = [dsp.logmelspectrogram(
        make_utterance(f, sr, HELD_OUT_SECONDS, np.random.RandomState(7)),
        mcfg) for f in decoys]
    per_roll = []
    for wav_i in wavs:
        m = dsp.logmelspectrogram(wav_i, mcfg)
        corr = mel_correlation(m, target_m)
        f0_i = dominant_f0(wav_i[2000:], sr)
        margin = corr - max(mel_correlation(m, dm) for dm in decoy_m)
        ok = (abs(f0_i - f0_ref) < f0_tol * f0_ref
              and corr >= mel_corr_min and margin > 0)
        per_roll.append((ok, corr, f0_i, margin, wav_i))
    return per_roll, f0_ref


def loss_dropped(head: str, first: float, final: float) -> bool:
    """The per-head loss-drop check."""
    if head == "mol":
        # discretized NLL over 64k bins: absolute drop, floor isn't near zero
        return final < first - 2.0
    if head == "gaussian":
        # continuous NLL; goes negative as the predicted scales shrink
        return final < first - 1.0
    return final < first * 0.5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--head", default="mulaw256", choices=HEADS)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--f0-tol", type=float, default=0.05,
                    help="relative F0-tracking tolerance")
    ap.add_argument("--mel-corr", type=float, default=None,
                    help="minimum mean per-frame log-mel correlation of the "
                         "generated audio vs the held-out target; default "
                         "per head (mulaw256 0.85, mol and gaussian 0.90)")
    ap.add_argument("--fault", default="none",
                    choices=tuple(cuda_train.FAULTS),
                    help="build the training backward with a deliberate "
                         "gradient bug; the run must then FAIL")
    ap.add_argument("--xla", action="store_true",
                    help="the plain training layer loop and the eager "
                         "decoder instead of the kernels")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--out-dir", default=None,
                    help="where the best rollout's wav goes (default: the "
                         "temporary directory)")
    args = ap.parse_args(argv)
    if args.fault == "bwd_mask_tshift" and args.head == "mulaw256":
        # the mask fault only perturbs the dropout branch, and mulaw256
        # trains at dropout 0.0 — the run would be a silent no-op PASS
        raise SystemExit(
            "--fault bwd_mask_tshift needs a dropout>0 head (mol/gaussian);"
            " mulaw256 trains at dropout 0.0 — use bwd_x_shift instead")
    device = resolve_device(args.device)
    if args.fault != "none" and (args.xla or device.type != "cuda"):
        raise SystemExit("--fault builds the backward kernel, which only the "
                         "fused path on the card runs")
    cuda_train.set_fault(args.fault)
    if args.fault != "none":
        print(f"FAULT INJECTION: {args.fault} (this run is EXPECTED to fail)")
    try:
        return _run(args, device)
    finally:
        cuda_train.set_fault("none")


def train(cfg: Config, train_data, steps: int, device: torch.device,
          dropout_seed: int = 0):
    """Train a fresh model (init from ``cfg.seed``) for ``steps`` steps on
    the pool of random crops, staged on the device and cycled in random
    order (the JAX script's, bit for bit); the steps' dropout seeds come
    from a generator seeded ``dropout_seed``. Returns (state, first loss,
    final loss, seconds)."""
    state = create_train_state(cfg, device=device)
    step_fn, _ = make_train_step(cfg)
    gen = torch.Generator().manual_seed(dropout_seed)
    srs = np.random.RandomState(1)
    pool = [to_device(b, device, pin_memory=False)
            for b in batch_pool(cfg, train_data, srs)]
    print(f"staged {len(pool)} device batches", flush=True)
    t0 = time.time()
    first = None
    for i in range(steps):
        m = step_fn(state, pool[srs.randint(len(pool))], gen)
        if i % 200 == 0 or i == steps - 1:
            loss = float(m["loss"])
            first = first if first is not None else loss
            print(f"step {i}: loss {loss:.3f} "
                  f"({(i + 1) / (time.time() - t0):.1f} steps/s)", flush=True)
    return state, first, float(m["loss"]), time.time() - t0


def rollouts(model, cfg: Config, test_mel, engine: str,
             device: torch.device):
    """N_ROLLOUTS waveforms free-run from the held-out mel in one batched
    call of ``engine`` ("cuda": the generation kernel; "scan": the eager
    decoder), sampling from a device generator seeded 42."""
    c = pad_mel_context(
        np.repeat(test_mel[None].astype(np.float32), N_ROLLOUTS, axis=0),
        cfg.cin_pad)
    return batch_wavegen(model, cfg, c=c, engine=engine, device=device,
                         generator=torch.Generator(device=device).manual_seed(42))


def _run(args, device: torch.device) -> int:
    """Train, roll out and score one head; 0 if every check passes."""
    cfg = make_config(args.head, args.sr, args.lr, args.xla)
    sr = cfg.sample_rate
    spec = spec_from_config(cfg)
    print(f"model: {cfg.layers}L/{cfg.stacks}S r{cfg.residual_channels} "
          f"rf={spec.receptive_field} head={args.head} device={device}",
          flush=True)
    train_data, test_wav, test_mel = build_corpus(cfg)
    state, first, final_loss, train_s = train(cfg, train_data, args.steps,
                                              device)

    # generate with the trained parameters (NOT the EMA shadow: at decay
    # 0.9999 and a few thousand steps it is still mostly the random init).
    # Three independent rollouts in one batched call: the free-running
    # sampler is chaotic, so the net scores the BEST rollout; a broken model
    # or kernel breaks all of them.
    engine = "scan" if args.xla else "cuda"
    t0 = time.time()
    wavs = rollouts(state.model, cfg, test_mel, engine, device)
    gen_s = time.time() - t0

    mel_corr_min = (args.mel_corr if args.mel_corr is not None
                    else MEL_CORR_MIN[args.head])
    per_roll, f0_ref = score(wavs, test_wav, sr, cfg.hop_size, args.f0_tol,
                             mel_corr_min)
    print("rollouts: " + ", ".join(
        f"corr {c:.3f}/F0 {f:.0f}Hz/margin {mg:+.3f}"
        f"{' OK' if ok else ''}" for ok, c, f, mg, _ in per_roll))
    # the best passing rollout, else the max-corr one
    passing = [r for r in per_roll if r[0]]
    _, c_ref, f0_gen, c_margin, wav = (
        max(passing, key=lambda r: r[1]) if passing
        else max(per_roll, key=lambda r: r[1]))
    print(f"\nloss: {first:.3f} -> {final_loss:.3f}")
    print(f"held-out F0: reference {f0_ref:.1f} Hz, generated {f0_gen:.1f} Hz "
          f"({abs(f0_gen - f0_ref) / f0_ref * 100:.1f}% off)")
    print(f"log-mel correlation: to target {c_ref:.3f} "
          f"(margin over best decoy {c_margin:+.3f})")
    out_dir = args.out_dir or tempfile.gettempdir()
    os.makedirs(out_dir, exist_ok=True)
    out_wav = os.path.join(out_dir, f"synthetic_e2e_{args.head}_gen.wav")
    dsp.save_wav(wav, out_wav, sr)
    print(f"wrote {out_wav}")

    ok_loss = loss_dropped(args.head, first, final_loss)
    ok_f0 = abs(f0_gen - f0_ref) < args.f0_tol * f0_ref
    ok_mel = c_ref >= mel_corr_min and c_margin > 0
    print(json.dumps({"head": args.head, "loss_first": round(first, 3),
                      "loss_final": round(final_loss, 3),
                      "f0_ref": round(f0_ref, 1),
                      "f0_gen": round(f0_gen, 1),
                      "mel_corr": round(c_ref, 3),
                      "mel_margin": round(c_margin, 3),
                      "fault": args.fault, "engine": engine,
                      "steps": args.steps, "train_s": round(train_s, 1),
                      "gen_s": round(gen_s, 1),
                      "rollouts": [[round(c, 3), round(f, 1), round(mg, 3),
                                    ok] for ok, c, f, mg, _ in per_roll],
                      "device": (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu")}),
          flush=True)
    print(f"loss-drop check: {'PASS' if ok_loss else 'FAIL'}; "
          f"F0-tracking check ({args.f0_tol:.0%}): "
          f"{'PASS' if ok_f0 else 'FAIL'}; "
          f"log-mel check (corr>={mel_corr_min}, margin>0): "
          f"{'PASS' if ok_mel else 'FAIL'}", flush=True)
    return 0 if (ok_loss and ok_f0 and ok_mel) else 1


if __name__ == "__main__":
    sys.exit(main())
