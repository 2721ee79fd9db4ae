"""How often the PyTorch port passes the sampled-audio quality net, and on
which side it fails, on one GPU.

    python -m wavenet_vocoder_tpu_torch.scripts.quality_spread \
        [--heads mol,gaussian] [--reps 4] [--scan-reps 1] [--out spread.json]

Per head and repetition, in turns: train the quality net's model
(``wavenet_vocoder_tpu_torch.scripts.synthetic_e2e``: the JAX script's
corpus, batches, model and 1500 steps) on the training kernels, then on the
plain layer loop (``fused_train=False``, the script's ``--xla`` training);
roll each trained model out through the generation kernel (engine "cuda")
and, in the first ``--scan-reps`` repetitions, through the eager decoder
(engine "scan") as well, and score every rollout with the script's scorer
and thresholds. Training is not repeatable on the card (the training
kernels' weight gradients are f32 atomic sums), so each repetition is a new
draw. Prints one ``[spread]`` JSON line per trained model and a summary
with the card's name and power limit. It runs on the card; ``--device cpu``
runs the plain versions (tests).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from wavenet_vocoder_tpu_torch.scripts import synthetic_e2e as se
from wavenet_vocoder_tpu_torch.synthesis import resolve_device
from wavenet_vocoder_tpu_torch.utils.profiling import gpu_name_and_limit


def one(head, xla, reps_scan, rep, corpora, device, steps):
    """Train one model of ``head`` (on the kernels, or the plain loop when
    ``xla``), roll it out and score it; the record."""
    cfg = se.make_config(head, xla=xla)
    if head not in corpora:
        corpora[head] = se.build_corpus(cfg)
    train_data, test_wav, test_mel = corpora[head]
    state, first, final, train_s = se.train(cfg, train_data, steps, device)
    rec = dict(head=head, train="plain loop" if xla else "kernels", rep=rep,
               loss_first=round(first, 3), loss_final=round(final, 3),
               loss_ok=se.loss_dropped(head, first, final),
               train_s=round(train_s, 1))
    engines = ("cuda", "scan") if rep < reps_scan else ("cuda",)
    for engine in engines:
        wavs = se.rollouts(state.model, cfg, test_mel, engine, device)
        rolls, _ = se.score(wavs, test_wav, cfg.sample_rate, cfg.hop_size,
                            0.05, se.MEL_CORR_MIN[head])
        rec[engine] = [[round(c, 3), round(f, 1), round(m, 3), ok]
                       for ok, c, f, m, _ in rolls]
        rec[engine + "_pass"] = rec["loss_ok"] and any(r[3] for r in rec[engine])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--heads", default="mol,gaussian")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--scan-reps", type=int, default=1,
                    help="repetitions whose models are also rolled out "
                         "through the eager decoder (~150 s each)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--out", help="write the records as JSON here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    corpora, out = {}, []
    for head in args.heads.split(","):
        for rep in range(args.reps):
            for xla in (False, True):
                rec = one(head, xla, args.scan_reps, rep, corpora, device,
                          args.steps)
                out.append(rec)
                print("[spread] " + json.dumps(rec), flush=True)
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    gpu = gpu_name_and_limit() if device.type == "cuda" else "cpu"
    for head in args.heads.split(","):
        for train in ("kernels", "plain loop"):
            for engine in ("cuda", "scan"):
                runs = [r for r in out if r["head"] == head
                        and r["train"] == train and engine in r]
                if runs:
                    n = sum(r[engine + "_pass"] for r in runs)
                    print(f"[spread] {head}, trained on the {train}, rolled "
                          f"out by {engine}: {n}/{len(runs)} pass; {gpu}",
                          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(gpu=gpu, runs=out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
