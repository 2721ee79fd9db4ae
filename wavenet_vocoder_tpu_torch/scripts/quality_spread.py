"""How often the PyTorch port passes the sampled-audio quality net, seed by
seed and arm by arm, on one GPU.

    python -m wavenet_vocoder_tpu_torch.scripts.quality_spread \
        [--heads mol,gaussian] [--seeds 0,1,2] \
        [--arms kernels,fused-plain,loop] [--reps 1] [--scan-reps 1] \
        [--jobs 1] [--out spread.json]

Per head, seed, repetition and arm: train the quality net's model
(``wavenet_vocoder_tpu_torch.scripts.synthetic_e2e``: the JAX script's
corpus, batch pool, batch order, model and 1500 steps) on the arm's path:

* ``kernels``: the fused stack on the training kernels (the script's path);
* ``fused-plain``: the fused stack's plain PyTorch versions on the card,
  the kernels' arithmetic and rounding points in torch ops (``plain_stack``);
* ``loop``: the plain layer loop (``fused_train=False``, the JAX script's
  ``--xla`` training).

A seed sets ``Config.seed`` (the init) and the seed of the generator the
steps draw their dropout seeds from; without ``--seeds`` the script's own
(the Config's seed and 0). Training is repeatable on the card (the training
kernels sum in a fixed order and the step runs cuDNN's deterministic
algorithms), so one (seed, arm) is one fixed draw: ``kernels`` against
``fused-plain`` isolates the kernels, ``fused-plain`` against ``loop`` the
fused design (the JAX package's own). Each trained model is rolled out
through the generation kernel (engine "cuda") and, in the first
``--scan-reps`` repetitions, through the eager decoder (engine "scan") as
well, and every rollout is scored with the script's scorer and thresholds.

Prints one ``[spread]`` JSON line per trained model, then per head and arm
the pass count, and per pair of arms over the seeds the discordant pairs
with the exact McNemar test and the sign test on the best log-mel
correlation (one-sided: the first arm worse), with the card's name and
power limit. ``--jobs N`` trains N models at once in processes of their own
(the card is idle most of a quality-net step; their ``train_s`` then
overlap). It runs on the card; ``--device cpu`` runs the plain versions
(tests).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile

import torch

from wavenet_vocoder_tpu_torch.ops import fused_train as ft
from wavenet_vocoder_tpu_torch.scripts import synthetic_e2e as se
from wavenet_vocoder_tpu_torch.synthesis import resolve_device
from wavenet_vocoder_tpu_torch.utils.profiling import gpu_name_and_limit

MODULE = "wavenet_vocoder_tpu_torch.scripts.quality_spread"
# arm -> the record's "train" label
ARMS = {"kernels": "kernels", "fused-plain": "fused plain",
        "loop": "plain loop"}


def plain_stack():
    """The fused stack's plain versions in place of the kernels, for CUDA
    tensors too: a patch for the arm ``fused-plain`` and for comparisons,
    never a switch of the main path."""
    from unittest import mock
    return mock.patch.object(ft, "_impl", lambda device: (
        ft.fused_res_stack_fwd_plain, ft.fused_res_stack_bwd_plain))


def one(head, arm, seed, reps_scan, rep, corpora, device, steps):
    """Train one model of ``head`` on ``arm`` from ``seed`` (None: the
    script's), roll it out and score it; the record."""
    cfg = se.make_config(head, xla=arm == "loop")
    if seed is not None:
        cfg = dataclasses.replace(cfg, seed=seed)
    if head not in corpora:
        corpora[head] = se.build_corpus(cfg)
    train_data, test_wav, test_mel = corpora[head]
    with plain_stack() if arm == "fused-plain" else contextlib.nullcontext():
        state, first, final, train_s = se.train(
            cfg, train_data, steps, device,
            dropout_seed=0 if seed is None else seed)
    rec = dict(head=head, arm=arm, train=ARMS[arm], seed=seed, rep=rep,
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


def _one_sided(k: int, n: int) -> float:
    """P(X >= k) for X ~ Binomial(n, 1/2); 1 where n = 0."""
    return sum(math.comb(n, i) for i in range(k, n + 1)) / 2 ** n


def paired(runs, head, a, b):
    """Arm ``a`` against arm ``b`` over the seeds (first repetition) both
    trained for ``head``: pass/fail discordant pairs with the exact McNemar
    test, and the sign test on the best rollout's log-mel corr (engine
    "cuda"); both one-sided, for ``a`` worse than ``b``."""
    by = {}
    for r in runs:
        if r["head"] == head and r["rep"] == 0:
            by.setdefault(r["seed"], {})[r["arm"]] = r
    pairs = [(v[a], v[b]) for v in by.values() if a in v and b in v]
    a_only = sum(x["cuda_pass"] and not y["cuda_pass"] for x, y in pairs)
    b_only = sum(y["cuda_pass"] and not x["cuda_pass"] for x, y in pairs)
    best = lambda r: max(c for c, _, _, _ in r["cuda"])
    lower = sum(best(x) < best(y) for x, y in pairs)
    higher = sum(best(x) > best(y) for x, y in pairs)
    return dict(seeds=len(pairs), a_pass_b_fail=a_only, a_fail_b_pass=b_only,
                mcnemar_p=_one_sided(b_only, a_only + b_only),
                corr_lower=lower, corr_higher=higher,
                sign_p=_one_sided(lower, lower + higher))


def _jobs(args, seeds, n_jobs):
    """The run split over ``n_jobs`` processes of this script, seeds dealt
    round-robin; their records, in (head, seed, arm) order."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for j in range(n_jobs):
            part = seeds[j::n_jobs]
            if not part:
                continue
            out, log = (os.path.join(tmp, f"part{j}.{x}") for x in ("json", "log"))
            cmd = [sys.executable, "-m", MODULE, "--heads", args.heads,
                   "--seeds", ",".join(map(str, part)), "--arms", args.arms,
                   "--reps", str(args.reps), "--scan-reps",
                   str(args.scan_reps), "--steps", str(args.steps), "--out",
                   out] + (["--device", args.device] if args.device else [])
            with open(log, "w") as f:
                procs.append((subprocess.Popen(cmd, cwd=root, env=env,
                                               stdout=f,
                                               stderr=subprocess.STDOUT),
                              out, log))
        runs = []
        for proc, out, log in procs:
            rc = proc.wait()
            with open(log) as f:
                text = f.read()
            print("".join(x + "\n" for x in text.splitlines()
                          if x.startswith("[spread] {")), end="", flush=True)
            if rc != 0:
                raise RuntimeError(f"job exited {rc}:\n{text[-3000:]}")
            with open(out) as f:
                runs += json.load(f)["runs"]
    order = {a: i for i, a in enumerate(ARMS)}
    return sorted(runs, key=lambda r: (args.heads.split(",").index(r["head"]),
                                       r["seed"], r["rep"], order[r["arm"]]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--heads", default="mol,gaussian")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated init and dropout seeds (default: "
                         "the script's own)")
    ap.add_argument("--arms", default="kernels,loop",
                    help=f"comma-separated, of {','.join(ARMS)}")
    ap.add_argument("--reps", type=int, default=1,
                    help="repetitions of each (seed, arm); on the card a "
                         "repetition repeats the draw")
    ap.add_argument("--scan-reps", type=int, default=1,
                    help="repetitions whose models are also rolled out "
                         "through the eager decoder (~150 s each)")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--jobs", type=int, default=1,
                    help="models trained at once, in processes of their own")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--out", help="write the records as JSON here")
    args = ap.parse_args(argv)
    heads, arms = args.heads.split(","), args.arms.split(",")
    for arm in arms:
        if arm not in ARMS:
            ap.error(f"arm {arm!r}: one of {', '.join(ARMS)}")
    seeds = ([int(x) for x in args.seeds.split(",")] if args.seeds
             else [None])
    device = resolve_device(args.device)
    if args.jobs > 1 and args.seeds:
        out = _jobs(args, seeds, args.jobs)
    else:
        corpora, out = {}, []
        for head in heads:
            for seed in seeds:
                for rep in range(args.reps):
                    for arm in arms:
                        rec = one(head, arm, seed, args.scan_reps, rep,
                                  corpora, device, args.steps)
                        out.append(rec)
                        print("[spread] " + json.dumps(rec), flush=True)
                        if device.type == "cuda":
                            torch.cuda.empty_cache()
    gpu = gpu_name_and_limit() if device.type == "cuda" else "cpu"
    for head in heads:
        for arm in arms:
            for engine in ("cuda", "scan"):
                runs = [r for r in out if r["head"] == head
                        and r["arm"] == arm and engine in r]
                if runs:
                    n = sum(r[engine + "_pass"] for r in runs)
                    print(f"[spread] {head}, trained on the {ARMS[arm]}, "
                          f"rolled out by {engine}: {n}/{len(runs)} pass; "
                          f"{gpu}", flush=True)
        for i, a in enumerate(arms):
            for b in arms[i + 1:]:
                p = paired(out, head, a, b)
                if p["seeds"]:
                    print(f"[spread] {head}, {a} vs {b} over {p['seeds']} "
                          f"seeds: pass/fail {p['a_pass_b_fail']} vs "
                          f"{p['a_fail_b_pass']} (McNemar one-sided p "
                          f"{p['mcnemar_p']:.4f}); best corr lower "
                          f"{p['corr_lower']}, higher {p['corr_higher']} "
                          f"(sign test one-sided p {p['sign_p']:.4f}); {gpu}",
                          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(gpu=gpu, runs=out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
