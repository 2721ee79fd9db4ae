"""Batch evaluation CLI: synthesize a dump directory (reference: evaluate.py).

    python -m wavenet_vocoder_tpu_torch.cli.evaluate DUMP_DIR CHECKPOINT \
        OUT_DIR [--preset JSON] [--hparams "k=v"] [--num-utterances N] \
        [--batch-size N] [--speaker-id N] [--seed N] [--deterministic] \
        [--engine auto|scan|cuda] [--device DEVICE] [--mesh] \
        [--distributed | --coordinator-address H:P --num-processes N \
         --process-id I] [--local-device-ids I] [--dist-backend nccl|gloo]

The port's counterpart of ``wavenet_vocoder_tpu/cli/evaluate.py``, with the
same arguments and outputs, plus ``--device``, ``--deterministic`` (argmax /
mean instead of sampling) and the process-group flags of cli.train. It runs
on the GPU unless ``--device`` names another device. Writes paired
{name}_gen.wav / {name}_ref.wav (reference: evaluate.py:208-253); mel-only
dirs (no *-wave.npy) synthesize from features alone (reference:
evaluate.py:51-78 dummy_collate).

``--mesh`` splits each batch over the local GPUs (the tail padded with
copies of the last utterance). ``--distributed`` (torchrun, or the address
flags) gives process i every n-th utterance of the length-sorted list from
the i-th; each process writes its own utterances and
``eval_manifest.proc{i}.txt``. The processes exchange nothing.
"""
from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np
import torch
import torch.distributed as dist

from wavenet_vocoder_tpu_torch.cli.synthesis import (
    ENGINE_CHOICES,
    load_params_and_config,
    resolve_engine,
)
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.ops.mulaw import inv_mulaw, inv_mulaw_quantize
from wavenet_vocoder_tpu_torch.parallel import distributed as pdist
from wavenet_vocoder_tpu_torch.synthesis import Synthesizer, pad_mel_context


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dump_dir")
    p.add_argument("checkpoint")
    p.add_argument("out_dir")
    p.add_argument("--preset", default=None)
    p.add_argument("--hparams", default="")
    p.add_argument("--num-utterances", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--speaker-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true",
                   help="argmax / mean outputs instead of sampling")
    p.add_argument("--verbose", type=int, default=0,
                   help="verbosity level (reference: evaluate.py:15, 97-102)")
    # accepted for reference-CLI compatibility: the reference parses these
    # but generation length always derives from the conditioning features
    # (reference: evaluate.py:104-110 parse; 53-57 length from mel)
    p.add_argument("--length", type=int, default=None,
                   help="compat only; length derives from features "
                        "(reference: evaluate.py:10, 104)")
    p.add_argument("--initial-value", type=float, default=None,
                   help="compat only (reference: evaluate.py:12, 109-110)")
    p.add_argument("--no-length-sort", action="store_true",
                   help="keep on-disk utterance order instead of grouping "
                        "similar lengths per batch (sorting minimizes padded "
                        "autoregressive steps; outputs are identical)")
    p.add_argument("--output-html", action="store_true",
                   help="suppress per-batch progress output "
                        "(reference: evaluate.py:198-200)")
    p.add_argument("--engine", default="auto", choices=ENGINE_CHOICES,
                   help="decoder engine: auto = cuda (the fused kernel, "
                        "weights packed once across batches), scan = the "
                        "eager step loop")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; fails "
                        "without a GPU)")
    p.add_argument("--mesh", action="store_true",
                   help="shard utterance batches over the local GPUs (data "
                        "axis; both engines)")
    pdist.add_cli_flags(p)
    args = p.parse_args(argv)
    if args.mesh and args.device is not None:
        raise ValueError("--mesh shards over the local GPUs; it does not "
                         "take --device")
    engine = resolve_engine(args.engine)
    pidx, pcount = pdist.initialize_from_args(args)
    try:
        _evaluate(args, engine, pidx, pcount)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _evaluate(args, engine: str, pidx: int, pcount: int) -> None:
    device = args.device
    if pcount > 1 and device is None and torch.cuda.is_available():
        device = pdist.process_device()

    if args.verbose > 0:
        print(f"dump_dir={args.dump_dir} checkpoint={args.checkpoint} "
              f"out_dir={args.out_dir} preset={args.preset}")
    if args.length is not None:
        print("WARNING: --length is accepted for reference-CLI compatibility "
              "but has no effect — generation length derives from the "
              "conditioning features (reference: evaluate.py:53-57)")
    if args.initial_value is not None:
        print("WARNING: --initial-value is accepted for reference-CLI "
              "compatibility but has no effect on conditioned evaluation")

    model, cfg, step = load_params_and_config(
        args.checkpoint, args.preset, args.hparams)
    spec = model.spec
    os.makedirs(args.out_dir, exist_ok=True)
    # move the model and (for cuda) pack the kernel's weights ONCE across
    # all batches (make_generation_fast_; reference: synthesis.py:48-49)
    mesh, n_dev = None, 1
    if args.mesh:
        from wavenet_vocoder_tpu_torch.parallel import make_mesh
        # one process per device: under --distributed a process meshes its
        # own GPU; the processes stay independent
        mesh = make_mesh({"data": -1}, devices=(
            [pdist.process_device()] if pcount > 1 else None))
        n_dev = mesh.shape["data"]
        print(f"Sharding utterance batches over {n_dev} devices")
    synth = Synthesizer(model, cfg, engine=engine, device=device, mesh=mesh)

    feats = sorted(glob(os.path.join(args.dump_dir, "*-feats.npy")))
    if not feats:
        raise SystemExit(f"No *-feats.npy under {args.dump_dir}")

    # speaker ids from the manifest when multi-speaker
    # (reference: evaluate.py:173-196 per-speaker counting)
    speaker_of = {}
    manifest = os.path.join(args.dump_dir, "train.txt")
    if os.path.exists(manifest):
        from wavenet_vocoder_tpu_torch.data import parse_manifest
        for u in parse_manifest(manifest):
            if u.speaker_id is not None:
                speaker_of[os.path.basename(u.feat_path)] = u.speaker_id
    multi_speaker = bool(speaker_of)

    if args.num_utterances:
        if multi_speaker:
            counts: dict = {}
            kept = []
            for f in feats:
                sid = speaker_of.get(os.path.basename(f))
                if counts.get(sid, 0) < args.num_utterances:
                    counts[sid] = counts.get(sid, 0) + 1
                    kept.append(f)
            feats = kept
        else:
            feats = feats[:args.num_utterances]
    batch_size = args.batch_size or 8
    if not args.no_length_sort and len(feats) > batch_size:
        # group similar lengths per batch: every row of a batch generates
        # max-length AR steps, so mixing a short utterance with a long one
        # wastes steps proportional to the spread
        n_frames = {f: int(np.load(f, mmap_mode="r").shape[0])
                    for f in feats}
        feats = sorted(feats, key=lambda f: (n_frames[f], f))
    if pcount > 1:
        # disjoint per-process stride after the length sort, so every
        # process gets a mix of lengths; no truncation: the processes run
        # no collectives to keep in step
        feats = feats[pidx::pcount]
        print(f"process {pidx}: {len(feats)} utterances")
    hop = audio.get_hop_size(cfg)
    mu = cfg.quantize_channels - 1

    def out_name(fpath):
        # (reference: evaluate.py:208-220 speaker-prefixed names)
        name = os.path.basename(fpath).replace("-feats.npy", "")
        if multi_speaker and (args.speaker_id is not None
                              or spec.has_global_conditioning):
            sid = (args.speaker_id if args.speaker_id is not None
                   else speaker_of.get(os.path.basename(fpath), 0))
            name = f"speaker{int(sid)}_{name}"
        return name

    for i in range(0, len(feats), batch_size):
        chunk = feats[i:i + batch_size]
        mels = [np.load(f) for f in chunk]
        max_len = max(m.shape[0] for m in mels)
        c = np.zeros((len(mels), max_len, mels[0].shape[1]), np.float32)
        for j, m in enumerate(mels):
            c[j, :m.shape[0]] = m
            if m.shape[0] < max_len:  # replicate-pad ragged tails
                c[j, m.shape[0]:] = m[-1]
        c = pad_mel_context(c, cfg.cin_pad)
        if args.speaker_id is not None:
            g = np.full(len(mels), args.speaker_id, np.int32)
        elif multi_speaker and spec.has_global_conditioning:
            g = np.asarray([speaker_of.get(os.path.basename(f), 0)
                            for f in chunk], np.int32)
        else:
            g = None
        if len(mels) % n_dev:
            # the mesh split needs batch % devices == 0: replicate-pad the
            # tail rows and drop their outputs below
            pad_n = n_dev - len(mels) % n_dev
            c = np.concatenate([c] + [c[-1:]] * pad_n, axis=0)
            if g is not None:
                g = np.concatenate([g, np.repeat(g[-1:], pad_n)])
        # one random stream per batch, keyed on the seed and the batch's
        # first utterance index
        gen = torch.Generator(device=synth.device).manual_seed(
            args.seed * 1000003 + i)
        wavs = synth(c, g=g, generator=gen, pad_context=False,
                     deterministic=args.deterministic)[:len(mels)]
        for j, fpath in enumerate(chunk):
            name = out_name(fpath)
            T_j = mels[j].shape[0] * hop
            audio.save_wav(wavs[j][:T_j],
                           os.path.join(args.out_dir, f"{name}_gen.wav"),
                           cfg.sample_rate)
            # reference target decode (reference: evaluate.py:223-253)
            wave_path = fpath.replace("-feats.npy", "-wave.npy")
            if os.path.exists(wave_path):
                y = np.load(wave_path)
                if cfg.is_mulaw_quantize:
                    ref = np.asarray(inv_mulaw_quantize(y, mu))
                elif cfg.input_type == "mulaw":
                    ref = np.asarray(inv_mulaw(y, mu))
                else:
                    ref = y
                if cfg.postprocess not in (None, "", "none"):
                    ref = getattr(audio, cfg.postprocess)(ref)
                if cfg.global_gain_scale > 0:
                    ref = ref / cfg.global_gain_scale
                audio.save_wav(ref, os.path.join(
                    args.out_dir, f"{name}_ref.wav"), cfg.sample_rate)
        if not args.output_html:
            print(f"[{min(i + batch_size, len(feats))}/{len(feats)}] done")

    # one process writes eval_manifest.txt; under --distributed each writes
    # the manifest of its own (disjoint) shard only
    mname = ("eval_manifest.txt" if pcount == 1
             else f"eval_manifest.proc{pidx}.txt")
    with open(os.path.join(args.out_dir, mname), "w") as f:
        f.write("".join(f"{out_name(fpath)}_gen.wav\n" for fpath in feats))


if __name__ == "__main__":
    main()
