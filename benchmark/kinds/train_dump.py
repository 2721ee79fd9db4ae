"""Recipe training from a dump on disk, as ``training/loop.train_loop`` runs
it: ``get_data_loaders`` -> ``prefetch_to_device`` -> ``train_step(state,
batch, step_generator(...))``, the loss read every ``log_every`` steps.

Parameters: ``utterances`` in the dump and ``lengths_s`` [shortest, longest]
(evenly spaced lengths, given to the files in an order drawn from the seed);
``check_steps``, the first steps (run in set-up, through the window's own
loader and call) that the reference follows; ``log_every``;
``trace_seconds``.

The dump (``<utt>-wave.npy`` in [-0.5, 0.5], ``<utt>-feats.npy`` standard
normal mels) is made on the card from the seed and written under the run's
temporary directory, which the run deletes; the arrays stay in host memory
for the reference, which works the checked batches out again from them.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import checks
from benchmark.reference import wavenet as ref


def write_dump(root: str, keys: dict, p: dict, seed: int, device):
    """Write the dump; returns (waves, feats), the arrays written."""
    hop, sr, D = keys["hop_size"], keys["sample_rate"], keys["num_mels"]
    n = p["utterances"]
    lo, hi = p["lengths_s"]
    frames = [int(round(s * sr / hop)) for s in np.linspace(lo, hi, n)]
    frames = [frames[i] for i in harness.permutation(seed, n, 6)]
    total = sum(frames)
    gen = harness.device_generator(seed, device, 7)
    wave = (torch.rand(total * hop, generator=gen, device=device) - 0.5).cpu()
    feats = torch.randn(total, D, generator=gen, device=device).cpu()
    off, waves, mels = 0, [], []
    for i, f in enumerate(frames):
        waves.append(wave[off * hop:(off + f) * hop].numpy())
        mels.append(feats[off:off + f].numpy())
        np.save(os.path.join(root, f"utt{i:04d}-wave.npy"), waves[-1])
        np.save(os.path.join(root, f"utt{i:04d}-feats.npy"), mels[-1])
        off += f
    return waves, mels


class Run:
    def __init__(self, cell, seed: int, device, spans, keys=None):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, spans
        self.keys = keys or cell.model_keys()
        self.p = cell.traffic
        self.dump = None

    def _batches(self):
        while True:
            yield from self.loader

    def setup(self) -> None:
        from wavenet_vocoder_tpu_torch.data.prefetch import prefetch_to_device
        from wavenet_vocoder_tpu_torch.training.loop import (get_data_loaders,
                                                             step_generator)
        from wavenet_vocoder_tpu_torch.training.train_state import (
            create_train_state, make_train_step)
        keys, p, dev = self.keys, self.p, self.device
        self.step_generator = step_generator
        self.cfg = cfg = harness.port_config(keys)
        self.dump = tempfile.mkdtemp(prefix="bench_dump_")
        self.raw = write_dump(self.dump, keys, p, self.seed, dev)
        self.weights = harness.make_weights(keys, self.seed, dev)
        model = harness.build_model(cfg, self.weights, dev)
        self.state = create_train_state(cfg, model=model, device=dev)
        self.train_step, _ = make_train_step(cfg)
        self.loader = get_data_loaders(self.dump, cfg)["train_no_dev"]
        self._cycle = self._batches()
        self.it = prefetch_to_device(self._cycle, device=dev,
                                     pin_memory=cfg.pin_memory)
        self.step = 0
        # the first steps: the window's own feed and call, recorded for the
        # reference
        b1 = self.state.optimizer.param_groups[0]["betas"][0]
        self.first = {"batches": [], "losses": []}
        for _ in range(p["check_steps"]):
            batch = next(self.it)
            self.first["batches"].append({k: v.clone() for k, v in batch.items()
                                          if v is not None})
            m = self._call(batch)
            self.first["losses"].append(float(m["loss"]))
            if self.step == 1:
                # Adam's first moment after one step is (1 - b1) g; a
                # parameter the optimizer holds no state for reads 0
                st = self.state.optimizer.state
                self.first["grad1"] = {
                    n: (st[t]["exp_avg"] / (1 - b1) if "exp_avg" in st.get(
                        t, {}) else torch.zeros_like(t))
                    for n, t in model.named_parameters()}
        model = self.state.model
        self.first["params"] = {n: t.detach().clone()
                                for n, t in model.named_parameters()}
        self.first["ema"] = {n: t.clone() for n, t in self.state.ema.items()}
        harness.sync(dev)

    def _call(self, batch):
        m = self.train_step(self.state, batch, self.step_generator(
            self.cfg, 0, self.step, "cpu"))
        self.step += 1
        return m

    def window(self, seconds: float, trace=None) -> dict:
        p = self.p
        self.steps = []
        if trace is not None:
            trace.start()
        start = time.perf_counter()
        while True:
            traced = trace is not None and trace.active
            with self.spans("loader.next"):
                batch = next(self.it)
            with self.spans("train_step.call"):
                m = self._call(batch)
            if self.step % p["log_every"] == 0:
                with self.spans("loss.read"):
                    float(m["loss"])
            self.steps.append(traced)
            now = time.perf_counter() - start
            if trace is not None and trace.active and now >= p["trace_seconds"]:
                trace.stop()
            if now >= seconds:
                break
        harness.sync(self.device)
        end = time.perf_counter()
        if trace is not None:
            trace.stop()
        self.rows, self.crop = batch["x"].shape[0], batch["x"].shape[1]
        samples = len(self.steps) * self.rows * self.crop
        return {"window_s": end - start, "end": end,
                "attempted": len(self.steps),
                "e2e": {"train_samples_per_s": samples / (end - start)}}

    def units(self, which: str = "all"):
        """(rows, crop) of each step taken: ``all``, or the ``traced`` or
        ``untraced`` ones."""
        return [(self.rows, self.crop) for t in self.steps
                if which == "all" or t == (which == "traced")]

    def release(self) -> None:
        """Stop the loader's threads and free the training state."""
        for g in (getattr(self, "it", None), getattr(self, "_cycle", None)):
            if g is not None:
                g.close()
        self.it = self._cycle = None
        self.state = None
        if self.dump is not None:
            shutil.rmtree(self.dump, ignore_errors=True)
            self.dump = None

    def _reference_batches(self):
        """The checked batches worked out again from the raw dump, and
        their largest difference from the program's."""
        waves, feats = self.raw
        index = checks.frame_index(feats)
        out, worst = [], 0.0
        for b in self.first["batches"]:
            mine, gap = checks.rederive_batch(b, waves, feats, self.keys,
                                              index)
            out.append(b if mine is None else mine)
            worst = max(worst, gap)
        return out, worst

    def check(self) -> dict:
        batches, gap = self._reference_batches()
        refr = ref.adam_steps(self.weights, self.keys, batches)
        return dict(checks.train_numbers(self.first, refr, self.weights),
                    batch_gap=gap)

    def control(self, what: str) -> dict:
        """The check with the reference in the program's place: at fp8
        (``"fp8"``), or with half of each batch left out and the mean taken
        over the rest (``"half_batch"``); both on the reference's batches."""
        batches, _ = self._reference_batches()
        mine, q = batches, ref.identity
        if what == "fp8":
            q = ref.fp8
        elif what == "half_batch":
            mine = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                    for b in batches]
        else:
            raise ValueError(what)
        stand_in = ref.adam_steps(self.weights, self.keys, mine, q)
        refr = ref.adam_steps(self.weights, self.keys, batches)
        return dict(checks.train_numbers(stand_in, refr, self.weights),
                    batch_gap=0.0)
