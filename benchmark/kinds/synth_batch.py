"""Offline batched vocoding: batches of utterances of one length each through
``synthesis.Synthesizer(engine="cuda")``, in a closed loop.

Parameters (``benchmark/traffic/<mix>.json``): ``batch`` utterances a batch;
``lengths_s``, the set of lengths, one a batch, in an order drawn from the
seed (every seed serves the same set); ``greedy_every``, every n-th batch is
greedy (the rest sample); ``check_rows`` greedy and ``check_sampled``
sampled utterances the reference runs over, the longest of each among them
(of a sampled batch one row, drawn from the seed, is kept for this);
``trace_seconds``, how long the traced run's profiler stays on (whole
batches).

Mel inputs are standard normal, made on the card from the seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import checks


class Run:
    def __init__(self, cell, seed: int, device, spans, keys=None):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, spans
        self.keys = keys or cell.model_keys()
        self.p = cell.traffic

    def setup(self) -> None:
        from wavenet_vocoder_tpu_torch.synthesis import Synthesizer
        keys, p, dev = self.keys, self.p, self.device
        self.cfg = harness.port_config(keys)
        self.weights = harness.make_weights(keys, self.seed, dev)
        model = harness.build_model(self.cfg, self.weights, dev)
        self.synth = Synthesizer(model, self.cfg, engine="cuda", device=dev)
        hop, sr = keys["hop_size"], keys["sample_rate"]
        self.frames = [max(1, int(round(s * sr / hop))) for s in p["lengths_s"]]
        self.order = harness.permutation(self.seed, len(self.frames), 1)
        B, D = p["batch"], keys["num_mels"]
        self.mels = [torch.randn(B, f, D, device=dev,
                                 generator=harness.device_generator(
                                     self.seed, dev, 2, j))
                     for j, f in enumerate(self.frames)]
        # warm every shape the window uses: one 256-step launch of each
        # mode, and the upsample net at each length
        for greedy in (True, False):
            self.synth(self.mels[0][:, :1], deterministic=greedy,
                       generator=harness.cpu_generator(self.seed, 9))
        cp = keys["cin_pad"]
        with torch.no_grad():
            for m in self.mels:
                c = torch.cat([m[:, :1].expand(-1, cp, -1), m,
                               m[:, -1:].expand(-1, cp, -1)], dim=1)
                self.synth.model.upsample_conditioning(c)
        harness.sync(dev)

    def window(self, seconds: float, trace=None) -> dict:
        p, keys = self.p, self.keys
        sr = keys["sample_rate"]
        self.batches = []
        if trace is not None:
            trace.start()
        B = self.mels[0].shape[0]
        start = time.perf_counter()
        i = 0
        while True:
            slot = self.order[i % len(self.order)]
            greedy = i % p["greedy_every"] == 0
            traced = trace is not None and trace.active
            with self.spans("batch"):
                wav = self.synth(self.mels[slot], deterministic=greedy,
                                 generator=harness.cpu_generator(self.seed, 3, i))
            keep = None if greedy else int(torch.randint(
                B, (1,), generator=harness.cpu_generator(self.seed, 8, i)))
            self.batches.append({
                "i": i, "slot": slot, "rows": wav.shape[0], "T": wav.shape[1],
                "greedy": greedy, "traced": traced,
                "wav": wav if greedy else None,
                "kept": None if greedy else (keep, wav[keep].copy())})
            i += 1
            now = time.perf_counter() - start
            if trace is not None and trace.active and now >= p["trace_seconds"]:
                trace.stop()
            if now >= seconds:
                break
        end = time.perf_counter()
        if trace is not None:
            trace.stop()
        audio_s = sum(b["rows"] * b["T"] for b in self.batches) / sr
        return {"window_s": end - start, "end": end,
                "attempted": len(self.batches),
                "e2e": {"synth_audio_s_per_s": audio_s / (end - start)}}

    def units(self, which: str = "all"):
        """(rows, samples) of each batch served: ``all``, or the
        ``traced`` or ``untraced`` ones."""
        return [(b["rows"], b["T"]) for b in self.batches
                if which == "all" or b["traced"] == (which == "traced")]

    def release(self) -> None:
        del self.synth

    def _item(self, b: dict, r: int, wav) -> dict:
        """One judged utterance: its mel with context frames, the samples
        served, and the noise it was drawn with (None when greedy)."""
        cp = self.keys["cin_pad"]
        m = self.mels[b["slot"]][r].cpu().numpy()
        noise = None if b["greedy"] else (harness.drawn_seed(
            harness.cpu_generator(self.seed, 3, b["i"])), r)
        return {"mel": np.concatenate([np.repeat(m[:1], cp, 0), m,
                                       np.repeat(m[-1:], cp, 0)]),
                "x": checks.served_samples(wav[None], self.keys)[0],
                "noise": noise}

    def _judged(self):
        """(greedy, sampled) utterances judged: the longest of each kind
        and others drawn from the seed."""
        p = self.p
        gen = harness.cpu_generator(self.seed, 4)
        greedy = [b for b in self.batches if b["greedy"]]
        pool = [(j, r) for j, b in enumerate(greedy) for r in range(b["rows"])]
        longest = max(range(len(greedy)), key=lambda j: greedy[j]["T"])
        first = (longest, int(torch.randint(greedy[longest]["rows"], (1,),
                                            generator=gen)))
        picks = [first] + [pool[k] for k in torch.randperm(
            len(pool), generator=gen).tolist() if pool[k] != first][
                :p["check_rows"] - 1]
        out_g = [self._item(greedy[j], r, greedy[j]["wav"][r])
                 for j, r in picks]
        sampled = [b for b in self.batches if not b["greedy"]]
        out_s = []
        if sampled:
            longest = max(range(len(sampled)), key=lambda j: sampled[j]["T"])
            rest = [j for j in torch.randperm(len(sampled),
                                              generator=gen).tolist()
                    if j != longest]
            for j in [longest] + rest[:p["check_sampled"] - 1]:
                r, wav = sampled[j]["kept"]
                out_s.append(self._item(sampled[j], r, wav))
        return out_g, out_s

    def check(self) -> dict:
        return checks.served_numbers(self.weights, self.keys, *self._judged(),
                                     self.device)

    def control(self, precision: str) -> dict:
        """The check with the reference at ``precision`` in the program's
        place, on the same utterances."""
        return checks.served_numbers(self.weights, self.keys, *self._judged(),
                                     self.device, control=precision)
