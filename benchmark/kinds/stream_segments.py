"""Interactive streaming: one voice fed mel frames a few at a time through
``streaming.StreamingSynthesizer(engine="cuda")``, the next segment as soon as
the last one's audio is on the host, ``reset()`` between utterances.

Parameters: ``streams`` rows a stream carries; ``segment_frames`` mel frames a
``feed``; ``lengths_s``, the set of utterance lengths, in an order drawn from
the seed; ``greedy_every``, every n-th utterance is greedy (the rest sample);
``check_utterances`` finished greedy and ``check_sampled`` finished sampled
utterances the reference runs over, the longest of each among them;
``trace_seconds``.

A segment is one ``feed`` call or the closing ``flush``; its latency runs
from the call to the return of its audio as a host array.
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

    def _stream(self, model, greedy: bool):
        from wavenet_vocoder_tpu_torch.streaming import StreamingSynthesizer
        return StreamingSynthesizer(
            model, self.cfg, batch=self.p["streams"], engine="cuda",
            device=self.device, deterministic=greedy,
            generator=harness.cpu_generator(self.seed, 5, int(greedy)))

    def setup(self) -> None:
        keys, p, dev = self.keys, self.p, self.device
        self.cfg = harness.port_config(keys)
        self.weights = harness.make_weights(keys, self.seed, dev)
        model = harness.build_model(self.cfg, self.weights, dev)
        self.streams = {g: self._stream(model, g) for g in (False, True)}
        hop, sr, D = keys["hop_size"], keys["sample_rate"], keys["num_mels"]
        self.frames = [max(1, int(round(s * sr / hop))) for s in p["lengths_s"]]
        self.order = harness.permutation(self.seed, len(self.frames), 1)
        gen = harness.device_generator(self.seed, dev, 2)
        flat = torch.randn(p["streams"], sum(self.frames), D, device=dev,
                           generator=gen).cpu().numpy()
        cuts = np.cumsum([0] + self.frames)
        self.mels = [flat[:, a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        # warm both streams on a short utterance: the first segments' and
        # the closing segment's shapes, greedy and sampled
        seg = p["segment_frames"]
        for s in self.streams.values():
            self._warm(s, self.mels[0][:, :3 * seg])
        # then one stream on an utterance of each length modulo a segment
        # that the mix holds, fed past the growth of the conditioning
        # window (the upsample net's context: cin_pad frames a side and a
        # frame a stretch layer, each way): the steady window and each
        # short last feed, which a 3-segment utterance does not reach
        context = 2 * (keys["cin_pad"]
                       + len(keys["upsample_params"]["upsample_scales"]))
        full = 2 + -(-context // seg)
        longest = max(self.mels, key=lambda m: m.shape[1])
        for r in sorted({f % seg for f in self.frames}):
            self._warm(self.streams[False], longest[:, :full * seg + r])
        harness.sync(dev)

    def _warm(self, stream, mel) -> None:
        stream.reset()
        for f in range(0, mel.shape[1], self.p["segment_frames"]):
            stream.feed(mel[:, f:f + self.p["segment_frames"]])
        stream.flush()

    def _utterance(self, u: int, start: float, seconds: float, trace):
        """Feed utterance u segment by segment; False once the window is
        over before the utterance finished."""
        p = self.p
        slot = self.order[u % len(self.order)]
        greedy = u % p["greedy_every"] == 0
        stream = self.streams[greedy]
        mel, seg = self.mels[slot], p["segment_frames"]
        stream.reset()
        outs, first, t_begin = [], None, time.perf_counter()
        calls = [mel[:, f:f + seg] for f in range(0, mel.shape[1], seg)]
        for j in range(len(calls) + 1):
            traced = trace is not None and trace.active
            name = "feed" if j < len(calls) else "flush"
            t0 = time.perf_counter()
            with self.spans(name):
                out = stream.feed(calls[j]) if j < len(calls) else stream.flush()
            t1 = time.perf_counter()
            self.segments.append({"ms": (t1 - t0) * 1e3, "T": out.shape[1],
                                  "traced": traced})
            outs.append(out)
            if first is None and out.shape[1] > 0:
                first = (t1 - t_begin) * 1e3
                self.first_audio.append({"t": t_begin, "ms": first})
            now = t1 - start
            if trace is not None and trace.active and now >= p["trace_seconds"]:
                trace.stop()
            if now >= seconds and j < len(calls):
                return False
        self.utterances.append({"slot": slot, "greedy": greedy,
                                "wav": np.concatenate(outs, axis=1)})
        return time.perf_counter() - start < seconds

    def window(self, seconds: float, trace=None) -> dict:
        self.segments, self.first_audio, self.utterances = [], [], []
        if trace is not None:
            trace.start()
        start = time.perf_counter()
        u = 0
        while self._utterance(u, start, seconds, trace):
            u += 1
        end = time.perf_counter()
        if trace is not None:
            trace.stop()
        ms = [s["ms"] for s in self.segments]
        return {"window_s": end - start, "end": end,
                "attempted": len(self.segments),
                "e2e": {"stream_seg_p95_ms": harness.quantile(ms, 0.95)}}

    def units(self, which: str = "all"):
        """(rows, samples) of each segment: ``all``, or the ``traced`` or
        ``untraced`` ones."""
        return [(self.p["streams"], s["T"]) for s in self.segments
                if which == "all" or s["traced"] == (which == "traced")]

    def release(self) -> None:
        del self.streams

    def _pick(self, greedy: bool, count: int, gen) -> list:
        """``count`` finished utterances of one kind: the longest and
        others drawn from the seed."""
        done = [u for u in self.utterances if u["greedy"] == greedy]
        if not done:
            return []
        longest = max(range(len(done)), key=lambda j: done[j]["wav"].shape[1])
        rest = [j for j in torch.randperm(len(done), generator=gen).tolist()
                if j != longest]
        return [done[j] for j in [longest] + rest[:count - 1]]

    def _judged(self):
        """(greedy, sampled) utterances judged, one item a stream row: its
        mel with context frames, the samples served, and the noise it was
        drawn with (the stream's seed and row; None when greedy)."""
        keys, p = self.keys, self.p
        gen = harness.cpu_generator(self.seed, 4)
        # the sampling stream's seed, drawn as reset() draws it
        seed = harness.drawn_seed(harness.cpu_generator(self.seed, 5, 0))
        cp = keys["cin_pad"]
        out = []
        for greedy, count in ((True, p["check_utterances"]),
                              (False, p["check_sampled"])):
            items = []
            for u in self._pick(greedy, count, gen):
                for r in range(p["streams"]):
                    m = self.mels[u["slot"]][r]
                    items.append({
                        "mel": np.concatenate([np.repeat(m[:1], cp, 0), m,
                                               np.repeat(m[-1:], cp, 0)]),
                        "x": checks.served_samples(u["wav"][r:r + 1], keys)[0],
                        "noise": None if greedy else (seed, r)})
            out.append(items)
        return out

    def check(self) -> dict:
        return checks.served_numbers(self.weights, self.keys, *self._judged(),
                                     self.device)

    def control(self, precision: str) -> dict:
        """The check with the reference at ``precision`` in the program's
        place, on the same utterances."""
        return checks.served_numbers(self.weights, self.keys, *self._judged(),
                                     self.device, control=precision)
