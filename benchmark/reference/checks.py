"""The numbers that decide ``correct``: the program's outputs held against the
plain reference.

Served audio: the reference runs once over each judged utterance with the
samples the program served as its inputs (teacher forcing: the sample
before each step, zero before the first; for the categorical head the
one-hot of the code before, code 127 before the first) and gives, at every
step, each candidate's score and value (``wavenet.candidates``): a mixture
component, or a class of the categorical head. A greedy step serves the
value of its most likely candidate (a component's clipped mean, a class's
code); a sampled step that of the candidate with the best Gumbel-perturbed
logit, a component's value being its clipped logistic or Gaussian draw,
from uniforms keyed by (seed, stream row, step, draw) that the reference
works out again from the request's seed. The gap of a served sample x is
the least, over candidates k, of the larger of (best score - score k) and
the distance of x from value k (|x - value k|; for a code 0 where they are
equal, else infinite): how far the reference has to be moved for x to be
its answer. For a code that is the shortfall of the served class's score.
``token_gap`` is the widest gap over the greedy requests' steps,
``sampled_gap`` over the sampled requests'.

Training: the batches are worked out again from the raw dump (each row's
crop found by its first conditioning frame) and must equal the program's
(``batch_gap``, exact); the reference trains on its own. Then the loss of
each of the first steps (``loss_gap``, the worst step's relative gap), and
leaf by leaf the first gradient (from Adam's first moment after one step),
the parameters' and the EMA shadow's change after the steps: each leaf's
gap between the program's norm and the reference's over the larger of the
reference's norm and the median leaf's. The limits hold the median leaf's
gap (``grad_gap_median``, ``change_gap_median``, ``ema_gap_median``) and
the median within each kind of residual-layer leaf, the worst kind
(``*_gap_kind``: e.g. every layer's ``conv1x1c.weight_v``), so that a
fault in one kind of leaf across the layers shows. The worst single leaf
is one of the upsampler's 9- and 1-element leaves or a weight-norm gain,
whose bf16 sums swing from seed to seed as widely as an fp8 run's do
(PERF.md); its gap and name are reported beside. Leaves whose
reference gradient is under a thousandth of the median leaf's (zero to
rounding) are left out of the changes.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import wavenet as ref

PREEMPHASIS = 0.85     # the decoder's inverse pre-emphasis coefficient
FIRST_CODE = 127       # the categorical head's input before the first step


def mulaw(x: np.ndarray, mu: int) -> np.ndarray:
    """Mu-law companding, [-1, 1] -> [-1, 1]."""
    return np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)


def served_samples(wav: np.ndarray, keys: dict) -> np.ndarray:
    """Undo the program's waveform decode (gain, inverse pre-emphasis) to get
    what the network produced: (B, T) -> (B, T), float64 samples, or for
    ``mulaw-quantize`` int64 codes, each the code nearest in the mu-law
    domain (the waveform holds inv_mulaw(2 code / mu - 1) up to the
    decode's rounding, far inside half a code)."""
    y = np.asarray(wav, np.float64)
    if keys.get("global_gain_scale", 0) > 0:
        y = y * keys["global_gain_scale"]
    if keys.get("postprocess") == "inv_preemphasis":
        prev = np.concatenate([np.zeros_like(y[:, :1]), y[:, :-1]], axis=1)
        y = y - PREEMPHASIS * prev
    if keys["input_type"] == "mulaw-quantize":
        mu = keys["quantize_channels"] - 1
        return np.rint((mulaw(y, mu) + 1.0) / 2.0 * mu).astype(np.int64)
    return y


def _gaps(score: torch.Tensor, value: torch.Tensor, x: torch.Tensor,
          exact: bool = False) -> torch.Tensor:
    sgap = score.amax(-1, keepdim=True) - score
    if exact:
        vgap = torch.where(value == x[..., None], 0.0, float("inf"))
    else:
        vgap = (x[..., None] - value).abs()
    return torch.maximum(sgap, vgap).amin(-1)


def _inputs(keys: dict, x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """The teacher-forced inputs of steps [a, b) of the served ``x`` (T,):
    (1, b - a, in_channels)."""
    if ref.head(keys) == "categorical":
        codes = x.long()
        prev = torch.cat([codes.new_full((1,), FIRST_CODE), codes[:-1]])
        return F.one_hot(prev[a:b], ref.in_channels(keys)).float()[None]
    return torch.cat([x.new_zeros(1), x[:-1]])[None, a:b, None]


@torch.no_grad()
def served_gap(weights: Dict[str, torch.Tensor], keys: dict,
               items: Sequence[dict], device, control: Optional[str] = None,
               block: int = 32768) -> Dict[str, float]:
    """The widest gap over the steps of ``items``, each a dict of ``mel``
    (T_mel + 2 cin_pad, C) with its context frames, ``x`` (T,) the
    program's samples, and ``noise``: None for a greedy request, else
    (seed, row) of a sampled one. ``control`` ("fp8") puts the reference
    at that precision in the program's place: its own answer at each step
    of the same inputs, with the same uniforms, is what is judged. The
    network runs one utterance at a time, in blocks of ``block`` outputs
    with the receptive field's history before each."""
    p = {k: v.to(device).float() for k, v in weights.items()}
    q = ref.fp8 if control == "fp8" else ref.identity
    exact = ref.head(keys) == "categorical"
    rf = 1 + sum((keys["kernel_size"] - 1) * d for d in ref.dilations(keys))
    worst, gaps = 0.0, []
    for item in items:
        mel_t = torch.as_tensor(item["mel"], device=device).float()[None]
        c = ref.conditioning(p, keys, mel_t)
        cq = c if control is None else ref.conditioning(p, keys, mel_t, q)
        x_t = torch.as_tensor(item["x"], device=device).float()
        T = x_t.shape[0]
        for a in range(0, T, block):
            b = min(T, a + block)
            h = max(0, a - rf)
            u = None
            if item["noise"] is not None:
                seed, row = item["noise"]
                u = ref.counter_uniforms(seed, row, a, b - a,
                                         ref.draws(keys), device)[None]
            inputs = _inputs(keys, x_t, h, b)
            o = ref.forward(p, keys, inputs, c[:, h:b])[:, a - h:]
            if control is None:
                judged = x_t[None, a:b]
            else:
                oq = ref.forward(p, keys, inputs, cq[:, h:b], q)
                judged = ref.sample(keys, oq[:, a - h:], u)
            g = _gaps(*ref.candidates(keys, o, u), judged, exact)
            worst = max(worst, float(g.max()))
            gaps.append(g.flatten().cpu())
    if not gaps:
        return {"gap": float("nan"), "median": float("nan"), "steps": 0}
    allg = torch.cat(gaps)
    return {"gap": worst, "median": float(allg.median()),
            "steps": int(allg.numel())}


def served_numbers(weights, keys, greedy_items, sampled_items, device,
                   control: Optional[str] = None) -> Dict[str, float]:
    """``token_gap`` over the greedy requests and ``sampled_gap`` over the
    sampled ones, with their medians and the steps judged."""
    out = {}
    for name, items in (("token_gap", greedy_items),
                        ("sampled_gap", sampled_items)):
        r = served_gap(weights, keys, items, device, control)
        out[name] = r["gap"]
        out[name + "_median"] = r["median"]
        out[name + "_steps"] = r["steps"]
    return out


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], refd: Dict[str, torch.Tensor],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref), the median
    leaf's norm(ref)), over the leaves in ``keep`` (all if None)."""
    names = [k for k in refd if keep is None or k in keep]
    rn, pn = _norms({k: refd[k] for k in names}), _norms(
        {k: prog[k] for k in names})
    med = float(np.median([rn[k] for k in names]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in names}


def leaf_gap(prog, refd, keep=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, refd, keep).values())


def moving_leaves(grad1: Dict[str, torch.Tensor]) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    n = _norms(grad1)
    med = float(np.median(list(n.values())))
    return {k for k, v in n.items() if v >= 1e-3 * med}


def leaf_kind(name: str) -> Optional[str]:
    """The kind of a residual layer's leaf (``conv_layers.7.conv1x1c.
    weight_v`` -> ``conv_layers.*.conv1x1c.weight_v``); None for others."""
    kind = re.sub(r"^conv_layers\.\d+\.", "conv_layers.*.", name)
    return kind if kind != name else None


def worst_kind(gaps: Dict[str, float]) -> Tuple[str, float]:
    """The kind of residual-layer leaf whose median gap is the largest."""
    kinds: Dict[str, List[float]] = {}
    for name, g in gaps.items():
        k = leaf_kind(name)
        if k is not None:
            kinds.setdefault(k, []).append(g)
    meds = {k: float(np.median(v)) for k, v in kinds.items()}
    worst = max(meds, key=meds.get)
    return worst, meds[worst]


def train_numbers(prog: dict, refr: dict, p0: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """prog/refr: ``losses`` (per step), ``grad1``, ``params`` and ``ema``
    after the steps; p0 the parameters both started from."""
    keep = moving_leaves(refr["grad1"])
    delta = lambda d: {k: d[k].double() - p0[k].double() for k in keep}
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(prog["losses"], refr["losses"]))}
    for key, gaps in (
            ("grad_gap", leaf_gaps(prog["grad1"], refr["grad1"])),
            ("change_gap", leaf_gaps(delta(prog["params"]),
                                     delta(refr["params"]))),
            ("ema_gap", leaf_gaps(delta(prog["ema"]), delta(refr["ema"])))):
        worst = max(gaps, key=gaps.get)
        out[key] = gaps[worst]
        out[key + "_leaf"] = worst
        out[key + "_median"] = float(np.median(list(gaps.values())))
        out[key + "_kind_name"], out[key + "_kind"] = worst_kind(gaps)
    return out


def rederive_batch(batch: Dict[str, torch.Tensor], waves: Sequence[np.ndarray],
                   feats: Sequence[np.ndarray], keys: dict,
                   index: Optional[dict] = None
                   ) -> Tuple[Optional[Dict[str, torch.Tensor]], float]:
    """The program's training batch worked out again from the raw dump.

    Each row's crop is found by its first conditioning frame (a frame of
    standard normal floats names its utterance and position); the crop is
    ``max_time_steps`` samples from the frame ``cin_pad`` past it, with
    ``cin_pad`` frames of context on each side, as the mol recipe crops.
    Returns (the reference's batch on the batch's device, or None where a
    row matches no frame; the largest difference from the program's)."""
    hop, cp = keys["hop_size"], keys["cin_pad"]
    frames = keys["max_time_steps"] // hop
    if index is None:
        index = frame_index(feats)
    c = batch["c"].detach().cpu().numpy()
    xs, cs = [], []
    for row in c:
        hit = index.get(row[0].tobytes())
        if hit is None:
            return None, float("inf")
        u, f0 = hit
        s = f0 + cp
        x = waves[u][s * hop:(s + frames) * hop]
        cc = feats[u][f0:s + frames + cp]
        if len(x) != frames * hop or len(cc) != frames + 2 * cp:
            return None, float("inf")
        xs.append(x)
        cs.append(cc)
    x = np.stack(xs).astype(np.float32)[..., None]
    mine = {"x": x, "y": x.copy(), "c": np.stack(cs).astype(np.float32),
            "input_lengths": np.full(len(xs), frames * hop, np.int32)}
    gap = 0.0
    for k, v in mine.items():
        theirs = batch[k].detach().cpu().numpy()
        if theirs.shape != v.shape:
            return None, float("inf")
        gap = max(gap, float(np.max(np.abs(theirs.astype(np.float64)
                                           - v.astype(np.float64)))))
    dev = batch["x"].device
    return {k: torch.as_tensor(v, device=dev) for k, v in mine.items()}, gap


def frame_index(feats: Sequence[np.ndarray]) -> dict:
    """Every mel frame of the dump, by its bytes -> (utterance, frame)."""
    return {f[i].tobytes(): (u, i) for u, f in enumerate(feats)
            for i in range(len(f))}
