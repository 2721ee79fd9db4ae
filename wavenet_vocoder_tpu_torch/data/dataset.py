"""Data pipeline: train.txt-compatible manifests, length-bucketed sampling,
hop-aligned random cropping with cin_pad context, and static-shape batching.

The port's counterpart of ``wavenet_vocoder_tpu/data/dataset.py``, copied
and adapted (the JAX module imports no JAX, but the port imports nothing of
the JAX package). Everything here stays numpy, with the same
``np.random.RandomState`` draws in the same order, so that from the same dump
and seed the port's batches equal the JAX package's bit for bit. Tensors
appear only in ``data/prefetch.py``.

Parity targets:
  * Manifest format ``wave.npy|feats.npy|N_frames|text[|speaker_id]``
    (reference: train.py:180-183; preprocess.py:28-37). 5th field => multi-
    speaker.
  * Glob fallback when no train.txt (reference: train.py:174-176).
  * Min-length filter: drop utterances shorter than
    ``max_time_steps + 2*cin_pad*hop`` (reference: train.py:191-196).
  * Optional single-speaker filter (reference: train.py:201-209).
  * ``PartialyRandomizedSimilarTimeLengthSampler`` semantics: sort by length,
    shuffle within groups of batch_size*8, shuffle group order
    (reference: train.py:232-278).
  * collate: hop-aligned random crop with +/- cin_pad mel context frames
    (reference: train.py:447-461); audio/mel alignment invariant
    ``len(x) == (len(c) - 2*cin_pad) * hop`` (reference: train.py:417-418);
    frame-repeat path via adjust_time_resolution (train.py:463-467);
    unconditional path trims silence (train.py:471-483).

Batches are STATIC-shaped: every training batch is cropped to exactly
``max_time_steps`` samples (the min-length filter guarantees this is
possible), as in the JAX package. The reference pads to the per-batch max
instead (train.py:489-498).

``DataLoader`` with ``num_workers > 1`` shares one ``RandomState`` across its
worker threads, as the JAX package's does, so which batch gets which crop
draws then depends on thread scheduling; at 0 or 1 workers the draws are in
batch order.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.dsp import audio
from wavenet_vocoder_tpu_torch.ops.mulaw import mulaw_quantize
from wavenet_vocoder_tpu_torch.utils import profiling


def effective_max_time_steps(cfg: Config) -> Optional[int]:
    """Crop size in samples: max_time_sec wins over max_time_steps
    (reference: train.py:437-441)."""
    if cfg.max_time_sec is not None:
        return int(cfg.max_time_sec * cfg.sample_rate)
    return cfg.max_time_steps


@dataclass
class Utterance:
    wave_path: str
    feat_path: Optional[str]
    n_frames: int
    text: str = ""
    speaker_id: Optional[int] = None

    @property
    def length(self) -> int:
        return self.n_frames


def parse_manifest(path: str) -> List[Utterance]:
    """Parse pipe-delimited train.txt (reference: train.py:180-183)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("|")
            multi_speaker = len(parts) == 5
            out.append(Utterance(
                wave_path=parts[0],
                feat_path=parts[1] if parts[1] else None,
                n_frames=int(parts[2]),
                text=parts[3] if len(parts) > 3 else "",
                speaker_id=int(parts[4]) if multi_speaker else None,
            ))
    return out


def glob_fallback(data_root: str) -> List[Utterance]:
    """No manifest: pair up *-wave.npy / *-feats.npy
    (reference: train.py:174-176)."""
    waves = sorted(glob.glob(os.path.join(data_root, "*-wave.npy")))
    out = []
    for w in waves:
        fpath = w.replace("-wave.npy", "-feats.npy")
        fpath = fpath if os.path.exists(fpath) else None
        if fpath:
            n = np.load(fpath, mmap_mode="r").shape[0]
        else:
            n = len(np.load(w, mmap_mode="r"))
        out.append(Utterance(wave_path=w, feat_path=fpath, n_frames=n))
    return out


class WaveNetDataset:
    """Lazy npy-backed dataset returning (wave, mel, speaker_id).

    Applies the reference's min-length and speaker filters
    (reference: train.py:191-216).
    """

    def __init__(self, data_root: str, cfg: Config,
                 speaker_id: Optional[int] = None,
                 train: bool = True):
        # ``train`` is kept for API stability; the min-length filter applies
        # to every split, like the reference's shared _NPYDataSource.
        del train
        self.cfg = cfg
        self.data_root = data_root
        manifest = os.path.join(data_root, "train.txt")
        if os.path.exists(manifest):
            utts = parse_manifest(manifest)
            # manifest paths are relative to the dump dir
            for u in utts:
                if not os.path.isabs(u.wave_path):
                    u.wave_path = os.path.join(data_root, u.wave_path)
                if u.feat_path and not os.path.isabs(u.feat_path):
                    u.feat_path = os.path.join(data_root, u.feat_path)
        else:
            utts = glob_fallback(data_root)

        self.multi_speaker = any(u.speaker_id is not None for u in utts)

        if speaker_id is not None:
            utts = [u for u in utts if u.speaker_id == speaker_id]

        # The reference applies this filter in _NPYDataSource, which backs
        # BOTH the train and dev loaders (reference: train.py:191-196): dev
        # utterances shorter than the crop would otherwise break the
        # crop-window arithmetic in collate_fn.
        max_time_steps = effective_max_time_steps(cfg)
        if max_time_steps is not None:
            hop = audio.get_hop_size(cfg)
            min_samples = max_time_steps + 2 * cfg.cin_pad * hop
            min_frames = (min_samples + hop - 1) // hop + 1
            kept = [u for u in utts if u.n_frames >= min_frames]
            if len(kept) < len(utts):
                print(f"[data] dropped {len(utts) - len(kept)}/{len(utts)} "
                      f"utterances shorter than {min_samples} samples "
                      "(reference: train.py:191-196)")
            utts = kept
        if not utts:
            raise ValueError(f"No usable utterances under {data_root}")
        self.utterances = utts

    def shard(self, process_id: int, num_processes: int) -> "WaveNetDataset":
        """Disjoint per-process corpus slice for multi-process data
        parallelism (every num_processes-th utterance). Shards are TRUNCATED
        to equal length, so every process runs the same number of steps.
        Returns self when single-process."""
        if num_processes <= 1:
            return self
        import copy
        out = copy.copy(self)
        n_equal = len(self.utterances) // num_processes
        if n_equal == 0:
            raise ValueError(
                f"corpus of {len(self.utterances)} utterances cannot feed "
                f"{num_processes} processes")
        out.utterances = self.utterances[process_id::num_processes][:n_equal]
        return out

    def __len__(self) -> int:
        return len(self.utterances)

    def lengths(self) -> np.ndarray:
        return np.asarray([u.n_frames for u in self.utterances])

    def __getitem__(self, idx: int):
        u = self.utterances[idx]
        wave = np.load(u.wave_path)
        mel = np.load(u.feat_path) if u.feat_path else None
        return wave, mel, u.speaker_id


class LengthBucketSampler:
    """Partially-randomized similar-length batching
    (reference: train.py:232-278): ascending length sort, shuffle within
    groups of ``batch_size * batch_group_size``, shuffle group order, then
    emit contiguous batches; drops the ragged tail when drop_last."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 batch_group_size: Optional[int] = None,
                 drop_last: bool = True, seed: int = 1234):
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        if batch_group_size is None:
            batch_group_size = min(batch_size * 8, len(self.lengths))
            batch_group_size -= batch_group_size % batch_size
        self.batch_group_size = max(batch_group_size, batch_size)
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.argsort(self.lengths, kind="stable")
        g = self.batch_group_size
        n_groups = len(order) // g
        for i in range(n_groups):
            self._rng.shuffle(order[i * g:(i + 1) * g])
        # shuffle the group order (keep the ragged tail last,
        # reference: train.py:262-270)
        groups = [order[i * g:(i + 1) * g] for i in range(n_groups)]
        self._rng.shuffle(groups)
        tail = order[n_groups * g:]
        flat = np.concatenate(groups + [tail]) if len(groups) else tail
        # permutation sanity (guards the reference's historical bug,
        # reference: train.py:1006-1008)
        assert len(np.unique(flat)) == len(self.lengths)
        b = self.batch_size
        n_batches = len(flat) // b
        for i in range(n_batches):
            yield flat[i * b:(i + 1) * b]
        if not self.drop_last and len(flat) % b:
            yield flat[n_batches * b:]

    def __len__(self) -> int:
        n = len(self.lengths) // self.batch_size
        if not self.drop_last and len(self.lengths) % self.batch_size:
            n += 1
        return n


def ensure_divisible(length: int, divisible_by: int = 256,
                     lower: bool = True) -> int:
    """(reference: train.py:408-414)."""
    if length % divisible_by == 0:
        return length
    if lower:
        return length - length % divisible_by
    return length + (divisible_by - length % divisible_by)


def assert_ready_for_upsampling(x, c, cin_pad: int, hop: int) -> None:
    """(reference: train.py:417-418)."""
    assert len(x) == (len(c) - 2 * cin_pad) * hop, (len(x), len(c), cin_pad, hop)


def collate_fn(items: List[Tuple[np.ndarray, Optional[np.ndarray], Any]],
               cfg: Config,
               rng: Optional[np.random.RandomState] = None,
               static_shapes: bool = True) -> Dict[str, np.ndarray]:
    """Batch assembly (reference: train.py:421-535), channels-last numpy.

    Returns dict: x (B,T,C_in) f32, y (B,T) i32 or (B,T,1) f32,
    c (B,T_mel,D) f32 or absent, g (B,) i32 or absent, input_lengths (B,) i32.
    """
    rng = rng or np.random.RandomState()
    hop = audio.get_hop_size(cfg)
    cin_pad = cfg.cin_pad
    local = items[0][1] is not None and cfg.cin_channels > 0
    global_cond = items[0][2] is not None and cfg.gin_channels > 0

    max_time_steps = effective_max_time_steps(cfg)

    new_items = []
    for x, c, g in items:
        if local:
            if cfg.upsample_conditional_features:
                assert_ready_for_upsampling(x, c, 0, hop)
                if max_time_steps is not None:
                    max_steps = ensure_divisible(max_time_steps, hop, True)
                    if len(x) > max_steps:
                        max_frames = max_steps // hop
                        hi = len(c) - max_frames - cin_pad + 1
                        if hi > cin_pad:
                            s = rng.randint(cin_pad, hi)
                        else:
                            # Utterance longer than the crop but too short to
                            # also supply cin_pad context on both sides
                            # (length in (max_steps, max_steps+2*cin_pad*hop);
                            # the reference fails on the empty randint,
                            # train.py:454): shrink the crop so the full
                            # utterance's edges provide the context.
                            s = cin_pad
                            max_frames = len(c) - 2 * cin_pad
                            assert max_frames > 0, (len(c), cin_pad)
                        ts = s * hop
                        x = x[ts:ts + hop * max_frames]
                        c = c[s - cin_pad:s + max_frames + cin_pad, :]
                        assert_ready_for_upsampling(x, c, cin_pad, hop)
            else:
                # Sample-resolution conditioning: the model consumes c with
                # len(c) == len(x), so the crop takes NO cin_pad context
                # here. The reference crops with context then asserts
                # len(x) == len(c) (train.py:463-468), which can only pass
                # when cin_pad == 0.
                x, c = audio.adjust_time_resolution(
                    x, c, cfg.silence_threshold)
                if max_time_steps is not None and len(x) > max_time_steps:
                    s = rng.randint(0, len(x) - max_time_steps + 1)
                    x = x[s:s + max_time_steps]
                    c = c[s:s + max_time_steps, :]
                assert len(x) == len(c), (len(x), len(c))
        else:
            if cfg.is_mulaw_quantize:
                x = audio.trim(x, cfg.silence_threshold)
            if max_time_steps is not None and len(x) > max_time_steps:
                s = rng.randint(0, len(x) - max_time_steps + 1)
                x = x[s:s + max_time_steps]
        new_items.append((x, c, g))

    input_lengths = np.asarray([len(it[0]) for it in new_items], np.int32)
    if static_shapes and max_time_steps is not None:
        pad_len = (ensure_divisible(max_time_steps, hop, True)
                   if (local and cfg.upsample_conditional_features)
                   else max_time_steps)
        pad_len = max(pad_len, int(input_lengths.max()))
    else:
        pad_len = int(input_lengths.max())

    mu = cfg.quantize_channels - 1
    if cfg.is_mulaw_quantize:
        pad_code = int(mulaw_quantize(np.zeros(1), mu)[0])
        x_b = np.full((len(new_items), pad_len), pad_code, np.int32)
        for i, (x, _, _) in enumerate(new_items):
            x_b[i, :len(x)] = x
        # one-hot via the native C++ hot loop when available
        # (numpy fancy-indexing fallback inside)
        from wavenet_vocoder_tpu_torch.data import native
        x_batch = native.onehot(x_b, cfg.quantize_channels)
        y_batch = x_b
    else:
        x_batch = np.zeros((len(new_items), pad_len, 1), np.float32)
        for i, (x, _, _) in enumerate(new_items):
            x_batch[i, :len(x), 0] = x
        y_batch = x_batch.copy()  # (B, T, 1) float targets

    out: Dict[str, np.ndarray] = {
        "x": x_batch, "y": y_batch, "input_lengths": input_lengths,
    }

    if local:
        if cfg.upsample_conditional_features:
            mel_len = pad_len // hop + 2 * cin_pad
        else:
            # sample-resolution conditioning: len(c) == len(x) (see crop above)
            mel_len = pad_len
        mel_len = max(mel_len, max(len(it[1]) for it in new_items))
        D = new_items[0][1].shape[1]
        c_batch = np.zeros((len(new_items), mel_len, D), np.float32)
        for i, (_, c, _) in enumerate(new_items):
            c_batch[i, :len(c)] = c
        out["c"] = c_batch

    if global_cond:
        out["g"] = np.asarray([int(it[2]) for it in new_items], np.int32)

    return out


class DataLoader:
    """Minimal batched loader: sampler indices -> collate on a worker thread
    pool with bounded read-ahead (replaces torch DataLoader,
    reference: train.py:1014-1017). Yields numpy batches."""

    def __init__(self, dataset: WaveNetDataset, cfg: Config,
                 batch_size: Optional[int] = None, shuffle: bool = True,
                 num_workers: Optional[int] = None, seed: int = 1234,
                 static_shapes: bool = True):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size or cfg.batch_size
        self.static_shapes = static_shapes
        self._rng = np.random.RandomState(seed)
        if shuffle:
            self.sampler = LengthBucketSampler(
                dataset.lengths(), self.batch_size, seed=seed)
        else:
            n = len(dataset)
            idx = np.arange(n)
            self.sampler = [idx[i:i + self.batch_size]
                            for i in range(0, n, self.batch_size)]
        self.num_workers = (cfg.num_workers if num_workers is None
                            else num_workers)

    def __len__(self):
        return len(self.sampler) if hasattr(self.sampler, "__len__") else 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor

        def make(idx_batch):
            items = [self.dataset[int(i)] for i in idx_batch]
            with profiling.span("data.collate"):
                return collate_fn(items, self.cfg, rng=self._rng,
                                  static_shapes=self.static_shapes)

        if self.num_workers <= 0:
            for idx_batch in self.sampler:
                yield make(idx_batch)
            return
        # bounded read-ahead: keep at most 2*num_workers collated batches in
        # flight (submitting everything upfront would hold the whole epoch's
        # batches in host memory)
        from collections import deque
        depth = 2 * self.num_workers
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = deque()
            it = iter(self.sampler)
            try:
                for _ in range(depth):
                    pending.append(pool.submit(make, next(it)))
            except StopIteration:
                pass
            while pending:
                fut = pending.popleft()
                try:
                    pending.append(pool.submit(make, next(it)))
                except StopIteration:
                    pass
                yield fut.result()
