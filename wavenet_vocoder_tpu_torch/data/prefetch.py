"""Device prefetch: overlap host collate + host-to-device copies with the
train step.

The port's counterpart of ``wavenet_vocoder_tpu/data/prefetch.py``. The
reference's input pipeline blocks the train step on a synchronous
``.to(device)`` (reference: train.py:698-733). Here, on a CUDA device, each
numpy batch is copied into pinned host memory and sent to the card with
``non_blocking=True`` on a side stream, ``depth`` batches ahead of the one the
step consumes, so the copies run under the step's kernels. Before a batch is
yielded the consumer's stream waits for its copy, and every tensor is marked
as used on that stream (``record_stream``), so the caching allocator does not
hand its memory to a later batch while the step still reads it.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from wavenet_vocoder_tpu_torch.synthesis import resolve_device


def to_device(batch: Dict[str, Any], device, *,
              pin_memory: bool = True) -> Dict[str, Any]:
    """numpy (or tensor) batch -> tensors on ``device``. On a CUDA device
    the host arrays are pinned when ``pin_memory`` and copied without
    blocking on the current stream; on the CPU they are wrapped in place."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: None if v is None else torch.as_tensor(v, device=device)
                for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        t = (torch.from_numpy(np.ascontiguousarray(v))
             if isinstance(v, np.ndarray) else torch.as_tensor(v))
        if pin_memory and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def prefetch_to_device(iterator: Iterable, *, depth: int = 2,
                       put: Optional[Callable[[Any], Any]] = None,
                       device=None, pin_memory: bool = True) -> Iterator:
    """Yield batches from ``iterator`` with ``depth`` batches already
    on their way to ``device`` ahead of consumption.

    ``device``: where the batches go (default: the GPU; raises without one
    unless a device is named). ``put`` customizes placement of one batch
    (it then replaces the copy, and is called on the side stream on a CUDA
    device); by default numpy arrays become tensors on ``device``, pinned
    first when ``pin_memory``. On the CPU no stream is used.
    """
    device = resolve_device(device)
    on_card = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_card else None
    if put is None:
        put = lambda b: to_device(b, device, pin_memory=pin_memory)

    def launch(b):
        if not on_card:
            return put(b), None
        # tensors made here are allocated on the side stream; the memory of
        # earlier batches comes back to it only after the consumer's work on
        # them is done (record_stream in ready())
        with torch.cuda.stream(side):
            out = put(b)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def ready(entry):
        out, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for v in _tensors(out):
                if v.device.type == "cuda":
                    v.record_stream(consumer)
        return out

    q: deque = deque()
    it = iter(iterator)
    try:
        while len(q) < depth:
            q.append(launch(next(it)))
    except StopIteration:
        pass
    while q:
        entry = q.popleft()
        try:
            q.append(launch(next(it)))
        except StopIteration:
            pass
        yield ready(entry)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
