"""Dump-directory manifests.

The port's counterpart of the manifest part of
``wavenet_vocoder_tpu/data/dataset.py``: the ``train.txt`` format
``wave.npy|feats.npy|N_frames|text[|speaker_id]`` (reference:
train.py:180-183; preprocess.py:28-37). A 5th field means multi-speaker.
The dataset, sampler and collate function belong to the data-pipeline
slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


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
