"""Video transforms and batch samplers (counterpart of
yume_tpu/data/transforms.py; reference fastvideo/dataset/transform.py:
CenterCropResizeVideo:324, TemporalRandomCrop; fastvideo/utils/
dataset_utils.py: LengthGroupedSampler:325, Collate:55). Host numpy,
channels-last.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Sequence

import numpy as np

from .native import center_crop_resize


class CenterCropResizeVideo:
    """Center-crop to the target aspect, then resize (the native C++ path
    where it builds)."""

    def __init__(self, size):
        self.h, self.w = size

    def __call__(self, video_u8: np.ndarray) -> np.ndarray:
        return center_crop_resize(video_u8, self.h, self.w)


class TemporalRandomCrop:
    """A random contiguous window of ``length`` frames."""

    def __init__(self, length: int, rng: random.Random | None = None):
        self.length = length
        self.rng = rng or random.Random()

    def __call__(self, total_frames: int):
        begin = self.rng.randint(0, max(total_frames - self.length, 0))
        return begin, min(begin + self.length, total_frames)


class LengthGroupedSampler:
    """Batches of indices grouped by sample length, so that each batch has
    one shape; the batches come in a seeded random order."""

    def __init__(self, lengths: Sequence[int], batch_size: int, seed: int = 0,
                 drop_last: bool = True):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rng = random.Random(seed)

    def __iter__(self) -> Iterator[List[int]]:
        idx = sorted(range(len(self.lengths)), key=lambda i: self.lengths[i])
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches = batches[:-1]
        self.rng.shuffle(batches)
        return iter(batches)


def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    """Stack the samples, right-padding frame counts with zeros to the
    batch's longest (reference Collate, dataset_utils.py:55); other values
    become lists."""
    out: Dict[str, np.ndarray] = {}
    for k in samples[0].keys():
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray) and vals[0].ndim >= 1:
            max_t = max(v.shape[0] for v in vals)
            out[k] = np.stack([
                np.concatenate([v, np.zeros((max_t - v.shape[0],) + v.shape[1:], v.dtype)])
                if v.shape[0] < max_t else v for v in vals])
        else:
            out[k] = vals
    return out
