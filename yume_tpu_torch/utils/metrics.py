"""Quality metrics: PSNR and per-frame PSNR of videos in [-1, 1] (the
port's copy of yume_tpu/utils/metrics.py)."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """PSNR in dB between two arrays in [-1, 1] (data_range 2)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def per_frame_psnr(a: np.ndarray, b: np.ndarray, frame_axis: int = 1,
                   data_range: float = 2.0) -> np.ndarray:
    """Per-frame PSNR along ``frame_axis`` for videos in [-1, 1]."""
    a = np.moveaxis(np.asarray(a), frame_axis, 0)
    b = np.moveaxis(np.asarray(b), frame_axis, 0)
    return np.array([psnr(x, y, data_range) for x, y in zip(a, b)])
