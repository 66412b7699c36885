"""upfirdn2d: upsample → FIR filter → downsample (StyleGAN resampling);
counterpart of yume_tpu/ops/upfirdn2d.py.

The JAX package computes this as one ``lax.conv_general_dilated`` (no Pallas
kernel): ``lhs_dilation`` inserts the upsampling zeros, the window stride
downsamples and the flipped filter is a depthwise convolution. Here the
zeros are inserted explicitly, each sample followed by ``up − 1`` of them
(the trailing ones included, as the reference's zero-insertion upsample),
the padding follows (negative padding crops), and the filter runs as a
depthwise ``F.conv2d`` with the channels folded into the batch. Autograd
gives the reference's gradient (its custom gradient is the transposed
filtering).

x: [B, C, H, W]; f: [fh, fw] (or separable [f]) un-normalised FIR filter, a
numpy array or a tensor; padding = (x0, x1, y0, y1), (px, py) or one int.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def setup_filter(f, normalize=True, gain=1.0, separable=None) -> np.ndarray:
    """Prepare a FIR filter (as the reference's ``setup_filter``)."""
    f = np.asarray(f, np.float32)
    if f.ndim == 0:
        f = f[None]
    if f.ndim == 1 and separable is not True:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    return f * gain


def _parse_pad(padding) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        return (padding,) * 4
    padding = tuple(padding)
    if len(padding) == 2:
        px, py = padding
        return (px, px, py, py)
    return padding  # (x0, x1, y0, y1)


def _filter_hw(f) -> Tuple[int, int]:
    return (f.shape[0], f.shape[0]) if f.ndim == 1 else tuple(f.shape)


def upfirdn2d(x: torch.Tensor, f, *, up: int = 1, down: int = 1, padding=0,
              gain: float = 1.0) -> torch.Tensor:
    """x: [B, C, H, W] → [B, C, H', W'] with
    H' = (H·up + y0 + y1 − fh + down) // down; computed in fp32, returned in
    x's dtype."""
    b, c, h, w = x.shape
    x0, x1, y0, y1 = _parse_pad(padding)
    f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    if f.ndim == 1:
        f = torch.outer(f, f)
    xr = x.reshape(b * c, 1, h, 1, w, 1).float()
    # each sample followed by up − 1 zeros along both axes
    xr = F.pad(xr, (0, up - 1, 0, 0, 0, up - 1)).reshape(b * c, 1, h * up, w * up)
    xr = F.pad(xr, (x0, x1, y0, y1))  # negative values crop
    # correlation with the flipped filter is the convolution
    out = F.conv2d(xr, torch.flip(f, (0, 1))[None, None], stride=down) * gain
    return out.reshape(b, c, out.shape[2], out.shape[3]).to(x.dtype)


def upsample2d(x, f, up=2, padding=0, gain=1.0):
    """(the reference's ``upsample2d``)"""
    fh, fw = _filter_hw(f)
    p = _parse_pad(padding)
    pad = (p[0] + (fw + up - 1) // 2, p[1] + (fw - up) // 2,
           p[2] + (fh + up - 1) // 2, p[3] + (fh - up) // 2)
    return upfirdn2d(x, f, up=up, padding=pad, gain=gain * up * up)


def downsample2d(x, f, down=2, padding=0, gain=1.0):
    """(the reference's ``downsample2d``)"""
    fh, fw = _filter_hw(f)
    p = _parse_pad(padding)
    pad = (p[0] + (fw - down + 1) // 2, p[1] + (fw - down) // 2,
           p[2] + (fh - down + 1) // 2, p[3] + (fh - down) // 2)
    return upfirdn2d(x, f, down=down, padding=pad, gain=gain)


def filter2d(x, f, padding=0, gain=1.0):
    fh, fw = _filter_hw(f)
    p = _parse_pad(padding)
    pad = (p[0] + fw // 2, p[1] + (fw - 1) // 2, p[2] + fh // 2, p[3] + (fh - 1) // 2)
    return upfirdn2d(x, f, padding=pad, gain=gain)
