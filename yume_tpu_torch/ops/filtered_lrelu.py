"""filtered_lrelu: up-filter → bias → leaky ReLU → clamp → down-filter
(counterpart of yume_tpu/ops/filtered_lrelu.py).

The reference's own ``impl='ref'`` decomposition: two :func:`upfirdn2d`
resamplings around one :func:`bias_act` over the NCHW activation with
``dim=1`` (K10 on the card, no permute copy).
"""

from __future__ import annotations

import numpy as np

from .bias_act import bias_act
from .upfirdn2d import _parse_pad, upfirdn2d


def filtered_lrelu(x, fu=None, fd=None, b=None, *, up: int = 1, down: int = 1, padding=0,
                   gain: float = np.sqrt(2), slope: float = 0.2, clamp=None):
    """x: [B, C, H, W]; fu/fd: upsample/downsample FIR filters (numpy or
    tensors); b: [C] bias."""
    if fu is None:
        fu = np.ones((1, 1), np.float32)
    if fd is None:
        fd = np.ones((1, 1), np.float32)
    fu_h = fu.shape[0] if fu.ndim >= 1 else 1
    fu_w = fu.shape[-1] if fu.ndim >= 1 else 1
    fd_h = fd.shape[0] if fd.ndim >= 1 else 1
    fd_w = fd.shape[-1] if fd.ndim >= 1 else 1
    px0, px1, py0, py1 = _parse_pad(padding)

    # the reference's ref-path padding arithmetic
    px0 += (fu_w + up - 1) // 2
    px1 += (fu_w - up) // 2
    py0 += (fu_h + up - 1) // 2
    py1 += (fu_h - up) // 2
    px0 += (fd_w - 1) // 2
    px1 += fd_w // 2
    py0 += (fd_h - 1) // 2
    py1 += fd_h // 2

    y = upfirdn2d(x, fu, up=up, padding=(px0, px1, py0, py1), gain=up ** 2)
    y = bias_act(y, b, dim=1, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(y, fd, down=down)
