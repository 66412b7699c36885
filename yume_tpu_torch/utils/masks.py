"""History/conditioning masks and output-size helpers (counterpart of
yume_tpu/utils/masks.py). The random draws of :func:`masks_like` are
explicit arguments; :func:`draw_history` makes them from a
``torch.Generator``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_history(generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two scalar draws of a training :func:`masks_like`: U(0, 1) (is
    the history pseudo-noised?) and N(0, 1) (its log-sigma)."""
    dev = generator.device
    return (torch.rand((), generator=generator, device=dev),
            torch.randn((), generator=generator, device=dev))


def masks_like(
    shape: Tuple[int, ...],
    *,
    zero: bool = False,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    p: float = 0.2,
    latent_frame_zero: int = 8,
    frame_axis: int = 1,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask1, mask2) over a latent of ``shape``.

    mask2 zeroes the history frames (all but the trailing
    ``latent_frame_zero``); mask1 does too, except in training (``draws``
    given as (u, n), see :func:`draw_history`), where with probability ``p``
    (u < p) its history is exp(−3.5 + 0.5·n) instead: a small pseudo-sigma
    for slightly noisy history (reference wan23/utils/utils.py:106-133)."""
    f = shape[frame_axis]
    ones = torch.ones(shape, dtype=dtype, device=device)
    tail = (torch.arange(f, device=device) >= f - latent_frame_zero).to(dtype)
    bshape = [1] * len(shape)
    bshape[frame_axis] = f
    tail = tail.reshape(bshape)
    if not zero:
        return ones, ones
    mask2 = ones * tail
    if draws is None:
        return mask2, mask2
    u, n = (d.to(device=device, dtype=torch.float32) for d in draws)
    sigma = torch.exp(-3.5 + 0.5 * n)
    hist_val = torch.where(u < p, sigma, torch.zeros_like(sigma)).to(dtype)
    mask1 = ones * tail + hist_val * (1.0 - tail)
    return mask1, mask2


def best_output_size(w: int, h: int, dw: int, dh: int, expected_area: int) -> Tuple[int, int]:
    """Largest (ow, oh) ≤ expected_area with ow % dw == 0, oh % dh == 0
    closest to the input aspect ratio (reference wan23/utils/utils.py:136-159)."""
    ratio = w / h
    ow = (expected_area * ratio) ** 0.5
    oh = expected_area / ow

    ow1 = int(ow // dw * dw)
    oh1 = int(expected_area / ow1 // dh * dh)
    ratio1 = ow1 / oh1

    oh2 = int(oh // dh * dh)
    ow2 = int(expected_area / oh2 // dw * dw)
    ratio2 = ow2 / oh2

    if max(ratio / ratio1, ratio1 / ratio) < max(ratio / ratio2, ratio2 / ratio):
        return ow1, oh1
    return ow2, oh2


def per_frame_timesteps(mask2_frame: torch.Tensor, t: torch.Tensor,
                        latent_frame_zero: int) -> torch.Tensor:
    """Per-latent-frame timesteps [B, F] for the 5B diffusion-forcing path:
    the trailing ``latent_frame_zero`` frames at t [B], the history at its
    mask value (reference fastvideo/sample/sample_5b.py:963-972)."""
    f = mask2_frame.shape[1]
    is_tail = torch.arange(f, device=mask2_frame.device) >= f - latent_frame_zero
    return torch.where(is_tail[None, :], t[:, None].to(mask2_frame.dtype), mask2_frame)
