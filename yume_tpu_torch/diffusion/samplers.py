"""Euler segment sampler (counterpart of
yume_tpu/diffusion/samplers.py::euler_sample_segment), as a Python loop over
the sigma ladder where the reference uses ``lax.scan``."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@torch.no_grad()
def euler_sample_segment(
    denoise_fn: DenoiseFn,
    latent: torch.Tensor,
    sigmas: np.ndarray,
    latent_frame_zero: int,
    *,
    history_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Tail-only Euler update with frozen history: history frames carry
    their timesteps (0 at inference), the tail σ_i·1000, and only the
    trailing ``latent_frame_zero`` frames integrate.

    latent: [B, F, H, W, C] = [history | tail noise]; ``denoise_fn(latent,
    t_frame)`` returns a velocity whose trailing frames are used.
    """
    b, f = latent.shape[:2]
    f_hist = f - latent_frame_zero
    if history_t is None:
        history_t = torch.zeros((b, f_hist), dtype=torch.float32, device=latent.device)
    sig = np.asarray(sigmas, np.float32)
    for s_i, s_n in zip(sig[:-1], sig[1:]):
        t_frame = torch.cat(
            [history_t * 1000.0,
             torch.full((b, latent_frame_zero), float(s_i * np.float32(1000.0)),
                        dtype=torch.float32, device=latent.device)], dim=1)
        v = denoise_fn(latent, t_frame)
        v_tail = v[:, -latent_frame_zero:]
        tail = latent[:, -latent_frame_zero:] + float(s_n - s_i) * v_tail
        latent = torch.cat([latent[:, :f_hist], tail], dim=1)
    return latent
