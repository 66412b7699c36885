"""Flow-matching transport: path plan, timestep sampling, training loss
(counterpart of yume_tpu/diffusion/transport.py).

The reference's live configuration: linear path (ICPlan), velocity
prediction, lognorm SNR, shift 3.0, reverse=True:
    x_t = (1 − t)·x1 + t·x0        (x1 = data, x0 = noise)
    u_t = x0 − x1                  (velocity target)
so t = 0 is clean data and t = 1 pure noise.

Random draws are explicit: :meth:`Transport.sample_t` maps a standard draw
(N(0, 1) for lognorm, U(0, 1) for uniform) to a timestep, and
:meth:`Transport.draw_t` makes that draw from a ``torch.Generator``, so a
test can hand the port and the JAX package the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .schedule import shift_t


@dataclasses.dataclass(frozen=True)
class Transport:
    """Linear-path velocity flow matching (the reference's live config)."""

    shift: float = 3.0
    training_timesteps: int = 1000
    snr_type: str = "lognorm"  # 'lognorm' | 'uniform'

    def draw_t(self, batch: int, generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
        """The standard draw behind :meth:`sample_t`: N(0, 1) for lognorm,
        U(0, 1) for uniform, [batch] fp32."""
        device = generator.device if generator is not None else device
        if self.snr_type == "lognorm":
            return torch.randn((batch,), generator=generator, device=device)
        if self.snr_type == "uniform":
            return torch.rand((batch,), generator=generator, device=device)
        raise ValueError(f"unknown snr_type {self.snr_type}")

    def sample_t(self, draw: torch.Tensor) -> torch.Tensor:
        """Training timesteps t ∈ (0, 1) from a standard draw: lognorm is
        sigmoid(N(0, 1)), then the shift warp (reference
        transport.py:139-153)."""
        if self.snr_type == "lognorm":
            t = torch.sigmoid(draw.float())
        elif self.snr_type == "uniform":
            t = draw.float()
        else:
            raise ValueError(f"unknown snr_type {self.snr_type}")
        if self.shift != 1.0:
            t = shift_t(t, self.shift)
        return t

    @staticmethod
    def plan(t: torch.Tensor, x0: torch.Tensor,
             x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x_t, u_t) along the reverse linear path; t [B] broadcasts over
        the trailing dims of x0/x1."""
        tb = t.reshape(t.shape + (1,) * (x1.dim() - t.dim()))
        return (1.0 - tb) * x1 + tb * x0, x0 - x1

    @staticmethod
    def score_from_velocity(v: torch.Tensor, x: torch.Tensor,
                            t: torch.Tensor) -> torch.Tensor:
        """∇log p_t(x) from a velocity prediction (reverse linear path):
        score = (−(1 − t)·v − x) / t."""
        tb = t.reshape(t.shape + (1,) * (x.dim() - t.dim()))
        ratio = -(1.0 - tb)
        var = tb * tb + (1.0 - tb) * tb
        return (ratio * v - x) / var

    def loss(self, v_pred: torch.Tensor, ut: torch.Tensor, *,
             tail_frames: Optional[int] = None, frame_axis: int = 1) -> torch.Tensor:
        """Per-sample velocity MSE [B] over the trailing ``tail_frames``
        frames (all frames when None), in fp32."""
        if tail_frames is not None:
            v_pred = v_pred.narrow(frame_axis, v_pred.shape[frame_axis] - tail_frames,
                                   tail_frames)
            ut = ut.narrow(frame_axis, ut.shape[frame_axis] - tail_frames, tail_frames)
        diff = (v_pred.float() - ut.float()) ** 2
        return diff.mean(dim=tuple(range(1, diff.dim())))
