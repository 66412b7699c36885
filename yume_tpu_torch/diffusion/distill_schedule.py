"""Distillation schedules (counterpart of
yume_tpu/diffusion/distill_schedule.py): the PCM (phased consistency) sigma
ladder, the discrete Euler solver of consistency and adversarial
distillation, the linear-quadratic schedule and the FlowMatchDiscrete
timestep ladder. The ladders are numpy; the solver's steps are torch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .schedule import shift_t


def linear_quadratic_schedule(num_steps: int, threshold: float = 0.025,
                              linear_steps: Optional[int] = None) -> np.ndarray:
    """Linear-then-quadratic sigma schedule (reference
    pipeline_mochi.linear_quadratic_schedule)."""
    if linear_steps is None:
        linear_steps = num_steps // 2
    linear = [i * threshold / linear_steps for i in range(linear_steps)]
    threshold_noise_step_diff = linear_steps - threshold * num_steps
    quadratic_steps = num_steps - linear_steps
    a = threshold_noise_step_diff / (linear_steps * quadratic_steps ** 2)
    b = threshold / linear_steps - 2 * a * linear_steps
    c = threshold - a * linear_steps ** 2 - b * linear_steps
    quadratic = [a * i ** 2 + b * i + c for i in range(linear_steps, num_steps)]
    return 1.0 - np.asarray(linear + quadratic, np.float32)


def pcm_sigmas(num_train_timesteps: int = 1000, shift: float = 1.0,
               pcm_timesteps: int = 50) -> np.ndarray:
    """Descending PCM sigma ladder (reference PCMFMScheduler.__init__,
    fastvideo/distill/solver.py:32-66)."""
    timesteps = np.linspace(1, num_train_timesteps, num_train_timesteps,
                            dtype=np.float32)[::-1]
    sigmas = shift_t(timesteps / num_train_timesteps, shift)
    idx = (np.arange(1, pcm_timesteps + 1)
           * (num_train_timesteps // pcm_timesteps)).round().astype(np.int64) - 1
    return np.ascontiguousarray(sigmas[::-1][idx][::-1])


@dataclasses.dataclass(frozen=True)
class EulerSolver:
    """Discrete Euler solver over a subsampled sigma ladder (reference
    wan/utils/fm_solvers.py:861-936): steps between teacher timesteps and
    forms multiphase targets. ``index`` arguments are [B] integer tensors."""

    sigmas: np.ndarray        # [K] at the euler timesteps
    sigmas_prev: np.ndarray   # [K] previous-step sigmas
    euler_timesteps: np.ndarray

    @classmethod
    def create(cls, sigmas: np.ndarray, timesteps: int = 1000,
               euler_timesteps: int = 50) -> "EulerSolver":
        step_ratio = timesteps // euler_timesteps
        idx = (np.arange(1, euler_timesteps + 1) * step_ratio).round().astype(np.int64) - 1
        sig = np.asarray(sigmas, np.float32)
        return cls(sigmas=sig[idx],
                   sigmas_prev=np.asarray([sig[0]] + sig[idx[:-1]].tolist(), np.float32),
                   euler_timesteps=idx)

    def _at(self, table: np.ndarray, index: torch.Tensor, ndim: int) -> torch.Tensor:
        t = torch.as_tensor(table, device=index.device)[index]
        return t.reshape((-1,) + (1,) * (ndim - 1))

    def euler_step(self, sample: torch.Tensor, v_pred: torch.Tensor,
                   index: torch.Tensor) -> torch.Tensor:
        sigma = self._at(self.sigmas, index, sample.dim())
        sigma_prev = self._at(self.sigmas_prev, index, sample.dim())
        return sample + (sigma_prev - sigma) * v_pred

    def multiphase_pred(self, sample: torch.Tensor, v_pred: torch.Tensor, index: torch.Tensor,
                        multiphase: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Phased-consistency target: a step to the start sigma of the
        current phase (reference euler_style_multiphase_pred,
        fm_solvers.py:896-936). Returns (target, the phase's start index, −1
        when none lies at or before ``index``)."""
        k = len(self.sigmas)
        starts = np.floor(np.linspace(0, k, num=multiphase, endpoint=False)).astype(np.int64)
        starts = torch.as_tensor(starts, device=index.device).expand(index.shape[0], -1)
        last_valid = torch.where(starts <= index[:, None], starts,
                                 torch.full_like(starts, -1)).max(dim=1).values
        sigma = self._at(self.sigmas, index, sample.dim())
        sigma_prev = self._at(self.sigmas, last_valid.clamp(min=0), sample.dim())
        sigma_prev = torch.where(last_valid.reshape(sigma.shape) >= 0, sigma_prev,
                                 torch.zeros_like(sigma_prev))
        return sample + (sigma_prev - sigma) * v_pred, last_valid


def flow_match_discrete_timesteps(num_steps: int, shift: float = 7.0,
                                  num_train_timesteps: int = 1000,
                                  reverse: bool = True) -> np.ndarray:
    """FlowMatchDiscreteScheduler timestep ladder (reference
    hyvideo/schedulers/scheduling_flow_match_discrete.py): shift-warped
    discrete sigmas in train-timestep units."""
    sigmas = np.linspace(1, 0, num_steps + 1, dtype=np.float32)
    if not reverse:
        sigmas = sigmas[::-1]
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    return sigmas[:-1] * num_train_timesteps
