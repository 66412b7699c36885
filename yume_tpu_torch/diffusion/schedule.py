"""Flow-matching noise schedules and timestep warps: the port's own copy of
yume_tpu/diffusion/schedule.py (pinned equal to it by
``tests/test_torch_configs.py``).

Re-derivation of the reference schedule helpers:
  - `get_sampling_sigmas` (reference wan/utils/fm_solvers.py:22-27)
  - the shift warp used by Transport.sample (reference
    hyvideo/diffusion/flow/transport.py:147-153)
  - flux-style resolution-dependent `time_shift` (reference
    hyvideo/diffusion/flow/transport.py:52-61)
"""

from __future__ import annotations

import math

import numpy as np


def shift_t(t, shift: float):
    """Warp t ← shift·t / (1 + (shift−1)·t).

    Used both for training-time timestep sampling under the `reverse`
    (xt = (1−t)x1 + t·x0) convention (reference transport.py:149-150) and
    for inference sigmas (reference fm_solvers.py:25). Identity at shift=1;
    pushes mass toward t=1 (high noise) for shift>1.
    """
    return (shift * t) / (1 + (shift - 1) * t)


def unshift_t(t, shift: float):
    """Inverse of :func:`shift_t`."""
    return t / (shift - (shift - 1) * t)


def sampling_sigmas(sampling_steps: int, shift: float, *, append_zero: bool = True) -> np.ndarray:
    """Shifted sigma ladder for Euler/DPM sampling.

    Reference `get_sampling_sigmas` (wan/utils/fm_solvers.py:22-27) returns
    the first `sampling_steps` entries of linspace(1, 0, steps+1) warped by
    :func:`shift_t`; the samplers then use sigma[i+1]−sigma[i] steps, so we
    optionally append the terminal 0 (matching the reference drivers, e.g.
    fastvideo/sample/sample.py's Euler loop which treats the ladder as
    having a final 0).
    """
    sigma = np.linspace(1, 0, sampling_steps + 1)[:sampling_steps]
    sigma = shift_t(sigma, shift)
    if append_zero:
        sigma = np.concatenate([sigma, [0.0]])
    return sigma.astype(np.float32)


def unipc_sigmas(sampling_steps: int, shift: float,
                 num_train_timesteps: int = 1000) -> np.ndarray:
    """The UniPC scheduler's default ladder (reference
    fm_solvers_unipc.py:182-207 set_timesteps): σ_max = 1 − 1/N (not 1),
    shifted, with a terminal 0 appended (final_sigmas_type='zero')."""
    sigma_max = 1.0 - 1.0 / num_train_timesteps
    sigma = np.linspace(sigma_max, 0.0, sampling_steps + 1)[:-1]
    sigma = shift_t(sigma, shift)
    return np.concatenate([sigma, [0.0]]).astype(np.float32)


def lin_mu(seq_len: int, x1: float = 256, y1: float = 0.5,
           x2: float = 4096, y2: float = 1.15) -> float:
    """Resolution-dependent shift exponent (reference transport.py:52-57)."""
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return m * seq_len + b


def time_shift(mu: float, sigma: float, t):
    """Flux-style exponential time shift (reference transport.py:60-61)."""
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)
