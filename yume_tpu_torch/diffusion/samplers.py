"""Euler samplers (counterpart of yume_tpu/diffusion/samplers.py):
``euler_sample`` over every frame (the t2v first segment),
``euler_sample_segment`` and the TeaCache variants
``euler_sample_segment_cached`` (fixed refresh interval) and
``euler_sample_segment_cached_adaptive`` (refresh on accumulated rel-L1
input change). Python loops over the sigma ladder where the reference uses
``lax.scan``/``lax.cond``; the adaptive refresh decision is read on the host
once per step."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (latent, t_frame) -> (v, cache) and (latent, t_frame, cache) -> v
FullFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, Any]]
CachedFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


def _t_frame(history_t, s_i, latent_frame_zero):
    """[B, F] timesteps: history_t·1000 then σ_i·1000 (in fp32, as the
    reference's fp32 ladder arithmetic) for the tail frames."""
    b = history_t.shape[0]
    tail = torch.full((b, latent_frame_zero), float(np.float32(s_i) * np.float32(1000.0)),
                      dtype=torch.float32, device=history_t.device)
    return torch.cat([history_t * 1000.0, tail], dim=1)


def _history_t(latent, latent_frame_zero, history_t):
    if history_t is not None:
        return history_t
    b, f = latent.shape[:2]
    return torch.zeros((b, f - latent_frame_zero), dtype=torch.float32,
                       device=latent.device)


def _euler_tail(latent, v, s_i, s_n, latent_frame_zero):
    """latent with its tail advanced by (σ_n − σ_i)·v (fp32 step size)."""
    f_hist = latent.shape[1] - latent_frame_zero
    dt = float(np.float32(s_n) - np.float32(s_i))
    tail = latent[:, -latent_frame_zero:] + dt * v[:, -latent_frame_zero:]
    return torch.cat([latent[:, :f_hist], tail], dim=1)


@torch.no_grad()
def euler_sample(denoise_fn: DenoiseFn, noise: torch.Tensor, sigmas: np.ndarray) -> torch.Tensor:
    """Plain Euler flow integration over all frames (the 5B t2v first
    segment: one timestep σ_i·1000 for every frame, no CFG).

    noise: [B, F, H, W, C], integrated in its own dtype (fp32 from the
    pipeline); sigmas: [steps+1] descending to 0; ``denoise_fn(latent,
    t_frame)`` returns the velocity of every frame.
    """
    b, f = noise.shape[:2]
    sig = np.asarray(sigmas, np.float32)
    latent = noise
    for i in range(len(sig) - 1):
        t_frame = torch.full((b, f), float(sig[i] * np.float32(1000.0)),
                             dtype=torch.float32, device=noise.device)
        v = denoise_fn(latent, t_frame)
        latent = latent + float(sig[i + 1] - sig[i]) * v
    return latent


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
    history_t = _history_t(latent, latent_frame_zero, history_t)
    sig = np.asarray(sigmas, np.float32)
    for i in range(len(sig) - 1):
        v = denoise_fn(latent, _t_frame(history_t, sig[i], latent_frame_zero))
        latent = _euler_tail(latent, v, sig[i], sig[i + 1], latent_frame_zero)
    return latent


@torch.no_grad()
def euler_sample_segment_cached(
    denoise_full: FullFn,
    denoise_cached: CachedFn,
    latent: torch.Tensor,
    sigmas: np.ndarray,
    latent_frame_zero: int,
    *,
    cache_interval: int = 2,
    history_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Euler tail sampling with TeaCache-style block-residual reuse
    (reference wan/modules/model.py:977-998): every ``cache_interval``-th
    step runs the full DiT and stores block residuals; in-between steps skip
    the cached blocks and add the stored residuals."""
    history_t = _history_t(latent, latent_frame_zero, history_t)
    sig = np.asarray(sigmas, np.float32)
    cache = None
    for i in range(len(sig) - 1):
        t_frame = _t_frame(history_t, sig[i], latent_frame_zero)
        if cache is None or i % cache_interval == 0:
            v, cache = denoise_full(latent, t_frame)
        else:
            v = denoise_cached(latent, t_frame, cache)
        latent = _euler_tail(latent, v, sig[i], sig[i + 1], latent_frame_zero)
    return latent


def _rel_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(a - b)) / torch.clamp_min(torch.sum(torch.abs(b)), 1e-6)


@torch.no_grad()
def euler_sample_segment_cached_adaptive(
    denoise_full: FullFn,
    denoise_cached: CachedFn,
    latent: torch.Tensor,
    sigmas: np.ndarray,
    latent_frame_zero: int,
    *,
    threshold: float = 0.15,
    history_t: Optional[torch.Tensor] = None,
    decide: Optional[Callable[[bool], bool]] = None,
) -> Tuple[torch.Tensor, int]:
    """TeaCache with data-adaptive refresh: each step adds the relative L1
    change of the tail latent to an fp32 accumulator and runs the full DiT
    only when it reaches ``threshold`` (then resets it); other steps reuse
    the cached residuals. Step 0 always runs full. ``decide`` maps this
    process's refresh decision to the one to take (under sequence
    parallelism: rank 0's, the same on every rank).

    Returns ``(latent, n_full)``, n_full counting the full-DiT steps
    (step 0 included)."""
    history_t = _history_t(latent, latent_frame_zero, history_t)
    sig = np.asarray(sigmas, np.float32)
    prev_tail = latent[:, -latent_frame_zero:]
    v, cache = denoise_full(latent, _t_frame(history_t, sig[0], latent_frame_zero))
    latent = _euler_tail(latent, v, sig[0], sig[1], latent_frame_zero)
    accum = torch.zeros((), dtype=torch.float32, device=latent.device)
    n_full = 1
    for i in range(1, len(sig) - 1):
        cur_tail = latent[:, -latent_frame_zero:]
        accum = accum + _rel_l1(cur_tail, prev_tail).float()
        t_frame = _t_frame(history_t, sig[i], latent_frame_zero)
        refresh = bool(accum >= threshold)  # one host read per step
        if decide is not None:
            refresh = decide(refresh)
        if refresh:
            v, cache = denoise_full(latent, t_frame)
            accum = torch.zeros_like(accum)
            n_full += 1
        else:
            v = denoise_cached(latent, t_frame, cache)
        latent = _euler_tail(latent, v, sig[i], sig[i + 1], latent_frame_zero)
        prev_tail = cur_tail
    return latent, n_full
