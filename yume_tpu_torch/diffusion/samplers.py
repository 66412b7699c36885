"""Euler samplers (counterpart of yume_tpu/diffusion/samplers.py):
``euler_sample`` over every frame (the t2v first segment),
``euler_sample_segment`` and the TeaCache variants
``euler_sample_segment_cached`` (fixed refresh interval) and
``euler_sample_segment_cached_adaptive`` (refresh on accumulated rel-L1
input change), and the test-time-scaling (TTS) samplers
``sde_euler_sample_segment`` (SDE churn) and ``time_travel_sample_segment``
(lookahead, optionally with churn); and the 14B classifier-free-guidance
segment samplers, which re-noise the history every step:
``cfg_euler_sample_segment`` (``ctx_null=None`` is the distilled
one-forward step), ``cfg_euler_sample_segment_cached`` and
``cfg_euler_sample_segment_cached_adaptive`` (TeaCache, one cache per CFG
branch), ``cfg_sde_euler_sample_segment`` and
``cfg_time_travel_sample_segment`` (the exact 14B TTS loop). Python loops
over the sigma ladder where the reference uses ``lax.scan``/``lax.cond``;
the adaptive refresh decision is read on the host once per step.

The TTS samplers take their standard-normal churn draws from
``noise_fn(shape)``, one call per churn in the reference's order, so a test
can feed the JAX package's draws."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .transport import Transport

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (latent, t_frame) -> (v, cache) and (latent, t_frame, cache) -> v
FullFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, Any]]
CachedFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]
# shape -> a standard-normal draw of that shape (the TTS churn noise)
NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]
# the CFG samplers' (latent, t_frame, context) -> v, its TeaCache forms
# (latent, t_frame, context) -> (v, cache) and (latent, t_frame, context, cache) -> v
CFGDenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


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


def _score(v_tail, x_tail, s_i):
    """The score from the tail's velocity at σ_i (reverse linear path)."""
    t = torch.full((x_tail.shape[0],), float(s_i), dtype=torch.float32, device=x_tail.device)
    return Transport.score_from_velocity(v_tail, x_tail, t)


@torch.no_grad()
def sde_euler_sample_segment(
    denoise_fn: DenoiseFn,
    latent: torch.Tensor,
    sigmas: np.ndarray,
    latent_frame_zero: int,
    noise_fn: NoiseFn,
    *,
    eta: float = 0.3,
    history_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SDE churn sampling (TTS; reference fastvideo/sample/sample_tts.py:
    726-744): after each Euler tail step, an Euler–Maruyama correction from
    the score estimate, x ← x + η²·σ·score·Δt + η·√(2Δt·σ)·ε, with ε one
    ``noise_fn`` draw a step. The step's scalars are fp32, as the
    reference's scanned ladder."""
    history_t = _history_t(latent, latent_frame_zero, history_t)
    f_hist = latent.shape[1] - latent_frame_zero
    sig = np.asarray(sigmas, np.float32)
    for i in range(len(sig) - 1):
        v = denoise_fn(latent, _t_frame(history_t, sig[i], latent_frame_zero))
        tail = _sde_tail(latent[:, -latent_frame_zero:], v[:, -latent_frame_zero:], sig[i],
                         sig[i + 1], noise_fn, eta)
        latent = torch.cat([latent[:, :f_hist], tail], dim=1)
    return latent


def _sde_tail(x_tail, v_tail, s_i, s_n, noise_fn, eta):
    """An Euler tail step from σ_i to σ_n and its churn,
    x − Δt·v + η²·σ·score·Δt + η·√(2Δt·σ)·ε (ε one ``noise_fn`` draw), the
    scalars in fp32 as the reference's scanned ladder."""
    dt = s_i - s_n
    tail = x_tail - float(dt) * v_tail
    score = _score(v_tail, x_tail, s_i)
    eps = noise_fn(tuple(x_tail.shape)).to(x_tail)
    drift = float(np.float32(eta ** 2) * s_i)
    scale = float(np.float32(eta) * np.sqrt(np.float32(2.0) * dt * s_i))
    return tail + drift * score * float(dt) + scale * eps


@torch.no_grad()
def time_travel_sample_segment(
    denoise_fn: DenoiseFn,
    latent: torch.Tensor,
    sigmas: np.ndarray,
    latent_frame_zero: int,
    *,
    interval: int = 2,
    travel_steps: int = 2,
    history_t: Optional[torch.Tensor] = None,
    sde: bool = False,
    noise_fn: Optional[NoiseFn] = None,
    eta: float = 0.3,
) -> torch.Tensor:
    """Time-travel (lookahead) sampling, frozen-history form (reference
    fastvideo/sample/sample_tts.py:690-854 in the 5B segment convention).

    Every ``interval`` steps: a provisional Euler step, the ODE rolled
    forward to step i + ``travel_steps`` − 1, then step i redone from the
    original state with the last lookahead velocity (the reference's
    splice-back). With ``sde`` an Euler–Maruyama churn (one ``noise_fn``
    draw) follows every Euler tail update, outer and lookahead alike."""
    history_t = _history_t(latent, latent_frame_zero, history_t)
    f_hist = latent.shape[1] - latent_frame_zero
    sig = np.asarray(sigmas, np.float32)
    n_steps = len(sig) - 1
    if sde and noise_fn is None:
        raise ValueError("sde churn needs a noise_fn")

    def euler_tail(latent, s_i, s_n, v=None):
        if v is None:
            v = denoise_fn(latent, _t_frame(history_t, s_i, latent_frame_zero))
        x_tail, v_tail = latent[:, -latent_frame_zero:], v[:, -latent_frame_zero:]
        tail = x_tail + float(s_n - s_i) * v_tail
        if sde:
            # python-float scalars, each rounded to fp32 where it meets a tensor
            dt = float(s_i - s_n)
            eps = noise_fn(tuple(tail.shape)).to(tail)
            scale = float(eta * np.sqrt(max(2.0 * dt * float(s_i), 0.0)))
            tail = tail + (eta ** 2) * float(s_i) * _score(v_tail, x_tail, s_i) * dt \
                + scale * eps
        return torch.cat([latent[:, :f_hist], tail], dim=1), v

    for i in range(n_steps):
        provisional, _ = euler_tail(latent, sig[i], sig[i + 1])
        if interval > 0 and i % interval == 0:
            xt, v_look = provisional, None
            for j in range(i + 1, min(n_steps, i + travel_steps)):
                xt, v_look = euler_tail(xt, sig[j], sig[j + 1])
            if v_look is not None:
                # splice-back: step i again from the original latent with the
                # lookahead velocity
                latent, _ = euler_tail(latent, sig[i], sig[i + 1], v=v_look)
                continue
        latent = provisional
    return latent


# ---------------------------------------------------------------------------
# the 14B CFG segment samplers: history re-noised every step
# ---------------------------------------------------------------------------


class _Renoise:
    """The 14B segment's frame layout (reference fastvideo/sample/
    sample.py:769-790): the history prefix of ``latent`` is the clean
    conditioning latent, re-noised at each step's σ as
    σ·noise + (1 − σ)·clean; the tail starts from ``noise``. Scalars are
    fp32, as the reference's ladder."""

    def __init__(self, latent, noise, latent_frame_zero):
        self.lfz = latent_frame_zero
        self.b, self.f = latent.shape[:2]
        self.f_hist = self.f - latent_frame_zero
        self.clean = latent[:, :self.f_hist]
        self.noise_hist = noise[:, :self.f_hist]
        self.noise_tail = noise[:, self.f_hist:]

    def hist(self, s):
        s = np.float32(s)
        return float(s) * self.noise_hist + float(np.float32(1.0) - s) * self.clean

    def start(self, s0):
        """The first state: history at σ_0, the tail pure noise."""
        return torch.cat([self.hist(s0), self.noise_tail], dim=1)

    def t_frame(self, s_i, device):
        """Every frame at σ_i·1000 (the 14B loop feeds one timestep)."""
        return torch.full((self.b, self.f), float(np.float32(s_i) * np.float32(1000.0)),
                          dtype=torch.float32, device=device)

    def step(self, latent, v, s_i, s_n):
        """The tail advanced by (σ_n − σ_i)·v, the history re-noised at σ_n."""
        dt = float(np.float32(s_n) - np.float32(s_i))
        tail = latent[:, -self.lfz:] + dt * v[:, -self.lfz:]
        return torch.cat([self.hist(s_n), tail], dim=1)


def _guide(v_c, v_u, guide_scale):
    return v_u + guide_scale * (v_c - v_u)


@torch.no_grad()
def cfg_euler_sample_segment(
    denoise_fn: CFGDenoiseFn,
    latent: torch.Tensor,
    noise: torch.Tensor,
    ctx: torch.Tensor,
    ctx_null: Optional[torch.Tensor],
    sigmas: np.ndarray,
    latent_frame_zero: int,
    guide_scale: float,
    batched_cfg: bool = False,
) -> torch.Tensor:
    """14B CFG Euler with history re-noising: per step a cond and an uncond
    forward, v = v_u + g·(v_c − v_u), the tail's Euler update and the
    history prefix re-noised at the next σ. ``latent``'s history frames are
    the clean conditioning latent; the tail starts from ``noise``.
    ``ctx_null=None`` is the distilled serving step: one cond-only forward
    (the guidance is in the weights). ``batched_cfg`` runs cond and uncond
    as one batch-2B forward on ``[latent; latent]`` with ``[ctx;
    ctx_null]`` (the reference's CFG parallelism; the model is
    batch-independent), split after it."""
    r = _Renoise(latent, noise, latent_frame_zero)
    sig = np.asarray(sigmas, np.float32)
    latent = r.start(sig[0])
    batched = batched_cfg and ctx_null is not None
    ctx2 = torch.cat([ctx, ctx_null]) if batched else None
    for i in range(len(sig) - 1):
        t_frame = r.t_frame(sig[i], latent.device)
        if batched:
            v2 = denoise_fn(torch.cat([latent, latent]), torch.cat([t_frame, t_frame]), ctx2)
            v = _guide(v2[:r.b], v2[r.b:], guide_scale)
        else:
            v = denoise_fn(latent, t_frame, ctx)
            if ctx_null is not None:
                v = _guide(v, denoise_fn(latent, t_frame, ctx_null), guide_scale)
        latent = r.step(latent, v, sig[i], sig[i + 1])
    return latent


@torch.no_grad()
def cfg_euler_sample_segment_cached(
    denoise_full,
    denoise_cached,
    latent: torch.Tensor,
    noise: torch.Tensor,
    ctx: torch.Tensor,
    ctx_null: torch.Tensor,
    sigmas: np.ndarray,
    latent_frame_zero: int,
    guide_scale: float,
    *,
    cache_interval: int = 2,
) -> torch.Tensor:
    """:func:`cfg_euler_sample_segment` with TeaCache block-residual reuse:
    every ``cache_interval``-th step runs the full DiT for both branches and
    stores each branch's residuals (the reference's ``cache`` and
    ``cache_uncond``); the steps between skip the cached blocks.
    ``denoise_full(latent, t, ctx) -> (v, cache)``,
    ``denoise_cached(latent, t, ctx, cache) -> v``."""
    r = _Renoise(latent, noise, latent_frame_zero)
    sig = np.asarray(sigmas, np.float32)
    latent = r.start(sig[0])
    cache_c = cache_u = None
    for i in range(len(sig) - 1):
        t_frame = r.t_frame(sig[i], latent.device)
        if cache_c is None or i % cache_interval == 0:
            v_c, cache_c = denoise_full(latent, t_frame, ctx)
            v_u, cache_u = denoise_full(latent, t_frame, ctx_null)
        else:
            v_c = denoise_cached(latent, t_frame, ctx, cache_c)
            v_u = denoise_cached(latent, t_frame, ctx_null, cache_u)
        latent = r.step(latent, _guide(v_c, v_u, guide_scale), sig[i], sig[i + 1])
    return latent


@torch.no_grad()
def cfg_euler_sample_segment_cached_adaptive(
    denoise_full,
    denoise_cached,
    latent: torch.Tensor,
    noise: torch.Tensor,
    ctx: torch.Tensor,
    ctx_null: torch.Tensor,
    sigmas: np.ndarray,
    latent_frame_zero: int,
    guide_scale: float,
    *,
    threshold: float = 0.15,
) -> Tuple[torch.Tensor, int]:
    """The CFG form of :func:`euler_sample_segment_cached_adaptive`: the
    cond and uncond caches refresh together when the accumulated rel-L1
    change of the tail latent (their shared input) reaches ``threshold``.
    Step 0 runs full. Returns ``(latent, n_full)``."""
    r = _Renoise(latent, noise, latent_frame_zero)
    sig = np.asarray(sigmas, np.float32)
    latent = r.start(sig[0])
    prev_tail = latent[:, -latent_frame_zero:]
    t_frame = r.t_frame(sig[0], latent.device)
    v_c, cache_c = denoise_full(latent, t_frame, ctx)
    v_u, cache_u = denoise_full(latent, t_frame, ctx_null)
    latent = r.step(latent, _guide(v_c, v_u, guide_scale), sig[0], sig[1])
    accum = torch.zeros((), dtype=torch.float32, device=latent.device)
    n_full = 1
    for i in range(1, len(sig) - 1):
        cur_tail = latent[:, -latent_frame_zero:]
        accum = accum + _rel_l1(cur_tail, prev_tail).float()
        t_frame = r.t_frame(sig[i], latent.device)
        if bool(accum >= threshold):  # one host read per step
            v_c, cache_c = denoise_full(latent, t_frame, ctx)
            v_u, cache_u = denoise_full(latent, t_frame, ctx_null)
            accum = torch.zeros_like(accum)
            n_full += 1
        else:
            v_c = denoise_cached(latent, t_frame, ctx, cache_c)
            v_u = denoise_cached(latent, t_frame, ctx_null, cache_u)
        latent = r.step(latent, _guide(v_c, v_u, guide_scale), sig[i], sig[i + 1])
        prev_tail = cur_tail
    return latent, n_full


@torch.no_grad()
def cfg_sde_euler_sample_segment(
    denoise_fn: CFGDenoiseFn,
    latent: torch.Tensor,
    noise: torch.Tensor,
    ctx: torch.Tensor,
    ctx_null: torch.Tensor,
    sigmas: np.ndarray,
    latent_frame_zero: int,
    guide_scale: float,
    noise_fn: NoiseFn,
    *,
    eta: float = 0.3,
) -> torch.Tensor:
    """:func:`cfg_euler_sample_segment` with the SDE churn after each tail
    update (reference fastvideo/sample/sample_tts.py:726-744),
    x ← x + η²·σ·score·Δt + η·√(2Δt·σ)·ε, ε one ``noise_fn`` draw a step."""
    r = _Renoise(latent, noise, latent_frame_zero)
    sig = np.asarray(sigmas, np.float32)
    latent = r.start(sig[0])
    lfz = latent_frame_zero
    for i in range(len(sig) - 1):
        t_frame = r.t_frame(sig[i], latent.device)
        v = _guide(denoise_fn(latent, t_frame, ctx), denoise_fn(latent, t_frame, ctx_null),
                   guide_scale)
        tail = _sde_tail(latent[:, -lfz:], v[:, -lfz:], sig[i], sig[i + 1], noise_fn, eta)
        latent = torch.cat([r.hist(sig[i + 1]), tail], dim=1)
    return latent


@torch.no_grad()
def cfg_time_travel_sample_segment(
    denoise_fn: CFGDenoiseFn,
    latent: torch.Tensor,
    noise: torch.Tensor,
    ctx: torch.Tensor,
    ctx_null: torch.Tensor,
    sigmas: np.ndarray,
    latent_frame_zero: int,
    guide_scale: float,
    *,
    interval: int = 2,
    travel_steps: int = 2,
    sde: bool = False,
    noise_fn: Optional[NoiseFn] = None,
    eta: float = 0.3,
) -> torch.Tensor:
    """The exact 14B TTS loop (reference fastvideo/sample/sample_tts.py:
    690-854): CFG Euler on the tail with the history re-noised each step,
    and every ``interval`` steps a lookahead rollout whose last velocity
    replaces step i's (splice-back). With ``sde`` the Euler–Maruyama churn
    (one ``noise_fn`` draw each) follows every tail update, outer and
    lookahead alike. As the reference: the history's σ index is capped at
    S − 1, so the prefix never reaches σ = 0; the lookahead's entry state
    re-noises the history at σ_{i+travel_steps} while the tail is at
    σ_{i+1}; the last outer step's churn has Δt = 0 (no noise) but keeps its
    mean shift. Where the lookahead is empty the provisional step stays
    (the reference would splice a stale velocity)."""
    lfz = latent_frame_zero
    r = _Renoise(latent, noise, latent_frame_zero)
    sig = np.asarray(sigmas, np.float32)
    n_steps = len(sig) - 1
    if sde and noise_fn is None:
        raise ValueError("sde churn needs a noise_fn")

    def hist_at(idx):
        return r.hist(sig[min(n_steps - 1, idx)])

    def cfg_v(lat, s_i):
        t_frame = r.t_frame(s_i, lat.device)
        return _guide(denoise_fn(lat, t_frame, ctx), denoise_fn(lat, t_frame, ctx_null),
                      guide_scale)

    def churn(tail_new, lat_tail, v_tail, s_i, s_n, final=False):
        # python-float scalars, each rounded to fp32 where it meets a tensor
        pred_x0 = lat_tail + (0.0 - s_i) * v_tail
        delta_t = 0.0 if final else max(s_i - s_n, 0.0)
        std = eta * float(np.sqrt(delta_t))
        score = -(lat_tail - pred_x0 * (1.0 - s_i)) / (s_i ** 2)
        mean = tail_new + (-0.5 * eta ** 2 * score) * (s_n - s_i)
        return mean + std * noise_fn(tuple(tail_new.shape)).to(tail_new)

    latent = torch.cat([hist_at(0), r.noise_tail], dim=1)
    for i in range(n_steps):
        s_i, s_n = float(sig[i]), float(sig[i + 1])
        v = cfg_v(latent, s_i)
        lat_tail = latent[:, -lfz:]
        temp_x0 = lat_tail + (s_n - s_i) * v[:, -lfz:]
        if sde:
            temp_x0 = churn(temp_x0, lat_tail, v[:, -lfz:], s_i, s_n,
                            final=i + 1 == n_steps)
        if interval > 0 and i % interval == 0:
            travel_stop = min(n_steps - 1, i + travel_steps)
            lat_tr = torch.cat([hist_at(travel_stop), temp_x0], dim=1)
            current = None
            for j in range(i + 1, travel_stop):
                sj, sjn = float(sig[j]), float(sig[j + 1])
                v_tr = cfg_v(lat_tr, sj)
                tr_tail = lat_tr[:, -lfz:]
                x0_tr = tr_tail + (sjn - sj) * v_tr[:, -lfz:]
                if sde:
                    x0_tr = churn(x0_tr, tr_tail, v_tr[:, -lfz:], sj, sjn)
                lat_tr = torch.cat([hist_at(j + 1), x0_tr], dim=1)
                current = v_tr
            if current is not None:
                temp_x0 = lat_tail + (s_n - s_i) * current[:, -lfz:]
        latent = torch.cat([hist_at(i + 1), temp_x0], dim=1)
    return latent
