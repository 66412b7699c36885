"""ODE integrators for flow sampling (counterpart of
yume_tpu/diffusion/integrators.py): fixed-step Euler, Heun and midpoint, and
adaptive Dormand–Prince 5(4) (dopri5), the reference Sampler's ODE methods
(hyvideo/diffusion/flow/transport.py:346-374).

dopri5 keeps the reference's arithmetic: the time and the step are tensors
of the state's dtype, a rejected step keeps the state and shrinks the step
by the controller's factor, and the loop ends at t1 or after
``max_steps`` tries. Its loop test reads the time on the host once a step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# Dormand–Prince 5(4) Butcher tableau
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DP_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
                   187 / 2100, 1 / 40])


def _fixed_step(fn, x, t0: float, t1: float, steps: int, method: str):
    ts = torch.linspace(t0, t1, steps + 1, dtype=torch.float32, device=x.device)

    def euler(x, t, tn):
        return x + (tn - t) * fn(x, t)

    def heun(x, t, tn):
        h = tn - t
        k1 = fn(x, t)
        k2 = fn(x + h * k1, tn)
        return x + 0.5 * h * (k1 + k2)

    def midpoint(x, t, tn):
        h = tn - t
        k1 = fn(x, t)
        k2 = fn(x + 0.5 * h * k1, t + 0.5 * h)
        return x + h * k2

    step = {"euler": euler, "heun2": heun, "midpoint": midpoint}[method]
    for i in range(steps):
        x = step(x, ts[i], ts[i + 1])
    return x


def _dopri5(fn, x0, t0: float, t1: float, rtol: float, atol: float, max_steps: int):
    direction = 1.0 if t1 >= t0 else -1.0
    h0 = direction * abs(t1 - t0) / 50.0

    def rk_step(x, t, h):
        ks = []
        for i in range(7):
            xi = x
            for j, a in enumerate(_DP_A[i]):
                xi = xi + h * a * ks[j]
            ks.append(fn(xi, t + float(_DP_C[i]) * h))
        x5, x4 = x, x
        for i in range(7):
            x5 = x5 + h * float(_DP_B5[i]) * ks[i]
            x4 = x4 + h * float(_DP_B4[i]) * ks[i]
        return x5, x5 - x4

    x = x0
    t = torch.tensor(t0, dtype=x0.dtype, device=x0.device)
    h = torch.tensor(h0, dtype=x0.dtype, device=x0.device)
    n = 0
    while n < max_steps and bool(direction * (t1 - t) > 1e-8):
        # clamp the step to not overshoot t1
        h = direction * torch.minimum(h.abs(), (t1 - t).abs())
        x_new, e = rk_step(x, t, h)
        scale = atol + rtol * torch.maximum(x.abs(), x_new.abs())
        en = torch.sqrt(torch.mean((e / scale) ** 2))
        accept = en <= 1.0
        # the order-5 controller with a safety factor
        h_next = h * torch.clamp(0.9 * en ** (-0.2), 0.2, 5.0)
        x = torch.where(accept, x_new, x)
        t = torch.where(accept, t + h, t)
        h = h_next
        n += 1
    return x


def odeint(fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], x0: torch.Tensor,
           t0: float = 1.0, t1: float = 0.0, *, method: str = "dopri5", steps: int = 50,
           rtol: float = 1e-5, atol: float = 1e-5, max_steps: int = 1000) -> torch.Tensor:
    """Integrate dx/dt = fn(x, t) from t0 to t1 (t a 0-d tensor).

    method: 'euler' | 'heun2' | 'midpoint' (``steps`` fixed steps) or
    'dopri5' (adaptive, embedded 5(4) error control with ``rtol``/``atol``,
    at most ``max_steps`` tries)."""
    if method == "dopri5":
        return _dopri5(fn, x0, float(t0), float(t1), rtol, atol, max_steps)
    return _fixed_step(fn, x0, float(t0), float(t1), steps, method)


def ode_sample(velocity_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               noise: torch.Tensor, *, method: str = "dopri5", steps: int = 50,
               rtol: float = 1e-5, atol: float = 1e-5) -> torch.Tensor:
    """Sample by integrating the reverse flow from σ = 1 (noise) to σ = 0:
    ``velocity_fn(x, sigma [B])`` is the flow-matching model's output, and
    on the reverse linear path dx/dσ = v (reference Sampler.sample_ode,
    transport.py:346-374)."""
    b = noise.shape[0]

    def fn(x, t):
        return velocity_fn(x, t.to(noise.dtype).expand(b))

    return odeint(fn, noise, 1.0, 0.0, method=method, steps=steps, rtol=rtol, atol=atol)
