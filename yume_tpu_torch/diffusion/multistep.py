"""Multistep flow-matching solvers: DPM-Solver++(2M) and UniPC (bh2)
(counterpart of yume_tpu/diffusion/multistep.py).

Equivalents of the reference's diffusers-derived schedulers
(``FlowDPMSolverMultistepScheduler``, wan/utils/fm_solvers.py;
``FlowUniPCMultistepScheduler``, wan/utils/fm_solvers_unipc.py), as Python
loops over the sigma ladder with one model call a step.

Math: with x_σ = (1−σ)·x1 + σ·x0 (x1 data, x0 noise) and velocity
v = x0 − x1, the data prediction is x1_hat = x − σ·v and the half-log-SNR
is λ(σ) = log(1−σ) − log(σ). DPM-Solver++ in data-prediction form:

    x_{σ_next} = (σ_next/σ)·x − α_next·expm1(−h)·D,   h = λ_next − λ,

where α = 1−σ and D is the (extrapolated) data prediction: first order
D = x1_hat_i; second order D = x1_hat_i + (1/(2 r)) (x1_hat_i − x1_hat_{i−1})
with r = h_{i−1}/h_i. UniPC's bh2 corrector additionally reuses the new
model output at σ_next to correct the step (predictor–corrector).

Precision as the reference: the step's scalars (λ, h, the ratios) in fp32,
the UniPC B(h) coefficients solved in float64 numpy from the static ladder
and applied in fp32, the latent updated in its own dtype (fp32 from the
pipeline).

Single-model form only: the dual-expert and phase-split arguments of the
reference (``denoise_fn_low``, ``boundary``, ``step_range``,
``init_carry``, ``return_carry``) belong to the 14B path and are refused.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

# (latent, sigma [B] fp32) -> velocity
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _refuse_dual_expert(**kw):
    given = sorted(k for k, v in kw.items() if v not in (None, False))
    if given:
        raise NotImplementedError(
            f"not ported yet: {', '.join(given)} (dual-expert and phase-split "
            "sampling belong to the 14B path, ROADMAP queue 1, item 6)")


def _lam(sigma) -> np.float32:
    """λ(σ) in fp32, σ clipped to [1e-6, 1 − 1e-6]."""
    sigma = np.clip(np.float32(sigma), np.float32(1e-6), np.float32(1 - 1e-6))
    return np.log(np.float32(1.0) - sigma) - np.log(sigma)


class MultistepCarry(NamedTuple):
    x: torch.Tensor
    prev_x0: torch.Tensor    # previous data prediction
    have_prev: bool


def _data_pred(x, v, sigma):
    return x - float(sigma) * v


def dpm_solver_step(x, x0_pred, prev_x0, have_prev: bool, sigma, sigma_next, sigma_prev):
    """One DPM-Solver++(2M) update in data-prediction space (σ's fp32)."""
    sigma, sigma_next = np.float32(sigma), np.float32(sigma_next)
    lam, lam_n = _lam(sigma), _lam(sigma_next)
    h = lam_n - lam
    if have_prev:
        r = (lam - _lam(sigma_prev)) / h
        d = x0_pred + (x0_pred - prev_x0) / float(np.float32(2.0) * r)
    else:
        d = x0_pred
    if sigma_next <= 1e-6:
        return d  # terminal step: the clean prediction
    alpha_n = np.float32(1.0) - sigma_next
    ratio = sigma_next / sigma if sigma > 0 else np.float32(0.0)
    return float(ratio) * x + float(alpha_n * (-np.expm1(-h))) * d


@torch.no_grad()
def sample_dpmpp_2m(
    denoise_fn: ModelFn,
    noise: torch.Tensor,
    sigmas: np.ndarray,
    *,
    denoise_fn_low=None,
    boundary=None,
    step_range=None,
    init_carry=None,
    return_carry: bool = False,
) -> torch.Tensor:
    """Full DPM-Solver++(2M) trajectory over a descending sigma ladder
    (last entry 0). ``denoise_fn(x, sigma[B]) -> velocity``."""
    _refuse_dual_expert(denoise_fn_low=denoise_fn_low, boundary=boundary,
                        step_range=step_range, init_carry=init_carry,
                        return_carry=return_carry)
    b = noise.shape[0]
    sig = np.asarray(sigmas, np.float32)
    prev = np.concatenate([sig[:1], sig[:-2]])
    carry = MultistepCarry(noise, torch.zeros_like(noise), False)
    for i in range(len(sig) - 1):
        sigma = torch.full((b,), float(sig[i]), dtype=torch.float32, device=noise.device)
        v = denoise_fn(carry.x, sigma)
        x0 = _data_pred(carry.x, v, sig[i])
        x_next = dpm_solver_step(carry.x, x0, carry.prev_x0, carry.have_prev,
                                 sig[i], sig[i + 1], prev[i])
        carry = MultistepCarry(x_next, x0, True)
    return carry.x


def _np_lam(s: float) -> float:
    with np.errstate(divide="ignore"):
        return float(np.log(1.0 - s) - np.log(s))


def _unipc_coeffs(s0: float, st: float, hist_sigmas, order: int):
    """B(h)-series coefficients for one UniP/UniC update (bh2), float64
    numpy. Mirrors fm_solvers_unipc.py:416-452/575-599 with predict_x0=True."""
    h = _np_lam(st) - _np_lam(s0)
    hh = -h
    h_phi_1 = np.expm1(hh)
    B_h = h_phi_1  # bh2
    rks = [(_np_lam(si) - _np_lam(s0)) / h for si in hist_sigmas] + [1.0]
    rks = np.asarray(rks, np.float64)
    R, b = [], []
    h_phi_k = h_phi_1 / hh - 1.0
    fact = 1.0
    for i in range(1, order + 1):
        R.append(np.power(rks, i - 1))
        b.append(h_phi_k * fact / B_h)
        fact *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    return float(h_phi_1), float(B_h), rks, np.stack(R), np.asarray(b)


def _unipc_tables(sig, order):
    """Per-step coefficient tables of the UniP/UniC recurrence (float64),
    from the static ladder: the corrector from the second step, order
    warm-up and lower-order-final. Unused history slots hold zero
    coefficients."""
    n_steps = len(sig) - 1
    K = max(order - 1, 1)
    tab = {k: np.zeros(n_steps) for k in
           ("s0", "c_ratio", "c_ah", "c_last", "p_ratio", "p_ah")}
    tab["c_hist"] = np.zeros((n_steps, K))
    tab["p_hist"] = np.zeros((n_steps, K))
    out_sigmas: list = []
    prev_order = 0
    lower_order_nums = 0
    for i in range(n_steps):
        s0, st_next = sig[i], sig[i + 1]
        tab["s0"][i] = s0
        if i > 0:
            oc = prev_order
            ss0 = sig[i - 1]
            hist = [out_sigmas[-(j + 1)] for j in range(1, oc)]
            h_phi_1, B_h, rks, R, bvec = _unipc_coeffs(ss0, s0, hist, oc)
            rhos_c = np.asarray([0.5]) if oc == 1 else np.linalg.solve(R, bvec)
            alpha_t = 1.0 - s0
            tab["c_ratio"][i] = s0 / ss0
            tab["c_ah"][i] = alpha_t * h_phi_1
            for j in range(1, oc):
                tab["c_hist"][i, j - 1] = alpha_t * B_h * float(rhos_c[j - 1]) / float(rks[j - 1])
            tab["c_last"][i] = alpha_t * B_h * float(rhos_c[-1])
        out_sigmas.append(s0)
        if len(out_sigmas) > order:
            out_sigmas.pop(0)
        this_order = min(order, n_steps - i, lower_order_nums + 1)
        hist = [out_sigmas[-(j + 1)] for j in range(1, this_order)]
        h_phi_1, B_h, rks, R, bvec = _unipc_coeffs(s0, st_next, hist, this_order)
        alpha_t = 1.0 - st_next
        tab["p_ratio"][i] = st_next / s0
        tab["p_ah"][i] = alpha_t * h_phi_1
        if this_order > 1:
            rhos_p = (np.asarray([0.5]) if this_order == 2
                      else np.linalg.solve(R[:-1, :-1], bvec[:-1]))
            for j in range(1, this_order):
                tab["p_hist"][i, j - 1] = (alpha_t * B_h * float(rhos_p[j - 1])
                                           / float(rks[j - 1]))
        lower_order_nums = min(lower_order_nums + 1, order)
        prev_order = this_order
    return tab


@torch.no_grad()
def sample_unipc(
    denoise_fn: ModelFn,
    noise: torch.Tensor,
    sigmas: np.ndarray,
    *,
    order: int = 2,
    denoise_fn_low=None,
    boundary=None,
    step_range=None,
    init_carry=None,
    return_carry: bool = False,
) -> torch.Tensor:
    """UniPC multistep sampling (bh2) at any order with the UniC corrector,
    as the reference FlowUniPCMultistepScheduler at the pipeline's settings
    (wan/utils/fm_solvers_unipc.py:350-739, predict_x0=True,
    prediction_type='flow_prediction', lower_order_final): one model call a
    sigma; each new model output first corrects the previous predictor step
    (UniC-p), then predicts the next sample (UniP-p), with order warm-up and
    lower-order-final.

    ``denoise_fn(x, sigma[B]) -> velocity``; ``sigmas`` descending, last
    entry 0 (the terminal step lands on the data prediction)."""
    _refuse_dual_expert(denoise_fn_low=denoise_fn_low, boundary=boundary,
                        step_range=step_range, init_carry=init_carry,
                        return_carry=return_carry)
    sig = [float(s) for s in np.asarray(sigmas, np.float64)]
    tab = _unipc_tables(sig, order)
    # applied in fp32, as the reference's scan reads them; the history
    # coefficients go to the latent's device once, the scalars stay on the host
    scal = {k: v.astype(np.float32) for k, v in tab.items() if v.ndim == 1}
    c_hist, p_hist = (torch.from_numpy(tab[k].astype(np.float32)).to(noise.device)
                      for k in ("c_hist", "p_hist"))
    b = noise.shape[0]
    K = c_hist.shape[1]

    def weighted(coeffs, diffs):  # Σ_k c_k · diffs[k]
        return torch.einsum("k,k...->...", coeffs, diffs)

    # hist[0] is the most recent data prediction; unused slots hold zeros
    # and meet zero coefficients
    x = noise
    last_sample = torch.zeros_like(noise)
    hist = torch.zeros((max(order, 2),) + tuple(noise.shape), dtype=noise.dtype,
                       device=noise.device)
    for i in range(len(sig) - 1):
        s0 = float(scal["s0"][i])
        v = denoise_fn(x, torch.full((b,), s0, dtype=noise.dtype, device=noise.device))
        m = x - s0 * v  # flow velocity → data prediction
        if i > 0:
            # UniC: correct the previous predictor step with the new m (the
            # stored prediction stays the uncorrected one, as the reference)
            m0 = hist[0]
            corr = weighted(c_hist[i], hist[1:1 + K] - m0[None])
            x = (float(scal["c_ratio"][i]) * last_sample - float(scal["c_ah"][i]) * m0
                 - (corr + float(scal["c_last"][i]) * (m - m0)))
        hist = torch.cat([m[None], hist[:-1]])
        last_sample = x
        pred = weighted(p_hist[i], hist[1:1 + K] - m[None])
        x = float(scal["p_ratio"][i]) * x - float(scal["p_ah"][i]) * m - pred
    return x
