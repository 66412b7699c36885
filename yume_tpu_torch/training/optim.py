"""8-bit-state Adam: blockwise-quantized moments (counterpart of
yume_tpu/training/optim.py).

The moments m and v of each parameter are kept as int8 codes with one fp32
scale per 256-element block of the parameter's flattened (padded) elements:
m symmetric linear, v as codes 0..127 of sqrt(v). An update dequantizes,
runs the fp32 Adam moment math, and requantizes, one parameter at a time
and in place. The arithmetic follows the reference's order, so on the same
gradients in the same layout the codes and scales agree with it.
"""

from __future__ import annotations

from typing import Dict

import torch

BLOCK = 256


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def _quantize_signed(x: torch.Tensor):
    """fp32 [N] → (int8 codes [N], fp32 scales [N/BLOCK]); symmetric linear."""
    xb = x.reshape(-1, BLOCK)
    scale = xb.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xb / safe[:, None]), -127, 127).to(torch.int8)
    return q.reshape(-1), scale


def _dequantize_signed(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.reshape(-1, BLOCK).float() * scale[:, None]).reshape(-1)


def _quantize_sqrt(x: torch.Tensor):
    """Non-negative fp32 [N] → int8 codes of sqrt(x) (linear in sqrt-space)."""
    r = torch.sqrt(torch.clamp(x, min=0.0)).reshape(-1, BLOCK)
    scale = r.amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(r / safe[:, None]), 0, 127).to(torch.int8)
    return q.reshape(-1), scale


def _dequantize_sqrt(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r = q.reshape(-1, BLOCK).float() * scale[:, None]
    return (r * r).reshape(-1)


def init_leaf(p: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero int8 moments and scales for one parameter."""
    n = _pad_len(p.numel())
    zq = lambda: torch.zeros((n,), dtype=torch.int8, device=p.device)  # noqa: E731
    zs = lambda: torch.zeros((n // BLOCK,), dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m_q": zq(), "m_scale": zs(), "v_q": zq(), "v_scale": zs()}


def adam8bit_update_(g: torch.Tensor, leaf: Dict[str, torch.Tensor], bc1: torch.Tensor,
                     bc2: torch.Tensor, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8) -> torch.Tensor:
    """The Adam direction m̂ / (sqrt(v̂) + eps) for gradient ``g`` (in g's
    dtype and shape); ``leaf``'s codes and scales are updated in place.
    ``bc1``, ``bc2``: the bias corrections 1 − b1**count and 1 − b2**count
    of the update's 1-based step, fp32 on g's device."""
    n = leaf["m_q"].numel()
    gf = torch.nn.functional.pad(g.reshape(-1).float(), (0, n - g.numel()))
    m = _dequantize_signed(leaf["m_q"], leaf["m_scale"])
    v = _dequantize_sqrt(leaf["v_q"], leaf["v_scale"])
    m = b1 * m + (1.0 - b1) * gf
    v = b2 * v + (1.0 - b2) * gf * gf
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    for key, (q, s) in (("m", _quantize_signed(m)), ("v", _quantize_sqrt(v))):
        leaf[f"{key}_q"].copy_(q)
        leaf[f"{key}_scale"].copy_(s)
    return upd[: g.numel()].reshape(g.shape).to(g.dtype)
