"""Attention dispatch (counterpart of yume_tpu/ops/attention.py).

``attention`` sends a CUDA tensor to the hand-written flash kernel and a CPU
tensor to :func:`plain_attention`, the fp32 oracle that mirrors the
reference's ``xla_attention`` (both live in :mod:`.flash_attention`, beside
the kernel wrapper they back).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, plain_attention

__all__ = ["attention", "plain_attention"]


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention over [B, L, N, D]: the flash kernel K1 on CUDA
    tensors, :func:`plain_attention` on CPU tensors."""
    return flash_attention(q, k, v, kv_len=kv_len, scale=scale)
