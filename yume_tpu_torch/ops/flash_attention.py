"""Flash-attention forward: wrapper of the CUDA kernel K1
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Replaces yume_tpu/ops/flash_attention.py::_fwd_kernel (via ``_fwd`` and
``flash_attention``). On the H100 the kernel is bound by tensor-core FLOPs
at the DiT shapes (self-attention over 12,095 tokens, 24 heads, D = 128);
its design (wmma bf16 tiles, fp32 online softmax, strided [B, L, N, D]
reads, in-kernel ragged edges) is described in the source.

On a CPU tensor :func:`flash_attention` runs :func:`plain_attention`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_SUPPORTED_HEAD_DIMS = (64, 128)


def plain_attention(q, k, v, *, kv_len=None, scale=None, return_lse=False):
    """Dense attention with an fp32 softmax over [B, L, N, D] (the
    reference's ``xla_attention``). Keys at positions >= kv_len[b] are
    masked with -inf. ``return_lse`` also returns the fp32 logsumexp of the
    scaled scores as [B, N, Lq]."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    s = s * scale
    if kv_len is not None:
        col = torch.arange(k.shape[1], device=k.device)
        mask = col[None, :] < kv_len.to(k.device)[:, None]  # [B, Lk]
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} must be bf16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, L, N, D]")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} needs unit stride in D, strides "
                f"that are multiples of 8 and a 16-byte aligned base")
    b, _, n, d = q.shape
    if k.shape[0] != b or k.shape[2:] != q.shape[2:] or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_SUPPORTED_HEAD_DIMS}")
    if b * n > 65535:
        raise ValueError("flash_attention: B*N exceeds the grid's y limit")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Attention over q [B, Lq, N, D], k/v [B, Lk, N, D] → [B, Lq, N, D]
    (and the fp32 lse [B, N, Lq] with ``return_lse``). ``kv_len``: optional
    [B] true key lengths; ``scale`` defaults to D**-0.5."""
    if not q.is_cuda:
        return plain_attention(q, k, v, kv_len=kv_len, scale=scale,
                               return_lse=return_lse)
    from .. import _build

    _check(q, k, v)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_len.shape != (b,):
            raise ValueError(f"flash_attention: kv_len must be [{b}]")
    if lq == 0:
        return (out, lse) if return_lse else out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.yume_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), kv_len.data_ptr() if kv_len is not None else None,
            b, lq, lk, n, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], ctypes.c_float(scale), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
