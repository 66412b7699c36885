"""Flash attention with gradients: wrappers of the CUDA kernels K1 (forward,
``csrc/flash_attention.cu``), K7 (the partial attention of ring attention,
the same kernel), K8 (dQ) and K9 (dK, dV) (``csrc/flash_attention_bwd.cu``),
and their plain PyTorch versions.

Replaces yume_tpu/ops/flash_attention.py: ``_fwd_kernel`` (via ``_fwd`` and
``flash_attention``), ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (via
``_bwd_impl``), the ``_flash`` custom VJP that ties them together
(:class:`FlashAttention`), and ``flash_attention_partial`` with its
``_flash_partial`` custom VJP (:class:`FlashAttentionPartial`). On the
H100 the kernels are bound by tensor-core FLOPs at the DiT shapes
(self-attention over 2,805 to 12,095 tokens, 24 heads, D = 128: 1.8e12
FLOP a 5B layer's forward). The forward is built for Hopper: TMA loads of
q, k and v through their [B, L, N, D] strides into a ring of swizzled
shared-memory tiles, a producer warpgroup and two consumer warpgroups,
Q·Kᵀ and P·V as ``wgmma`` with S, P and the fp32 output accumulator in
registers, and the online softmax on the registers. The backward is two
kernels of the same design without atomics (K8 holds 128 q rows and
streams K/V, K9 holds 128 kv rows and streams Q/dO), with the scores, their
gradients and the accumulators in registers. The designs are described in
their sources.

K7 is K1's kernel launched for one kv block of ring attention: it returns
the block-normalized output with its fp32 logsumexp, so that blocks held
on other devices merge exactly (``parallel/ulysses.py``). It keeps its own
launch count. A row with no live key (``kv_len`` <= 0, a ring hop over pad
tokens only) gets output 0 and lse ``MASKED_LSE``, which any merge weighs
to zero. Bound on the H100 like K1: tensor-core FLOPs (a ring hop at sp = 4
is 1.1e11 FLOP against 75 MB of q/k/v/out).

On CPU tensors :func:`flash_attention` runs :func:`plain_attention`, which
autograd differentiates, :func:`flash_attention_partial` runs
:func:`plain_attention_partial`, and the backward wrappers run
:func:`plain_attention_bwd`. On CUDA tensors each wrapper launches its
kernel or raises. When a gradient is needed the forward goes through
:class:`FlashAttention` (CUDA tensors) or :class:`FlashAttentionPartial`
(on both devices), whose backward runs K8 and K9 or their plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_SUPPORTED_HEAD_DIMS = (16, 64, 128)
# lse of a row with no live key: the kernel's -0.7f·FLT_MAX
# (csrc/flash_attention.cu) in fp32, as the TPU kernel's; far below any
# real lse and still finite
MASKED_LSE = (torch.tensor(-0.7, dtype=torch.float32) * torch.finfo(torch.float32).max).item()


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
        s = s.masked_fill(~_key_mask(kv_len, k)[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def plain_attention_partial(q, k, v, *, kv_len=None, scale=None):
    """K7's plain version: attention of q [B, Lq, N, D] over one kv block,
    in fp32, as (out [B, Lq, N, D] in q's dtype, lse [B, N, Lq] fp32). A
    row with no live key gets output 0 and lse ``MASKED_LSE`` (as the
    kernel; the reference's blocked twin returns the mean of v there).
    Differentiable without NaNs, empty rows included."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if kv_len is not None:
        s = s.masked_fill(~_key_mask(kv_len, k)[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m)).detach()
    p = torch.exp(s - m)                    # 0 at masked keys
    l = p.sum(dim=-1)                       # [B, N, Lq]: >= 1, or 0 for an empty row
    live = l > 0
    l_safe = torch.where(live, l, torch.ones_like(l))
    out = torch.einsum("bnqk,bknd->bqnd", p, v.float()) / l_safe.transpose(1, 2)[..., None]
    lse = torch.where(live, m[..., 0] + torch.log(l_safe), torch.full_like(l, MASKED_LSE))
    return out.to(q.dtype), lse


def _key_mask(kv_len, k):
    """[B, Lk] bool: key j of batch b is live (j < kv_len[b])."""
    col = torch.arange(k.shape[1], device=k.device)
    return col[None, :] < kv_len.to(k.device)[:, None]


def attention_delta(out, dout):
    """delta = Σ_d out·dout in fp32, as [B, N, Lq] (the flash backward's
    row term; the reference's ``_bwd`` computes it the same way)."""
    return torch.einsum("bqnd,bqnd->bnq", out.float(), dout.float()).contiguous()


def plain_attention_bwd(q, k, v, out, lse, dout, *, kv_len=None, scale=None,
                        delta=None):
    """The flash backward in fp32 from the forward's lse: returns (dq, dk,
    dv) in the dtypes of q, k and v. ``delta`` [B, N, Lq] defaults to
    Σ_d out·dout; a caller that folds an lse cotangent into it (the
    partial-attention VJP) passes its own and may give ``out=None``.

        p  = exp(s·scale − lse), 0 at masked keys
        dv = pᵀ·do,  dp = do·vᵀ,  ds = p∘(dp − delta)·scale
        dq = ds·k,   dk = dsᵀ·q
    """
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    if delta is None:
        delta = attention_delta(out, dout)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bqnd,bknd->bnqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    if kv_len is not None:
        p = p.masked_fill(~_key_mask(kv_len, k)[:, None, None, :], 0.0)
    dv = torch.einsum("bnqk,bqnd->bknd", p, dof)
    dp = torch.einsum("bqnd,bknd->bnqk", dof, vf)
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = torch.einsum("bnqk,bknd->bqnd", ds, kf)
    dk = torch.einsum("bnqk,bqnd->bknd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bf16(name, t, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"flash_attention: {name} must be on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bf16, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be [B, L, N, D]")
    if not _strides_ok(t):
        raise ValueError(
            f"flash_attention: {name} needs unit stride in D, strides "
            f"that are multiples of 8 and a 16-byte aligned base")


def _strides_ok(t) -> bool:
    return (t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bf16(name, t, q.device)
    b, _, n, d = q.shape
    if k.shape[0] != b or k.shape[2:] != q.shape[2:] or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_SUPPORTED_HEAD_DIMS}")
    if b * n > 65535:
        raise ValueError("flash_attention: B*N exceeds the grid's y limit")


def _kv_len_arg(kv_len, b, device):
    if kv_len is None:
        return None
    kv_len = kv_len.to(device=device, dtype=torch.int32).contiguous()
    if kv_len.shape != (b,):
        raise ValueError(f"flash_attention: kv_len must be [{b}]")
    return kv_len


def _fwd(q, k, v, kv_len, scale, counter):
    """Launch the forward kernel as K1 or K7 (``counter``, the wrapper
    whose launch count it adds to): (out, lse)."""
    from .. import _build

    _check(q, k, v)
    if not scale > 0:
        raise ValueError(f"flash_attention: the kernel takes a positive scale, got {scale}")
    b, lq, n, d = q.shape
    lk = k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, n, lq), dtype=torch.float32, device=q.device)
    kv_len = _kv_len_arg(kv_len, b, q.device)
    if lq == 0:
        return out, lse
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.yume_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), kv_len.data_ptr() if kv_len is not None else None,
            b, lq, lk, n, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], ctypes.c_float(scale), stream)
    _build.check(err, counter.__name__)
    counter.launches += 1
    return out, lse


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class FlashAttention(torch.autograd.Function):
    """Attention on the card with a gradient: the forward launches K1 and
    keeps q, k, v, out, lse and kv_len; the backward computes delta and
    launches K8 and K9 (the reference's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, scale):
        out, lse = _fwd(q, k, v, kv_len, scale, flash_attention)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kv_len, ctx.scale = kv_len, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         kv_len=ctx.kv_len, scale=ctx.scale)
        return dq, dk, dv, None, None


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
    [B] true key lengths; ``scale`` defaults to D**-0.5. Differentiable on
    both devices; the lse output is not: a caller that needs its gradient
    uses :func:`flash_attention_partial`."""
    if not q.is_cuda:
        return plain_attention(q, k, v, kv_len=kv_len, scale=scale,
                               return_lse=return_lse)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        if return_lse:
            raise ValueError(
                "flash_attention: the lse output has no gradient here; use "
                "flash_attention_partial (K7), whose VJP takes it")
        return FlashAttention.apply(q, k, v, kv_len, scale)
    out, lse = _fwd(q, k, v, kv_len, scale, flash_attention)
    return (out, lse) if return_lse else out


class FlashAttentionPartial(torch.autograd.Function):
    """K7 with a gradient for both outputs (the reference's
    ``_flash_partial`` custom VJP). The lse cotangent folds into the flash
    backward's row term,

        ds = p∘(dp − (Σ_d out·dout − dlse))·scale,

    so the backward is :func:`flash_attention_bwd` with
    ``delta = attention_delta(out, dout) − dlse``: K8 and K9 on the card.
    A missing cotangent counts as zero. On CPU tensors the forward is
    :func:`plain_attention_partial` (without a graph) and the backward
    :func:`plain_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, scale):
        if q.is_cuda:
            out, lse = _fwd(q, k, v, kv_len, scale, flash_attention_partial)
        else:
            out, lse = plain_attention_partial(q, k, v, kv_len=kv_len, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kv_len, ctx.scale = kv_len, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        delta = attention_delta(out, dout)
        if dlse is not None:
            delta = (delta - dlse.float()).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, kv_len=ctx.kv_len,
                                         scale=ctx.scale, delta=delta)
        return dq, dk, dv, None, None


def flash_attention_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """Partial attention of q [B, Lq, N, D] over one kv block k/v
    [B, Lk, N, D] (K7): returns the block-normalized output [B, Lq, N, D]
    in q's dtype and its logsumexp [B, N, Lq] in fp32, for merging across
    kv blocks held on other devices (ring attention). ``kv_len``: optional
    [B] live keys of the block (0 or less: the row's output is 0 and its
    lse ``MASKED_LSE``). Differentiable through both outputs, on either
    device through :class:`FlashAttentionPartial`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return FlashAttentionPartial.apply(q, k, v, kv_len, scale)
    if not q.is_cuda:
        return plain_attention_partial(q, k, v, kv_len=kv_len, scale=scale)
    return _fwd(q, k, v, kv_len, scale, flash_attention_partial)


def _check_bwd(q, k, v, dout, lse, delta):
    _check(q, k, v)
    _check_bf16("dout", dout, q.device)
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention: dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    b, lq, n, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.device != q.device or t.dtype != torch.float32
                or t.shape != (b, n, lq) or not t.is_contiguous()):
            raise ValueError(f"flash_attention: {name} must be a contiguous fp32 "
                             f"[{b}, {n}, {lq}] tensor on {q.device}")


def _dout_arg(dout):
    """dout is read through its strides; one that breaks the kernel's
    alignment rules (a broadcast or odd-strided gradient) is made
    contiguous once."""
    return dout if dout.dim() == 4 and _strides_ok(dout) else dout.contiguous()


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, kv_len=None, scale=None):
    """dQ of attention (K8) from the forward's lse [B, N, Lq] and delta
    [B, N, Lq] (see :func:`plain_attention_bwd`)."""
    if not q.is_cuda:
        return plain_attention_bwd(q, k, v, None, lse, dout, kv_len=kv_len,
                                   scale=scale, delta=delta)[0]
    from .. import _build

    dout = _dout_arg(dout)
    _check_bwd(q, k, v, dout, lse, delta)
    b, lq, n, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    kv_len = _kv_len_arg(kv_len, b, q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if lq == 0:
        return dq
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.yume_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None, dq.data_ptr(),
            b, lq, k.shape[1], n, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], *dq.stride()[:3], ctypes.c_float(scale), stream)
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, kv_len=None, scale=None):
    """(dK, dV) of attention (K9); arguments as :func:`flash_attention_bwd_dq`."""
    if not q.is_cuda:
        return plain_attention_bwd(q, k, v, None, lse, dout, kv_len=kv_len,
                                   scale=scale, delta=delta)[1:]
    from .. import _build

    dout = _dout_arg(dout)
    _check_bwd(q, k, v, dout, lse, delta)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    kv_len = _kv_len_arg(kv_len, b, q.device)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if lk == 0:
        return dk, dv
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.yume_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            kv_len.data_ptr() if kv_len is not None else None,
            dk.data_ptr(), dv.data_ptr(), b, lq, lk, n, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            ctypes.c_float(scale), stream)
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, kv_len=None, scale=None,
                        delta=None):
    """(dq, dk, dv) of attention: delta (default Σ_d out·dout), then K8 and
    K9 on the card, :func:`plain_attention_bwd` on the CPU. ``delta`` is an
    argument, as in the reference's ``_bwd_impl``, so a VJP that folds an
    lse cotangent into it can reuse the kernels."""
    if delta is None:
        delta = attention_delta(out, dout)
    if not q.is_cuda:
        return plain_attention_bwd(q, k, v, out, lse, dout, kv_len=kv_len,
                                   scale=scale, delta=delta)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_len=kv_len, scale=scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_len=kv_len,
                                     scale=scale)
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_partial.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
