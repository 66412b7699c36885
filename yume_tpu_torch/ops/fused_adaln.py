"""Fused elementwise "glue" of the DiT block: kernels K2-K5 and their plain
PyTorch versions (counterpart of yume_tpu/ops/fused_adaln.py).

* :func:`adaln_norm`     — ``LN(x)·(gate + scale_tab[idx]) + shift_tab[idx]``
  (replaces ``_adaln_norm_kernel``; CUDA C++, ``csrc/adaln_norm.cu``).
* :func:`adaln_residual` — ``x + y·scale_tab[idx]`` in fp32, out in x.dtype
  (replaces ``_adaln_residual_kernel``; Triton).
* :func:`qk_norm_rope`   — RMSNorm(q)·w_q and RMSNorm(k)·w_k over the full
  model dim, an x.dtype round-trip, then the interleaved-pair RoPE of both
  (replaces ``_qk_norm_rope_kernel``; CUDA C++, ``csrc/qk_norm_rope.cu``).
* :func:`rms_norm`       — fp32 RMSNorm·w (replaces ``_rms_kernel``; Triton).

What bounds them on the H100: each is one pass of row reductions plus a few
FLOPs per element over [B, L, D] bf16 activations (D = 3072), i.e. HBM
bandwidth; at 12,095 tokens one pass reads and writes ~74 MB. K2 and K4
(see their sources) give a warp a row at a time in 16-byte vectors, stage
what every row reads (K2's modulation table rows, K4's weights) once a
persistent CTA and bring the next row in by cp.async while they compute
the current one. K4 reads q and k through their row strides, so the W8A8
block hands it the q and k column blocks of its fused qkv output without a
copy. K3 is one Triton program per token row with the whole row (BLOCK =
next power of two of D, masked) in registers, so every input byte is read
once and every output byte written once; it loads the per-token
modulation row directly from the compact [B, K, D] fp32 table by ``idx``
(the TPU kernel's one-hot dot was a Mosaic workaround). K5 reads its
rows contiguously: a program takes ``_RMS_ROWS`` rows and walks D in
chunks of at most 1,024 columns (three at D = 3,072, so no lane is
masked), 16-byte loads, twice: the sum of squares, then the scaled row
(the second read hits the cache). Any batch size works.

Each wrapper runs its plain version on CPU tensors and launches its kernel
(or raises) on CUDA tensors. When an input requires grad, the launch goes
through :class:`_Recompute`, whose backward recomputes through the plain
version as the reference's custom VJPs do. The plain versions keep the reference's
rounding points: fp32 math, one cast at the end, and the x.dtype round-trip
between the norm and the rotation in :func:`qk_norm_rope`.

``triton`` is imported, and the CUDA library built, when a kernel is first
launched, never at import.
"""

from __future__ import annotations

import functools
import types

import torch

from . import rope as rope_lib

# bound to the triton modules on first launch (see _kernels)
triton = None
tl = None

_MAX_D = 16384
# K5's tile: rows a program and the widest D chunk (16-byte loads of bf16
# across num_warps = ROWS·CHUNK/256 warps)
_RMS_ROWS, _RMS_CHUNK = 2, 1024


# ---------------------------------------------------------------------------
# plain versions (CPU path and on-card oracle)
# ---------------------------------------------------------------------------


def _table_rows(tab, idx):
    """[B|1, K, D] table → per-token rows [B, L, D] (or [B|1, 1, D] when
    idx is None: row 0 everywhere)."""
    if idx is None:
        return tab[:, :1]
    tab = tab.expand(idx.shape[0], -1, -1)
    index = idx.long()[:, :, None].expand(-1, -1, tab.shape[-1])
    return torch.gather(tab, 1, index)


def _adaln_norm_ref(x, scale_tab, shift_tab, idx, eps, gate, out_dtype):
    s = _table_rows(scale_tab, idx)
    t = _table_rows(shift_tab, idx)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    return (n * (gate + s) + t).to(out_dtype)


def _adaln_residual_ref(x, y, scale_tab, idx):
    s = _table_rows(scale_tab, idx)
    return (x.float() + y.float() * s).to(x.dtype)


def _rms_ref(x, w, eps):
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


def _qk_norm_rope_ref(q, k, w_q, w_k, cos, sin, num_heads, eps):
    b, l, dim = q.shape
    d_ = dim // num_heads
    q4 = _rms_ref(q, w_q, eps).reshape(b, l, num_heads, d_)
    k4 = _rms_ref(k, w_k, eps).reshape(b, l, num_heads, d_)
    return (rope_lib.apply_rope(q4, cos, sin).reshape(b, l, dim),
            rope_lib.apply_rope(k4, cos, sin).reshape(b, l, dim))


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _kernels():
    global triton, tl
    import triton as _triton
    import triton.language as _tl

    triton, tl = _triton, _tl

    @triton.jit
    def adaln_residual_kernel(x_ptr, y_ptr, idx_ptr, s_ptr, o_ptr, L, D,
                              tab_bstride,
                              HAS_IDX: tl.constexpr, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        b = row // L
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0).to(tl.float32)
        y = tl.load(y_ptr + row * D + cols, mask=mask, other=0.0).to(tl.float32)
        if HAS_IDX:
            k = tl.load(idx_ptr + row).to(tl.int64)
        else:
            k = 0
        s = tl.load(s_ptr + b * tab_bstride + k * D + cols, mask=mask, other=0.0)
        tl.store(o_ptr + row * D + cols, (x + y * s).to(o_ptr.dtype.element_ty),
                 mask=mask)

    @triton.jit
    def rms_norm_kernel(x_ptr, w_ptr, o_ptr, R, D, eps,
                        ROWS: tl.constexpr, CHUNK: tl.constexpr):
        # ROWS rows a program, D walked in CHUNK-wide contiguous pieces
        rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
        rmask = (rows < R)[:, None]
        base = rows[:, None] * D
        cols = tl.arange(0, CHUNK)
        sq = tl.zeros((ROWS, CHUNK), dtype=tl.float32)
        for c0 in range(0, D, CHUNK):
            c = c0 + cols
            m = rmask & (c < D)[None, :]
            x = tl.load(x_ptr + base + c[None, :], mask=m, other=0.0).to(tl.float32)
            sq += x * x
        r = tl.rsqrt(tl.sum(sq, axis=1) / D + eps)[:, None]
        for c0 in range(0, D, CHUNK):
            c = c0 + cols
            m = rmask & (c < D)[None, :]
            x = tl.load(x_ptr + base + c[None, :], mask=m, other=0.0).to(tl.float32)
            w = tl.load(w_ptr + c, mask=c < D, other=0.0)[None, :]
            tl.store(o_ptr + base + c[None, :], (x * r * w).to(o_ptr.dtype.element_ty),
                     mask=m)

    return types.SimpleNamespace(
        adaln_residual=adaln_residual_kernel, rms_norm=rms_norm_kernel)


def _block(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _warps(block: int) -> int:
    return max(1, min(16, block // 256))


def _rms_tile(d: int):
    """K5's D chunk and warps for width d: chunks of at most ``_RMS_CHUNK``
    columns; at the model widths a thread loads 8 bf16 (16 bytes) a chunk."""
    chunk = min(_RMS_CHUNK, _block(d))
    return chunk, _warps(_RMS_ROWS * chunk)


# ---------------------------------------------------------------------------
# launch-side checks
# ---------------------------------------------------------------------------


_ACT_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# dtype codes of K2 and K4 (csrc/adaln_norm.cu, csrc/qk_norm_rope.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_act(name, t, like=None, strided_rows=False):
    """A CUDA [B, L, D] activation; contiguous, or with ``strided_rows``
    only its last axis contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in _ACT_DTYPES:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name} must be a [B, L, D] tensor")
    if strided_rows and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must be contiguous")
    if not strided_rows and not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [B, L, D] tensor")
    if t.shape[-1] > _MAX_D:
        raise ValueError(f"{name}: D = {t.shape[-1]} exceeds {_MAX_D}")
    if like is not None and (t.shape != like.shape or t.device != like.device):
        raise ValueError(f"{name}: shape/device {tuple(t.shape)} on {t.device} "
                         f"differs from {tuple(like.shape)} on {like.device}")


def _table(name, tab, x):
    """fp32 contiguous [B|1, K, D] table on x's device, and its batch stride."""
    b, _, d = x.shape
    tab = tab.to(device=x.device, dtype=torch.float32).contiguous()
    if tab.dim() != 3 or tab.shape[0] not in (1, b) or tab.shape[-1] != d:
        raise ValueError(f"{name}: table must be [1 or {b}, K, {d}], "
                         f"got {tuple(tab.shape)}")
    return tab, (tab.shape[1] * d if tab.shape[0] == b and b > 1 else 0)


def _index(idx, x):
    if idx is None:
        return None
    if tuple(idx.shape) != tuple(x.shape[:2]):
        raise ValueError(f"idx must be [B, L] = {tuple(x.shape[:2])}, "
                         f"got {tuple(idx.shape)}")
    return idx.to(device=x.device, dtype=torch.int32).contiguous()


def _weight(name, w, x):
    w = w.to(device=x.device, dtype=torch.float32).contiguous()
    if w.shape != (x.shape[-1],):
        raise ValueError(f"{name} must be [{x.shape[-1]}], got {tuple(w.shape)}")
    return w


def _rope_tables(cos, sin, x, half):
    """fp32 contiguous RoPE tables [L, half] or batched [B, L, half] on x's
    device, and their batch stride."""
    b, l, _ = x.shape
    cos = cos.to(device=x.device, dtype=torch.float32).contiguous()
    sin = sin.to(device=x.device, dtype=torch.float32).contiguous()
    if cos.shape != sin.shape or cos.shape not in ((l, half), (b, l, half)):
        raise ValueError(f"qk_norm_rope: cos/sin must be [{l}, {half}] or "
                         f"[{b}, {l}, {half}], got {tuple(cos.shape)}")
    return cos, sin, (l * half if cos.dim() == 3 else 0)


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors, no gradient)
# ---------------------------------------------------------------------------


def _adaln_norm_launch(x, scale_tab, shift_tab, idx, eps, gate, out_dtype):
    """K2 on contiguous x; idx None reads table row 0 everywhere."""
    from .. import _build

    _check_act("adaln_norm x", x)
    if out_dtype not in (x.dtype, torch.float32):  # the pairs K2 instantiates
        raise TypeError(f"adaln_norm: no kernel from {x.dtype} to {out_dtype} "
                        f"(x's dtype or float32 out)")
    s_tab, bstride = _table("adaln_norm scale_tab", scale_tab, x)
    t_tab, _ = _table("adaln_norm shift_tab", shift_tab, x)
    if s_tab.shape != t_tab.shape:
        raise ValueError("adaln_norm: scale and shift tables differ in shape")
    idx = _index(idx, x)
    b, l, d = x.shape
    out = torch.empty((b, l, d), dtype=out_dtype, device=x.device)
    if b * l == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.yume_adaln_norm(
            x.data_ptr(), None if idx is None else idx.data_ptr(), s_tab.data_ptr(),
            t_tab.data_ptr(), out.data_ptr(), b, l, d, s_tab.shape[1], bstride,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], float(eps), float(gate), stream)
    _build.check(err, "adaln_norm")
    adaln_norm.launches += 1
    return out


def _adaln_residual_launch(x, y, scale_tab, idx):
    _check_act("adaln_residual x", x)
    _check_act("adaln_residual y", y, like=x)
    s_tab, bstride = _table("adaln_residual scale_tab", scale_tab, x)
    idx = _index(idx, x)
    b, l, d = x.shape
    out = torch.empty_like(x)
    if b * l == 0:
        return out
    block = _block(d)
    with torch.cuda.device(x.device):
        _kernels().adaln_residual[(b * l,)](
            x, y, idx if idx is not None else x, s_tab, out, l, d, bstride,
            HAS_IDX=idx is not None, BLOCK_D=block, num_warps=_warps(block))
    adaln_residual.launches += 1
    return out


def _rms_norm_launch(x, w, eps):
    _check_act("rms_norm x", x)
    w = _weight("rms_norm w", w, x)
    b, l, d = x.shape
    out = torch.empty_like(x)
    rows = b * l
    if rows == 0:
        return out
    chunk, warps = _rms_tile(d)
    with torch.cuda.device(x.device):
        _kernels().rms_norm[(-(-rows // _RMS_ROWS),)](
            x, w, out, rows, d, float(eps), ROWS=_RMS_ROWS, CHUNK=chunk,
            num_warps=warps)
    rms_norm.launches += 1
    return out


def _qk_norm_rope_launch(q, k, w_q, w_k, cos, sin, num_heads, eps):
    """K4: q and k read in place through their batch and row strides; the
    outputs are contiguous."""
    from .. import _build

    _check_act("qk_norm_rope q", q, strided_rows=True)
    _check_act("qk_norm_rope k", k, like=q, strided_rows=True)
    if k.dtype != q.dtype:
        raise TypeError("qk_norm_rope: q and k dtypes differ")
    b, l, d = q.shape
    if d % num_heads or (d // num_heads) % 2:
        raise ValueError(f"qk_norm_rope: D = {d} does not split into "
                         f"{num_heads} heads of even size")
    half = d // num_heads // 2
    w_q = _weight("qk_norm_rope w_q", w_q, q)
    w_k = _weight("qk_norm_rope w_k", w_k, q)
    cos, sin, tab_bstride = _rope_tables(cos, sin, q, half)
    oq = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    ok = torch.empty((b, l, d), dtype=k.dtype, device=k.device)
    if b * l == 0:
        return oq, ok
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.yume_qk_norm_rope(
            q.data_ptr(), k.data_ptr(), w_q.data_ptr(), w_k.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), oq.data_ptr(), ok.data_ptr(), b, l, d, half, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), tab_bstride, _DTYPE_CODES[q.dtype],
            float(eps), stream)
    _build.check(err, "qk_norm_rope")
    qk_norm_rope.launches += 1
    return oq, ok


# ---------------------------------------------------------------------------
# gradients: forward on the kernel, backward through the plain version
# ---------------------------------------------------------------------------


def _adaln_norm_f32(x, scale_tab, shift_tab, idx, eps, gate, out_dtype):
    return _adaln_norm_ref(x, scale_tab.float(), shift_tab.float(), idx, eps,
                           gate, out_dtype)


def _adaln_residual_f32(x, y, scale_tab, idx):
    return _adaln_residual_ref(x, y, scale_tab.float(), idx)


class _Recompute(torch.autograd.Function):
    """A glue kernel with a gradient (the reference's custom VJPs,
    yume_tpu/ops/fused_adaln.py): the forward launches the kernel and keeps
    only the primal tensor inputs; the backward recomputes the op through
    its plain version and differentiates that, so every tensor input that
    requires grad (activations, the fp32 modulation tables, norm weights,
    RoPE tables) gets its gradient."""

    @staticmethod
    def forward(ctx, launch, ref, n_tensors, *args):
        tensors, static = args[:n_tensors], args[n_tensors:]
        ctx.ref, ctx.static = ref, static
        ctx.save_for_backward(*tensors)
        return launch(*tensors, *static)

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:3 + len(tensors)]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if need else t
                      for t, need in zip(tensors, needs)]
            outs = ctx.ref(*leaves, *ctx.static)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads = [torch.zeros_like(o) if g is None else g for o, g in zip(outs, grads)]
        wrt = [t for t, need in zip(leaves, needs) if need]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (None, None, None, *(next(got) if need else None for need in needs),
                *(None for _ in ctx.static))


def _run(launch, ref, tensors, static):
    """Launch on the card; through :class:`_Recompute` when a tensor input
    requires grad, so the output carries the gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        return _Recompute.apply(launch, ref, len(tensors), *tensors, *static)
    return launch(*tensors, *static)


# ---------------------------------------------------------------------------
# public ops
# ---------------------------------------------------------------------------


def adaln_norm(x, scale_tab, shift_tab, idx, *, eps=1e-6, gate=1.0,
               out_dtype=None):
    """``LayerNorm(x) * (gate + scale_tab[idx]) + shift_tab[idx]`` (K2).

    x: [B, L, D]; scale_tab/shift_tab: [B or 1, K, D] (computed in fp32);
    idx: [B, L] int or None (None ⇒ row 0 everywhere). gate=1 is the AdaLN
    "(1 + scale)" form; gate=0 with a weight/bias table is an affine
    LayerNorm. ``out_dtype`` overrides the output dtype (the Head keeps
    fp32)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if not x.is_cuda:
        return _adaln_norm_f32(x, scale_tab, shift_tab, idx, eps, gate, out_dtype)
    return _run(_adaln_norm_launch, _adaln_norm_f32, (x, scale_tab, shift_tab, idx),
                (eps, gate, out_dtype))


def adaln_residual(x, y, scale_tab, idx):
    """``x + y * scale_tab[idx]`` in fp32 → x.dtype (K3, the AdaLN gated
    residual). Shapes as in :func:`adaln_norm`."""
    if not x.is_cuda:
        return _adaln_residual_f32(x, y, scale_tab, idx)
    return _run(_adaln_residual_launch, _adaln_residual_f32, (x, y, scale_tab, idx), ())


def rms_norm(x, w, *, eps=1e-5):
    """fp32 RMSNorm with learned scale over the last axis (K5)."""
    if not x.is_cuda:
        return _rms_ref(x, w, eps)
    return _run(_rms_norm_launch, _rms_ref, (x, w), (eps,))


def qk_norm_rope(q, k, w_q, w_k, cos, sin, num_heads, *, eps=1e-5):
    """RMSNorm over the full model dim + RoPE for q and k in one pass (K4).

    q/k: [B, L, D] flat (heads packed), the last axis contiguous and the
    rows possibly strided (the q and k column blocks of a fused qkv
    projection); w_q/w_k: [D]; cos/sin: [L, head_dim//2] fp32, or
    [B, L, head_dim//2] per-sample tables (the MVDT masked pass). Returns
    rotated flat, contiguous (q, k) in the input dtype. Math equals
    RMSNorm → x.dtype → apply_rope."""
    if not q.is_cuda:
        return _qk_norm_rope_ref(q, k, w_q, w_k, cos, sin, num_heads, eps)
    return _run(_qk_norm_rope_launch, _qk_norm_rope_ref,
                (q, k, w_q, w_k, cos, sin), (num_heads, eps))


adaln_norm.launches = 0
adaln_residual.launches = 0
rms_norm.launches = 0
qk_norm_rope.launches = 0
