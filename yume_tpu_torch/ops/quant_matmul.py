"""W8A8 int8 matmul: wrapper of the CUDA kernel K6 (``csrc/quant_matmul.cu``)
and its plain PyTorch version (counterpart of yume_tpu/ops/quant_matmul.py).

Scheme, as in the reference:

* activations: per-row (per-token) absmax → ``a_scale = max(absmax,
  1e-8) / 127``, ``q = clip(round(x / a_scale), -127, 127)`` (round half to
  even, true division);
* weights: per-output-channel absmax, the same formula;
* s8 × s8 products summed exactly in int32; the epilogue computes
  ``acc · a_scale · w_scale`` in fp32, left to right, and casts once.

Weights are kept in torch ``Linear`` layout ``[N, K]``: each output
channel's K values are contiguous, the K-major B operand of int8
``wgmma``; the per-channel scale is a per-row absmax of that matrix.

K6 replaces yume_tpu/ops/quant_matmul.py::_fused_kernel (via
``_fused_q8_matmul_2d``), which quantizes each activation tile in VMEM and
feeds the MXU. On the H100 the 5B projections (M = 12,095 tokens) are bound
by int8 tensor-core operations. K6 is two CUDA kernels under one launch: a
pre-pass that quantizes each activation row once (``a_scale`` and int8
``xq``, the scratch the wrapper allocates), then a warp-specialised int8
``wgmma`` GEMM fed by TMA that rescales in its epilogue. Every W8A8
projection (not only K ≥ 8192, a TPU measurement) goes through it. Its
design is described in the source.

On a CPU tensor :func:`q8_dot` runs :func:`_q8_matmul_ref` and
:func:`q8_quantize` runs :func:`_quantize_act`; on a CUDA tensor each
launches its kernel or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_EPS = 1e-8


@dataclasses.dataclass
class Q8:
    """Per-output-channel int8 weight in ``Linear`` layout:
    ``w ≈ q.float() * scale[:, None]``."""

    q: torch.Tensor      # int8 [N, K]
    scale: torch.Tensor  # fp32 [N]


def _absmax_scale(t: torch.Tensor) -> torch.Tensor:
    """``max(max |t|, 1e-8) / 127`` over the last dim, in fp32, keepdim.

    The divisor is a tensor on t's device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which is not the IEEE
    quotient the reference and the kernel compute."""
    d127 = torch.tensor(127.0, dtype=torch.float32, device=t.device)
    return t.float().abs().amax(-1, keepdim=True).clamp_min(_EPS) / d127


def _round_clip(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(t.float() / scale), -127, 127)


def quantize_weight(w: torch.Tensor) -> Q8:
    """Symmetric per-output-channel int8 of a ``[N, K]`` weight: the weight
    half of the reference's ``int8_dot_general`` (per column of its
    ``[K, N]`` kernel). Quantize the weight as it is cast to the compute
    dtype, as the reference's ``promote_dtype`` does before the matmul."""
    scale = _absmax_scale(w)
    return Q8(q=_round_clip(w, scale).to(torch.int8), scale=scale[:, 0])


def q8_dequant(w: Q8, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Q8 → dense ``[N, K]`` weight."""
    return (w.q.float() * w.scale[:, None]).to(dtype)


def _quantize_act(x: torch.Tensor):
    """Plain version of K6's pre-pass: x [..., K] → int8 activations
    [..., K] and their fp32 per-row scales [...]."""
    a_scale = _absmax_scale(x)
    return _round_clip(x, a_scale).to(torch.int8), a_scale[..., 0]


def _q8_matmul_ref(x: torch.Tensor, qw: torch.Tensor, w_scale: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K6: x [..., K] (any float dtype), qw int8 [N, K],
    w_scale fp32 [N] → [..., N] in ``out_dtype``.

    The integer product is a float64 matmul of the int8 values: every
    partial sum is an integer below 127²·K < 2⁵³, so it is exact in any
    order, on the CPU and on the card alike (CUDA has no int32 matmul)."""
    qa, a_scale = _quantize_act(x)
    acc = qa.double() @ qw.double().t()
    return (acc.float() * a_scale[..., None] * w_scale).to(out_dtype)


def _check(x2: torch.Tensor, w: Q8, out_dtype: torch.dtype):
    k = x2.shape[1]
    n = w.q.shape[0]
    if x2.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise TypeError(f"q8_dot: the kernel takes bf16 activations and "
                        f"writes bf16, got {x2.dtype} → {out_dtype}")
    if w.q.dtype != torch.int8 or w.q.dim() != 2 or w.q.shape[1] != k:
        raise ValueError(f"q8_dot: weight must be int8 [N, {k}], got "
                         f"{w.q.dtype} {tuple(w.q.shape)}")
    if w.scale.dtype != torch.float32 or tuple(w.scale.shape) != (n,):
        raise ValueError(f"q8_dot: scale must be fp32 [{n}], got "
                         f"{w.scale.dtype} {tuple(w.scale.shape)}")
    for name, t in (("weight", w.q), ("scale", w.scale)):
        if not t.is_cuda or t.device != x2.device:
            raise ValueError(f"q8_dot: {name} must be on {x2.device}")
    if w.q.data_ptr() % 16:
        raise ValueError("q8_dot: the int8 weight needs a 16-byte aligned base")
    if k % 32 or n % 8:
        raise ValueError(f"q8_dot: the kernel needs K % 32 == 0 and N % 8 == 0, "
                         f"got K = {k}, N = {n}")
    _check_rows(x2, "q8_dot")


def _check_rows(x2: torch.Tensor, what: str):
    if x2.shape[0] > 2**31 - 1:  # the kernels' row index is a C int
        raise ValueError(f"{what}: M = {x2.shape[0]} exceeds 2^31 - 1 rows")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., K] as [M, K] rows that the pre-pass reads in place: unit
    stride in K, 16-byte aligned rows (copied otherwise)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(-1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    return x2


def q8_quantize(x: torch.Tensor):
    """K6's pre-pass alone: x [..., K] → (int8 activations [..., K], fp32
    per-row scales [...]). :func:`q8_dot` runs it inside its own launch;
    this entry point checks and times it apart."""
    if not x.is_cuda:
        return _quantize_act(x)
    from .. import _build

    k = x.shape[-1]
    x2 = _rows(x)
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"q8_quantize: the kernel takes bf16 rows, got {x2.dtype}")
    if k % 32:
        raise ValueError(f"q8_quantize: the kernel needs K % 32 == 0, got K = {k}")
    _check_rows(x2, "q8_quantize")
    m = x2.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    a_scale = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m:
        lib = _build.library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.yume_q8_quantize(x2.data_ptr(), a_scale.data_ptr(), xq.data_ptr(),
                                       m, k, x2.stride(0), stream)
        _build.check(err, "q8_quantize")
        q8_quantize.launches += 1
    return xq.reshape(x.shape), a_scale.reshape(x.shape[:-1])


def q8_dot(x: torch.Tensor, w: Q8, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(w).T`` with dynamic per-row int8 activations:
    x [..., K], w int8 [N, K] → [..., N] in ``dtype`` (default x.dtype).

    One launch runs K6's two CUDA kernels: the pre-pass (per-row scales
    and int8 activations, into scratch allocated here), then the int8
    GEMM with its rescaling epilogue."""
    out_dtype = x.dtype if dtype is None else dtype
    if not x.is_cuda:
        return _q8_matmul_ref(x, w.q, w.scale, out_dtype)
    from .. import _build

    k = x.shape[-1]
    n = w.q.shape[0]
    x2 = _rows(x)
    w = Q8(q=w.q.contiguous(), scale=w.scale.contiguous())
    _check(x2, w, out_dtype)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m:
        a_scale = torch.empty((m,), dtype=torch.float32, device=x.device)
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
        lib = _build.library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.yume_q8_matmul(x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
                                     a_scale.data_ptr(), xq.data_ptr(), out.data_ptr(),
                                     m, n, k, x2.stride(0), stream)
        _build.check(err, "q8_dot")
        q8_dot.launches += 1
    return out.reshape(*x.shape[:-1], n)


q8_dot.launches = 0
q8_quantize.launches = 0


def int8_dot_general(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """W8A8 ``x @ weight.T`` for a ``Linear``-layout weight [N, K]: the
    counterpart of the reference's ``int8_dot_general`` for the Dense
    pattern. The weight is quantized per output channel on every call and
    the output takes the promoted dtype of x and weight.

    The DiT quantizes each weight once and calls :func:`q8_dot` (see
    ``models/dit.py``); the int8 weight and scale are the same bits."""
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    return q8_dot(x, quantize_weight(weight), out_dtype)
