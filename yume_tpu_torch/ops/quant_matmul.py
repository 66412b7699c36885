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

The int4 storage of the quantized trunk (:class:`Q4`, group-wise scales)
reaches K6 through :func:`q4_to_q8`, the reference's relay onto the
per-channel int8 grid: plain PyTorch glue (XLA glue in the reference), run
on every call and never cached, so that only the int4 bytes stay resident.
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


@dataclasses.dataclass
class Q4:
    """Group-wise int4 weight in ``Linear`` layout, two nibbles a byte along
    K: ``w ≈ (nibble − 8) · scale`` with one fp32 scale per (output channel,
    group of ``g`` input rows). Within group ``j`` the low nibble of byte
    ``q[n, j·g/2 + i]`` holds input row ``j·g + i`` and the high nibble row
    ``j·g + g/2 + i`` (the reference's halves packing)."""

    q: torch.Tensor      # uint8 [N, K/2]
    scale: torch.Tensor  # fp32 [N, K/g]

    @property
    def group(self) -> int:
        return 2 * self.q.shape[-1] // self.scale.shape[-1]


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
    dtype, as the reference's ``promote_dtype`` does before the matmul.
    ``quantize_weight.calls`` counts the calls."""
    quantize_weight.calls += 1
    scale = _absmax_scale(w)
    return Q8(q=_round_clip(w, scale).to(torch.int8), scale=scale[:, 0])


quantize_weight.calls = 0


def q8_dequant(w: Q8, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Q8 → dense ``[N, K]`` weight."""
    return (w.q.float() * w.scale[:, None]).to(dtype)


def _unpack_q4(w: Q4) -> torch.Tensor:
    """The signed nibbles of ``w`` as fp32 ``[N, K/g, g]`` (exact)."""
    n, g_count = w.scale.shape
    q = w.q.reshape(n, g_count, w.group // 2)
    return torch.cat([q & 0xF, q >> 4], dim=-1).float().sub_(8.0)


def q4_dequant(w: Q4, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Q4 → dense ``[N, K]`` weight: ``(nibble − 8) · scale`` in fp32, cast
    once."""
    wg = _unpack_q4(w).mul_(w.scale[..., None])
    return wg.reshape(w.q.shape[0], -1).to(dtype)


def q4_to_q8(w: Q4) -> Q8:
    """Relay the group-wise int4 storage onto the per-channel int8 grid K6
    takes (the reference's ``q4_to_q8``). The channel scale comes from the
    group scales alone, ``s = max_g(8·scale_g) / 127`` (|nibble − 8| ≤ 8),
    and each weight is ``round((nibble − 8) · (scale_g / s))``, the ratio
    formed first, all in fp32; a channel whose scales are all 0 relays to
    zeros, as XLA converts the reference's 0/0 to 0."""
    d127 = torch.tensor(127.0, dtype=torch.float32, device=w.scale.device)
    s_chan = (w.scale * 8.0).amax(-1) / d127                        # [N]
    ratio = (w.scale / s_chan[:, None]).nan_to_num_(0.0)           # [N, G]
    wq = _unpack_q4(w).mul_(ratio[..., None]).round_().clamp_(-127, 127)
    return Q8(q=wq.to(torch.int8).reshape(w.q.shape[0], -1), scale=s_chan)


def q4_dot(x: torch.Tensor, w: Q4, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ dequant(w).T`` from stored int4 weights: ``q8_dot(x,
    q4_to_q8(w))``, the relay made anew on each call (K6 on the card)."""
    return q8_dot(x, q4_to_q8(w), dtype)


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
