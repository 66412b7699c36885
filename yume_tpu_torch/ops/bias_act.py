"""Fused bias + activation + gain + clamp (StyleGAN ``bias_act``): wrapper of
the CUDA kernel K10 (``csrc/bias_act.cu``) and its plain PyTorch version
(counterpart of yume_tpu/ops/bias_act.py).

``y = clamp(act(x + b, alpha) · gain, −clamp, clamp)``, with ``b`` along
axis ``dim`` of ``x`` and ``clamp`` None or negative for no clamp. The
activation table (:data:`ACTIVATIONS`: function, derivative, default alpha
and gain) is the reference's, quirks included: ``elu`` ignores alpha and
``selu`` has fixed constants.

K10 replaces yume_tpu/ops/bias_act.py::_kernel (launched by
``_forward_pallas``), which computes in fp32 and casts once at the end; the
plain version :func:`bias_act_plain` follows that kernel (the reference's
XLA path computes in the input's dtype; for fp32 inputs the two agree). On
the H100 the op is one read and one write per element, bound by HBM
bandwidth; the kernel views x as ``[outer, C, inner]`` so that ``dim=-1``
and ``dim=1`` on NCHW need no permute copy, and moves 16-byte vectors (see
the source).

The gradient is the reference's custom VJP (``_core_bwd``): the analytic
derivative at ``x + b``, zero where ``|y| >= clamp``, and ``db`` the sum of
``dx`` over every axis but ``dim``. The reference computes it with XLA, so
the backward of :class:`BiasAct` is plain PyTorch on both devices.

On a CPU tensor :func:`bias_act` runs the plain version; on a CUDA tensor it
launches K10 or raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

_SELU_L, _SELU_A = 1.0507009873554805, 1.6732632423543772


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


@dataclasses.dataclass(frozen=True)
class ActSpec:
    fn: Callable
    grad: Callable  # d act(x) / dx, as a function of x (pre-activation)
    def_alpha: float = 0.0
    def_gain: float = 1.0


ACTIVATIONS = {
    "linear": ActSpec(lambda x, a: x, lambda x, a: torch.ones_like(x)),
    "relu": ActSpec(lambda x, a: torch.clamp_min(x, 0.0),
                    lambda x, a: (x >= 0).to(x.dtype), def_gain=math.sqrt(2)),
    "lrelu": ActSpec(lambda x, a: torch.where(x >= 0, x, a * x),
                     lambda x, a: torch.where(x >= 0, 1.0, a).to(x.dtype),
                     def_alpha=0.2, def_gain=math.sqrt(2)),
    "tanh": ActSpec(lambda x, a: torch.tanh(x), lambda x, a: 1 - torch.tanh(x) ** 2),
    "sigmoid": ActSpec(lambda x, a: _sigmoid(x),
                       lambda x, a: _sigmoid(x) * (1 - _sigmoid(x))),
    "elu": ActSpec(lambda x, a: torch.where(x >= 0, x, torch.expm1(x)),
                   lambda x, a: torch.where(x >= 0, 1.0, torch.exp(x))),
    "selu": ActSpec(lambda x, a: _SELU_L * torch.where(x >= 0, x, _SELU_A * torch.expm1(x)),
                    lambda x, a: _SELU_L * torch.where(x >= 0, 1.0, _SELU_A * torch.exp(x))),
    "softplus": ActSpec(
        lambda x, a: torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x))),
        lambda x, a: _sigmoid(x)),
    "swish": ActSpec(lambda x, a: _sigmoid(x) * x,
                     lambda x, a: _sigmoid(x) * (1 + x * (1 - _sigmoid(x))),
                     def_gain=math.sqrt(2)),
}
# the kernel's activation codes (enum Act in csrc/bias_act.cu)
ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _channel_view(b: torch.Tensor, ndim: int, dim: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[dim] = -1
    return b.reshape(shape)


def _clamps(clamp) -> bool:
    return clamp is not None and clamp >= 0


def bias_act_plain(x, b=None, *, dim=-1, act="linear", alpha=0.0, gain=1.0, clamp=None):
    """The plain version of K10 (alpha and gain resolved): fp32 math, one
    cast to x's dtype at the end, as the TPU kernel."""
    xf = x.float()
    if b is not None:
        xf = xf + _channel_view(b.float(), x.dim(), dim % x.dim())
    y = ACTIVATIONS[act].fn(xf, alpha) * gain
    if _clamps(clamp):
        y = torch.clamp(y, -clamp, clamp)
    return y.to(x.dtype)


def _check(x, b, dim):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bias_act: the kernel takes fp32, bf16 or fp16, got {x.dtype}")
    if b is not None:
        if b.dim() != 1 or b.shape[0] != x.shape[dim]:
            raise ValueError(f"bias_act: bias must be [{x.shape[dim]}], got {tuple(b.shape)}")
        if b.device != x.device:
            raise ValueError(f"bias_act: bias must be on {x.device}")


def _launch(x, b, dim, act, alpha, gain, clamp):
    """K10 on a CUDA tensor: y in x's dtype and shape, contiguous."""
    from .. import _build

    _check(x, b, dim)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        c = x.shape[dim]
        inner = math.prod(x.shape[dim + 1:])
        bf = None if b is None else b.detach().float().contiguous()
        lib = _build.library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.yume_bias_act(x.data_ptr(), None if bf is None else bf.data_ptr(),
                                    y.data_ptr(), x.numel(), c, inner, _DTYPE_CODES[x.dtype],
                                    ACT_CODES[act], alpha, gain,
                                    -1.0 if not _clamps(clamp) else float(clamp), stream)
        _build.check(err, "bias_act")
        bias_act.launches += 1
    return y


def _forward(x, b, dim, act, alpha, gain, clamp):
    if x.is_cuda:
        return _launch(x, b, dim, act, alpha, gain, clamp)
    return bias_act_plain(x, b, dim=dim, act=act, alpha=alpha, gain=gain, clamp=clamp)


class BiasAct(torch.autograd.Function):
    """``bias_act`` with the reference's custom VJP: the forward is K10 (or
    the plain version on the CPU), the backward the analytic derivative."""

    @staticmethod
    def forward(ctx, x, b, dim, act, alpha, gain, clamp):
        y = _forward(x, b, dim, act, alpha, gain, clamp)
        ctx.save_for_backward(x, b, y)
        ctx.cfg = (dim, act, alpha, gain, clamp)
        return y

    @staticmethod
    def backward(ctx, g):
        x, b, y = ctx.saved_tensors
        dim, act, alpha, gain, clamp = ctx.cfg
        xb = x + _channel_view(b, x.dim(), dim) if b is not None else x
        d = ACTIVATIONS[act].grad(xb.float(), alpha) * gain
        if _clamps(clamp):
            d = torch.where(y.float().abs() >= clamp, 0.0, d)
        dx = (g.float() * d).to(x.dtype)
        db = None
        if b is not None and ctx.needs_input_grad[1]:
            db = dx.sum([i for i in range(x.dim()) if i != dim]).to(b.dtype)
        return dx, db, None, None, None, None, None


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, *, dim: int = -1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """Fused bias + activation + gain + clamp; ``b`` [C] along axis ``dim``
    of ``x``; ``alpha`` and ``gain`` default to the activation's. One
    launch of K10 on a CUDA tensor."""
    spec = ACTIVATIONS[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)
    clamp = None if clamp is None else float(clamp)
    dim = dim % x.dim()
    if torch.is_grad_enabled() and (x.requires_grad or (b is not None and b.requires_grad)):
        return BiasAct.apply(x, b, dim, act, alpha, gain, clamp)
    return _forward(x, b, dim, act, alpha, gain, clamp)


bias_act.launches = 0
