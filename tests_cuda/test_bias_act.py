"""K10, the fused bias + activation kernel, against its plain PyTorch
version on the card, at the edges the discriminator's path does not reach:
every activation in fp32, bf16 and fp16, channel counts that are not a
multiple of the 16-byte vector, ``dim=1`` on NCHW, inputs that are not
16-byte aligned or not contiguous, an empty tensor, clamp 0, the launch
count, the gradient and the wrapper's input checks.

Both sides compute in fp32 and round once to x's dtype. The kernel's
``expf``/``expm1f``/``log1pf``/``tanhf`` and ATen's CUDA functions may
differ by an ulp, so fp32 is held to 1e-6 (relative and absolute) and the
half types to one ulp of their own (2⁻⁷ relative for bf16, 2⁻¹⁰ for fp16).
"""

import pytest
import torch

from yume_tpu_torch.ops import bias_act as ba

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.fixture
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32, scale=3.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _check(x, b=None, **kw):
    spec = ba.ACTIVATIONS[kw.get("act", "linear")]
    kw.setdefault("alpha", spec.def_alpha)
    kw.setdefault("gain", spec.def_gain)
    before = ba.bias_act.launches
    got = ba.bias_act(x, b, **kw)
    want = ba.bias_act_plain(x, b, **kw)
    assert got.shape == x.shape and got.dtype == x.dtype
    assert ba.bias_act.launches == before + (1 if x.numel() else 0)
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL[x.dtype], atol=1e-6)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("act", sorted(ba.ACTIVATIONS))
def test_every_activation(gen, act, dtype):
    x = _randn(gen, 8, 196, 384, dtype=dtype)
    _check(x, _randn(gen, 384), act=act, clamp=4.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,dim", [((5, 7, 13), -1), ((3, 13), -1), ((1, 3), -1),
                                       ((2, 13, 5, 3), 1), ((4, 6, 11, 7), 1), ((37,), 0)])
def test_channels_off_the_vector_width(gen, shape, dim, dtype):
    x = _randn(gen, *shape, dtype=dtype)
    _check(x, _randn(gen, shape[dim]), dim=dim, act="lrelu", clamp=2.5)


def test_no_bias_and_default_gain(gen):
    _check(_randn(gen, 64, 384), act="lrelu")
    _check(_randn(gen, 64, 384), act="swish", gain=0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_misaligned_input(gen, dtype):
    """A view one element into its storage: no 16-byte vector fits, the
    scalar loop does it all."""
    buf = _randn(gen, 1 + 6 * 384, dtype=dtype)
    x = buf[1:].view(6, 384)
    assert x.data_ptr() % 16
    _check(x, _randn(gen, 384), act="selu", clamp=3.0)


def test_non_contiguous_input(gen):
    x = _randn(gen, 384, 24, dtype=torch.float16).t()
    assert not x.is_contiguous()
    _check(x, _randn(gen, 384), act="tanh")
    x = _randn(gen, 2, 9, 5, 6).permute(0, 3, 1, 2)
    _check(x, _randn(gen, 6), dim=1, act="elu")


def test_empty_tensor(gen):
    x = torch.empty((0, 384), device="cuda")
    assert _check(x, _randn(gen, 384), act="lrelu").numel() == 0


@pytest.mark.parametrize("act", ["lrelu", "softplus", "sigmoid"])
def test_clamp_zero(gen, act):
    got = _check(_randn(gen, 17, 384), _randn(gen, 384), act=act, clamp=0.0)
    assert not got.any()


def test_gradient_matches_the_cpu(gen):
    """The autograd Function launches K10 forward and differentiates in
    plain PyTorch: dx and db on the card equal the CPU's."""
    x, b, g = _randn(gen, 8, 196, 384), _randn(gen, 384), _randn(gen, 8, 196, 384)
    out = []
    for dev in ("cuda", "cpu"):
        xd, bd = (t.to(dev).requires_grad_() for t in (x, b))
        y = ba.bias_act(xd, bd, act="swish", clamp=2.0)
        out.append([t.cpu() for t in torch.autograd.grad(y, (xd, bd), g.to(dev))])
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_input_checks(gen):
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        ba.bias_act(_randn(gen, 4, 8, dtype=torch.float64), act="relu")
    with pytest.raises(ValueError, match="bias must be"):
        ba.bias_act(_randn(gen, 4, 8), _randn(gen, 7), act="relu")
    with pytest.raises(ValueError, match="bias must be on"):
        ba.bias_act(_randn(gen, 4, 8), torch.zeros(8), act="relu")
