"""K10's module family against the JAX package on the CPU: ``bias_act``'s
plain version against the interpreted Pallas kernel (every activation, with
and without bias and clamp, fp32 and bf16, channels last and NCHW with
``dim=1``), its autograd Function against ``jax.grad`` through the custom
VJP, ``upfirdn2d`` and its resamplers, and ``filtered_lrelu``.

Inputs are numpy arrays from a seed. Tolerances, with their reasons:
* fp32 forward 1e-6 absolute and relative: both sides compute in fp32 and
  round once; exp, log1p and tanh may differ by an ulp between XLA:CPU and
  ATen;
* bf16 forward: one bf16 ulp (2⁻⁸ relative), where an fp32 ulp apart
  rounds to a neighbouring bf16 value;
* gradients 1e-5: the same analytic formulas, fp32;
* upfirdn2d and filtered_lrelu 1e-5: fp32 convolutions summed in another
  order.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import assert_close
from yume_tpu.ops import bias_act as jba
from yume_tpu.ops import filtered_lrelu as jfl
from yume_tpu.ops import upfirdn2d as jup
from yume_tpu_torch.ops import bias_act as tba
from yume_tpu_torch.ops import filtered_lrelu as tfl
from yume_tpu_torch.ops import upfirdn2d as tup

TOL = 1e-6


def _interpret():
    return (contextlib.nullcontext() if jax.default_backend() == "tpu"
            else pltpu.force_tpu_interpret_mode())


def _inputs(rng_np, shape=(64, 32), c=32):
    x = rng_np.standard_normal(shape).astype(np.float32) * 3
    b = rng_np.standard_normal((c,)).astype(np.float32)
    return x, b


def test_activation_table_matches_jax():
    assert list(tba.ACTIVATIONS) == list(jba.ACTIVATIONS)
    for name, spec in jba.ACTIVATIONS.items():
        assert tba.ACTIVATIONS[name].def_alpha == spec.def_alpha, name
        assert tba.ACTIVATIONS[name].def_gain == spec.def_gain, name


@pytest.mark.parametrize("clamp", [None, 2.0])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("act", sorted(jba.ACTIVATIONS))
def test_plain_matches_interpreted_kernel(rng_np, act, with_bias, clamp):
    x, b = _inputs(rng_np)
    with _interpret():
        want = jba.bias_act(jnp.asarray(x), jnp.asarray(b) if with_bias else None, act=act,
                            clamp=clamp, impl="pallas")
    got = tba.bias_act(torch.from_numpy(x), torch.from_numpy(b) if with_bias else None,
                       act=act, clamp=clamp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("act", ["lrelu", "swish", "tanh", "softplus", "selu"])
def test_plain_bf16_matches_interpreted_kernel(rng_np, act):
    x, b = _inputs(rng_np)
    xb = jnp.asarray(x, jnp.bfloat16)
    with _interpret():
        want = jba.bias_act(xb, jnp.asarray(b), act=act, clamp=4.0, impl="pallas")
    got = tba.bias_act(torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16),
                       torch.from_numpy(b), act=act, clamp=4.0)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=TOL)


@pytest.mark.parametrize("act,clamp", [("lrelu", 0.5), ("sigmoid", None)])
def test_nchw_dim1_matches_jax(rng_np, act, clamp):
    x, b = _inputs(rng_np, (2, 6, 5, 7), 6)
    with _interpret():
        want = jba.bias_act(jnp.asarray(x), jnp.asarray(b), dim=1, act=act, clamp=clamp,
                            impl="pallas")
    got = tba.bias_act(torch.from_numpy(x), torch.from_numpy(b), dim=1, act=act, clamp=clamp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("act,clamp,dim", [("swish", 1.5, -1), ("lrelu", None, -1),
                                           ("softplus", 2.0, -1), ("selu", None, -1),
                                           ("lrelu", 0.7, 1)])
def test_gradients_match_jax_vjp(rng_np, act, clamp, dim):
    shape, c = ((32, 16), 16) if dim == -1 else ((2, 5, 4, 3), 5)
    x, b = _inputs(rng_np, shape, c)
    g = rng_np.standard_normal(shape).astype(np.float32)

    def f(x, b):
        return jnp.sum(jba.bias_act(x, b, dim=dim, act=act, clamp=clamp, impl="pallas") * g)

    with _interpret():
        gx_j, gb_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    xt, bt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = tba.bias_act(xt, bt, dim=dim, act=act, clamp=clamp)
    assert type(y.grad_fn).__name__ == "BiasActBackward"
    gx, gb = torch.autograd.grad(y, (xt, bt), torch.from_numpy(g))
    assert_close(gx, gx_j, 1e-5)
    assert_close(gb, gb_j, 1e-5)


def test_cpu_path_launches_no_kernel(rng_np):
    x, b = _inputs(rng_np)
    before = tba.bias_act.launches
    tba.bias_act(torch.from_numpy(x), torch.from_numpy(b), act="lrelu")
    assert tba.bias_act.launches == before


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 1, 1, 1)), (2, 1, (2, 1, 2, 1)),
                                         (1, 2, (1, 1, 1, 1)), (2, 2, (2, 2, 2, 2)),
                                         (2, 1, (-1, 2, 1, -2))],
                         ids=["fir", "up", "down", "up-down", "crop"])
def test_upfirdn2d_matches_jax(rng_np, up, down, pad):
    x = rng_np.standard_normal((2, 3, 8, 8)).astype(np.float32)
    f = jup.setup_filter([1, 3, 3, 1])
    np.testing.assert_array_equal(tup.setup_filter([1, 3, 3, 1]), f)
    want = jup.upfirdn2d(jnp.asarray(x), f, up=up, down=down, padding=pad, gain=1.5)
    got = tup.upfirdn2d(torch.from_numpy(x), f, up=up, down=down, padding=pad, gain=1.5)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("fn,kw", [("upsample2d", {}), ("downsample2d", {"padding": 1}),
                                   ("filter2d", {"padding": (1, 2)})])
def test_resamplers_match_jax(rng_np, fn, kw):
    x = rng_np.standard_normal((1, 2, 6, 7)).astype(np.float32)
    f = jup.setup_filter([1, 2, 1])
    want = getattr(jup, fn)(jnp.asarray(x), f, **kw)
    got = getattr(tup, fn)(torch.from_numpy(x), torch.from_numpy(f), **kw)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("clamp", [None, 0.8])
def test_filtered_lrelu_matches_jax(rng_np, clamp):
    x = rng_np.standard_normal((1, 4, 8, 8)).astype(np.float32)
    b = rng_np.standard_normal((4,)).astype(np.float32)
    f = jup.setup_filter([1, 3, 3, 1])
    with _interpret():
        want = jfl.filtered_lrelu(jnp.asarray(x), f, f, jnp.asarray(b), up=2, down=2,
                                  clamp=clamp, impl="pallas")
    got = tfl.filtered_lrelu(torch.from_numpy(x), f, f, torch.from_numpy(b), up=2, down=2,
                             clamp=clamp)
    assert tuple(got.shape) == want.shape == (1, 4, 8, 8)
    assert_close(got, want, 1e-5)
