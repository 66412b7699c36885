"""The port's W8A8 int8 matmul (yume_tpu_torch/ops/quant_matmul.py) against
the JAX package's on the CPU: ``int8_dot_general``, ``q8_dot`` and
``q8_dequant`` on seeded numpy inputs in fp32 and bf16, inputs built to hit
exact .5 ties, and the DiT's once-quantized weights against per-call
quantization.

Tolerance: none. Both sides quantize with IEEE division and round half to
even, sum the int8 products exactly (int32 in XLA, float64 of the int8
values in the port) and rescale with the same two fp32 products, so every
comparison is ``assert_array_equal``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from yume_tpu.ops import quant_matmul as jqm
from yume_tpu_torch.models import dit as tdit
from yume_tpu_torch.ops import quant_matmul as tqm

DN = (((1,), (0,)), ((), ()))
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """One numpy array as the same values in JAX and torch."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _inputs(rng, m, k, n, ties):
    x = rng.standard_normal((m, k)).astype(np.float32) * 2.0
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    if ties:
        # absmax 127 makes the scale exactly 1, so every v + 0.5 is a tie
        x[:, 0] = 127.0
        x[:, 1:9] = np.arange(8) - 3.5
        w[0, :] = 127.0
        w[1:9, :] = (np.arange(8) - 3.5)[:, None]
        x[2] = 0.0  # an all-zero row: the 1e-8 scale floor
    return x, w


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("ties", [False, True])
def test_int8_dot_general_matches_jax(rng_np, dtype, ties):
    x, w = _inputs(rng_np, 13, 96, 40, ties)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    want = jqm.int8_dot_general(jx, jw, DN)
    got = tqm.int8_dot_general(tx, tw.t())
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_np(got), _np(want))
    if ties:
        assert np.abs(_np(want)).max() > 0  # not a vacuous all-zero product


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("out", [None, "fp32"])
def test_q8_dot_and_dequant_match_jax(rng_np, dtype, out):
    x, w = _inputs(rng_np, 2 * 7, 64, 24, ties=False)
    jx, tx = _pair(x.reshape(2, 7, 64), dtype)
    # a JAX Q8 from the weight half of int8_dot_general
    scale = np.maximum(np.abs(w).max(0, keepdims=True), 1e-8) / np.float32(127.0)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    jw = jqm.Q8(q=jnp.asarray(q), scale=jnp.asarray(scale, jnp.float32))
    tw = tqm.Q8(q=torch.from_numpy(q.T.copy()), scale=torch.from_numpy(scale[0]))
    jdt, tdt = (jnp.float32, torch.float32) if out else (None, None)
    want = jqm.q8_dot(jx, jw, jdt)
    got = tqm.q8_dot(tx, tw, tdt)
    assert got.shape == (2, 7, 24)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(tqm.q8_dequant(tw, torch.float32)).T,
                                  _np(jqm.q8_dequant(jw, jnp.float32)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_weight_matches_int8_dot_general(rng_np, dtype):
    # the weight half of int8_dot_general (per output channel), against numpy
    _, w = _inputs(rng_np, 3, 32, 16, ties=True)
    _, tw = _pair(w.T, dtype)
    q8 = tqm.quantize_weight(tw)
    scale = np.maximum(np.abs(_np(tw)).max(1), 1e-8) / np.float32(127.0)
    np.testing.assert_array_equal(q8.scale.numpy(), scale.astype(np.float32))
    np.testing.assert_array_equal(
        q8.q.numpy(), np.clip(np.round(_np(tw) / scale[:, None]), -127, 127))


def test_cached_weight_quantization_is_per_call_quantization(rng_np):
    """The DiT quantizes the concatenated q/k/v weight once and reuses it;
    that is bit for bit the per-call quantization of the reference, whole
    or per projection, and an in-place weight update is seen."""
    dim, tokens = 64, 10
    owner = nn.Module()
    layers = [nn.Linear(dim, dim) for _ in range(3)]
    def randn(*shape):
        return torch.from_numpy(rng_np.standard_normal(shape).astype(np.float32))

    with torch.no_grad():
        for lin in layers:
            lin.weight.copy_(randn(dim, dim))
            lin.bias.copy_(randn(dim))
    x = randn(1, tokens, dim)

    def per_call():
        parts = [tqm.int8_dot_general(x, lin.weight) + lin.bias for lin in layers]
        return torch.cat(parts, -1)

    with torch.no_grad():
        first = tdit._w8a8_dense(x, owner, "qkv", layers)
        cached = owner._q8_cache["qkv"][1]
        again = tdit._w8a8_dense(x, owner, "qkv", layers)
        assert owner._q8_cache["qkv"][1] is cached  # reused, not re-derived
        np.testing.assert_array_equal(first.numpy(), per_call().numpy())
        np.testing.assert_array_equal(again.numpy(), first.numpy())
        whole = torch.cat([lin.weight for lin in layers])
        np.testing.assert_array_equal(
            first.numpy(),
            (tqm.int8_dot_general(x, whole) + torch.cat([l.bias for l in layers])).numpy())
        layers[1].weight.mul_(2.0)  # in place: the cache must follow
        np.testing.assert_array_equal(
            tdit._w8a8_dense(x, owner, "qkv", layers).numpy(), per_call().numpy())
    assert owner._q8_cache["qkv"][1] is not cached


def _jax_quantize_act(a):
    """The activation quantization of JAX's q8_dot
    (yume_tpu/ops/quant_matmul.py, the lines that compute a_scale and qa)."""
    a = a.astype(jnp.float32)
    a_scale = jnp.maximum(jnp.max(jnp.abs(a), axis=-1, keepdims=True), 1e-8) / 127.0
    return jnp.clip(jnp.round(a / a_scale), -127, 127).astype(jnp.int8), a_scale


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_prepass_plain_matches_jax_quantization(rng_np, dtype):
    """K6's pre-pass (``q8_quantize`` on the CPU: its plain version) against
    JAX's: int8 rows and fp32 scales bit for bit, with a zero row (the 1e-8
    floor) and rows of exact .5 ties; then the same bits through JAX's own
    q8_dot with an identity weight (acc = qa, w_scale = 1)."""
    k = 96
    x, _ = _inputs(rng_np, 11, k, 8, ties=True)
    x[7] = 0.0
    jx, tx = _pair(x.reshape(1, 11, k), dtype)
    want_q, want_s = _jax_quantize_act(jx)
    got_q, got_s = tqm.q8_quantize(tx)
    assert got_q.dtype == torch.int8 and got_q.shape == (1, 11, k)
    assert got_s.dtype == torch.float32 and got_s.shape == (1, 11)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s)[..., 0])
    assert (got_q.numpy()[0, 7] == 0).all() and np.abs(got_q.numpy()).max() == 127
    eye = jqm.Q8(q=jnp.eye(k, dtype=jnp.int8), scale=jnp.ones((1, k), jnp.float32))
    through_jax = jqm.q8_dot(jx, eye, jnp.float32)
    np.testing.assert_array_equal(_np(got_q.float() * got_s[..., None]), _np(through_jax))


def test_cpu_path_launches_no_kernel(rng_np):
    x, w = _inputs(rng_np, 4, 32, 8, ties=False)
    before = tqm.q8_dot.launches, tqm.q8_quantize.launches
    tqm.int8_dot_general(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    tqm.q8_quantize(torch.from_numpy(x))
    assert (tqm.q8_dot.launches, tqm.q8_quantize.launches) == before
