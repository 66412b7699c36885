"""The port's quantized DiT trunk (``yume_tpu_torch/models/quantized.py``,
the int4 family of ``ops/quant_matmul.py``) and batched CFG against the JAX
package on the CPU, on weights carried across by
``utils.convert.quantized_dit_state_dict``:

* ``_quantize_leaf`` and ``_quantize_leaf4`` (the int8 fallback of a K that
  does not split into groups, a leaf too small to quantize, an all-zero
  channel), ``q4_to_q8``, ``q4_dequant``: bit for bit, on fp32 and bf16
  leaves; ``q4_dot`` and ``q8_dot`` on stored weights: equal;
* ``quantize_dit_blocks`` and ``quantize_host_blocks``: the same bits as
  JAX's and as each other; ``quantized_bytes`` as JAX counts;
* the DiT forward on a quantized trunk against ``int8_dit_apply`` at the
  reference's 5B and 14B smoke configs, packed and unpacked, Q8 and Q4,
  with W8A8 and without, and its delta cache (``cache_edge`` with
  ``return_cache`` and ``block_cache``);
* the pipelines' samplers on a quantized trunk, on JAX's noise: TI2V's
  euler and teacache (fixed and adaptive) segments, t2v Euler and UniPC
  with CFG; I2V's CFG Euler, teacache, tts and ``cfg_parallel``;
* ``batched_cfg`` against JAX's and against the unbatched port.

fp32 compute. Tolerances: the quantization and the relay are exact (the
same bits); ``q8_dot``/``q4_dot`` and each block projection on the same
input equal (exact integer sums); one forward on the dequantized trunk
1e-4 (float32 sums in another order on XLA:CPU and ATen, as
``test_torch_dit.py``), its bf16 delta cache one bf16 step of its
magnitude; latents 1e-4 and videos 1e-3 (``test_torch_pipeline.py``), a
TeaCache segment 2e-3 (a residual a last bit apart rounds to the
neighbouring bf16 value, carried through the guidance scale, as
``test_torch_i2v.py`` sets out); the toy CFG samplers 1e-5 and the batched
against the unbatched port 1e-5 (the toy model is batch-independent
elementwise arithmetic).

W8A8 forwards: a relative L2 of 2e-2. Those 1e-7 differences upstream move
an activation across an int8 rounding boundary now and then, and one code
moves its row of the product by ``a_scale · |w|``: one such flip in block
1's ``ffn.2`` of the 14B smoke trunk moved the output by 7.9e-3, and the
forwards here differ by up to 8.5e-3 relative L2 (int4, unpacked), while
a wrong scale or code layout moves them by O(1). The stored-weight
products themselves are held bit for bit above.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_i2v import _t
from test_torch_pipeline import _params
from test_torch_sample_cli import _jax_smoke_config, _jax_smoke_config_14b
from torch_parity import assert_close, port_config, rel_l2, torch_threads
from yume_tpu.diffusion import samplers as jsamplers
from yume_tpu.models import quantized as jq
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.ops import quant_matmul as jqm
from yume_tpu_torch.diffusion import samplers as tsamplers
from yume_tpu_torch.diffusion.schedule import sampling_sigmas
from yume_tpu_torch.models import quantized as tq
from yume_tpu_torch.models.dit import QLinear, WanDiT
from yume_tpu_torch.ops import quant_matmul as tqm
from yume_tpu_torch.utils import convert

TOL, VIDEO_TOL, STEP_TOL, TOY_TOL = 1e-4, 1e-3, 2e-3, 1e-5
W8A8_REL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with torch_threads(2):
        yield


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _leaf(shape, dtype, seed):
    """A [K, N] JAX kernel and the port's [N, K] weight, one channel zero."""
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    if dtype == "bf16":
        j, t = _bf16(w)
    else:
        j, t = jnp.asarray(w), torch.from_numpy(w)
    return j, t.t().contiguous()


def _port_q(leaf):
    """A JAX Q8/Q4 kernel in the port's layout."""
    return convert._Stored(leaf.q, leaf.scale).port("w")


# -- the leaves ----------------------------------------------------------------------

# [K, N]: three groups of 128; K = 200, no whole groups (int4 falls back to
# int8); one group; too small to quantize
SHAPES = [(384, 256), (200, 128), (128, 192), (64, 256)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_leaf_matches_jax(bits, dtype):
    jfn, tfn = {8: (jq._quantize_leaf, tq._quantize_leaf),
                4: (jq._quantize_leaf4, tq._quantize_leaf4)}[bits]
    kinds = []
    for i, shape in enumerate(SHAPES):
        jw, tw = _leaf(shape, dtype, 10 + i)
        want, got = jfn(jw), tfn(tw)
        kinds.append(type(got).__name__)
        if isinstance(got, torch.Tensor):
            assert got is tw and not isinstance(want, (jqm.Q8, jqm.Q4))
            continue
        assert type(got).__name__ == type(want).__name__, shape
        ref = _port_q(want)
        assert got.q.dtype == torch.from_numpy(ref["w.q"]).dtype
        np.testing.assert_array_equal(got.q.numpy(), ref["w.q"], err_msg=str(shape))
        np.testing.assert_array_equal(got.scale.numpy(), ref["w.scale"], err_msg=str(shape))
        assert (got.scale == 0).any()                      # the zero channel
        assert_close(QLinear(got, torch.zeros(shape[1])).dequant(torch.float32).t(),
                     jq._dequantize_leaf(want, jnp.float32), 0.0)
    assert kinds == ({8: ["Q8", "Q8", "Q8", "Tensor"],
                      4: ["Q4", "Q8", "Q4", "Tensor"]}[bits])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_q4_relay_and_products_match_jax(dtype):
    """``q4_to_q8`` bit for bit (the zero channel relays to zeros), and the
    stored-weight products ``q4_dot`` and ``q8_dot`` on the same x."""
    jw, tw = _leaf((384, 256), dtype, 20)
    j4, t4 = jq._quantize_leaf4(jw), tq._quantize_leaf4(tw)
    want, got = jqm.q4_to_q8(j4), tqm.q4_to_q8(t4)
    ref = _port_q(want)
    np.testing.assert_array_equal(got.q.numpy(), ref["w.q"])
    np.testing.assert_array_equal(got.scale.numpy(), ref["w.scale"])
    assert (got.q[3] == 0).all() and got.scale[3] == 0
    assert_close(tqm.q4_dequant(t4, torch.float32).t(), jqm.q4_dequant(j4, jnp.float32), 0.0)
    x = np.random.default_rng(21).standard_normal((2, 7, 384)).astype(np.float32)
    assert_close(tqm.q4_dot(torch.from_numpy(x), t4), jqm.q4_dot(jnp.asarray(x), j4), 0.0)
    j8, t8 = jq._quantize_leaf(jw), tq._quantize_leaf(tw)
    assert_close(tqm.q8_dot(torch.from_numpy(x), t8), jqm.q8_dot(jnp.asarray(x), j8), 0.0)


# -- the trunk -----------------------------------------------------------------------

CONFIGS = {"5b": _jax_smoke_config, "14b": _jax_smoke_config_14b}


def _model_inputs(c, seed):
    rng = np.random.default_rng(seed)
    d = c.dit
    x = rng.standard_normal((1, 5, 8, 8, d.in_dim)).astype(np.float32)
    t = np.array([[0.0, 0.0, 0.0, 700.0, 700.0]], np.float32)
    ctx = rng.standard_normal((1, d.text_len, d.text_dim)).astype(np.float32)
    clip = (rng.standard_normal((1, d.image_context_len, d.image_dim)).astype(np.float32)
            if d.image_context_len else None)
    return x, t, ctx, clip


@pytest.fixture(scope="module")
def trunks():
    """Per smoke config: the JAX DiT's perturbed parameters, and per bits
    JAX's quantized trunk (``quantize_dit_blocks``) with the port's from
    the converted state dict, without and with W8A8."""
    out = {}
    for name, make in CONFIGS.items():
        c = make()
        x, t, ctx, clip = _model_inputs(c, 30)
        dit = JaxDiT(c.dit, dtype=jnp.float32)
        params = _params(dit, 31, x, t, ctx, packed=False,
                         **({"clip_context": clip} if clip is not None else {}))
        q = {}
        for bits in (8, 4):
            other, stacked = jq.quantize_dit_blocks(params, c.dit.num_layers, bits=bits)
            sd = convert.quantized_dit_state_dict(other, stacked, c.dit.num_layers)
            q[bits] = (other, stacked, {w8a8: _port_trunk(c, sd, bits, w8a8)
                                        for w8a8 in (False, True)})
        out[name] = (c, params, q)
    return out


def _port_trunk(c, sd, bits, w8a8, param_dtype=torch.float32):
    cfg = dataclasses.replace(port_config(c.dit), w8a8=w8a8)
    return tq.quantized_dit_from_state_dict(cfg, sd, bits, device="cpu", dtype=torch.float32,
                                            param_dtype=param_dtype)


def _port_dense(c, params):
    dit = WanDiT(port_config(c.dit), torch.float32, device="meta").to_empty(device="cpu")
    convert.load_state_dict(dit, convert.dit_state_dict(params, c.dit.num_layers))
    return dit.eval()


def _buffers_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_quantize_dit_blocks_matches_jax(trunks, config, bits):
    """The port quantizing its own trunk gives JAX's bits (every block
    projection a QLinear of the right kind, self-attention q, k and v one
    ``qkv``); ``quantize_host_blocks`` from
    the state dict casts to bf16 first, as JAX's does, and equals the
    port's ``quantize_dit_blocks`` of the bf16 trunk and JAX's
    ``quantize_host_blocks``; ``quantized_bytes`` as JAX counts."""
    c, params, q = trunks[config]
    other, stacked, tdits = q[bits]
    mine = tq.quantize_dit_blocks(_port_dense(c, params), bits)
    _buffers_equal(mine, tdits[False])
    kinds = {type(m.stored).__name__ for m in mine.modules() if isinstance(m, QLinear)}
    assert kinds == {"Q8" if bits == 8 else "Q4"}
    n_proj = 10 if c.dit.image_context_len else 8      # qkv as one; + k_img, v_img
    assert sum(isinstance(m, QLinear) for m in mine.modules()) == n_proj * c.dit.num_layers
    assert tq.quantized_bytes(mine) == tuple(int(v) for v in jq.quantized_bytes(stacked))

    sd = convert.dit_state_dict(params, c.dit.num_layers)
    host = tq.quantize_host_blocks(port_config(c.dit), bits, state_dict=sd, device="cpu",
                                   dtype=torch.float32)
    bf16 = WanDiT(port_config(c.dit), torch.float32, device="meta",
                  param_dtype=torch.bfloat16).to_empty(device="cpu")
    convert.load_state_dict(bf16, sd)
    _buffers_equal(host, tq.quantize_dit_blocks(bf16, bits))
    j_host = jq.quantize_host_blocks(params, c.dit.num_layers, bits)
    want = _port_trunk(c, convert.quantized_dit_state_dict(*j_host, c.dit.num_layers), bits,
                       False, torch.bfloat16)
    _buffers_equal(host, want)


def _j_apply(c, other, stacked, x, t, ctx, clip, w8a8, **kw):
    cfg = dataclasses.replace(c.dit, w8a8=w8a8)
    extra = {"clip_context": jnp.asarray(clip)} if clip is not None else {}
    return jq.int8_dit_apply(JaxDiT(cfg, dtype=jnp.float32), other, stacked, jnp.asarray(x),
                             jnp.asarray(t), jnp.asarray(ctx), latent_frame_zero=2,
                             **extra, **kw)


def _t_apply(tdit, x, t, ctx, clip, **kw):
    with torch.no_grad():
        return tdit(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                    latent_frame_zero=2,
                    clip_context=None if clip is None else torch.from_numpy(clip), **kw)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_int8_dit_apply_matches_jax(trunks, config, bits, w8a8, packed):
    c, _, q = trunks[config]
    other, stacked, tdits = q[bits]
    x, t, ctx, clip = _model_inputs(c, 32)
    want = _j_apply(c, other, stacked, x, t, ctx, clip, w8a8, packed=packed)
    calls = tqm.quantize_weight.calls
    got = _t_apply(tdits[w8a8], x, t, ctx, clip, packed=packed)
    assert tqm.quantize_weight.calls == calls        # stored weights, never re-derived
    assert got.shape == want.shape == ((1, 2, 8, 8, c.dit.out_dim) if packed
                                       else (1, 5, 8, 8, c.dit.out_dim))
    assert np.abs(np.asarray(want)).max() > 1e-2
    _check(got, want, w8a8)


def _check(got, want, w8a8, tol=TOL):
    if w8a8:
        assert rel_l2(got, want) <= W8A8_REL
    else:
        assert_close(got, want, tol)


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_int8_dit_apply_delta_cache_matches_jax(trunks, config, bits, w8a8):
    """A 4-layer trunk: ``return_cache`` (the delta entering block 3 minus
    entering block 1, bf16) and ``block_cache`` (blocks 0 and 3 with the
    delta added before block 3), at ``cache_edge`` 1, the port's forward
    against JAX's ``int8_dit_apply``."""
    c, _, _ = trunks[config]
    c = dataclasses.replace(c, dit=dataclasses.replace(c.dit, num_layers=4))
    x, t, ctx, clip = _model_inputs(c, 33)
    params = _params(JaxDiT(c.dit, dtype=jnp.float32), 34, x, t, ctx, packed=False,
                     **({"clip_context": clip} if clip is not None else {}))
    other, stacked = jq.quantize_dit_blocks(params, 4, bits=bits)
    tdit = _port_trunk(c, convert.quantized_dit_state_dict(other, stacked, 4), bits, w8a8)
    want, want_cache = _j_apply(c, other, stacked, x, t, ctx, clip, w8a8, return_cache=True,
                                cache_edge=1)
    got, got_cache = _t_apply(tdit, x, t, ctx, clip, return_cache=True, cache_edge=1)
    assert got_cache.dtype == torch.bfloat16 and got_cache.shape == want_cache.shape
    _check(got, want, w8a8)
    _check(got_cache, want_cache, w8a8,
           2.0 ** -8 * float(np.abs(np.asarray(want_cache, np.float32)).max()))
    delta = 0.1 * np.random.default_rng(35).standard_normal(want_cache.shape)
    jd, td = _bf16(delta.astype(np.float32))
    want = _j_apply(c, other, stacked, x, t, ctx, clip, w8a8, block_cache=jd, cache_edge=1)
    got = _t_apply(tdit, x, t, ctx, clip, block_cache=td, cache_edge=1)
    _check(got, want, w8a8)


# -- batched CFG -------------------------------------------------------------------


def _toy_v(x, t_frame, ctx, lib):
    """A batch-independent toy velocity: each sample sees its own context."""
    s = t_frame.reshape(t_frame.shape + (1,) * (x.ndim - t_frame.ndim)) / 1000.0
    c = ctx.mean(-1).reshape((-1,) + (1,) * (x.ndim - 1))
    return x * (0.3 + 0.5 * s) + 0.1 * lib.sin(3.0 * x) + 0.2 * c


def test_batched_cfg_matches_jax_and_the_unbatched_port():
    rng = np.random.default_rng(36)
    lat, noise = (rng.standard_normal((2, 5, 4, 4, 8)).astype(np.float32) for _ in range(2))
    ctx, ctx_null = (rng.standard_normal((2, 3)).astype(np.float32) for _ in range(2))
    sig = sampling_sigmas(4, 3.0)
    calls = []

    def t_fn(x, t, k):
        calls.append(x.shape[0])
        return _toy_v(x, t, k, torch)

    want = jsamplers.cfg_euler_sample_segment(
        lambda x, t, k: _toy_v(x, t, k, jnp), jnp.asarray(lat), jnp.asarray(noise),
        jnp.asarray(ctx), jnp.asarray(ctx_null), sig, 2, 5.0, batched_cfg=True)
    got = tsamplers.cfg_euler_sample_segment(t_fn, _t(lat), _t(noise), _t(ctx), _t(ctx_null),
                                             sig, 2, 5.0, batched_cfg=True)
    assert calls == [4] * 4                  # one batch-2B forward a step
    unbatched = tsamplers.cfg_euler_sample_segment(
        lambda x, t, k: _toy_v(x, t, k, torch), _t(lat), _t(noise), _t(ctx), _t(ctx_null),
        sig, 2, 5.0)
    assert_close(got, want, TOY_TOL)
    assert_close(got, unbatched, TOY_TOL)
