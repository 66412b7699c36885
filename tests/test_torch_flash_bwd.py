"""The port's attention and glue-kernel gradients against the JAX package on
the CPU.

* :func:`plain_attention_bwd` (the plain version of K8/K9) against the VJP
  of the reference's Pallas ``flash_attention`` run in interpret mode, as
  tests/test_attention.py runs it, with and without ``kv_len``, at ragged
  lengths; and the CPU autograd of ``attention`` against ``jax.grad`` of
  ``xla_attention``.
* The glue ops K2–K5 (their plain versions under autograd, and the
  ``_Recompute`` Function the card's kernels go through) against
  ``jax.vjp`` of the JAX fallbacks, including the gradients of the
  modulation tables, norm weights and (batched) RoPE tables.

fp32 inputs from numpy seeds. Tolerances: 1e-4 of the largest gradient for
attention (the interpreted kernel sums its blocks in another order than
ATen's einsum), 1e-5 absolute for the glue ops (same formulas, sum order
only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import assert_close, to_np
from yume_tpu.ops import attention as jattn
from yume_tpu.ops import flash_attention as jflash
from yume_tpu.ops import fused_adaln as jfused
from yume_tpu_torch.ops import attention as tattn
from yume_tpu_torch.ops import flash_attention as tflash
from yume_tpu_torch.ops import fused_adaln as tfused
from yume_tpu_torch.ops import rope as trope

ATTN_REL = 1e-4
GLUE_TOL = 1e-5


def _rel_close(got, want, rel):
    want = to_np(want)
    np.testing.assert_allclose(to_np(got), want, atol=rel * np.abs(want).max(), rtol=0)


def _attn_inputs(rng, b, lq, lk, n, d):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, lq, n, d), (b, lk, n, d), (b, lk, n, d), (b, lq, n, d))]


@pytest.mark.parametrize("lq,lk,kv_len,d", [
    pytest.param(100, 150, None, 64, id="100-150-None"),
    pytest.param(70, 200, (37, 200), 64, id="70-200-kv_len1"),
    # either side of the kernels' 64- and 128-row tiles
    pytest.param(129, 127, None, 64, id="129-127-None"),
    # a batch with no live key: the reference's finite mask value spreads
    # its softmax over the masked keys, the port (like K1) gives out 0,
    # lse MASKED_LSE and zero gradients; only the live batch is compared
    pytest.param(65, 64, (0, 64), 64, id="65-64-kv_len0"),
    pytest.param(63, 65, (50, 65), 16, id="63-65-d16"),
    pytest.param(64, 129, (100, 129), 128, id="64-129-d128"),
])
def test_plain_attention_bwd_matches_pallas_vjp(rng_np, lq, lk, kv_len, d):
    q, k, v, g = _attn_inputs(rng_np, 2, lq, lk, 2, d)
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda *a: jflash.flash_attention(*a, kv_len=jl),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    live = [i for i in range(2) if kv_len is None or kv_len[i] > 0]
    if len(live) < 2:  # the kernel's forward on an empty batch
        out, lse = tflash.plain_attention_partial(tq, tk, tv, kv_len=tl)
    else:
        out, lse = tflash.plain_attention(tq, tk, tv, kv_len=tl, return_lse=True)
    got = tflash.plain_attention_bwd(tq, tk, tv, out, lse, tg, kv_len=tl)
    for a, w in zip(got, want):
        _rel_close(a[live], np.asarray(w)[live], ATTN_REL)
    if kv_len is not None:  # masked keys get exactly zero gradient
        for i, n_live in enumerate(kv_len):
            assert not got[1][i, n_live:].any() and not got[2][i, n_live:].any()
            if n_live == 0:  # and a query with no live key zero dq
                assert not got[0][i].any()
    # the split wrappers (K8 and K9 on the card) give the same on the CPU
    delta = tflash.attention_delta(out, tg)
    assert torch.equal(tflash.flash_attention_bwd_dq(tq, tk, tv, tg, lse, delta, kv_len=tl),
                       got[0])
    for a, w in zip(tflash.flash_attention_bwd_dkv(tq, tk, tv, tg, lse, delta, kv_len=tl),
                    got[1:]):
        assert torch.equal(a, w)


@pytest.mark.parametrize("kv_len", [None, (5, 9)])
def test_attention_autograd_matches_jax_grad(rng_np, kv_len):
    q, k, v, _ = _attn_inputs(rng_np, 2, 7, 9, 3, 16)
    g = rng_np.standard_normal((2, 7, 3, 16)).astype(np.float32)
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    want = jax.grad(lambda *a: jnp.sum(jattn.xla_attention(*a, kv_len=jl) * g),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tattn.attention(*leaves, kv_len=tl)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, w in zip(got, want):
        assert_close(a, w, GLUE_TOL)


# ---------------------------------------------------------------------------
# glue ops K2–K5
# ---------------------------------------------------------------------------


def _glue(rng, b=2, l=10, d=64, k=2):
    x = rng.standard_normal((b, l, d)).astype(np.float32) * 2 + 0.5
    y = rng.standard_normal((b, l, d)).astype(np.float32)
    s = rng.standard_normal((b, k, d)).astype(np.float32) * 0.1
    t = rng.standard_normal((b, k, d)).astype(np.float32) * 0.1
    idx = rng.integers(0, k, (b, l)).astype(np.int32)
    return x, y, s, t, idx


def _cases(rng):
    """(name, port plain version, JAX fallback, its float inputs); the
    integer index and static arguments are bound in."""
    x, y, s, t, idx = _glue(rng)
    w = 1.0 + s[0, 0]
    cos, sin = trope.grid_rope(2, 2, 3, 16)
    bcos = np.ascontiguousarray(np.stack([cos, cos[::-1]]))
    bsin = np.ascontiguousarray(np.stack([sin, sin[::-1]]))
    q = rng.standard_normal((2, 12, 64)).astype(np.float32)
    kk = rng.standard_normal((2, 12, 64)).astype(np.float32)
    ti, ji = torch.from_numpy(idx), jnp.asarray(idx)
    return [
        ("adaln_norm",
         lambda *a: tfused._adaln_norm_f32(*a, ti, 1e-6, 1.0, torch.float32),
         lambda *a: jfused._adaln_norm_ref(*a, ji, 1e-6, 1.0, jnp.float32),
         (x, s, t)),
        ("adaln_norm affine",
         lambda *a: tfused._adaln_norm_f32(*a, None, 1e-6, 0.0, torch.float32),
         lambda *a: jfused._adaln_norm_ref(*a, None, 1e-6, 0.0, jnp.float32),
         (x, s[:1, :1] + 1.0, t[:1, :1])),
        ("adaln_residual", lambda *a: tfused._adaln_residual_f32(*a, ti),
         lambda *a: jfused._adaln_residual_ref(*a, ji), (x, y, s)),
        ("rms_norm", lambda a, b_: tfused._rms_ref(a, b_, 1e-6),
         lambda a, b_: jfused._rms_ref(a, b_, 1e-6), (x, w)),
        ("qk_norm_rope", lambda *a: tfused._qk_norm_rope_ref(*a, 4, 1e-6),
         lambda *a: jfused._qk_norm_rope_ref(*a, 4, 1e-6),
         (q, kk, w, 1.0 + t[0, 0], cos, sin)),
        ("qk_norm_rope batched tables", lambda *a: tfused._qk_norm_rope_ref(*a, 4, 1e-6),
         lambda *a: jfused._qk_norm_rope_ref(*a, 4, 1e-6),
         (q, kk, w, 1.0 + t[0, 0], bcos, bsin)),
    ]


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("through", ["autograd", "recompute"])
def test_glue_gradients_match_jax_vjp(rng_np, case, through):
    name, port, ref, inputs = _cases(rng_np)[case]
    outs_j, vjp = jax.vjp(ref, *map(jnp.asarray, inputs))
    outs_j = outs_j if isinstance(outs_j, tuple) else (outs_j,)
    cots = [rng_np.standard_normal(o.shape).astype(np.float32) for o in outs_j]
    want = vjp(tuple(map(jnp.asarray, cots)) if len(cots) > 1 else jnp.asarray(cots[0]))
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in inputs]
    if through == "autograd":
        outs = port(*leaves)
    else:
        # the Function the card's kernels go through, with the plain version
        # standing in for the launch (there is no kernel on the CPU)
        outs = tfused._Recompute.apply(lambda *a: tuple(o.detach() for o in _tup(port(*a)))
                                       if len(cots) > 1 else port(*a).detach(),
                                       port, len(leaves), *leaves)
    outs = _tup(outs)
    got = torch.autograd.grad(outs, leaves, [torch.from_numpy(c) for c in cots])
    for a, w in zip(got, want):
        assert_close(a, w, GLUE_TOL)


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def test_glue_ops_keep_the_graph_on_the_cpu(rng_np):
    x, y, s, _, idx = _glue(rng_np)
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    out = tfused.adaln_residual(tx, torch.from_numpy(y), ts, torch.from_numpy(idx))
    assert out.grad_fn is not None
    out.sum().backward()
    assert tx.grad is not None and ts.grad.abs().sum() > 0
