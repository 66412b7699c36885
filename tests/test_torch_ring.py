"""K7, the partial flash attention of ring attention, and the ring merge,
against the JAX package on the CPU: the port's plain version
(:func:`plain_attention_partial`, what :func:`flash_attention_partial`
runs on CPU tensors without a gradient) and its autograd Function
against JAX's ``flash_attention_partial`` in Pallas interpret mode, as
tests/test_attention.py runs it; ``_merge_partials`` against JAX's.

fp32 inputs from numpy seeds. Tolerances: out and lse 1e-5, the merge
invariant 1e-5 (sum order only: the interpreted kernel sums its blocks in
another order than ATen's einsum), gradients 1e-4 of the largest gradient
(as the flash backward's test, tests/test_torch_flash_bwd.py). In a fully
masked block the two differ on purpose: JAX's normalized output there is
the mean of v, the port's (and its kernel's) is 0; only that both lse lie
at or below -1e38 is compared, and that the block merges to zero weight.
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
from yume_tpu.parallel import ulysses as julysses
from yume_tpu_torch.ops import flash_attention as tflash
from yume_tpu_torch.parallel import ulysses as tulysses

TOL = 1e-5
GRAD_REL = 1e-4


def _inputs(rng, b, lq, lk, n, d):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, lq, n, d), (b, lk, n, d), (b, lk, n, d))]


def _jax_partial(q, k, v, kv_len=None):
    with pltpu.force_tpu_interpret_mode():
        return jflash.flash_attention_partial(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32))


@pytest.mark.parametrize("lq,lk,kv_len", [(128, 256, None), (70, 150, (37, 150))])
def test_partial_attention_matches_pallas(rng_np, lq, lk, kv_len):
    q, k, v = _inputs(rng_np, 2, lq, lk, 2, 64)
    want_o, want_lse = _jax_partial(q, k, v, kv_len)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    got_o, got_lse = tflash.flash_attention_partial(*map(torch.from_numpy, (q, k, v)),
                                                    kv_len=tl)
    assert got_o.dtype == torch.float32 and got_lse.shape == (2, 2, lq)
    assert_close(got_o, want_o, TOL)
    assert_close(got_lse, want_lse, TOL)


def test_merge_invariant_matches_jax(rng_np):
    """Blocks merged by their lse equal attention over all keys: the
    invariant ring attention rests on; the port's merge of its partials
    against JAX's merge of its interpreted kernel's, and both against
    dense attention."""
    q, k, v = _inputs(rng_np, 1, 96, 300, 2, 32)
    cuts = (0, 128, 200, 300)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = want = None
    for a, b in zip(cuts, cuts[1:]):
        o_t, l_t = tflash.flash_attention_partial(tq, tk[:, a:b], tv[:, a:b])
        o_j, l_j = _jax_partial(q, k[:, a:b], v[:, a:b])
        got = (o_t, l_t) if got is None else tulysses._merge_partials(*got, o_t, l_t)
        want = (o_j, l_j) if want is None else julysses._merge_partials(*want, o_j, l_j)
    assert_close(got[0], want[0], TOL)
    assert_close(got[1], want[1], TOL)
    dense = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert_close(got[0], dense, TOL)


def test_fully_masked_block(rng_np):
    """kv_len 0 (a ring hop over pad tokens only): both lse at or below
    -1e38, the port's output finite and 0, and the block merges to zero
    weight."""
    q, k, v = _inputs(rng_np, 1, 64, 64, 2, 32)
    zero = np.zeros((1,), np.int32)
    _, want_lse = _jax_partial(q, k, v, zero)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o_m, l_m = tflash.flash_attention_partial(tq, tk, tv, kv_len=torch.from_numpy(zero))
    assert np.asarray(want_lse).max() <= -1e38 and l_m.max().item() <= -1e38
    assert torch.isfinite(o_m).all() and not o_m.any()
    o, lse = tflash.flash_attention_partial(tq, tk, tv)
    merged_o, merged_lse = tulysses._merge_partials(o, lse, o_m, l_m)
    assert torch.equal(merged_o, o) and torch.equal(merged_lse, lse)
    # from the ring's initial state, the masked block leaves the output 0
    init = torch.full_like(lse, tulysses._INITIAL_LSE)
    o0, _ = tulysses._merge_partials(torch.zeros_like(o), init, o_m, l_m)
    assert not o0.any()


@pytest.mark.parametrize("through", ["autograd", "function"])
def test_gradient_through_merge_matches_jax_grad(rng_np, through):
    """Gradients of q, k and v through per-block partial attention and the
    lse merge (so through both outputs of each block) against jax.grad of
    the interpreted kernel's custom VJP. ``autograd``: the plain version
    under autograd (the reference the card's VJP is held to);
    ``function``: the entry point, which goes through the autograd
    Function on both devices (its backward folds the lse cotangent into
    delta and runs the flash backward; here the plain versions stand in
    for K7, K8 and K9)."""
    q, k, v = _inputs(rng_np, 1, 64, 192, 2, 32)
    g = rng_np.standard_normal(q.shape).astype(np.float32)
    kv_len = np.asarray([150], np.int32)
    cut = 128

    def blocks(partial, merge, q, k, v, l1, l2):
        o1, s1 = partial(q, k[:, :cut], v[:, :cut], l1)
        o2, s2 = partial(q, k[:, cut:], v[:, cut:], l2)
        return merge(o1, s1, o2, s2)[0]

    def jloss(q, k, v):
        o = blocks(lambda *a: jflash.flash_attention_partial(*a[:3], kv_len=a[3]),
                   julysses._merge_partials, q, k, v,
                   jnp.asarray([cut], jnp.int32), jnp.asarray(kv_len - cut))
        return jnp.sum(o * g)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    fn = tflash.plain_attention_partial if through == "autograd" else \
        tflash.flash_attention_partial
    partial = lambda q, k, v, kl: fn(q, k, v, kv_len=kl)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = blocks(partial, tulysses._merge_partials, *leaves, torch.tensor([cut]),
               torch.from_numpy(kv_len - cut))
    got = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    for a, w in zip(got, want):
        w = to_np(w)
        np.testing.assert_allclose(to_np(a), w, atol=GRAD_REL * np.abs(w).max(), rtol=0)
    assert not got[1][:, 150:].any() and not got[2][:, 150:].any()  # masked keys
