"""The flash-attention backward kernels K8 (dQ) and K9 (dK, dV) against
:func:`plain_attention_bwd` on the card: head dims 16, 64 and 128, batch > 1, q and
kv lengths that are not multiples of 64, Lk < 64, kv_len including 0, a
non-contiguous dout, the gradients of the ``attention`` autograd path, and
K7's VJP (``flash_attention_partial``) with a cotangent on its lse. Then the
tiles of the Hopper kernels (K8: 128 q rows a CTA, 64-key K/V tiles; K9: 128
kv rows a CTA, 64-row q tiles): lengths either side of 64,
128 and 192 at every head dim, kv_len inside the last kv tile, at 0 and at
Lk, Lq = 2,805 (an lse/delta row that is no multiple of 16 bytes), the 5B
trainer's grid (24 heads, more CTAs than SMs), strided q/k/v views, the
cross-attention shape, and the 14B trainer's 40 heads, self and over the
257 CLIP keys; each case runs three times and must be bit-identical.

Tolerance: the kernels round P and dS to bf16 before their tensor-core
products and write bf16; the plain version computes in fp32 from the same
bf16 inputs. For N(0, 1) inputs and dout the gradients are O(1)–O(10), so
the bound is relative: 2e-2 × max |plain| per output (about 3 bf16 ulps of
the largest entry).
"""

import pytest
import torch

from yume_tpu_torch.ops import attention as attn
from yume_tpu_torch.ops.flash_attention import (attention_delta, flash_attention,
                                                flash_attention_bwd,
                                                flash_attention_bwd_dkv,
                                                flash_attention_bwd_dq,
                                                flash_attention_partial,
                                                plain_attention_bwd,
                                                plain_attention_partial)

pytestmark = pytest.mark.cuda

REL_TOL = 2e-2


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.fixture
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(0)


def _close(got, want):
    tol = REL_TOL * want.float().abs().max().item() + 1e-6
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("b,lq,lk,n,d,kv_len", [
    (1, 64, 64, 1, 128, None),
    (2, 65, 130, 3, 64, (77, 130)),
    (1, 200, 37, 2, 128, None),          # Lk < 64
    (2, 127, 513, 4, 128, (1, 500)),
    (3, 64, 100, 2, 128, (0, 100, 37)),  # a batch with no live key
    (1, 53, 70, 4, 16, None),
    (2, 90, 45, 2, 64, (45, 20)),
])
def test_flash_bwd_edges(gen, b, lq, lk, n, d, kv_len):
    q, k, v = _randn(gen, b, lq, n, d), _randn(gen, b, lk, n, d), _randn(gen, b, lk, n, d)
    dout = _randn(gen, b, lq, n, d)
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out, lse = flash_attention(q, k, v, kv_len=kl, return_lse=True)
    before = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, out, lse, dout, kv_len=kl)
    assert (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = plain_attention_bwd(q, k, v, out, lse, dout, kv_len=kl)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _close(g, w)
    if kv_len is not None:
        for i, n_live in enumerate(kv_len):
            # masked keys get zero gradient; a query with no key gets zero dq
            if n_live < lk:
                assert got[1][i, n_live:].abs().max().item() == 0.0
                assert got[2][i, n_live:].abs().max().item() == 0.0
            if n_live == 0:
                assert got[0][i].abs().max().item() == 0.0


def test_flash_bwd_strided_dout_and_delta(gen):
    b, l, n, d = 2, 97, 4, 128
    q, k, v = _randn(gen, b, l, n, d), _randn(gen, b, l, n, d), _randn(gen, b, l, n, d)
    out, lse = flash_attention(q, k, v, return_lse=True)
    # dout as a view into a wider buffer: strided, not contiguous
    dout = _randn(gen, b, l, 2, n, d)[:, :, 1]
    assert not dout.is_contiguous()
    delta = attention_delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta)
    want = plain_attention_bwd(q, k, v, out, lse, dout.contiguous())
    for g, w in zip((dq, dk, dv), want):
        _close(g, w)


@pytest.mark.parametrize("kv_len", [None, (300,)])
def test_attention_autograd_uses_the_kernels(gen, kv_len):
    b, lq, lk, n, d = 1, 150, 300, 2, 128
    q, k, v = (_randn(gen, b, lq, n, d), _randn(gen, b, lk, n, d), _randn(gen, b, lk, n, d))
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    g = _randn(gen, b, lq, n, d)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention_bwd_dq.launches
    out = attn.attention(*leaves, kv_len=kl)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    assert flash_attention_bwd_dq.launches == before + 1
    _, lse = flash_attention(q, k, v, kv_len=kl, return_lse=True)
    want = plain_attention_bwd(q, k, v, out.detach(), lse, g, kv_len=kl)
    for a, w in zip(got, want):
        _close(a, w)


def test_lse_output_refuses_gradients(gen):
    q = _randn(gen, 1, 8, 2, 64).requires_grad_()
    with pytest.raises(ValueError, match="flash_attention_partial"):
        flash_attention(q, q, q, return_lse=True)


@pytest.mark.parametrize("kv_len", [None, (1, 90)])
def test_partial_attention_vjp_with_dlse(gen, kv_len):
    """K7 under autograd: the backward folds the lse cotangent into delta
    and launches K8 and K9; the gradients equal the plain version's under
    autograd from the same bf16 inputs."""
    b, lq, lk, n, d = 2, 150, 90, 2, 128
    q, k, v = (_randn(gen, b, lq, n, d), _randn(gen, b, lk, n, d), _randn(gen, b, lk, n, d))
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    dout, dlse = _randn(gen, b, lq, n, d), torch.randn((b, n, lq), generator=gen, device="cuda")
    grads = []
    for fn in (flash_attention_partial, plain_attention_partial):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = flash_attention_partial.launches, flash_attention_bwd_dq.launches
        out, lse = fn(*leaves, kv_len=kl)
        grads.append(torch.autograd.grad((out, lse), leaves, (dout, dlse)))
        kernel = fn is flash_attention_partial
        assert (flash_attention_partial.launches, flash_attention_bwd_dq.launches) == (
            before[0] + kernel, before[1] + kernel)
    for g, w in zip(*grads):
        _close(g, w)


def _inputs(gen, b, lq, lk, n, d, kv_len=None, strided=False):
    if strided:  # [B, N, L, D] tensors seen as [B, L, N, D]
        q, k, v = (_randn(gen, b, n, l, d).transpose(1, 2) for l in (lq, lk, lk))
    else:
        q, k, v = _randn(gen, b, lq, n, d), _randn(gen, b, lk, n, d), _randn(gen, b, lk, n, d)
    dout = _randn(gen, b, lq, n, d)
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out, lse = flash_attention(q, k, v, kv_len=kl, return_lse=True)
    return q, k, v, dout, kl, out, lse


def _check_three_runs(q, k, v, dout, kl, out, lse):
    """K8 and K9 three times (bit-identical) against the plain version."""
    delta = attention_delta(out, dout)
    runs = []
    for _ in range(3):
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_len=kl)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_len=kl)
        runs.append((dq, dk, dv))
    for again in runs[1:]:
        for a, b in zip(runs[0], again):
            assert torch.equal(a, b)
    want = plain_attention_bwd(q, k, v, out, lse, dout, kv_len=kl)
    for g, w in zip(runs[0], want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _close(g, w)
    return runs[0]


_TILE_EDGES = [(63, 65), (64, 64), (65, 63), (127, 129), (128, 128), (129, 127),
               (191, 193), (192, 192), (193, 191)]


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("lq,lk", _TILE_EDGES)
def test_flash_bwd_tile_edges(gen, lq, lk, d):
    _check_three_runs(*_inputs(gen, 2, lq, lk, 2, d))


@pytest.mark.parametrize("lq,lk,d,kv_len", [
    (129, 193, 128, (150, 193)),    # kv_len inside K8's last key tile and K9's last CTA
    (129, 193, 64, (100, 193)),     # K9's second CTA lies wholly past kv_len
    (65, 127, 64, (0, 127)),        # no live key; kv_len = Lk
    (191, 63, 16, (63, 1)),
])
def test_flash_bwd_kv_len_edges(gen, lq, lk, d, kv_len):
    q, k, v, dout, kl, out, lse = _inputs(gen, 2, lq, lk, 3, d, kv_len)
    dq, dk, dv = _check_three_runs(q, k, v, dout, kl, out, lse)
    for i, n_live in enumerate(kv_len):
        assert not dk[i, n_live:].any() and not dv[i, n_live:].any()
        if n_live == 0:
            assert not dq[i].any()


@pytest.mark.parametrize("case,b,lq,lk,n,kv_len,strided", [
    ("odd lse/delta pitch", 1, 2805, 300, 2, None, False),
    ("5B trainer grid", 1, 2805, 2805, 24, None, False),
    ("cross Lk=512", 1, 2805, 512, 24, None, False),
    ("strided q, k, v", 2, 300, 257, 4, (257, 100), True),
    # the 14B trainer: 40 heads at its width, and the 257 CLIP keys, whose
    # last 128-key tile holds one live key
    ("14B width, 40 heads", 1, 2805, 2805, 40, None, False),
    ("CLIP keys Lk=257, 40 heads", 1, 2805, 257, 40, None, False),
])
def test_flash_bwd_trainer_shapes(gen, case, b, lq, lk, n, kv_len, strided):
    q, k, v, dout, kl, out, lse = _inputs(gen, b, lq, lk, n, 128, kv_len, strided)
    if strided:
        assert not q.is_contiguous() and not k.is_contiguous()
    _check_three_runs(q, k, v, dout, kl, out, lse)
