"""The port's hand-written kernels against their plain PyTorch versions on
the card, at the edge cases the main path does not reach: ragged q and kv
lengths, per-batch kv_len (including 0), strided views, head dim 64, batch
> 1 with per-batch modulation tables, and the wrappers' input checks; the
partial attention K7 (ring attention's block) at ragged Lq and Lk, kv_len
0, 1 and Lk, head dims 16, 64 and 128, and a q that is a strided view, as
an all-to-all's output may be. The forward's tiling edges: Lq and Lk
either side of its 128-row q block and 128-key tile, kv_len either side of
a tile and 0, every head dim, the full 5B grid, the W8A8 split's v view
and a V that exposes a wrong P-register layout, each run three times and
bit-identical between runs. K4 (qk_norm_rope) at the W8A8 block's qkv
views, views that are not 16-byte aligned, B > 1 with per-sample tables,
odd L and L = 0, the 14B width and D = 16,384, head dims whose cos/sin
index is or is not constant per lane, and every dtype. K2 (adaln_norm)
at the 14B width, with staged and unstaged tables (per-batch, a large K),
rows of mean 100, every admitted dtype pair, misaligned rows, odd D and
L = 0, and the unpacked t2v stream's K = 31 tables for K2 and K3.

Tolerances: flash attention 2e-2 max-abs for N(0, 1) bf16 inputs against
the fp32 plain version; the glue kernels one bf16 ulp of the output
magnitude (2^-7 × max |plain|), since both sides compute in fp32 and round
once.
"""

import pytest
import torch

from yume_tpu_torch.ops import fused_adaln as fa
from yume_tpu_torch.ops.flash_attention import (MASKED_LSE, flash_attention,
                                                flash_attention_partial, plain_attention,
                                                plain_attention_partial)

pytestmark = pytest.mark.cuda

K1_TOL = 2e-2
GLUE_REL_TOL = 2.0 ** -7


def _randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


@pytest.fixture
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(0)


@pytest.mark.parametrize("b,lq,lk,n,d,kv_len", [
    (1, 1, 1, 1, 128, None),
    (2, 65, 130, 3, 64, (77, 130)),
    (1, 200, 64, 2, 128, (64,)),
    (2, 127, 513, 4, 128, (1, 500)),
    (3, 64, 100, 2, 128, (0, 100, 37)),
])
def test_flash_attention_edges(gen, b, lq, lk, n, d, kv_len):
    q = _randn(gen, b, lq, n, d)
    k = _randn(gen, b, lk, n, d)
    v = _randn(gen, b, lk, n, d)
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out, lse = flash_attention(q, k, v, kv_len=kl, return_lse=True)
    want, want_lse = plain_attention(q, k, v, kv_len=kl, return_lse=True)
    live = [i for i in range(b) if kv_len is None or kv_len[i] > 0]
    err = (out[live].float() - want[live].float()).abs().max().item()
    assert err <= K1_TOL, err
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-3, rtol=1e-3)
    for i in set(range(b)) - set(live):  # every key masked: output 0
        assert out[i].abs().max().item() == 0.0


def test_flash_attention_strided_views(gen):
    # q/k/v as views into one packed [B, L, 3, N, D] projection
    qkv = _randn(gen, 2, 97, 3, 4, 128)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    err = (flash_attention(q, k, v).float() - plain_attention(q, k, v).float()).abs().max()
    assert err.item() <= K1_TOL


def _fwd_repeated(q, k, v, kl=None):
    """flash_attention's (out, lse) three times: the runs must agree bit
    for bit (no atomics, no order that changes between launches)."""
    runs = [flash_attention(q, k, v, kv_len=kl, return_lse=True) for _ in range(3)]
    for out, lse in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])
    return runs[0]


def _check_fwd(out, lse, want, want_lse, rows=None):
    rows = slice(None) if rows is None else rows
    err = (out[rows].float() - want[rows].float()).abs().max().item()
    assert err <= K1_TOL, err
    torch.testing.assert_close(lse[rows], want_lse[rows], atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("lq,lk", [(127, 127), (128, 128), (129, 129), (255, 255),
                                   (127, 255), (255, 129), (129, 128), (128, 127)])
def test_flash_forward_tile_edges(gen, lq, lk, d):
    """Lq and Lk either side of the q block and key tile (128), ragged both."""
    q, k, v = _randn(gen, 2, lq, 3, d), _randn(gen, 2, lk, 3, d), _randn(gen, 2, lk, 3, d)
    out, lse = _fwd_repeated(q, k, v)
    _check_fwd(out, lse, *plain_attention(q, k, v, return_lse=True))


@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_forward_kv_len_edges(gen, d):
    """kv_len either side of a key tile (127, 128, 129), past two tiles, and
    0 (output 0, lse MASKED_LSE), one per batch, over 300 keys."""
    kv_len = (127, 128, 129, 0, 257)
    b = len(kv_len)
    q, k, v = _randn(gen, b, 200, 2, d), _randn(gen, b, 300, 2, d), _randn(gen, b, 300, 2, d)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out, lse = _fwd_repeated(q, k, v, kl)
    want, want_lse = plain_attention_partial(q, k, v, kv_len=kl)
    live = [i for i in range(b) if kv_len[i] > 0]
    _check_fwd(out, lse, want, want_lse, live)
    assert out[3].abs().max().item() == 0.0 and lse[3].max().item() == MASKED_LSE


def test_flash_forward_full_grid(gen):
    """B·N = 2×24 at the 5B segment's 12,095 tokens: every q block of every
    head runs; four heads of each batch are held to the plain version (the
    fp32 plain version of all 48 would take ~28 GB)."""
    b, l, n, d = 2, 12095, 24, 128
    q, k, v = _randn(gen, b, l, n, d), _randn(gen, b, l, n, d), _randn(gen, b, l, n, d)
    out, lse = _fwd_repeated(q, k, v)
    for hs in (slice(0, 3), slice(23, 24)):
        want, want_lse = plain_attention(q[:, :, hs], k[:, :, hs], v[:, :, hs],
                                         return_lse=True)
        _check_fwd(out[:, :, hs], lse[:, hs], want, want_lse)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_w8a8_v_view(gen, d):
    """v as the W8A8 split makes it: a [B, L, N, D] view of one [B, L, 3·dim]
    projection, row stride 3·dim (models/dit.py), with q and k contiguous."""
    b, l, n = 1, 300, 4
    qkv = _randn(gen, b, l, 3 * n * d)
    q, k, v = (t.reshape(b, l, n, d) if i < 2 else t.view(b, l, n, d)
               for i, t in enumerate(qkv.split(n * d, -1)))
    q, k = q.contiguous(), k.contiguous()
    assert v.stride(1) == 3 * n * d
    out, lse = _fwd_repeated(q, k, v)
    _check_fwd(out, lse, *plain_attention(q, k, v, return_lse=True))


@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_forward_identity_v(gen, d):
    """V far from uniform: key j carries a one-hot row at column j mod D,
    scaled by 1 + (j // D) / (Lk / D) (in [1, 2), so one bf16 ulp stays
    below 2^-7), so output column c is the weighted softmax mass of the
    keys ≡ c (mod D). A P register read against the wrong keys moves mass
    between columns, which N(0, 1) inputs average away."""
    lq, lk, n = 130, 384, 2
    q, k = _randn(gen, 1, lq, n, d, scale=2.0), _randn(gen, 1, lk, n, d)
    j = torch.arange(lk, device="cuda")
    v = torch.zeros(1, lk, n, d, device="cuda")
    v[0, j, :, j % d] = (1.0 + (j // d) / (lk // d)).float()[:, None]
    v = v.to(torch.bfloat16)
    out, lse = _fwd_repeated(q, k, v)
    _check_fwd(out, lse, *plain_attention(q, k, v, return_lse=True))


def test_flash_attention_rejects_unsupported(gen):
    q = _randn(gen, 1, 8, 2, 128)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        flash_attention(q[..., ::2], q[..., ::2], q[..., ::2])  # D = 64, not unit stride
    with pytest.raises(ValueError):
        x = _randn(gen, 1, 8, 2, 96)
        flash_attention(x, x, x)
    with pytest.raises(ValueError):  # the kernel folds the scale into its running max
        flash_attention(q, q, q, scale=-0.1)


def test_flash_attention_counts_launches(gen):
    q = _randn(gen, 1, 8, 2, 128)
    before = flash_attention.launches
    flash_attention(q, q, q)
    assert flash_attention.launches == before + 1


@pytest.mark.parametrize("b,lq,lk,n,d,kv_len", [
    (1, 3024, 3024, 2, 128, (3023,)),     # a ring hop at sp = 4, the last shard
    (2, 65, 130, 3, 64, (0, 130)),
    (3, 127, 77, 2, 16, (1, 77, 0)),
    (1, 200, 63, 4, 128, None),
    (2, 6048 // 64 + 1, 100, 2, 128, (100, 1)),
])
def test_flash_attention_partial_edges(gen, b, lq, lk, n, d, kv_len):
    q = _randn(gen, b, lq, n, d)
    k = _randn(gen, b, lk, n, d)
    v = _randn(gen, b, lk, n, d)
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    before = flash_attention_partial.launches, flash_attention.launches
    out, lse = flash_attention_partial(q, k, v, kv_len=kl)
    assert (flash_attention_partial.launches, flash_attention.launches) == (
        before[0] + 1, before[1])
    want, want_lse = plain_attention_partial(q, k, v, kv_len=kl)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert out.is_contiguous() and lse.shape == (b, n, lq)
    assert (out.float() - want.float()).abs().max().item() <= K1_TOL
    live = [i for i in range(b) if kv_len is None or kv_len[i] > 0]
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-3, rtol=1e-3)
    for i in set(range(b)) - set(live):  # no live key: output 0, lse MASKED_LSE
        assert out[i].abs().max().item() == 0.0
        assert lse[i].max().item() == want_lse[i].min().item() == MASKED_LSE


def test_flash_attention_partial_strided_q(gen):
    """q, k and v as head slices of wider [B, L, N, D] buffers (a zero-copy
    view of an all-to-all's output), kv as a run of a longer block."""
    buf = _randn(gen, 1, 6048, 24, 128)
    q = buf[:, :, 12:]
    kv = _randn(gen, 2, 1, 6048, 24, 128)
    k, v = kv[0, :, 3024:, :12], kv[1, :, 3024:, :12]
    assert not q.is_contiguous() and not k.is_contiguous()
    kl = torch.tensor([3023], dtype=torch.int32, device="cuda")
    out, lse = flash_attention_partial(q, k, v, kv_len=kl)
    want, want_lse = plain_attention_partial(q, k, v, kv_len=kl)
    assert (out.float() - want.float()).abs().max().item() <= K1_TOL
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=1e-3)


def _glue_check(got, want):
    tol = GLUE_REL_TOL * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("d", [64, 96, 1500, 3072, 5120])
@pytest.mark.parametrize("mode", ["adaln", "affine", "fp32_out"])
def test_adaln_norm_edges(gen, d, mode):
    """K2 with per-batch tables [2, 3, D] and idx (staged up to 3,072; at
    5,120 the six table rows do not fit and the row kernel takes them), as
    the norm3 affine LayerNorm (gate 0, no idx, K = 1) and as the Head's
    fp32 output; D = 1,500 is not whole bf16 vectors (the row kernel)."""
    b, l, k = 2, 37, 3
    x = _randn(gen, b, l, d, scale=3.0)
    s = _randn(gen, b, k, d, dtype=torch.float32, scale=0.1)
    t = _randn(gen, b, k, d, dtype=torch.float32, scale=0.1)
    idx = torch.randint(0, k, (b, l), generator=gen, device="cuda", dtype=torch.int32)
    before = fa.adaln_norm.launches
    if mode == "affine":
        w, bias = s[:1, :1] + 1.0, t[:1, :1]
        got = fa.adaln_norm(x, w, bias, None, gate=0.0)
        want = fa._adaln_norm_ref(x, w, bias, None, 1e-6, 0.0, x.dtype)
    else:
        od = torch.float32 if mode == "fp32_out" else torch.bfloat16
        got = fa.adaln_norm(x, s, t, idx, out_dtype=od)
        want = fa._adaln_norm_ref(x, s, t, idx, 1e-6, 1.0, od)
    assert fa.adaln_norm.launches == before + 1
    assert got.dtype == want.dtype
    _glue_check(got, want)


# (b, l, d, k, per-batch tables, x dtype, out dtype, row mean)
K2_CASES = [
    (1, 300, 5120, 2, False, torch.bfloat16, torch.bfloat16, 0.0),  # 14B width, staged
    (1, 300, 5120, 2, False, torch.bfloat16, torch.float32, 0.0),   # its Head
    (2, 50, 3072, 2, True, torch.bfloat16, torch.bfloat16, 0.0),    # 4 staged table rows
    (2, 50, 3072, 2, False, torch.bfloat16, torch.bfloat16, 0.0),   # [1, K, D] over B = 2
    (2, 50, 3072, 4, True, torch.bfloat16, torch.bfloat16, 0.0),    # 8 rows: the row kernel
    (1, 50, 3072, 8, False, torch.bfloat16, torch.bfloat16, 0.0),   # K = 8: the row kernel
    (1, 64, 3072, 2, False, torch.bfloat16, torch.bfloat16, 100.0),  # two-pass variance
    (1, 64, 3072, 2, False, torch.float32, torch.float32, 100.0),
    (2, 37, 3072, 2, True, torch.float16, torch.float16, 0.0),
    (2, 37, 3072, 2, True, torch.float16, torch.float32, 0.0),
    (2, 37, 3072, 2, True, torch.float32, torch.float32, 0.0),
    (2, 37, 1500, 2, False, torch.float32, torch.float32, 0.0),     # fp32: whole vectors
    (2, 37, 1001, 2, False, torch.bfloat16, torch.bfloat16, 0.0),   # odd D: scalar path
    (2, 0, 3072, 2, False, torch.bfloat16, torch.bfloat16, 0.0),    # no token
    (1, 1, 3072, 2, False, torch.bfloat16, torch.bfloat16, 0.0),
    (1, 5, 16384, 1, False, torch.bfloat16, torch.bfloat16, 0.0),   # rows too wide to stage
    # the unpacked t2v stream: 3 frames of 22 x 40 tokens, K = 31 table rows
    # (too many to stage: the row kernel), the AdaLN and the Head's fp32 out
    (1, 3 * 880, 3072, 31, False, torch.bfloat16, torch.bfloat16, 0.0),
    (1, 3 * 880, 3072, 31, False, torch.bfloat16, torch.float32, 0.0),
]


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("b,l,d,k,per_batch,dtype,out_dtype,mean", K2_CASES)
def test_adaln_norm_tables_and_dtypes(gen, b, l, d, k, per_batch, dtype, out_dtype, mean,
                                      misaligned):
    """K2 against its plain version: the 14B width, per-batch tables that
    are and are not staged, a [1, K, D] table over B = 2, a K whose tables
    do not fit, rows of mean 100 and unit spread (a one-pass E[x^2] - mu^2
    loses the variance there), every admitted dtype pair, odd D, L = 0,
    one token, rows too wide to stage; and each again with x's data one
    element past a 16-byte boundary (the row kernel's scalar path). Each call launches the kernel once (none without a token)."""
    x = _randn(gen, b, l, d, dtype=torch.float32) + mean
    if misaligned:  # contiguous, but its data starts one element in
        flat = torch.empty(b * l * d + 1, dtype=dtype, device="cuda")
        x_k = flat[1:].view(b, l, d)
        x_k.copy_(x)
    else:
        x_k = x.to(dtype)
    s = _randn(gen, b if per_batch else 1, k, d, dtype=torch.float32, scale=0.1)
    t = _randn(gen, b if per_batch else 1, k, d, dtype=torch.float32, scale=0.1)
    idx = torch.randint(0, k, (b, l), generator=gen, device="cuda", dtype=torch.int32)
    before = fa.adaln_norm.launches
    got = fa.adaln_norm(x_k, s, t, idx, out_dtype=out_dtype)
    assert fa.adaln_norm.launches == before + (b * l > 0)
    want = fa._adaln_norm_ref(x_k, s, t, idx, 1e-6, 1.0, out_dtype)
    assert got.dtype == out_dtype and got.shape == (b, l, d)
    if got.numel():
        _glue_check(got, want)


def test_adaln_norm_refuses_dtype_pairs(gen):
    """K2 instantiates x's dtype to itself or to fp32 only."""
    s = _randn(gen, 1, 1, 64, dtype=torch.float32)
    for dtype, out_dtype in ((torch.bfloat16, torch.float16), (torch.float32, torch.bfloat16),
                             (torch.float16, torch.bfloat16)):
        with pytest.raises(TypeError, match="no kernel"):
            fa.adaln_norm(_randn(gen, 1, 4, 64, dtype=dtype), s, s, None, out_dtype=out_dtype)


@pytest.mark.parametrize("b,l,d,k,per_batch", [
    (2, 50, 3072, 2, True),
    (1, 3 * 880, 3072, 31, False),  # the unpacked t2v stream: K = 31, 3 frames of 22 x 40
])
def test_adaln_residual_batched_tables(gen, b, l, d, k, per_batch):
    x, y = _randn(gen, b, l, d), _randn(gen, b, l, d)
    s = _randn(gen, b if per_batch else 1, k, d, dtype=torch.float32, scale=0.1)
    idx = torch.randint(0, k, (b, l), generator=gen, device="cuda", dtype=torch.int32)
    _glue_check(fa.adaln_residual(x, y, s, idx), fa._adaln_residual_ref(x, y, s, idx))
    _glue_check(fa.adaln_residual(x, y, s[:1], None), fa._adaln_residual_ref(x, y, s[:1], None))


@pytest.mark.parametrize("heads,head_dim", [(24, 128), (4, 64)])
def test_qk_norm_rope_and_rms_norm_batched(gen, heads, head_dim):
    b, l = 2, 45
    d = heads * head_dim
    q, k = _randn(gen, b, l, d), _randn(gen, b, l, d)
    wq = 1.0 + _randn(gen, d, dtype=torch.float32, scale=0.1)
    wk = 1.0 + _randn(gen, d, dtype=torch.float32, scale=0.1)
    ang = torch.rand((l, head_dim // 2), generator=gen, device="cuda") * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    got = fa.qk_norm_rope(q, k, wq, wk, cos, sin, heads, eps=1e-6)
    want = fa._qk_norm_rope_ref(q, k, wq, wk, cos, sin, heads, 1e-6)
    for g, w in zip(got, want):
        _glue_check(g, w)
    _glue_check(fa.rms_norm(q, wq, eps=1e-6), fa._rms_ref(q, wq, 1e-6))


@pytest.mark.parametrize("d", [33, 1500, 3072, 5120])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_rms_norm_edges(gen, d, dtype):
    """K5's own kernel: an odd D, a D that ends inside a 1,024-wide chunk,
    the 5B and 14B widths, a row count that is not a multiple of the rows a
    program takes, every activation dtype."""
    x = _randn(gen, 3, 37, d, dtype=dtype, scale=3.0)
    w = 1.0 + _randn(gen, d, dtype=torch.float32, scale=0.1)
    before = fa.rms_norm.launches
    got = fa.rms_norm(x, w, eps=1e-6)
    assert fa.rms_norm.launches == before + 1
    want = fa._rms_ref(x, w, 1e-6)
    assert got.dtype == want.dtype and got.shape == want.shape
    _glue_check(got, want)


def test_glue_rejects_non_contiguous(gen):
    x = _randn(gen, 2, 8, 128).transpose(0, 1)
    s = _randn(gen, 1, 1, 128, dtype=torch.float32)
    with pytest.raises(ValueError):
        fa.adaln_residual(x, x, s, None)
    # K4 takes strided rows, but not a strided last axis
    q = _randn(gen, 2, 128, 8).transpose(1, 2)
    w = torch.ones(128, device="cuda")
    cos = torch.ones((8, 32), device="cuda")
    with pytest.raises(ValueError):
        fa.qk_norm_rope(q, q, w, w, cos, cos, 2, eps=1e-6)


# (b, l, heads, head_dim, layout, per-sample tables): "qkv" passes q and k
# as the first two column blocks of a fused [B, L, 3·D] projection (rows
# strided, as the W8A8 block does), "misaligned" as such blocks shifted by
# one element (not 16-byte aligned: the kernel's scalar path)
K4_CASES = [
    (2, 45, 4, 64, "contiguous", True),
    (2, 45, 24, 128, "qkv", True),        # 5B widths
    (3, 37, 40, 128, "qkv", False),       # 14B widths, odd L
    (2, 0, 4, 64, "contiguous", False),   # no token
    (1, 1, 4, 64, "qkv", False),
    (2, 33, 6, 96, "qkv", True),          # half 48 does not divide 128
    (2, 9, 8, 4, "contiguous", False),    # half 2
    (2, 17, 10, 150, "contiguous", True),  # D = 1,500: not whole vectors
    (2, 29, 24, 128, "misaligned", True),
    (1, 5, 128, 128, "qkv", False),       # D = 16,384: rows past the registers
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("b,l,heads,head_dim,layout,batched", K4_CASES)
def test_qk_norm_rope_batched_tables(gen, b, l, heads, head_dim, layout, batched, dtype):
    """K4 against its plain version: per-sample RoPE tables [B, L, D/2]
    (the MVDT masked pass) and shared ones, strided and misaligned views,
    odd L and L = 0, the 14B width and the widest D, head dims whose
    cos/sin index is or is not constant per lane (D = 16,384 and the
    misaligned views take the row kernel, the rest the staged one), every
    dtype; each call goes to the kernel (the count moves by one) and never
    to the plain version."""
    d = heads * head_dim
    if layout == "contiguous":
        q, k = _randn(gen, b, l, d, dtype=dtype), _randn(gen, b, l, d, dtype=dtype)
    else:
        shift = int(layout == "misaligned")
        qkv = _randn(gen, b, l, 3 * d + shift, dtype=dtype, scale=2.0)
        q, k = qkv[..., shift:shift + d], qkv[..., shift + d:shift + 2 * d]
    wq = 1.0 + _randn(gen, d, dtype=torch.float32, scale=0.1)
    wk = 1.0 + _randn(gen, d, dtype=torch.float32, scale=0.1)
    ang = torch.rand(((b,) if batched else ()) + (l, head_dim // 2), generator=gen,
                     device="cuda") * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    before = fa.qk_norm_rope.launches
    got = fa.qk_norm_rope(q, k, wq, wk, cos, sin, heads, eps=1e-6)
    assert fa.qk_norm_rope.launches == before + (b * l > 0)
    want = fa._qk_norm_rope_ref(q, k, wq, wk, cos, sin, heads, 1e-6)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (b, l, d) and g.is_contiguous()
        if g.numel():
            _glue_check(g, w)


def test_glue_gradients_on_the_card(gen):
    """With inputs that require grad, the glue kernels launch through
    their autograd Function, and the gradients (activations, fp32 tables,
    weights, batched RoPE tables) equal those of the plain versions under
    autograd on the same inputs: the backward recomputes through them."""
    b, l, heads, head_dim, k = 2, 37, 4, 64, 2
    d = heads * head_dim
    x, y = _randn(gen, b, l, d), _randn(gen, b, l, d)
    s = _randn(gen, b, k, d, dtype=torch.float32, scale=0.1)
    t = _randn(gen, b, k, d, dtype=torch.float32, scale=0.1)
    idx = torch.randint(0, k, (b, l), generator=gen, device="cuda", dtype=torch.int32)
    w = 1.0 + _randn(gen, d, dtype=torch.float32, scale=0.1)
    ang = torch.rand((b, l, head_dim // 2), generator=gen, device="cuda") * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    cases = [
        (fa.adaln_norm, lambda *a: fa._adaln_norm_ref(*a, idx, 1e-6, 1.0, torch.bfloat16),
         lambda *a: fa.adaln_norm(*a, idx), (x, s, t)),
        (fa.adaln_residual, lambda *a: fa._adaln_residual_ref(*a, idx),
         lambda *a: fa.adaln_residual(*a, idx), (x, y, s)),
        (fa.rms_norm, lambda *a: fa._rms_ref(*a, 1e-6),
         lambda *a: fa.rms_norm(*a, eps=1e-6), (x, w)),
        (fa.qk_norm_rope, lambda *a: fa._qk_norm_rope_ref(*a, heads, 1e-6),
         lambda *a: fa.qk_norm_rope(*a, heads, eps=1e-6), (x, y, w, w + 0.5, cos, sin)),
    ]
    for counter, plain, kernel, inputs in cases:
        grads = []
        for fn in (kernel, plain):
            leaves = [a.clone().requires_grad_() for a in inputs]
            before = counter.launches
            outs = fn(*leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            assert all(o.grad_fn is not None for o in outs)
            cots = [torch.ones_like(o) for o in outs]
            grads.append(torch.autograd.grad(outs, leaves, cots))
            assert counter.launches == before + (fn is kernel)
        for g_kernel, g_plain in zip(*grads):
            torch.testing.assert_close(g_kernel, g_plain, atol=1e-5, rtol=1e-5)
