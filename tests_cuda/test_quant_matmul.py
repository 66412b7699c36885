"""K6, the W8A8 int8 matmul kernel, against its plain PyTorch version on
the card, at the edges the main path does not reach: one row and ragged
rows, the shallowest and deepest K, the narrowest and widest N, the GEMM's
tiling edges (128 x 256 tiles, 128-deep K steps: N not a multiple of 256,
K % 128 in {32, 64, 96}, a single K step, more tiles than SMs x 8), the
14B widths, all-zero rows (the 1e-8 scale floor), exact .5 ties, batch
dimensions, non-contiguous activations, the pre-pass alone, and the
wrapper's input checks.

Both sides quantize with IEEE division and round half to even, sum the
int8 products exactly and share the fp32 epilogue, so the outputs must be
bit-identical: the check is ``torch.equal``.
"""

import pytest
import torch

from yume_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen(cuda):
    return torch.Generator(device=cuda).manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _check(x, w):
    got = qm.q8_dot(x, w)
    want = qm._q8_matmul_ref(x, w.q, w.scale, x.dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() != want.float()).sum().item()
    assert diff == 0, (diff, (got.float() - want.float()).abs().max().item())
    return got


@pytest.mark.parametrize("m,k,n", [
    (1, 32, 8),
    (17, 32, 9216),
    (17, 14336, 8),
    (1, 14336, 9216),
    (130, 96, 136),      # K % 128 == 96; N = 136 leaves 120 columns of a tile
    (12095, 3072, 9216),
    (300, 256, 3080),    # N % 256 == 8: the last tile holds one column pair
    (200, 160, 264),     # K % 128 == 32
    (200, 192, 264),     # K % 128 == 64
    (129, 128, 256),     # a single full K step; one row past a tile
    (64, 64, 512),       # a single partial K step
    (12095, 3072, 3072),  # 1,140 tiles: more than 132 SMs x 8
    (257, 5120, 13824),  # 14B widths: dim 5120 -> ffn 13824
    (129, 13824, 5120),  # and back
])
def test_q8_dot_shapes(gen, m, k, n):
    x = _randn(gen, m, k)
    w = qm.quantize_weight(_randn(gen, n, k))
    _check(x, w)


def test_q8_dot_repeats_bit_identical(gen):
    x = _randn(gen, 1000, 3072)
    w = qm.quantize_weight(_randn(gen, 3072, 3072))
    first = _check(x, w)
    for _ in range(2):
        assert torch.equal(qm.q8_dot(x, w), first)


def test_q8_dot_zero_rows_and_ties(gen):
    m, k, n = 40, 64, 24
    x = _randn(gen, m, k)
    x[3] = 0.0                     # scale floor: 1e-8 / 127, output 0
    # a row whose absmax is 127: the scale is 1 and k + 0.5 values tie
    tie = torch.arange(k, device="cuda", dtype=torch.float32) % 8 - 3.5
    tie[0] = 127.0
    x[5] = tie.to(torch.bfloat16)
    w = qm.quantize_weight(_randn(gen, n, k))
    out = _check(x, w)
    assert out[3].abs().max().item() == 0.0


def test_q8_dot_batch_dims_and_strides(gen):
    x = _randn(gen, 2, 3, 21, 256)
    w = qm.quantize_weight(_randn(gen, 64, 128))
    _check(x[..., 128:], w)                # batch dims (copied to rows)
    _check(x[..., ::2], w)                 # non-unit stride in K: copied first
    _check(x[0, 1, :, 128:], w)            # row stride 256: read in place
    _check(x.transpose(1, 2)[..., 64:192], w)


def test_q8_dot_reads_strided_rows_in_place(gen):
    # a 5B-width slice of wider rows: the pre-pass reads it through its stride
    big = _randn(gen, 1000, 4096)
    x = big[:, 1024:1024 + 3072]
    assert qm._rows(x).data_ptr() == x.data_ptr()
    _check(x, qm.quantize_weight(_randn(gen, 512, 3072)))


@pytest.mark.parametrize("m,k", [(1, 32), (333, 3072), (65, 14336)])
def test_q8_quantize_matches_plain(gen, m, k):
    x = _randn(gen, m, k)
    x[0] = 0.0                             # the 1e-8 scale floor
    if k >= 64:                            # absmax 127: scale 1, .5 ties
        tie = torch.arange(k, device="cuda", dtype=torch.float32) % 8 - 3.5
        tie[0] = 127.0
        x[-1] = tie.to(torch.bfloat16)
    wide = torch.zeros((m, k + 64), device="cuda", dtype=torch.bfloat16)
    wide[:, 64:] = x
    want_q, want_s = qm._quantize_act(x)
    for src in (x, wide[:, 64:]):          # contiguous, and strided in place
        got_q, got_s = qm.q8_quantize(src)
        assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)


def test_int8_dot_general_on_card(gen):
    x = _randn(gen, 33, 64)
    weight = _randn(gen, 40, 64)
    got = qm.int8_dot_general(x, weight)
    w = qm.quantize_weight(weight)
    assert torch.equal(got, qm._q8_matmul_ref(x, w.q, w.scale, torch.bfloat16))


def test_q8_dot_rejects_unsupported(gen):
    w = qm.quantize_weight(_randn(gen, 16, 64))
    x = _randn(gen, 4, 64)
    with pytest.raises(TypeError):
        qm.q8_dot(x.float(), w)
    with pytest.raises(TypeError):
        qm.q8_dot(x, w, torch.float32)
    with pytest.raises(ValueError):   # K % 32
        qm.q8_dot(_randn(gen, 4, 48), qm.quantize_weight(_randn(gen, 16, 48)))
    with pytest.raises(ValueError):   # N % 8
        qm.q8_dot(x, qm.quantize_weight(_randn(gen, 12, 64)))
    with pytest.raises(ValueError):   # weight on the host
        qm.q8_dot(x, qm.Q8(w.q.cpu(), w.scale))
    with pytest.raises(ValueError):   # K disagrees
        qm.q8_dot(_randn(gen, 4, 32), w)
    with pytest.raises(TypeError):
        qm.q8_quantize(x.float())
    with pytest.raises(ValueError):   # K % 32
        qm.q8_quantize(_randn(gen, 4, 48))


def test_q8_dot_counts_launches(gen):
    w = qm.quantize_weight(_randn(gen, 16, 64))
    before = qm.q8_dot.launches, qm.q8_quantize.launches
    qm.q8_dot(_randn(gen, 4, 64), w)     # one count for its two kernels
    assert (qm.q8_dot.launches, qm.q8_quantize.launches) == (before[0] + 1, before[1])
