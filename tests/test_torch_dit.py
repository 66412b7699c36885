"""PyTorch port of the WanDiT against the JAX model on the CPU: FramePack
plans and token grids, one DiTBlock, and the packed forward, on perturbed
(non-zero) parameters converted with yume_tpu_torch.utils.convert.

fp32 throughout. Tolerances: 1e-5 for one block and 1e-4 for the 2-layer
model, from the order of float32 sums differing between XLA:CPU and ATen
(the model stacks more of them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, perturb, port_config
from yume_tpu.configs import DiTConfig
from yume_tpu.models import dit as jdit
from yume_tpu_torch.models import dit as tdit
from yume_tpu_torch.ops import rope as trope
from yume_tpu_torch.utils.convert import dit_state_dict, load_state_dict

TINY = DiTConfig(
    model_type="ti2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128, freq_dim=32,
    text_dim=16, text_len=16, num_heads=4, num_layers=2, framepack=True,
)
BLOCK_TOL = 1e-5
MODEL_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jmodel = jdit.WanDiT(TINY, dtype=jnp.float32)
    x = jnp.zeros((1, 3, 8, 8, TINY.in_dim))
    shapes = jax.eval_shape(
        lambda key: jmodel.init(key, x, jnp.zeros((1, 3)),
                                jnp.zeros((1, TINY.text_len, TINY.text_dim)),
                                packed=False),
        jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=1)}
    tmodel = tdit.WanDiT(port_config(TINY), torch.float32, device="meta").to_empty(device="cpu")
    load_state_dict(tmodel, dit_state_dict(params, TINY.num_layers))
    return jmodel, params, tmodel


@pytest.mark.parametrize("f_hist", [1, 2, 5, 6, 7, 22, 23, 86, 87, 342, 343])
def test_framepack_plan_and_grids_equal(f_hist):
    want = jdit.framepack_plan(f_hist)
    got = tdit.framepack_plan(f_hist)
    assert [tuple(vars(c).values()) for c in got] == [tuple(vars(c).values()) for c in want]
    assert tdit.packed_grids(got, 44, 80, (1, 2, 2)) == jdit.packed_grids(want, 44, 80, (1, 2, 2))


def test_720p_segment_token_count():
    # 31 history frames + 8 tail frames at the 44×80 latent grid
    grids = tdit.packed_grids(tdit.framepack_plan(31), 44, 80, (1, 2, 2))
    assert [(c.start, c.stop, c.scale) for c in tdit.framepack_plan(31)] == [
        (0, 1, 1), (1, 10, 8), (10, 26, 4), (26, 28, 2), (28, 31, 1)]
    hist = sum(f * h * w for f, h, w in grids)
    tail = 8 * 22 * 40
    assert (hist, tail, hist + tail) == (5055, 7040, 12095)


def test_dit_block_matches_jax(models, rng_np):
    _, params, tmodel = models
    b, l, k = 2, 12, 2
    x = rng_np.standard_normal((b, l, TINY.dim)).astype(np.float32)
    ctx = rng_np.standard_normal((b, 5, TINY.dim)).astype(np.float32)
    e = rng_np.standard_normal((b, k, TINY.dim)).astype(np.float32)
    e0 = 0.1 * rng_np.standard_normal((b, k, 6, TINY.dim)).astype(np.float32)
    idx = rng_np.integers(0, k, (b, l)).astype(np.int32)
    cos, sin = trope.grid_rope(2, 2, 3, TINY.head_dim)

    jmod = jdit.Modulation(jnp.asarray(e), jnp.asarray(e0), jnp.asarray(idx))
    want = jdit.DiTBlock(TINY).apply(
        {"params": params["params"]["blocks_0"]}, jnp.asarray(x), jmod,
        jnp.asarray(ctx), jnp.asarray(cos), jnp.asarray(sin))
    tmod = tdit.Modulation(torch.from_numpy(e), torch.from_numpy(e0), torch.from_numpy(idx))
    with torch.no_grad():
        got = tmodel.blocks[0](torch.from_numpy(x), tmod, torch.from_numpy(ctx),
                               torch.from_numpy(cos), torch.from_numpy(sin))
    assert_close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("f_hist", [3, 343])  # 343: every scale incl. double_f
def test_packed_forward_matches_jax(models, rng_np, f_hist):
    jmodel, params, tmodel = models
    lfz = 2
    x = rng_np.standard_normal((1, f_hist + lfz, 8, 8, TINY.in_dim)).astype(np.float32)
    t = np.concatenate([np.zeros((1, f_hist)), np.full((1, lfz), 700.0)], 1).astype(np.float32)
    ctx = rng_np.standard_normal((1, TINY.text_len, TINY.text_dim)).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                        packed=True, latent_frame_zero=lfz)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                     latent_frame_zero=lfz)
    assert got.shape == (1, lfz, 8, 8, TINY.out_dim)
    assert np.abs(np.asarray(want)).max() > 1e-2  # not a bias-only output
    assert_close(got, want, MODEL_TOL)
