"""Sequence-parallel serving of the port against the JAX package on the
CPU: four spawned processes in a gloo group (``torch_parity.RankPool``, one
for the module) run the port's SP code, and JAX runs its ``shard_map``
over 4 of the 8 virtual CPU devices on the same inputs: Ulysses, ring and
USP (2 × 2) attention with padding masked; ``sp_dit_forward`` against
``sp_dit_apply`` (with the TeaCache residual cache kept on each rank's
tokens and fed back); ``generate_segment`` with ``sp_groups`` against the
JAX pipeline with a mesh (Euler; interval TeaCache with and without W8A8;
W8A8 + adaptive TeaCache, whose refresh decisions must agree on every
rank). Weights are carried across by ``utils/convert.py``.

The 14B model (``tests/test_torch_i2v.py``'s tiny i2v pipeline):
``sp_dit_forward`` with the CLIP context against ``sp_dit_apply``, and
``I2VPipeline.generate`` with ``sp_groups`` on ranks 0 and 1 (sp 2; rank 0
alone holds the VAE, umT5 and CLIP, and hands the conditioning and the
noise to rank 1) against the JAX pipeline with a 2-device mesh, on JAX's
noise: CFG Euler, ``cfg_parallel``, and adaptive TeaCache, whose refresh
decisions are rank 0's on both ranks (n_full equal to JAX's). Its latents
are held to 1e-4, the TeaCache ones to the 2e-3 of
``tests/test_torch_i2v.py`` (a bf16 residual a rounding apart), and the
videos to 1e-3 and 2e-2.

fp32 inputs from numpy seeds. Tolerances: attention 1e-5, the DiT and its
cache 1e-4, latents 1e-4 (as tests/test_torch_teacache.py: the order of
float32 sums differs between XLA:CPU and ATen, and between the sharded and
the merged attention). Every rank must return the same velocity and
latents, bit for bit, and the same n_full.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from test_torch_i2v import BF16_STEP_TOL, BF16_STEP_VIDEO_TOL, TINY as I2V, VIDEO_TOL
from test_torch_pipeline import _params
from test_torch_pp import SIZE, i2v_model  # noqa: F401 (a fixture)
from test_torch_teacache import CFG, F_HIST, LFZ, STEPS
from torch_parity import assert_close, port_config
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.parallel.mesh import make_mesh, make_usp_mesh
from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxPipeline
from yume_tpu_torch.models.quantized import quantize_dit_blocks
from yume_tpu_torch.parallel.mesh import SPGroups
from yume_tpu_torch.pipelines.i2v import I2VPipeline
from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
from yume_tpu_torch.utils import convert

ATTN_TOL, OUT_TOL, LATENT_TOL = 1e-5, 1e-4, 1e-4
WORLD = 4
KINDS = ["ulysses", "ring", "usp"]
W8A8 = dataclasses.replace(CFG, dit=dataclasses.replace(CFG.dit, w8a8=True))


def _mesh(kind):
    devices = jax.devices()[:WORLD]
    if kind == "usp":
        return make_usp_mesh(data=1, fsdp=1, sp_u=2, sp_r=WORLD // 2, devices=devices)
    return make_mesh(data=1, fsdp=1, sp=WORLD, devices=devices)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = torch_parity.RankPool(WORLD, str(tmp_path_factory.mktemp("sp") / "rendezvous"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def model(ranks):
    """The 4-layer fp32 DiT of test_torch_teacache.py on every rank (key
    "dit") and its JAX parameters."""
    dit_p = _params(JaxDiT(CFG.dit, dtype=jnp.float32), 21, jnp.zeros((1, 3, 4, 4, 8)),
                    jnp.zeros((1, 3)), jnp.zeros((1, 16, 16)), packed=False)
    ranks.run("rank_load_dit", "dit", port_config(CFG.dit),
              convert.dit_state_dict(dit_p, CFG.dit.num_layers))
    return dit_p


def _same_on_every_rank(results):
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])
    return results[0]


def test_usp_groups_follow_the_jax_mesh(ranks):
    """Rank = i_u·sp_r + i_r, the device order of make_usp_mesh's reshape:
    the Ulysses group of a rank is its column of that grid, the ring group
    its row."""
    devices = _mesh("usp").devices.reshape(2, 2)  # [sp_u, sp_r]
    grid = np.vectorize(lambda d: d.id)(devices)
    for rank, i_u, i_r, u_ranks, r_ranks in ranks.run("rank_layout"):
        assert grid[i_u, i_r] == rank
        assert u_ranks == list(grid[:, i_r]) and r_ranks == list(grid[i_u])


def test_agree_takes_rank_0s_decision(ranks):
    assert ranks.run("rank_agree") == [(True, False)] * WORLD


@pytest.mark.parametrize("kind", KINDS)
def test_sp_attention_masks_padding(ranks, kind):
    """L = 21 true tokens padded to 24 with tokens that are not zero: the
    kv_len mask alone must exclude them."""
    from yume_tpu.parallel.ulysses import sp_shard_map_attention, usp_shard_map_attention

    b, l_true, l_pad, n, d = 2, 21, 24, 8, 16
    rng = np.random.default_rng(31)
    q, k, v = (rng.standard_normal((b, l_pad, n, d)).astype(np.float32) for _ in range(3))
    kv_len = jnp.full((b,), l_true, jnp.int32)
    if kind == "usp":
        fn = usp_shard_map_attention(_mesh(kind), kv_len=kv_len, impl="xla")
    else:
        fn = sp_shard_map_attention(_mesh(kind), kind, impl="xla", kv_len=kv_len)
    want = fn(*map(jnp.asarray, (q, k, v)))
    got = np.concatenate(ranks.run("rank_sp_attention", kind, q, k, v, l_true), axis=1)
    assert_close(got, want, ATTN_TOL)


def _dit_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, F_HIST + LFZ, 4, 4, 8)).astype(np.float32)
    t = np.concatenate([np.zeros((1, F_HIST)), np.full((1, LFZ), 700.0)], 1).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 16)).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("kind,mode", [
    ("ulysses", "plain"), ("ring", "plain"), ("usp", "plain"),
    ("ring", "cache"), ("usp", "cache"),
])
def test_sp_dit_forward_matches_sp_dit_apply(ranks, model, kind, mode):
    """``cache``: a full step that returns the residual cache (each rank's
    chunk of JAX's token-sharded cache), then a cached step that feeds it
    back."""
    from yume_tpu.parallel.sp_forward import sp_dit_apply

    x, t, ctx = _dit_inputs(32)
    jdit, mesh = JaxDiT(CFG.dit, dtype=jnp.float32), _mesh(kind)

    @functools.partial(jax.jit, static_argnames=("return_cache",))
    def jax_sp(x, t, block_cache=None, return_cache=False):
        return sp_dit_apply(jdit, model, mesh, x, t, jnp.asarray(ctx), latent_frame_zero=LFZ,
                            kind=kind, cache_list=cache_list, block_cache=block_cache,
                            return_cache=return_cache)

    if mode == "plain":
        cache_list = ()
        want = jax_sp(x, t)
        got = _same_on_every_rank(ranks.run("rank_sp_dit", "dit", kind, x, t, ctx, LFZ))
        assert np.abs(np.asarray(want)).max() > 1e-2  # not a bias-only output
        assert_close(got, want, OUT_TOL)
        return
    cache_list = (1, 2)
    want, want_cache = jax_sp(x, t, return_cache=True)
    results = ranks.run("rank_sp_dit", "dit", kind, x, t, ctx, LFZ, cache_list, None, True)
    assert_close(_same_on_every_rank([r[0] for r in results]), want, OUT_TOL)
    want_cache = np.asarray(want_cache, np.float32)    # [n, B, L_pad, dim]
    for j in range(len(cache_list)):
        got = np.concatenate([r[1][j] for r in results], axis=1)
        assert_close(got, want_cache[j], 2.0 ** -8 * np.abs(want_cache[j]).max())
    # a cached step: the next step's timesteps, the cache fed back
    t2 = np.where(t > 0, 500.0, 0.0).astype(np.float32)
    want = jax_sp(x, t2, block_cache=jnp.asarray(want_cache, jnp.bfloat16))
    got = ranks.run("rank_sp_dit", "dit", kind, x, t2, ctx, LFZ, cache_list, want_cache)
    assert_close(_same_on_every_rank(got), want, OUT_TOL)


def _segment_data():
    rng = np.random.default_rng(22)   # test_torch_teacache.py's data
    return (rng.standard_normal((1, F_HIST, 4, 4, 8)).astype(np.float32),
            rng.standard_normal((1, LFZ, 4, 4, 8)).astype(np.float32),
            rng.standard_normal((1, 16, 16)).astype(np.float32))


@pytest.mark.parametrize("kind,w8a8,kw", [
    ("ring", False, dict(steps=2)),
    ("usp", False, dict(steps=2)),
    ("ring", False, dict(steps=4, sampler="teacache", teacache_interval=2)),
    ("ulysses", True, dict(steps=4, sampler="teacache", teacache_interval=2)),
    ("ring", True, dict(steps=STEPS, sampler="teacache", teacache_threshold=0.1)),
])
def test_sp_generate_segment_matches_jax(ranks, model, kind, w8a8, kw):
    """The last case is the headline's mode, W8A8 + adaptive TeaCache at
    threshold 0.1, on test_torch_teacache.py's model and data, whose
    accumulated rel-L1 stays at least 1e-3 (relative) from the threshold
    there: every rank must take the same refresh decisions and count the
    same n_full as JAX."""
    history, noise, ctx = _segment_data()
    cfg = W8A8 if w8a8 else CFG
    jpipe = JaxPipeline(cfg, JaxDiT(cfg.dit, dtype=jnp.float32), model, None, None,
                        mesh=_mesh(kind), sp_kind=kind)
    want = jpipe.generate_segment(jnp.asarray(history), jnp.asarray(ctx),
                                  noise=jnp.asarray(noise), **kw)
    results = ranks.run("rank_sp_segment", "dit", port_config(CFG), kind, w8a8, history,
                        ctx, noise, kw)
    got = _same_on_every_rank([r[0] for r in results])
    n_full = {r[1] for r in results}
    assert len(n_full) == 1
    if kw.get("sampler") == "teacache":
        assert n_full == {int(jpipe.last_teacache_n_full)}
        if "teacache_threshold" in kw:
            assert 1 < n_full.pop() < STEPS   # both kinds of step ran
    assert got.shape == (1, F_HIST + LFZ, 4, 4, 8)
    np.testing.assert_array_equal(got[:, :F_HIST], history)
    assert_close(got, want, LATENT_TOL)


def test_sp_refuses_samplers_that_bypass_the_sp_forward():
    groups = SPGroups(group=None, sp=WORLD, rank=0)
    pipe = TI2VPipeline(port_config(CFG), None, None, sp_groups=groups, sp_kind="ring")
    for sampler in ("sde", "time_travel", "tts"):
        with pytest.raises(NotImplementedError, match="SP serving"):
            pipe.generate_segment(torch.zeros((1, F_HIST, 4, 4, 8)), torch.zeros((1, 16, 16)),
                                  sampler=sampler)


# -- the 14B model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def i2v_dit(ranks, i2v_model):
    """The tiny i2v DiT on every rank (key "i2v")."""
    jpipe, sds = i2v_model
    ranks.run("rank_load_dit", "i2v", port_config(I2V.dit), sds["dit"])
    return jpipe


@pytest.mark.parametrize("kind", KINDS)
def test_sp_dit_forward_with_clip_context_matches_sp_dit_apply(ranks, i2v_dit, kind):
    """Every rank embeds the CLIP tokens with the text; cross-attention over
    both stays local."""
    from yume_tpu.parallel.sp_forward import sp_dit_apply

    rng = np.random.default_rng(33)
    x = rng.standard_normal((1, F_HIST + LFZ, 8, 8, 18)).astype(np.float32)
    t = np.concatenate([np.zeros((1, F_HIST)), np.full((1, LFZ), 700.0)], 1).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 16)).astype(np.float32)
    clip = rng.standard_normal((1, 5, 12)).astype(np.float32)
    want = jax.jit(lambda x, t, c, k: sp_dit_apply(
        JaxDiT(I2V.dit, dtype=jnp.float32), i2v_dit.dit_params, _mesh(kind), x, t, c,
        latent_frame_zero=LFZ, clip_context=k, kind=kind))(x, t, ctx, clip)
    got = ranks.run("rank_sp_dit", "i2v", kind, x, t, ctx, LFZ, (), None, False, clip)
    assert np.abs(np.asarray(want)).max() > 1e-2
    assert_close(_same_on_every_rank(got), want, OUT_TOL)


# mode: (generate kwargs, steps) — sp 2 on ranks 0 and 1, Ulysses and ring
I2V_MODES = {
    "euler_ulysses": ("ulysses", dict(), 2),
    "euler_ring_cfg_parallel": ("ring", dict(cfg_parallel=True), 2),
    "teacache_adaptive_ring": ("ring", dict(sampler="teacache", teacache_threshold=0.3), 5),
}


@pytest.mark.parametrize("mode", sorted(I2V_MODES))
def test_sp_i2v_generate_matches_jax(ranks, i2v_dit, mode):
    import dataclasses as dc

    kind, kw, steps = I2V_MODES[mode]
    rng = np.random.default_rng(34)
    img = rng.uniform(-1, 1, (1, 1, SIZE, SIZE, 3)).astype(np.float32)
    ctx, ctx_null = (rng.standard_normal((1, 16, 16)).astype(np.float32) for _ in range(2))
    seed = 3
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 3, 8, 8, 8),
                                         jnp.float32))
    mesh = make_mesh(data=1, fsdp=1, sp=2, devices=jax.devices()[:2])
    jpipe = dc.replace(i2v_dit, mesh=mesh, sp_kind=kind, _cond_cache=None,
                       cfg_parallel=kw.get("cfg_parallel", False))
    jkw = {k: v for k, v in kw.items() if k != "cfg_parallel"}
    want_lat, want_video = jpipe.generate(jnp.asarray(img), jnp.asarray(ctx),
                                          jnp.asarray(ctx_null), frame_num=5, steps=steps,
                                          seed=seed, **jkw)
    results = ranks.run("rank_i2v_generate", "sp2", port_config(I2V), convert.pipeline_state_dicts(
        i2v_dit), img, ctx, ctx_null, noise, dict(frame_num=5, steps=steps, seed=seed, **kw),
        kind)
    assert results[2:] == [None, None]          # ranks outside the group
    (lat0, n_full0, video), (lat1, n_full1, shape1) = results[:2]
    np.testing.assert_array_equal(lat1, lat0)
    assert shape1 == video.shape == (1, 5, SIZE, SIZE, 3)
    lat_tol, video_tol = LATENT_TOL, VIDEO_TOL
    if "teacache_threshold" in kw:
        lat_tol, video_tol = BF16_STEP_TOL, BF16_STEP_VIDEO_TOL
        assert n_full0 == n_full1 == int(jpipe.last_teacache_n_full)
        assert 1 < n_full0 < steps
    assert_close(lat0, want_lat, lat_tol)
    assert_close(video, want_video, video_tol)


def test_sp_i2v_refuses_the_storage_trunk(i2v_dit):
    """The JAX guard: the int8/int4 storage trunk is single-chip."""
    sds = convert.pipeline_state_dicts(i2v_dit)
    pipe = I2VPipeline.from_state_dicts(port_config(I2V), sds["dit"], None, device="cpu",
                                        dtype=torch.float32)
    quantize_dit_blocks(pipe.dit, 8)
    pipe.sp_groups = SPGroups(group=None, sp=2, rank=0)
    with pytest.raises(NotImplementedError, match="storage trunk is single-chip"):
        pipe.generate(torch.zeros((1, 1, SIZE, SIZE, 3)), torch.zeros((1, 16, 16)),
                      torch.zeros((1, 16, 16)), frame_num=5, steps=2)
