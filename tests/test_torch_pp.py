"""Pipeline parallelism of the port against the JAX package on the CPU: two
spawned processes in a gloo group (``torch_parity.RankPool``, one for the
module), one stage a rank, run the port's ``pp_dit_forward`` and the
pipelines' ``parallelize_pp`` routes; JAX runs ``pp_dit_apply`` and its
``parallelize_pp`` over 2 of the 8 virtual CPU devices on the same inputs:

* the staged forward, packed, unpacked and with ``clip_context`` (the 14B
  model), at batch 1 and at batch 2 in one or two microbatches, equal to
  the one-rank forward of the same model on the same rank (``torch.equal``:
  the same blocks in the same order, the activations sent in their own
  dtype and layout) and within 1e-4 of JAX's;
* each rank holding its stage's blocks only;
* the JAX routes: TI2V's Euler segment and t2v first segment, I2V's CFG
  Euler segment (``generate``, rank 0 alone holding the VAE, umT5 and CLIP),
  on JAX's noise, within 1e-4 (latents) and 1e-3 (the 14B video);
* the refusals: a stage count that does not divide the layers, a quantized
  trunk, a sampler other than Euler.

fp32 inputs from numpy seeds; the tolerances are those of
``tests/test_torch_teacache.py`` and ``tests/test_torch_i2v.py`` (float32
sums in another order on XLA:CPU and ATen).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from test_torch_i2v import TINY as I2V, _params as i2v_params
from test_torch_teacache import CFG, F_HIST, LFZ
from test_torch_pipeline import _params
from torch_parity import assert_close, port_config
from yume_tpu.models.clip import CLIPVisual as JaxCLIP
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.models.t5 import T5Encoder as JaxT5
from yume_tpu.models.vae import WanVAE as JaxVAE
from yume_tpu.parallel.pipeline import pp_dit_apply, prepare_pp
from yume_tpu.pipelines import i2v as ji2v
from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxPipeline
from yume_tpu_torch.parallel.pipeline import PPGroups, stage_blocks
from yume_tpu_torch.pipelines.i2v import I2VPipeline
from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
from yume_tpu_torch.utils import convert

OUT_TOL, LATENT_TOL, VIDEO_TOL = 1e-4, 1e-4, 1e-3
STAGES = 2
SIZE = 32


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = torch_parity.RankPool(STAGES, str(tmp_path_factory.mktemp("pp") / "rendezvous"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def ti2v_model():
    """test_torch_teacache.py's 4-layer fp32 DiT: JAX parameters and the
    port's state dict."""
    dit_p = _params(JaxDiT(CFG.dit, dtype=jnp.float32), 21, jnp.zeros((1, 3, 4, 4, 8)),
                    jnp.zeros((1, 3)), jnp.zeros((1, 16, 16)), packed=False)
    return dit_p, convert.dit_state_dict(dit_p, CFG.dit.num_layers)


@pytest.fixture(scope="module")
def i2v_model():
    """test_torch_i2v.py's tiny 14B-shaped pipeline: the JAX pipeline and
    the port's state dicts."""
    c = I2V
    dit, vae, t5, clip = (JaxDiT(c.dit, dtype=jnp.float32), JaxVAE(c.vae),
                          JaxT5(c.t5, dtype=jnp.float32), JaxCLIP(c.clip))
    ids = jnp.zeros((1, 16), jnp.int32)
    dit_p = i2v_params(dit, 101, jnp.zeros((1, 3, 8, 8, 18)), jnp.zeros((1, 3)),
                       jnp.zeros((1, 16, 16)), packed=False,
                       clip_context=jnp.zeros((1, 5, 12)))
    jpipe = ji2v.I2VPipeline(
        c, dit, dit_p, vae, i2v_params(vae, 102, jnp.zeros((1, 5, SIZE, SIZE, 3))),
        t5, i2v_params(t5, 103, ids, jnp.ones_like(ids)),
        clip, i2v_params(clip, 104, jnp.zeros((1, 16, 16, 3))))
    return jpipe, convert.pipeline_state_dicts(jpipe)


def _mesh_devices():
    return jax.devices()[:STAGES]


# (model, packed, batch, microbatches)
FORWARDS = {
    "packed": ("ti2v", True, 1, None),
    "unpacked": ("ti2v", False, 1, None),
    "packed_batch2": ("ti2v", True, 2, None),
    "unpacked_batch2_one_microbatch": ("ti2v", False, 2, 1),
    "clip_context": ("i2v", True, 1, None),
    "clip_context_unpacked": ("i2v", False, 1, None),
}


@pytest.mark.parametrize("case", sorted(FORWARDS))
def test_pp_forward_matches_jax_and_one_rank(ranks, ti2v_model, i2v_model, case):
    which, packed, b, m = FORWARDS[case]
    cfg = CFG.dit if which == "ti2v" else I2V.dit
    params = ti2v_model[0] if which == "ti2v" else i2v_model[0].dit_params
    sd = ti2v_model[1] if which == "ti2v" else i2v_model[1]["dit"]
    h = 4 if which == "ti2v" else 8
    rng = np.random.default_rng(61)
    f = F_HIST + LFZ
    x = rng.standard_normal((b, f, h, h, cfg.in_dim)).astype(np.float32)
    t = np.concatenate([np.zeros((b, F_HIST)), np.full((b, LFZ), 700.0)], 1)
    if not packed:
        t = rng.uniform(0, 1000, (b, f))
    t = t.astype(np.float32)
    ctx = rng.standard_normal((b, 16, 16)).astype(np.float32)
    clip = (rng.standard_normal((b, 5, 12)).astype(np.float32) if cfg.image_context_len
            else None)
    pp = prepare_pp(params, cfg.num_layers, STAGES, devices=_mesh_devices())
    jdit = JaxDiT(cfg, dtype=jnp.float32)

    @jax.jit
    def jax_pp(other, staged, x, t, ctx, clip):
        return pp_dit_apply(jdit, other, staged, pp.mesh, x, t, ctx, latent_frame_zero=LFZ,
                            clip_context=clip, num_microbatches=m, packed=packed)

    want = jax_pp(pp.other, pp.staged, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                  None if clip is None else jnp.asarray(clip))
    results = ranks.run("rank_pp_dit", port_config(cfg), sd, x, t, ctx, clip, packed, LFZ, m)
    for got, equal, held, total, blocks in results:
        assert equal, "the staged forward is not the one-rank forward bit for bit"
        np.testing.assert_array_equal(got, results[0][0])
        assert_close(got, want, OUT_TOL)
        # each rank keeps its half of the blocks and everything else
        assert total - held == blocks // STAGES
    assert np.abs(np.asarray(want)).max() > 1e-2       # not a bias-only output


def _segment_data():
    rng = np.random.default_rng(22)
    return (rng.standard_normal((1, F_HIST, 4, 4, 8)).astype(np.float32),
            rng.standard_normal((1, LFZ, 4, 4, 8)).astype(np.float32),
            rng.standard_normal((1, 16, 16)).astype(np.float32))


def _jax_ti2v(params):
    jpipe = JaxPipeline(CFG, JaxDiT(CFG.dit, dtype=jnp.float32), params, None, None)
    jpipe.parallelize_pp(STAGES, devices=_mesh_devices())
    return jpipe


def test_pp_generate_segment_matches_jax(ranks, ti2v_model):
    history, noise, ctx = _segment_data()
    want = _jax_ti2v(ti2v_model[0]).generate_segment(
        jnp.asarray(history), jnp.asarray(ctx), steps=3, noise=jnp.asarray(noise))
    results = ranks.run("rank_pp_ti2v", port_config(CFG), ti2v_model[1], "generate_segment",
                        [history, ctx], dict(steps=3, noise=noise))
    np.testing.assert_array_equal(results[1], results[0])
    np.testing.assert_array_equal(results[0][:, :F_HIST], history)
    assert_close(results[0], want, LATENT_TOL)


def test_pp_generate_t2v_matches_jax(ranks, ti2v_model):
    """The unpacked forward staged: 5 frames of 32×32 (3 latent frames of
    4×4, the activations transposed as the unpacked embedding leaves
    them)."""
    _, noise, ctx = _segment_data()
    noise = np.random.default_rng(23).standard_normal((1, 3, 4, 4, 8)).astype(np.float32)
    kw = dict(size=(32, 32), frame_num=5, steps=3, return_latents=True)
    want = _jax_ti2v(ti2v_model[0]).generate_t2v(jnp.asarray(ctx), noise=jnp.asarray(noise),
                                                 **kw)
    results = ranks.run("rank_pp_ti2v", port_config(CFG), ti2v_model[1], "generate_t2v",
                        [ctx], dict(noise=noise, **kw))
    np.testing.assert_array_equal(results[1], results[0])
    assert_close(results[0], want, LATENT_TOL)


def test_pp_i2v_generate_matches_jax(ranks, i2v_model):
    """The 14B's CFG Euler segment staged, with rank 0 alone holding the
    VAE, umT5 and CLIP: it computes the conditioning and decodes; rank 1
    gets the conditioning from it and the video's shape."""
    jpipe, sds = i2v_model
    rng = np.random.default_rng(62)
    img = rng.uniform(-1, 1, (1, 1, SIZE, SIZE, 3)).astype(np.float32)
    ctx, ctx_null = (rng.standard_normal((1, 16, 16)).astype(np.float32) for _ in range(2))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 3, 8, 8, 8), jnp.float32))
    jpp = dataclasses.replace(jpipe, _cond_cache=None)
    jpp.parallelize_pp(STAGES, devices=_mesh_devices())
    want_lat, want_video = jpp.generate(jnp.asarray(img), jnp.asarray(ctx),
                                        jnp.asarray(ctx_null), frame_num=5, steps=2, seed=3)
    results = ranks.run("rank_i2v_generate", "pp", port_config(I2V), sds, img, ctx, ctx_null,
                        noise, dict(frame_num=5, steps=2, seed=3))
    (lat0, _, video), (lat1, _, shape1) = results
    np.testing.assert_array_equal(lat1, lat0)
    assert shape1 == video.shape == (1, 5, SIZE, SIZE, 3)
    assert_close(lat0, want_lat, LATENT_TOL)
    assert_close(video, want_video, VIDEO_TOL)


def test_stage_counts_must_divide_the_layers():
    assert stage_blocks(30, 3, 2) == range(20, 30)
    assert stage_blocks(40, 8, 1) == range(5, 10)
    for layers, stages in ((30, 4), (40, 3), (2, 3)):
        with pytest.raises(ValueError, match="does not divide"):
            stage_blocks(layers, stages, 0)


def test_pp_refusals(ti2v_model):
    """A sampler other than Euler on a staged trunk (the JAX refusal), and
    staging a quantized trunk (which the JAX parallelize_pp would leave
    unstaged)."""
    dit = torch_parity._port_dit(port_config(CFG.dit), ti2v_model[1])
    staged = TI2VPipeline(port_config(CFG), dit, None,
                          pp_groups=PPGroups(group=None, stages=2, stage=0))
    history, noise, ctx = (torch.from_numpy(a) for a in _segment_data())
    for sampler in ("teacache", "sde", "time_travel", "tts"):
        with pytest.raises(NotImplementedError, match="pp trunk supports the euler"):
            staged.generate_segment(history, ctx, noise=noise, sampler=sampler)
    i2v = I2VPipeline(port_config(I2V), dit, None, pp_groups=staged.pp_groups)
    with pytest.raises(NotImplementedError, match="pp trunk supports the euler"):
        i2v.generate(torch.zeros((1, 1, SIZE, SIZE, 3)), ctx, ctx, frame_num=5,
                     sampler="teacache")
    pipe = TI2VPipeline(port_config(CFG), dit, None)
    pipe.quantize_int8()
    with pytest.raises(NotImplementedError, match="int8/int4 trunk is not staged"):
        pipe.parallelize_pp(STAGES)
