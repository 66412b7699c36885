"""The text-to-video first segment of the port against the JAX package on
the CPU: the unpacked DiT forward (``packed=False``, bf16 matmul config and
W8A8) and its embedding, the samplers ``euler_sample``,
``sample_dpmpp_2m`` and ``sample_unipc`` (order 2 and 3) on a toy velocity
field, ``generate_t2v`` with every solver (the multistep ones with CFG),
``generate_t2v_dmd``, and a t2v first segment continued by
``generate_segment``, on perturbed parameters and injected noise.

A tiny 2-layer, dim-64 model in fp32. Tolerances:
  * the embedding's ``idx``, ``cos``, ``sin`` and ``t_values`` equal;
  * the DiT outputs 1e-4 (bf16 matmul config and W8A8 alike), from the
    order of float32 sums differing between XLA:CPU and ATen, as
    ``test_torch_dit.py``; the W8A8 products are exact on both sides
    (``test_torch_quant_matmul.py``);
  * the toy samplers 1e-5: fp32 elementwise steps whose only difference is
    the last bit of ``sin`` and of the solvers' fp32 scalars;
  * latents 1e-4 and video 1e-3, as ``test_torch_pipeline.py`` (both
    pipelines round the latent to bf16 before the DiT, and the decoder
    amplifies the last bits).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import TINY, _params
from torch_parity import assert_close, port_config, torch_threads
from yume_tpu.diffusion import multistep as jmultistep
from yume_tpu.diffusion import samplers as jsamplers
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.models.vae import WanVAE as JaxVAE
from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxPipeline
from yume_tpu_torch.diffusion import multistep as tmultistep
from yume_tpu_torch.diffusion import samplers as tsamplers
from yume_tpu_torch.diffusion.schedule import sampling_sigmas, unipc_sigmas
from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
from yume_tpu_torch.utils import convert

W8A8 = dataclasses.replace(TINY, dit=dataclasses.replace(TINY.dit, w8a8=True))
OUT_TOL, TOY_TOL, LATENT_TOL, VIDEO_TOL = 1e-4, 1e-5, 1e-4, 1e-3
# a 5-frame clip of 32×32 pixels: 3 latent frames of 4×4, 12 tokens
SIZE, FRAME_NUM, F_LAT = (32, 32), 5, 3
CTX_SHAPE = (1, 16, 16)


@pytest.fixture(scope="module")
def setup():
    c = TINY
    dit_p = _params(JaxDiT(c.dit, dtype=jnp.float32), 31, jnp.zeros((1, 3, 4, 4, 8)),
                    jnp.zeros((1, 3)), jnp.zeros((1, 16, 16)), packed=False)
    vae_p = _params(JaxVAE(c.vae), 32, jnp.zeros((1, 5, 32, 32, 3)))
    jpipes = {w8a8: JaxPipeline(cfg, JaxDiT(cfg.dit, dtype=jnp.float32), dit_p,
                                JaxVAE(cfg.vae), vae_p)
              for w8a8, cfg in ((False, TINY), (True, W8A8))}
    with torch_threads(2):
        tpipe = TI2VPipeline.from_state_dicts(
            port_config(c), convert.dit_state_dict(dit_p, c.dit.num_layers),
            convert.vae22_state_dict(vae_p, c.vae.num_res_blocks), device="cpu",
            dtype=torch.float32)
    tpipes = {False: tpipe, True: tpipe.with_w8a8()}
    rng = np.random.default_rng(33)
    data = dict(ctx=rng.standard_normal(CTX_SHAPE).astype(np.float32),
                ctx_null=rng.standard_normal(CTX_SHAPE).astype(np.float32),
                noise=rng.standard_normal((1, F_LAT, 4, 4, 8)).astype(np.float32),
                tail=rng.standard_normal((1, 2, 4, 4, 8)).astype(np.float32))
    with torch_threads(2):
        yield jpipes, tpipes, dit_p, data


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the unpacked forward ----------------------------------------------------


def _forward_inputs(f, seed):
    """Two samples of ``f`` latent frames with distinct per-frame
    timesteps."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, f, 8, 8, 8)).astype(np.float32)
    t = rng.uniform(0.0, 1000.0, (2, f)).astype(np.float32)
    ctx = rng.standard_normal((2,) + CTX_SHAPE[1:]).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("f", [1, 3, 5])
def test_unpacked_forward_matches_jax(setup, f):
    jpipes, tpipes, dit_p, _ = setup
    jdit, tdit = jpipes[False].dit, tpipes[False].dit
    x, t, ctx = _forward_inputs(f, 34 + f)
    want = jdit.apply(dit_p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), packed=False)
    with torch.no_grad():
        got = tdit(_t(x), _t(t), _t(ctx), packed=False)
        emb = tdit.embed_unpacked(_t(x), _t(t), _t(ctx))
    assert got.shape == (2, f, 8, 8, 8) and got.dtype == torch.float32
    assert np.abs(np.asarray(want)).max() > 1e-2  # not a bias-only output
    assert_close(got, want, OUT_TOL)

    jemb = jdit.apply(dit_p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                      method=jdit.embed_unpacked)
    # K = F table rows: a token's row is its latent frame
    assert emb["idx"].dtype == torch.int32 and emb["idx"].shape == (2, f * 16)
    for key in ("idx", "cos", "sin", "t_values"):
        np.testing.assert_array_equal(emb[key].numpy(), np.asarray(jemb[key]), err_msg=key)
    assert emb["t_values"].dtype == torch.float32
    assert emb["l_hist"] == jemb["l_hist"] == 0
    assert emb["tail_grid"] == tuple(jemb["tail_grid"]) == (f, 4, 4)
    assert_close(emb["tokens"], jemb["tokens"], 1e-5)


def test_unpacked_w8a8_forward_matches_jax(setup):
    jpipes, tpipes, dit_p, _ = setup
    x, t, ctx = _forward_inputs(3, 38)
    want = jpipes[True].dit.apply(dit_p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                  packed=False)
    with torch.no_grad():
        got = tpipes[True].dit(_t(x), _t(t), _t(ctx), packed=False)
        bf16 = tpipes[False].dit(_t(x), _t(t), _t(ctx), packed=False)
    assert_close(got, want, OUT_TOL)
    assert np.abs((got - bf16).numpy()).max() > 1e-4  # the int8 products did run


# -- the samplers on a toy velocity field ------------------------------------


def _toy_v(x, s, lib):
    """A smooth, state-dependent velocity; ``s`` is σ [B] or t_frame [B, F]."""
    s = s.reshape(s.shape + (1,) * (x.ndim - s.ndim))
    return x * (0.3 + 0.5 * s) + 0.1 * lib.sin(3.0 * x)


def _toy_noise():
    return np.random.default_rng(39).standard_normal((2, 3, 4, 4, 8)).astype(np.float32)


def test_euler_sample_matches_jax():
    noise = _toy_noise()
    sig = sampling_sigmas(6, 5.0)
    want = jsamplers.euler_sample(lambda x, t: _toy_v(x, t / 1000.0, jnp),
                                  jnp.asarray(noise), sig)
    got = tsamplers.euler_sample(lambda x, t: _toy_v(x, t / 1000.0, torch), _t(noise), sig)
    assert got.dtype == torch.float32
    assert_close(got, want, TOY_TOL)


def test_dpmpp_2m_matches_jax():
    noise = _toy_noise()
    sig = sampling_sigmas(6, 5.0)
    want = jmultistep.sample_dpmpp_2m(lambda x, s: _toy_v(x, s, jnp), jnp.asarray(noise), sig)
    got = tmultistep.sample_dpmpp_2m(lambda x, s: _toy_v(x, s, torch), _t(noise), sig)
    assert_close(got, want, TOY_TOL)


@pytest.mark.parametrize("order", [2, 3])
def test_unipc_matches_jax(order):
    noise = _toy_noise()
    sig = unipc_sigmas(7, 5.0)
    want = jmultistep.sample_unipc(lambda x, s: _toy_v(x, s, jnp), jnp.asarray(noise), sig,
                                   order=order)
    got = tmultistep.sample_unipc(lambda x, s: _toy_v(x, s, torch), _t(noise), sig,
                                  order=order)
    assert_close(got, want, TOY_TOL)


@pytest.mark.parametrize("sampler", ["sample_dpmpp_2m", "sample_unipc"])
@pytest.mark.parametrize("arg", ["denoise_fn_low", "boundary", "step_range", "init_carry",
                                 "return_carry"])
def test_multistep_refuses_dual_expert_arguments(sampler, arg):
    value = {"denoise_fn_low": lambda x, s: x, "boundary": 0.875, "step_range": (0, 2),
             "init_carry": (), "return_carry": True}[arg]
    with pytest.raises(NotImplementedError, match=f"{arg}.*queue 1, item 6"):
        getattr(tmultistep, sampler)(lambda x, s: x, torch.zeros(1, 1), sampling_sigmas(2, 5.0),
                                     **{arg: value})


# -- the pipeline ------------------------------------------------------------


def _both_t2v(setup, solver, steps, **kw):
    jpipes, tpipes, _, data = setup
    guide = {} if solver == "euler" else dict(guide_scale=5.0)
    jkw = dict(ctx_null=jnp.asarray(data["ctx_null"])) if guide else {}
    tkw = dict(ctx_null=_t(data["ctx_null"])) if guide else {}
    want = jpipes[False].generate_t2v(
        jnp.asarray(data["ctx"]), size=SIZE, frame_num=FRAME_NUM, steps=steps, solver=solver,
        noise=jnp.asarray(data["noise"]), return_latents=True, **guide, **jkw, **kw)
    got = tpipes[False].generate_t2v(
        _t(data["ctx"]), size=SIZE, frame_num=FRAME_NUM, steps=steps, solver=solver,
        noise=_t(data["noise"]), return_latents=True, **guide, **tkw, **kw)
    return want, got


@pytest.mark.parametrize("solver", ["euler", "unipc", "unipc3", "dpmpp"])
def test_generate_t2v_matches_jax(setup, solver):
    jpipes, tpipes, _, data = setup
    want, got = _both_t2v(setup, solver, steps=4)
    assert got.shape == (1, F_LAT, 4, 4, 8) and got.dtype == torch.float32
    assert np.abs(got.numpy() - data["noise"]).max() > 1e-2
    assert_close(got, want, LATENT_TOL)
    jvid = jpipes[False].decode_auto(want)
    tvid = tpipes[False].decode_auto(got)
    assert tvid.shape == (1, FRAME_NUM, 32, 32, 3)
    assert (np.abs(np.asarray(jvid)) < 0.99).mean() > 0.1  # not all clipped
    assert_close(tvid, jvid, VIDEO_TOL)


def test_generate_t2v_decodes_by_default(setup):
    jpipes, tpipes, _, data = setup
    want = jpipes[False].generate_t2v(jnp.asarray(data["ctx"]), size=SIZE,
                                      frame_num=FRAME_NUM, steps=2,
                                      noise=jnp.asarray(data["noise"]))
    got = tpipes[False].generate_t2v(_t(data["ctx"]), size=SIZE, frame_num=FRAME_NUM, steps=2,
                                     noise=_t(data["noise"]))
    assert got.shape == (1, FRAME_NUM, 32, 32, 3)
    assert_close(got, want, VIDEO_TOL)


def test_generate_t2v_seeded_noise(setup):
    """Without ``noise`` the latent starts from N(0, 1) drawn by a seeded
    torch.Generator on the pipeline's device (other numbers than JAX's
    PRNG): the same seed gives the same latents, another seed others."""
    _, tpipes, _, data = setup
    run = [tpipes[False].generate_t2v(_t(data["ctx"]), size=SIZE, frame_num=FRAME_NUM,
                                      steps=1, seed=s, return_latents=True)
           for s in (5, 5, 6)]
    assert run[0].shape == (1, F_LAT, 4, 4, 8)
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])


def test_generate_t2v_dmd_matches_jax(setup):
    jpipes, tpipes, dit_p, data = setup
    kw = dict(size=SIZE, frame_num=FRAME_NUM, steps=3)
    want = jpipes[False].generate_t2v_dmd(jnp.asarray(data["ctx"]), teacher_params=dit_p,
                                          noise=jnp.asarray(data["noise"]), **kw)
    got = tpipes[False].generate_t2v_dmd(_t(data["ctx"]), noise=_t(data["noise"]), **kw)
    assert_close(got, want, LATENT_TOL)
    # an explicit teacher (this pipeline's own DiT) gives the same rollout
    teacher = tpipes[False].generate_t2v_dmd(_t(data["ctx"]), noise=_t(data["noise"]),
                                             teacher_params=tpipes[False].dit, **kw)
    assert torch.equal(teacher, got)


def test_t2v_then_segment_matches_jax(setup):
    """The webapp's rollout: a t2v first segment's latents continued by one
    packed ``generate_segment``."""
    jpipes, tpipes, _, data = setup
    jlat, tlat = _both_t2v(setup, "euler", steps=3)
    jlat = jpipes[False].generate_segment(jlat, jnp.asarray(data["ctx"]), steps=2,
                                          noise=jnp.asarray(data["tail"]))
    tlat = tpipes[False].generate_segment(tlat, _t(data["ctx"]), steps=2,
                                          noise=_t(data["tail"]))
    assert tlat.shape == (1, F_LAT + 2, 4, 4, 8)
    assert_close(tlat, jlat, LATENT_TOL)
    assert_close(tpipes[False].decode_auto(tlat[:, -2:]),
                 jpipes[False].decode_auto(jlat[:, -2:]), VIDEO_TOL)


class PPParams:
    """Stands for the reference's pipeline-parallel parameters."""


@pytest.mark.parametrize("params,item", [((None, None), "quantize_dit_blocks"),
                                         (PPParams(), "item 8")])
def test_t2v_refuses_unported_params(setup, params, item):
    _, tpipes, _, data = setup
    with pytest.raises(NotImplementedError, match=item):
        tpipes[False].generate_t2v_dmd(_t(data["ctx"]), teacher_params=params, size=SIZE,
                                       frame_num=FRAME_NUM, steps=1)


def test_t2v_refuses_unknown_solver(setup):
    _, tpipes, _, data = setup
    with pytest.raises(ValueError, match="solver"):
        tpipes[False].generate_t2v(_t(data["ctx"]), size=SIZE, frame_num=FRAME_NUM,
                                   steps=1, solver="heun")
