"""The port's 14B i2v path against the JAX package on the CPU, on a tiny
14B-shaped pipeline (the msk/y channels, the CLIP branch, the Wan2.1 VAE,
FramePack) with perturbed parameters converted to the port:

* ``I2VCrossAttention`` and the i2v DiT, packed and unpacked, in fp32 and
  with W8A8;
* ``build_mask_channels``, ``clip_features`` and ``make_conditioning`` in
  image and history mode, the incremental history encode equal to a fresh
  one and to the full-clip encode;
* the CFG segment samplers on a toy velocity field;
* ``generate`` with every sampler (euler, teacache at a fixed interval and
  adaptive, sde, time_travel, tts, the distilled cond-only mode) and two
  ``generate_next`` continuations, on JAX's noise and churn draws injected;
* the refusals of what is not ported.

fp32. Tolerances: the toy samplers 1e-5 (fp32 elementwise steps, their
scalars rounded alike); one cross-attention 1e-5; the DiT outputs, ``y``,
the CLIP features and the latents 1e-4 (float32 sums in another order on
XLA:CPU and ATen; both pipelines round the DiT input to bf16); the videos
1e-3 (the decoder amplifies the last bits). ``n_full`` and the masks must
be equal.

TeaCache segments: both packages keep the block residuals in bf16, and a
residual whose float32 value differs in its last bit can round to the
neighbouring bf16 value (one of the 8,704 residuals of a forward of this
model did: 1.2e-4 apart at |r| ≤ 1.6). A cached step adds it back, the
live block after it spreads it over the tokens, and the guidance scale of
5 multiplies it: the latents moved up to 1.1e-3. So the TeaCache latents
are held to 2e-3 and their videos to 2e-2, and each segment must differ
from the uncached Euler one by more than ten times that.

Continuations: the history's ``y`` is the VAE encode of 5 or 9 frames,
~2e-6 apart on the two sides (``test_make_conditioning_matches_jax``
holds it to 1e-4), and both pipelines round the DiT input ``[latent | y]``
to bf16 (a step of 7.8e-3 at |y| ≈ 1): an element that close to a
rounding boundary rounds apart, which moved the second continuation's
latents by up to 8.3e-4 (the sampler on the same ``y`` and CLIP features
agreed to 3.3e-6). So the continuations are held to the same 2e-3 and
2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, perturb, port_config, torch_threads
from yume_tpu.configs import CLIPConfig, DiTConfig, PipelineConfig, T5Config, VAEConfig
from yume_tpu.diffusion import samplers as jsamplers
from yume_tpu.models.clip import CLIPVisual as JaxCLIP
from yume_tpu.models.dit import I2VCrossAttention as JaxI2VCross
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.models.t5 import T5Encoder as JaxT5
from yume_tpu.models.vae import WanVAE as JaxVAE
from yume_tpu.pipelines import i2v as ji2v
from yume_tpu_torch.diffusion import samplers as tsamplers
from yume_tpu_torch.diffusion.schedule import sampling_sigmas
from yume_tpu_torch.pipelines import i2v as ti2v
from yume_tpu_torch.utils import convert

# the smoke config's shapes (stride 2 × 4 × 4, 2 mask channels) with 4 layers,
# so that TeaCache's num_layers // 4 leaves a live block on each side
TINY = PipelineConfig(
    name="i2v-tiny",
    dit=DiTConfig(model_type="i2v", in_dim=18, out_dim=8, dim=64, ffn_dim=128, freq_dim=32,
                  text_dim=16, text_len=16, num_heads=4, num_layers=4, framepack=True,
                  image_context_len=5, image_dim=12),
    vae=VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                  temporal_downsample=(True, False), stride=(2, 4, 4), patchify=1,
                  arch="wan21"),
    t5=T5Config(vocab_size=64, dim=16, dim_attn=16, dim_ffn=24, num_heads=2, num_layers=1,
                text_len=16),
    clip=CLIPConfig(image_size=16, patch_size=8, dim=12, num_heads=2, num_layers=2,
                    out_tokens=5),
    latent_frame_zero=2,
    sample_shift=3.0,
).check_i2v_channels()
W8A8 = dataclasses.replace(TINY, dit=dataclasses.replace(TINY.dit, w8a8=True))
TOY_TOL, ATTN_TOL, TOL, VIDEO_TOL = 1e-5, 1e-5, 1e-4, 1e-3
# one bf16 step of a DiT input or a cached residual, carried to the output
BF16_STEP_TOL, BF16_STEP_VIDEO_TOL = 2e-3, 2e-2
SIZE, FRAMES = 32, 5            # 32×32 pixels → 8×8 latents; 5 frames → 3 latent
TTS_SEED_OFFSET = 7777


def _params(model, seed, *args, **kw):
    shapes = jax.eval_shape(lambda k: model.init(k, *args, **kw), jax.random.PRNGKey(0))
    return {"params": perturb(shapes["params"], seed)}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def pipes():
    c = TINY
    dit = JaxDiT(c.dit, dtype=jnp.float32)
    vae, t5, clip = JaxVAE(c.vae), JaxT5(c.t5, dtype=jnp.float32), JaxCLIP(c.clip)
    ids = jnp.zeros((1, 16), jnp.int32)
    dit_p = _params(dit, 101, jnp.zeros((1, 3, 8, 8, 18)), jnp.zeros((1, 3)),
                    jnp.zeros((1, 16, 16)), packed=False, clip_context=jnp.zeros((1, 5, 12)))
    jpipe = ji2v.I2VPipeline(
        c, dit, dit_p, vae, _params(vae, 102, jnp.zeros((1, 5, SIZE, SIZE, 3))),
        t5, _params(t5, 103, ids, jnp.ones_like(ids)),
        clip, _params(clip, 104, jnp.zeros((1, 16, 16, 3))))
    sds = convert.pipeline_state_dicts(jpipe)
    assert set(sds) == {"dit", "vae", "t5", "clip"}
    with torch_threads(2):
        tpipe = ti2v.I2VPipeline.from_state_dicts(
            port_config(c), sds["dit"], sds["vae"], sds["t5"], sds["clip"], device="cpu",
            dtype=torch.float32)
        yield jpipe, tpipe


def _frames(seed, t, size=SIZE):
    return np.random.default_rng(seed).uniform(-1, 1, (1, t, size, size, 3)).astype(np.float32)


def _ctx(seed):
    return np.random.default_rng(seed).standard_normal((1, 16, 16)).astype(np.float32)


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("w8a8", [False, True])
def test_i2v_cross_attention_matches_jax(pipes, w8a8):
    jpipe, tpipe = pipes
    cfg = W8A8 if w8a8 else TINY
    rng = np.random.default_rng(105)
    x = rng.standard_normal((1, 40, 64)).astype(np.float32)
    ctx = rng.standard_normal((1, 5 + 16, 64)).astype(np.float32)
    want = JaxI2VCross(cfg.dit).apply(
        {"params": jpipe.dit_params["params"]["blocks_1"]["cross_attn"]}, jnp.asarray(x),
        jnp.asarray(ctx))
    dit = tpipe.with_w8a8().dit if w8a8 else tpipe.dit
    with torch.no_grad():
        got = dit.blocks[1].cross_attn(_t(x), _t(ctx))
    assert type(dit.blocks[1].cross_attn).__name__ == "I2VCrossAttention"
    assert np.abs(np.asarray(want)).max() > 1e-2
    assert_close(got, want, ATTN_TOL if not w8a8 else TOL)


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("packed", [True, False])
def test_i2v_dit_matches_jax(pipes, packed, w8a8):
    jpipe, tpipe = pipes
    cfg = W8A8 if w8a8 else TINY
    rng = np.random.default_rng(106)
    x = rng.standard_normal((1, 5, 8, 8, 18)).astype(np.float32)
    t = np.array([[0.0, 0.0, 0.0, 700.0, 700.0]], np.float32)
    ctx, clip_ctx = _ctx(107), rng.standard_normal((1, 5, 12)).astype(np.float32)
    want = JaxDiT(cfg.dit, dtype=jnp.float32).apply(
        jpipe.dit_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), packed=packed,
        latent_frame_zero=2, clip_context=jnp.asarray(clip_ctx))
    dit = tpipe.with_w8a8().dit if w8a8 else tpipe.dit
    with torch.no_grad():
        got = dit(_t(x), _t(t), _t(ctx), packed=packed, latent_frame_zero=2,
                  clip_context=_t(clip_ctx))
    assert got.shape == want.shape == ((1, 2, 8, 8, 8) if packed else (1, 5, 8, 8, 8))
    assert np.abs(np.asarray(want)).max() > 1e-2
    assert_close(got, want, TOL)


def test_i2v_dit_needs_clip_context(pipes):
    _, tpipe = pipes
    with pytest.raises(ValueError, match="clip_context"):
        tpipe.dit(torch.zeros(1, 3, 8, 8, 18), torch.zeros(1, 3), torch.zeros(1, 16, 16),
                  latent_frame_zero=2)


# -- conditioning -------------------------------------------------------------


@pytest.mark.parametrize("frame_num,cond,stride_t", [(81, 1, 4), (113, 81, 4), (5, 1, 2),
                                                     (13, 5, 2)])
def test_build_mask_channels_matches_jax(frame_num, cond, stride_t):
    want = ji2v.build_mask_channels(frame_num, 3, 5, cond_pixel_frames=cond, batch=2,
                                    stride_t=stride_t)
    got = ti2v.build_mask_channels(frame_num, 3, 5, cond_pixel_frames=cond, batch=2,
                                   stride_t=stride_t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_clip_features_match_jax(pipes):
    jpipe, tpipe = pipes
    frame = _frames(108, 1)[:, 0]
    want = jpipe.clip_features(jnp.asarray(frame))
    got = tpipe.clip_features(_t(frame))
    assert got.shape == want.shape == (1, 5, 12)
    assert_close(got, want, TOL)


@pytest.mark.parametrize("history", [False, True])
def test_make_conditioning_matches_jax(pipes, history):
    """Image mode: one frame padded to 5; history mode: 5 frames padded to
    13 (a 4n+1 history, streamed and cached)."""
    jpipe, tpipe = pipes
    frames = _frames(109, 5 if history else 1)
    frame_num = 13 if history else FRAMES
    jpipe._cond_cache = tpipe._cond_cache = None
    want = jpipe.make_conditioning(jnp.asarray(frames), frame_num, history_mode=history)
    got = tpipe.make_conditioning(_t(frames), frame_num, history_mode=history)
    assert got.shape == want.shape == (1, (frame_num - 1) // 2 + 1, 8, 8, 2 + 8)
    assert np.abs(np.asarray(want)[..., 2:]).max() > 0.1
    np.testing.assert_array_equal(got[..., :2].numpy(), np.asarray(want)[..., :2])
    assert_close(got, want, TOL)
    assert (tpipe._cond_cache is not None) == history
    assert (tpipe._cond_cache or {}).get("frames") == (5 if history else None)


def test_incremental_conditioning_equals_full(pipes):
    """A 9-frame history after a cached 5-frame one encodes only its 4 new
    frames: equal to a fresh streamed encode and to the full-clip encode."""
    _, tpipe = pipes
    frames = _t(_frames(110, 9))
    tpipe._cond_cache = None
    tpipe.make_conditioning(frames[:, :5], 13, history_mode=True)
    got = tpipe.make_conditioning(frames, 17, history_mode=True)
    assert tpipe._cond_cache["frames"] == 9
    tpipe._cond_cache = None
    fresh = tpipe.make_conditioning(frames, 17, history_mode=True)
    with torch.no_grad():
        full = tpipe.vae.encode(torch.cat([frames, frames.new_zeros((1, 8, SIZE, SIZE, 3))], 1))
    assert_close(got, fresh, 2e-5)
    assert_close(got[..., 2:], full, 2e-5)
    tpipe._cond_cache = None


# -- the CFG segment samplers on a toy velocity field ----------------------------


def _toy_v(x, t_frame, ctx, lib):
    s = t_frame.reshape(t_frame.shape + (1,) * (x.ndim - t_frame.ndim)) / 1000.0
    return x * (0.3 + 0.5 * s) + 0.1 * lib.sin(3.0 * x) + 0.2 * ctx.mean()


def _toy_inputs():
    rng = np.random.default_rng(111)
    lat = rng.standard_normal((2, 5, 4, 4, 8)).astype(np.float32)
    noise = rng.standard_normal((2, 5, 4, 4, 8)).astype(np.float32)
    return lat, noise, np.float32(0.7), np.float32(-0.4)


def _jax_draws(key, n, shape):
    """The draws of one rng split a churn, as the JAX samplers take them."""
    out = []
    for _ in range(n):
        key, eps = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(eps, shape, jnp.float32)))
    return out


def _feeder(draws):
    it = iter(draws)

    def noise_fn(shape):
        a = next(it)
        assert a.shape == shape
        return _t(a)
    return noise_fn


@pytest.mark.parametrize("distilled", [False, True])
def test_cfg_euler_sample_segment_matches_jax(distilled):
    lat, noise, c, u = _toy_inputs()
    sig = sampling_sigmas(4, 3.0)
    want = jsamplers.cfg_euler_sample_segment(
        lambda x, t, k: _toy_v(x, t, k, jnp), jnp.asarray(lat), jnp.asarray(noise),
        jnp.asarray(c), None if distilled else jnp.asarray(u), sig, 2, 5.0)
    got = tsamplers.cfg_euler_sample_segment(
        lambda x, t, k: _toy_v(x, t, k, torch), _t(lat), _t(noise), _t(c),
        None if distilled else _t(u), sig, 2, 5.0)
    assert_close(got, want, TOY_TOL)


def test_cfg_teacache_samplers_match_jax():
    """The cached samplers on a toy 'DiT' whose cache is its last velocity:
    the fixed interval and the adaptive one (its n_full, and a threshold
    that leaves cached and full steps both)."""
    lat, noise, c, u = _toy_inputs()
    sig = sampling_sigmas(8, 3.0)

    def fns(lib):
        def full(x, t, k):
            v = _toy_v(x, t, k, lib)
            return v, v

        def cached(x, t, k, cache):
            return 0.5 * cache + 0.5 * _toy_v(x, t, k, lib)
        return full, cached

    args_j = (jnp.asarray(lat), jnp.asarray(noise), jnp.asarray(c), jnp.asarray(u), sig, 2, 5.0)
    args_t = (_t(lat), _t(noise), _t(c), _t(u), sig, 2, 5.0)
    want = jsamplers.cfg_euler_sample_segment_cached(*fns(jnp), *args_j, cache_interval=3)
    got = tsamplers.cfg_euler_sample_segment_cached(*fns(torch), *args_t, cache_interval=3)
    assert_close(got, want, TOY_TOL)
    want, jn = jsamplers.cfg_euler_sample_segment_cached_adaptive(*fns(jnp), *args_j,
                                                                  threshold=0.3)
    got, tn = tsamplers.cfg_euler_sample_segment_cached_adaptive(*fns(torch), *args_t,
                                                                 threshold=0.3)
    assert tn == int(jn) and 1 < tn < 8
    assert_close(got, want, TOY_TOL)


def test_cfg_sde_euler_sample_segment_matches_jax():
    lat, noise, c, u = _toy_inputs()
    sig, key = sampling_sigmas(4, 3.0), jax.random.PRNGKey(112)
    want = jsamplers.cfg_sde_euler_sample_segment(
        lambda x, t, k: _toy_v(x, t, k, jnp), jnp.asarray(lat), jnp.asarray(noise),
        jnp.asarray(c), jnp.asarray(u), sig, 2, 5.0, key)
    got = tsamplers.cfg_sde_euler_sample_segment(
        lambda x, t, k: _toy_v(x, t, k, torch), _t(lat), _t(noise), _t(c), _t(u), sig, 2,
        5.0, _feeder(_jax_draws(key, 4, (2, 2, 4, 4, 8))))
    assert_close(got, want, TOY_TOL)


@pytest.mark.parametrize("sde", [False, True])
def test_cfg_time_travel_sample_segment_matches_jax(sde):
    lat, noise, c, u = _toy_inputs()
    sig, key = sampling_sigmas(5, 3.0), jax.random.PRNGKey(113)
    want = jsamplers.cfg_time_travel_sample_segment(
        lambda x, t, k: _toy_v(x, t, k, jnp), jnp.asarray(lat), jnp.asarray(noise),
        jnp.asarray(c), jnp.asarray(u), sig, 2, 5.0, sde=sde, rng=key)
    got = tsamplers.cfg_time_travel_sample_segment(
        lambda x, t, k: _toy_v(x, t, k, torch), _t(lat), _t(noise), _t(c), _t(u), sig, 2,
        5.0, sde=sde, noise_fn=_feeder(_jax_draws(key, 20, (2, 2, 4, 4, 8))))
    assert_close(got, want, TOY_TOL)


def test_batched_cfg_refused():
    lat, noise, c, u = _toy_inputs()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
        tsamplers.cfg_euler_sample_segment(lambda x, t, k: x, _t(lat), _t(noise), _t(c),
                                           _t(u), sampling_sigmas(2, 3.0), 2, 5.0,
                                           batched_cfg=True)


# -- generate and generate_next ----------------------------------------------------

# (sampler, generate kwargs, steps, distilled)
MODES = {
    "euler": ("euler", {}, 2, False),
    "teacache_interval": ("teacache", dict(teacache_interval=2), 4, False),
    "teacache_adaptive": ("teacache", dict(teacache_threshold=0.3), 5, False),
    "sde": ("sde", {}, 3, False),
    "time_travel": ("time_travel", {}, 3, False),
    "tts": ("tts", {}, 3, False),
    "distilled": ("euler", {}, 2, True),
}


def _noise(seed, f_lat):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, f_lat, 8, 8, 8),
                                        jnp.float32))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_matches_jax(pipes, mode):
    jpipe, tpipe = pipes
    sampler, kw, steps, distilled = MODES[mode]
    img = _frames(114, 1)
    ctx, ctx_null = _ctx(115), _ctx(116)
    seed = 3
    jpipe._cond_cache = tpipe._cond_cache = None
    want_lat, want_video = jpipe.generate(
        jnp.asarray(img), jnp.asarray(ctx), None if distilled else jnp.asarray(ctx_null),
        frame_num=FRAMES, steps=steps, seed=seed, sampler=sampler, **kw)
    churn = None
    if sampler in ("sde", "time_travel", "tts"):
        churn = [_t(a) for a in _jax_draws(jax.random.PRNGKey(seed + TTS_SEED_OFFSET), 20,
                                           (1, 2, 8, 8, 8))]
    got_lat, got_video = tpipe.generate(
        _t(img), _t(ctx), None if distilled else _t(ctx_null), frame_num=FRAMES, steps=steps,
        seed=seed, sampler=sampler, noise=_t(_noise(seed, 3)), churn_noise=churn, **kw)
    assert got_lat.shape == want_lat.shape == (1, 3, 8, 8, 8)
    assert got_video.shape == want_video.shape == (1, FRAMES, SIZE, SIZE, 3)
    assert np.abs(np.asarray(want_lat)[:, -2:] - _noise(seed, 3)[:, -2:]).max() > 1e-2
    lat_tol, video_tol = TOL, VIDEO_TOL
    if sampler == "teacache":
        lat_tol, video_tol = BF16_STEP_TOL, BF16_STEP_VIDEO_TOL
        assert tpipe.last_teacache_n_full == int(jpipe.last_teacache_n_full)
        if "teacache_threshold" in kw:
            assert 1 < tpipe.last_teacache_n_full < steps
        uncached, _ = tpipe.generate(_t(img), _t(ctx), _t(ctx_null), frame_num=FRAMES,
                                     steps=steps, seed=seed, noise=_t(_noise(seed, 3)))
        assert (got_lat - uncached).abs().max() > 10 * lat_tol
    assert_close(got_lat, want_lat, lat_tol)
    assert_close(got_video, want_video, video_tol)


def test_generate_next_matches_jax(pipes):
    """Two continuations of 4 frames after an image segment: the first
    streams the 5-frame history and caches it, the second encodes only the
    4 new frames; CLIP sees the last history frame. Both pipelines continue
    JAX's video, so that each continuation is held alone (the videos
    themselves differ by up to ``VIDEO_TOL``)."""
    jpipe, tpipe = pipes
    img, ctx, ctx_null = _frames(117, 1), _ctx(118), _ctx(119)
    jpipe._cond_cache = tpipe._cond_cache = None
    jv = jpipe.generate(jnp.asarray(img), jnp.asarray(ctx), jnp.asarray(ctx_null),
                        frame_num=FRAMES, steps=2, seed=0)[1]
    tpipe.generate(_t(img), _t(ctx), _t(ctx_null), frame_num=FRAMES, steps=2, seed=0,
                   noise=_t(_noise(0, 3)))
    for s, (frames, f_lat) in enumerate(((9, 5), (13, 7)), start=1):
        hist = _t(jv)
        jl, jv = jpipe.generate_next(jv, jnp.asarray(ctx), jnp.asarray(ctx_null),
                                     frame_zero=4, steps=2, seed=s)
        tl, tv = tpipe.generate_next(hist, _t(ctx), _t(ctx_null), frame_zero=4, steps=2,
                                     seed=s, noise=_t(_noise(s, f_lat)))
        assert tl.shape == jl.shape == (1, f_lat, 8, 8, 8)
        assert tv.shape == jv.shape == (1, frames, SIZE, SIZE, 3)
        assert tpipe._cond_cache["frames"] == jpipe._cond_cache["frames"] == frames - 4
        assert_close(tl, jl, BF16_STEP_TOL)
        assert_close(tv, jv, BF16_STEP_VIDEO_TOL)


def test_pipeline_refusals(pipes):
    _, tpipe = pipes
    img, ctx = _t(_frames(120, 1)), _t(_ctx(121))
    with pytest.raises(NotImplementedError, match="distilled"):
        tpipe.generate(img, ctx, None, frame_num=FRAMES, steps=2, sampler="teacache")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
        tpipe.quantize_int8()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 8"):
        tpipe.parallelize_pp(2)
