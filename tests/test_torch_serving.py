"""The serving entry points' pipeline pieces of the port against the JAX
package on the CPU: ``encode_auto`` and ``encode_image_conditioning``, the
width-tiled decode, the TTS samplers (``sde_euler_sample_segment`` and
``time_travel_sample_segment`` with and without churn) on a toy velocity
field, ``generate_segment`` with the samplers 'sde', 'time_travel' and
'tts', and the Euler segment's ``progress_cb``; the tiny pipeline of
``test_torch_pipeline.py`` on perturbed parameters, inputs from numpy
seeds, JAX's noise draws injected.

fp32. Tolerances, as ``test_torch_t2v.py``: the toy samplers 1e-5 (fp32
steps whose only difference is the last bit of ``sin`` and of the fp32
scalars); latents 1e-4 (XLA:CPU and ATen sum float32 in another order, and
both pipelines round the latent to bf16 before the DiT); video 1e-3 (the
decoder amplifies the last bits); the progress timesteps and the masks
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import TINY, pipelines  # noqa: F401 (the module fixture)
from torch_parity import assert_close, torch_threads
from yume_tpu.diffusion import samplers as jsamplers
from yume_tpu_torch.diffusion import samplers as tsamplers
from yume_tpu_torch.diffusion.schedule import sampling_sigmas
from yume_tpu_torch.pipelines import tiled_decode as ttiled

TOY_TOL, LATENT_TOL, VIDEO_TOL = 1e-5, 1e-4, 1e-3
LFZ, STEPS = TINY.latent_frame_zero, 3
CTX_SHAPE = (1, 16, 16)


@pytest.fixture(scope="module")
def pipes(pipelines):  # noqa: F811
    with torch_threads(2):
        yield pipelines


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _video(seed, t, h=32, w=32):
    return np.random.default_rng(seed).uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32)


# -- video to latents ----------------------------------------------------------


def test_encode_auto_matches_jax(pipes):
    jpipe, tpipe = pipes
    video = _video(40, 5)
    want = jpipe.encode_auto(jnp.asarray(video))
    got = tpipe.encode_auto(_t(video))
    assert got.shape == want.shape == (1, 3, 4, 4, 8) and got.dtype == torch.float32
    assert_close(got, want, LATENT_TOL)


def test_encode_image_conditioning_matches_jax(pipes):
    """Four repeated frames give two latent frames, zero-padded to the five
    of 9 frames; mask2 is one over the last ``latent_frame_zero``."""
    jpipe, tpipe = pipes
    img = _video(41, 1)[0, 0]
    frames = np.repeat(img[None], 4, 0)[None]
    jz, jmask = jpipe.encode_image_conditioning(jnp.asarray(frames), 9)
    tz, tmask = tpipe.encode_image_conditioning(_t(frames), 9)
    assert tz.shape == jz.shape == (1, 5, 4, 4, 8)
    assert np.abs(np.asarray(jz)[:, :2]).max() > 0.1
    assert_close(tz, jz, LATENT_TOL)
    np.testing.assert_array_equal(tz[:, 2:].numpy(), 0.0)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_decode_tiled_matches_jax(pipes):
    """A latent 12 columns wide: five tiles with 4-column overlaps, each
    through the port's streaming decode against JAX's full-clip one."""
    from yume_tpu.pipelines.tiled_decode import _tile_bounds

    jpipe, tpipe = pipes
    z = np.random.default_rng(42).standard_normal((1, 3, 4, 12, 8)).astype(np.float32)
    want = jpipe.decode_tiled(jnp.asarray(z))
    got = tpipe.decode_tiled(_t(z))
    assert got.shape == want.shape == (1, 5, 32, 96, 3)
    assert_close(got, want, VIDEO_TOL)
    for w, n, ov in ((12, 5, 4), (80, 5, 2), (80, 2, 2), (13, 4, 1)):
        assert ttiled._tile_bounds(w, n, ov) == _tile_bounds(w, n, ov)


# -- the TTS samplers on a toy velocity field ----------------------------------


def _toy_v(x, t_frame, lib):
    """A smooth, state-dependent velocity; t_frame [B, F] is σ·1000."""
    s = t_frame.reshape(t_frame.shape + (1,) * (x.ndim - t_frame.ndim)) / 1000.0
    return x * (0.3 + 0.5 * s) + 0.1 * lib.sin(3.0 * x)


def _toy_latent():
    return np.random.default_rng(43).standard_normal((2, 4, 4, 4, 8)).astype(np.float32)


def _sde_draws(key, n_steps, shape):
    """The JAX SDE segment's draws: one split a step."""
    out = []
    for _ in range(n_steps):
        key, eps = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(eps, shape, jnp.float32)))
    return out


def _travel_draws(key, n_steps, travel_steps, shape):
    """The JAX time-travel sampler's draws, in the order it takes them."""
    keys = jax.random.split(key, 4 * n_steps * max(1, travel_steps))
    return [np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in keys]


def _feeder(draws):
    it = iter(draws)

    def noise_fn(shape):
        a = next(it)
        assert a.shape == shape
        return _t(a)
    return noise_fn


def test_sde_euler_sample_segment_matches_jax():
    latent, sig, key = _toy_latent(), sampling_sigmas(5, 5.0), jax.random.PRNGKey(44)
    want = jsamplers.sde_euler_sample_segment(
        lambda x, t: _toy_v(x, t, jnp), jnp.asarray(latent), sig, LFZ, key)
    got = tsamplers.sde_euler_sample_segment(
        lambda x, t: _toy_v(x, t, torch), _t(latent), sig, LFZ,
        _feeder(_sde_draws(key, 5, (2, LFZ, 4, 4, 8))))
    np.testing.assert_array_equal(got[:, :-LFZ].numpy(), latent[:, :-LFZ])
    assert_close(got, want, TOY_TOL)


@pytest.mark.parametrize("sde", [False, True])
def test_time_travel_sample_segment_matches_jax(sde):
    latent, sig, key = _toy_latent(), sampling_sigmas(5, 5.0), jax.random.PRNGKey(45)
    want = jsamplers.time_travel_sample_segment(
        lambda x, t: _toy_v(x, t, jnp), jnp.asarray(latent), sig, LFZ, sde=sde,
        rng=key if sde else None)
    draws = _travel_draws(key, 5, 2, (2, LFZ, 4, 4, 8)) if sde else []
    got = tsamplers.time_travel_sample_segment(
        lambda x, t: _toy_v(x, t, torch), _t(latent), sig, LFZ, sde=sde,
        noise_fn=_feeder(draws) if sde else None)
    assert_close(got, want, TOY_TOL)
    plain = tsamplers.euler_sample_segment(lambda x, t: _toy_v(x, t, torch), _t(latent),
                                           sig, LFZ)
    assert np.abs((got - plain).numpy()).max() > 1e-3   # the lookahead changed the result


# -- generate_segment: TTS samplers and progress --------------------------------


def _segment_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32),
            rng.standard_normal(CTX_SHAPE).astype(np.float32),
            rng.standard_normal((1, LFZ, 4, 4, 8)).astype(np.float32))


@pytest.mark.parametrize("sampler", ["sde", "time_travel", "tts"])
def test_generate_segment_tts_matches_jax(pipes, sampler):
    """JAX draws its churn from PRNGKey(seed + 7919); the port takes the
    same draws through ``churn_noise``."""
    jpipe, tpipe = pipes
    history, ctx, noise = _segment_inputs(46)
    seed, shape = 3, (1, LFZ, 4, 4, 8)
    want = jpipe.generate_segment(jnp.asarray(history), jnp.asarray(ctx), steps=STEPS,
                                  seed=seed, sampler=sampler, noise=jnp.asarray(noise))
    key = jax.random.PRNGKey(seed + 7919)
    draws = (_sde_draws(key, STEPS, shape) if sampler == "sde" else
             _travel_draws(key, STEPS, 2, shape) if sampler == "tts" else [])
    got = tpipe.generate_segment(_t(history), _t(ctx), steps=STEPS, seed=seed,
                                 sampler=sampler, noise=_t(noise),
                                 churn_noise=[_t(d) for d in draws])
    assert got.shape == (1, 3 + LFZ, 4, 4, 8)
    np.testing.assert_array_equal(got[:, :3].numpy(), history)
    assert_close(got, want, LATENT_TOL)
    # the port's own draws: seeded, so repeatable, and the churn moves the tail
    a = tpipe.generate_segment(_t(history), _t(ctx), steps=STEPS, seed=seed,
                               sampler=sampler, noise=_t(noise))
    b = tpipe.generate_segment(_t(history), _t(ctx), steps=STEPS, seed=seed,
                               sampler=sampler, noise=_t(noise))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    if sampler != "time_travel":
        assert np.abs((a - got).numpy()).max() > 1e-3


def test_progress_cb_receives_jax_timesteps(pipes):
    """One call a step, with the value JAX's callback receives (σ_i·1000),
    and the same latents as without a callback."""
    jpipe, tpipe = pipes
    history, ctx, noise = _segment_inputs(47)
    jseen, tseen = [], []
    want = jpipe.generate_segment(jnp.asarray(history), jnp.asarray(ctx), steps=STEPS,
                                  noise=jnp.asarray(noise),
                                  progress_cb=lambda s: jseen.append(float(s)))
    jax.effects_barrier()
    got = tpipe.generate_segment(_t(history), _t(ctx), steps=STEPS, noise=_t(noise),
                                 progress_cb=tseen.append)
    plain = tpipe.generate_segment(_t(history), _t(ctx), steps=STEPS, noise=_t(noise))
    assert len(tseen) == STEPS and all(type(s) is float for s in tseen)
    assert tseen == jseen
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert_close(got, want, LATENT_TOL)
