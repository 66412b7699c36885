"""The PyTorch port of the Wan2.2 VAE encoder against the JAX model on the
CPU: ``patchify``, ``avg_down3d``, the full-clip ``encode`` and the
streaming encode (pixel frame 0, then chunks of 4), on perturbed parameters
converted with yume_tpu_torch.utils.convert, the whole VAE loaded strictly.

fp32 on ``tests/test_vae.py``'s tiny config. Tolerances: the reshapes
(``patchify``) equal; ``avg_down3d`` 1e-6 (a mean of four or eight fp32
values, summed in another order); latents 1e-4 max-abs, as the decoder's
tests, from the order of float32 sums in the convolutions differing between
XLA:CPU and ATen; the port's streaming encode against its own full encode
2e-5: the same convolutions on chunks, where a wrong cache (the temporal
downsample's first-chunk passthrough above all) moves latents by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vae import DEC_DIM, TINY
from torch_parity import assert_close, perturb, port_config, torch_threads
from yume_tpu.models import vae as jvae
from yume_tpu_torch.models import vae as tvae
from yume_tpu_torch.utils.convert import load_state_dict, vae22_state_dict

TOL, STREAM_TOL = 1e-4, 2e-5


@pytest.fixture(scope="module")
def encoded():
    """(port model, video, JAX encode, JAX streaming encode)."""
    jmodel = jvae.WanVAE(TINY, dec_dim=DEC_DIM)
    video = np.random.default_rng(5).uniform(-1, 1, (1, 9, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.asarray(video)),
                            jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=6)}
    with torch_threads(2):
        tmodel = tvae.WanVAE(port_config(TINY), DEC_DIM, device="meta").to_empty(device="cpu")
        load_state_dict(tmodel, vae22_state_dict(params))   # strict: encoder and decoder
        want = jmodel.apply(params, jnp.asarray(video), method=jmodel.encode)
        want_stream = jvae.streaming_encode(jmodel, params, jnp.asarray(video))
        yield tmodel, video, np.asarray(want), np.asarray(want_stream)


def test_patchify_matches_jax():
    x = np.random.default_rng(7).standard_normal((2, 3, 8, 12, 3)).astype(np.float32)
    for p in (1, 2, 4):
        got = tvae.patchify(torch.from_numpy(x), p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jvae.patchify(jnp.asarray(x), p)))
        np.testing.assert_array_equal(tvae.unpatchify(got, p).numpy(), x)


@pytest.mark.parametrize("t,ft,fs,out_ch", [(5, 2, 2, 16), (4, 2, 2, 8), (3, 1, 2, 8),
                                            (1, 2, 1, 4)])
def test_avg_down3d_matches_jax(t, ft, fs, out_ch):
    """Channels-first in the port, channels-last in JAX; T odd and even
    (front padding), the temporal and the spatial fold alone."""
    x = np.random.default_rng(8).standard_normal((2, t, 8, 4, 4)).astype(np.float32)
    want = jvae.avg_down3d(jnp.asarray(x), out_ch, ft, fs)
    got = tvae.avg_down3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), out_ch, ft, fs)
    assert_close(got.permute(0, 2, 3, 4, 1), want, 1e-6)


def test_encode_matches_jax(encoded):
    tmodel, video, want, _ = encoded
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(video))
    assert got.shape == want.shape == (1, 3, 4, 4, TINY.z_dim) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.1      # not a bias-only latent
    assert_close(got, want, TOL)


def test_streaming_encode_matches_encode_and_jax(encoded):
    tmodel, video, want, want_stream = encoded
    v = torch.from_numpy(video)
    got = tvae.streaming_encode(tmodel, v)
    with torch.no_grad():
        full = tmodel.encode(v)
    assert got.shape == full.shape == want_stream.shape
    assert_close(got, full, STREAM_TOL)
    assert_close(got, want_stream, TOL)
    assert_close(got, want, TOL)

