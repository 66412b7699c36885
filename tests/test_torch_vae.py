"""PyTorch port of the Wan2.2 VAE decoder against the JAX model on the CPU:
the full-clip ``decode`` and the streaming decode at chunks of 1 and 2
latent frames, each held against the JAX ``decode``, on perturbed parameters
converted with yume_tpu_torch.utils.convert.

fp32. Tolerance 1e-4 max-abs: the order of float32 sums in the convolutions
differs between XLA:CPU and ATen (oneDNN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, perturb, port_config
from yume_tpu.configs import VAEConfig
from yume_tpu.models import vae as jvae
from yume_tpu_torch.models import vae as tvae
from yume_tpu_torch.utils.convert import load_state_dict, vae22_state_dict

TINY = VAEConfig(
    z_dim=8, base_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=2,
    temporal_downsample=(False, True, True), stride=(4, 16, 16), patchify=2,
)
DEC_DIM = 24
TOL = 1e-4


@pytest.fixture(scope="module")
def decoded():
    """(port model, latent, JAX decode of it)."""
    jmodel = jvae.WanVAE(TINY, dec_dim=DEC_DIM)
    video = jnp.zeros((1, 9, 64, 64, 3))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, video), jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=3)}
    tmodel = tvae.WanVAE(port_config(TINY), DEC_DIM, device="meta").to_empty(device="cpu")
    load_state_dict(tmodel, vae22_state_dict(params), allow_unused=True)
    z = np.random.default_rng(4).standard_normal((1, 3, 4, 4, TINY.z_dim)).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(z), method=jmodel.decode)
    return tmodel, z, np.asarray(want)


def _check(got, want):
    assert got.shape == want.shape == (1, 9, 64, 64, 3)
    inside = np.abs(want) < 0.99
    assert inside.mean() > 0.5, "output mostly clipped: the comparison would be vacuous"
    assert_close(got, want, TOL)


def test_decode_matches_jax(decoded):
    tmodel, z, want = decoded
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z))
    _check(got, want)


@pytest.mark.parametrize("chunk", [1, 2])
def test_streaming_decode_matches_jax_decode(decoded, chunk):
    tmodel, z, want = decoded
    got = tvae.streaming_decode(tmodel, torch.from_numpy(z), chunk_latent_frames=chunk)
    _check(got, want)
