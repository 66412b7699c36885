"""The port's Wan2.1 VAE (``arch='wan21'``, the 14B's) against the JAX
model on the CPU: ``encode`` and ``decode`` on perturbed parameters, the
streaming encode and decode (the chunked forms the 14B pipeline runs)
against the port's full-clip ones, the latent normalisation, and the
released ``Wan2.1_VAE.pth`` layout: the port's state dict written as that
file reads back through JAX's ``convert_vae21_state_dict`` to the JAX
parameters bit for bit and loads into the port strictly.

The 14B's channel and stage layout at a small width: base 16, multipliers
(1, 2, 4, 4), two residual blocks a stage, temporal downsampling in the
first two stages (stride 4 × 8 × 8), 16 latent channels (so the Wan2.1
normalisation applies).

fp32. Tolerances: encode and decode 1e-4 against JAX (the order of float32
sums in the convolutions differs between XLA:CPU and ATen); streaming
against full 2e-5 (the same library on both sides, chunked convolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, perturb, port_config, torch_threads
from yume_tpu.configs import VAEConfig
from yume_tpu.models import vae as jvae
from yume_tpu_torch.models import vae as tvae
from yume_tpu_torch.utils.convert import load_state_dict, vae21_state_dict

TINY = VAEConfig(z_dim=16, base_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=2,
                 temporal_downsample=(True, True, False), stride=(4, 8, 8), patchify=1,
                 arch="wan21")
TOL, STREAM_TOL = 1e-4, 2e-5
FRAMES, SIZE = 9, 32


@pytest.fixture(scope="module")
def vaes():
    jmodel = jvae.WanVAE(TINY)
    video = jnp.zeros((1, FRAMES, SIZE, SIZE, 3))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, video), jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=91)}
    tmodel = tvae.WanVAE(port_config(TINY), device="meta").to_empty(device="cpu")
    load_state_dict(tmodel, vae21_state_dict(params, TINY.num_res_blocks))
    with torch_threads(2):
        yield jmodel, params, tmodel.eval()


def _video(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (1, FRAMES, SIZE, SIZE, 3)) \
        .astype(np.float32)


def _latent(seed):
    return np.random.default_rng(seed).standard_normal((1, 3, 4, 4, 16)).astype(np.float32)


def test_wan21_constants_match_jax():
    np.testing.assert_array_equal(tvae.WAN21_LATENT_MEAN, jvae.WAN21_LATENT_MEAN)
    np.testing.assert_array_equal(tvae.WAN21_LATENT_STD, jvae.WAN21_LATENT_STD)


def test_encode_matches_jax(vaes):
    jmodel, params, tmodel = vaes
    video = _video(92)
    want = jmodel.apply(params, jnp.asarray(video), method=jmodel.encode)
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(video))
    assert got.shape == want.shape == (1, 3, 4, 4, 16) and got.dtype == torch.float32
    assert np.abs(np.asarray(want)).max() > 0.1
    assert_close(got, want, TOL)


def test_decode_matches_jax(vaes):
    jmodel, params, tmodel = vaes
    z = _latent(93)
    want = np.asarray(jmodel.apply(params, jnp.asarray(z), method=jmodel.decode))
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z))
    assert got.shape == want.shape == (1, FRAMES, SIZE, SIZE, 3)
    assert (np.abs(want) < 0.99).mean() > 0.5, "output mostly clipped"
    assert_close(got, want, TOL)


def test_streaming_encode_equals_full(vaes):
    _, _, tmodel = vaes
    video = torch.from_numpy(_video(94))
    with torch.no_grad():
        want = tmodel.encode(video)
    assert_close(tvae.streaming_encode(tmodel, video), want, STREAM_TOL)


@pytest.mark.parametrize("chunk", [1, 2])
def test_streaming_decode_equals_full(vaes, chunk):
    _, _, tmodel = vaes
    z = torch.from_numpy(_latent(95))
    with torch.no_grad():
        want = tmodel.decode(z)
    assert_close(tvae.streaming_decode(tmodel, z, chunk_latent_frames=chunk), want,
                 STREAM_TOL)


def test_released_layout_round_trips(vaes, tmp_path):
    """``Wan2.1_VAE.pth`` as the port writes it: JAX's converter maps it to
    the JAX tree bit for bit, every tensor is used, and the port's modules
    carry exactly its keys with the released shapes."""
    from yume_tpu.utils.checkpoint import convert_vae21_state_dict

    _, params, tmodel = vaes
    sd = vae21_state_dict(params, TINY.num_res_blocks)
    path = tmp_path / "Wan2.1_VAE.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    loaded = {k: v.numpy() for k, v in torch.load(str(path)).items()}
    back = convert_vae21_state_dict(loaded, num_res_blocks=TINY.num_res_blocks)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path_, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path_]), leaf, err_msg=str(path_))
    own = tmodel.state_dict()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert tuple(own[k].shape) == v.shape, k
    # a reference-layout spot check: flat stage lists, the halving upsample
    assert sd["encoder.downsamples.2.resample.1.weight"].shape == (16, 16, 3, 3)
    assert sd["encoder.downsamples.2.time_conv.weight"].shape == (16, 16, 3, 1, 1)
    assert sd["decoder.upsamples.3.resample.1.weight"].shape == (32, 64, 3, 3)
    assert "decoder.upsamples.3.time_conv.weight" not in sd          # spatial only
    assert sd["decoder.upsamples.4.residual.2.weight"].shape == (64, 32, 3, 3, 3)
    assert sd["decoder.upsamples.7.time_conv.weight"].shape == (128, 64, 3, 1, 1)
