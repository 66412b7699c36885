"""The ported slice against the JAX pipeline on the CPU: a tiny
TI2VPipeline with perturbed parameters converted to the port; encode_text,
two generate_segment calls with injected noise, and decode_auto of each
tail.

fp32 parameters. Both pipelines round the latent to bf16 before the DiT
(as the reference does), so a last-bit float32 difference can move one
input by one bf16 step. Tolerances: context 1e-5, latents 1e-4, video 1e-3,
from the order of float32 sums differing between XLA:CPU and ATen and the
decoder amplifying it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, perturb, port_config
from yume_tpu.configs import DiTConfig, PipelineConfig, T5Config, VAEConfig
from yume_tpu.models.dit import WanDiT
from yume_tpu.models.t5 import T5Encoder
from yume_tpu.models.vae import WanVAE
from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxPipeline
from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
from yume_tpu_torch.utils import convert

TINY = PipelineConfig(
    name="tiny",
    dit=DiTConfig(model_type="ti2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128,
                  freq_dim=32, text_dim=16, text_len=16, num_heads=4,
                  num_layers=2, framepack=True),
    vae=VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                  temporal_downsample=(True, False), stride=(2, 8, 8), patchify=2),
    t5=T5Config(vocab_size=64, dim=16, dim_attn=16, dim_ffn=24, num_heads=2,
                num_layers=1, text_len=16),
    latent_frame_zero=2,
    sample_shift=5.0,
)
CTX_TOL, LATENT_TOL, VIDEO_TOL = 1e-5, 1e-4, 1e-3


def _params(model, seed, *args, **kw):
    shapes = jax.eval_shape(lambda k: model.init(k, *args, **kw), jax.random.PRNGKey(0))
    return {"params": perturb(shapes["params"], seed)}


@pytest.fixture(scope="module")
def pipelines():
    c = TINY
    dit = WanDiT(c.dit, dtype=jnp.float32)
    vae = WanVAE(c.vae)
    t5 = T5Encoder(c.t5, dtype=jnp.float32)
    ids = jnp.zeros((1, 16), jnp.int32)
    dit_p = _params(dit, 11, jnp.zeros((1, 3, 4, 4, 8)), jnp.zeros((1, 3)),
                    jnp.zeros((1, 16, 16)), packed=False)
    vae_p = _params(vae, 12, jnp.zeros((1, 5, 32, 32, 3)))
    t5_p = _params(t5, 13, ids, jnp.ones_like(ids))
    jpipe = JaxPipeline(c, dit, dit_p, vae, vae_p, t5, t5_p)
    tpipe = TI2VPipeline.from_state_dicts(
        port_config(c), convert.dit_state_dict(dit_p, c.dit.num_layers),
        convert.vae22_state_dict(vae_p, c.vae.num_res_blocks),
        convert.t5_state_dict(t5_p, c.t5.num_layers), device="cpu", dtype=torch.float32)
    return jpipe, tpipe


def test_slice_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    rng = np.random.default_rng(14)
    ids = rng.integers(2, 64, (1, 16)).astype(np.int32)
    mask = np.zeros((1, 16), np.int32)
    mask[0, :9] = 1
    history = rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32)
    noises = [rng.standard_normal((1, 2, 4, 4, 8)).astype(np.float32) for _ in range(2)]

    jctx = jpipe.encode_text(jnp.asarray(ids), jnp.asarray(mask))
    tctx = tpipe.encode_text(ids, mask)
    assert_close(tctx, jctx, CTX_TOL)

    jlat, tlat = jnp.asarray(history), torch.from_numpy(history)
    for noise in noises:
        jlat = jpipe.generate_segment(jlat, jctx, steps=2, noise=jnp.asarray(noise))
        tlat = tpipe.generate_segment(tlat, tctx, steps=2, noise=torch.from_numpy(noise))
        assert tlat.shape == (1, jlat.shape[1], 4, 4, 8)
        assert_close(tlat, jlat, LATENT_TOL)
        jvid = jpipe.decode_auto(jlat[:, -2:])
        tvid = tpipe.decode_auto(tlat[:, -2:])
        assert tvid.shape == (1, 3, 32, 32, 3)
        assert (np.abs(np.asarray(jvid)) < 0.99).mean() > 0.1  # not all clipped
        assert_close(tvid, jvid, VIDEO_TOL)
    # history frames stay frozen, the tail moved away from its noise
    np.testing.assert_array_equal(tlat[:, :3].numpy(), history)
    assert np.abs(tlat[:, -2:].numpy() - noises[1]).max() > 1e-2


def test_bf16_history_promotes_tail_to_fp32(pipelines):
    """A bf16 history with fp32 tail noise: jnp.concatenate promotes the
    latent to fp32, so the tail integrates in fp32 on both sides. Both get
    the same bf16 history values; the port must not round the noise (and
    every step of the tail) to bf16."""
    jpipe, tpipe = pipelines
    rng = np.random.default_rng(15)
    history = torch.from_numpy(rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32))
    history = history.to(torch.bfloat16)
    noises = [rng.standard_normal((1, 2, 4, 4, 8)).astype(np.float32) for _ in range(2)]
    ctx = rng.standard_normal((1, 16, 16)).astype(np.float32)

    jlat = jnp.asarray(history.float().numpy()).astype(jnp.bfloat16)
    tlat = history
    for noise in noises:
        jlat = jpipe.generate_segment(jlat, jnp.asarray(ctx), steps=2,
                                      noise=jnp.asarray(noise))
        tlat = tpipe.generate_segment(tlat, torch.from_numpy(ctx), steps=2,
                                      noise=torch.from_numpy(noise))
        assert jlat.dtype == jnp.float32
        assert tlat.dtype == torch.float32
        assert_close(tlat, jlat, LATENT_TOL)
    np.testing.assert_array_equal(tlat[:, :3].numpy(), history.float().numpy())
