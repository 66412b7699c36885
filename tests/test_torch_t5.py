"""PyTorch port of the umT5 encoder against the JAX model on the CPU, on
perturbed parameters converted with yume_tpu_torch.utils.convert.

fp32. Tolerance 1e-5 max-abs: the order of float32 sums differs between
XLA:CPU and ATen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, perturb, port_config
from yume_tpu.configs import T5Config
from yume_tpu.models import t5 as jt5
from yume_tpu_torch.models import t5 as tt5
from yume_tpu_torch.utils.convert import load_state_dict, t5_state_dict

TINY = T5Config(vocab_size=128, dim=64, dim_attn=64, dim_ffn=96, num_heads=4,
                num_layers=2, num_buckets=32, text_len=16)
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jmodel = jt5.T5Encoder(TINY, dtype=jnp.float32)
    ids = jnp.zeros((1, TINY.text_len), jnp.int32)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, ids, jnp.ones_like(ids)),
                            jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=2)}
    tmodel = tt5.T5Encoder(port_config(TINY), torch.float32, device="meta").to_empty(device="cpu")
    load_state_dict(tmodel, t5_state_dict(params, TINY.num_layers))
    return jmodel, params, tmodel


def _inputs(rng_np):
    ids = rng_np.integers(0, TINY.vocab_size, (2, TINY.text_len)).astype(np.int32)
    mask = np.zeros((2, TINY.text_len), np.int32)
    mask[0, :11] = 1   # partial mask
    mask[1, :] = 1
    return ids, mask


def test_relative_position_bucket_equal():
    rel = np.arange(-300, 301)[None, :]
    np.testing.assert_array_equal(tt5.relative_position_bucket(rel),
                                  jt5.relative_position_bucket(rel))


def test_encoder_matches_jax(models, rng_np):
    jmodel, params, tmodel = models
    ids, mask = _inputs(rng_np)
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    assert_close(got, want, TOL)


def test_encode_text_partial_mask_matches_jax(models, rng_np):
    jmodel, params, tmodel = models
    ids, mask = _inputs(rng_np)
    want = jt5.encode_text(jmodel, params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = tt5.encode_text(tmodel, torch.from_numpy(ids), torch.from_numpy(mask))
    assert np.all(got[0, 11:].numpy() == 0.0)
    assert_close(got, want, TOL)
