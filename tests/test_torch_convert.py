"""The port's state dicts fed back through the JAX package's own torch →
flax converters reproduce the original parameter trees exactly (the port
uses the reference torch naming, and utils/convert.py is an exact inverse).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import perturb, port_config
from yume_tpu.configs import DiTConfig, T5Config, VAEConfig
from yume_tpu.models import dit as jdit
from yume_tpu.models import t5 as jt5
from yume_tpu.models import vae as jvae
from yume_tpu.utils.checkpoint import (convert_dit_state_dict, convert_t5_state_dict,
                                       convert_vae22_state_dict)
from yume_tpu_torch.models import dit as tdit
from yume_tpu_torch.models import t5 as tt5
from yume_tpu_torch.models import vae as tvae
from yume_tpu_torch.utils import convert

DIT = DiTConfig(model_type="ti2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128,
                freq_dim=32, text_dim=16, text_len=16, num_heads=4, num_layers=2)
T5 = T5Config(vocab_size=64, dim=16, dim_attn=16, dim_ffn=24, num_heads=2,
              num_layers=2, text_len=16)
VAE = VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                temporal_downsample=(True, False), stride=(2, 8, 8), patchify=2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got["params"]), _flat(want["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _tree(model, seed, *args, **kw):
    shapes = jax.eval_shape(lambda k: model.init(k, *args, **kw), jax.random.PRNGKey(0))
    return {"params": perturb(shapes["params"], seed)}


def test_dit_roundtrip_exact():
    tree = _tree(jdit.WanDiT(DIT, dtype=jnp.float32), 5, jnp.zeros((1, 3, 8, 8, 8)),
                 jnp.zeros((1, 3)), jnp.zeros((1, 16, 16)), packed=False)
    model = tdit.WanDiT(port_config(DIT), torch.float32, device="meta").to_empty(device="cpu")
    convert.load_state_dict(model, convert.dit_state_dict(tree, DIT.num_layers))
    _assert_trees_equal(convert_dit_state_dict(_port_sd(model), DIT.num_layers), tree)


def test_t5_roundtrip_exact():
    ids = jnp.zeros((1, 16), jnp.int32)
    tree = _tree(jt5.T5Encoder(T5, dtype=jnp.float32), 6, ids, jnp.ones_like(ids))
    model = tt5.T5Encoder(port_config(T5), torch.float32, device="meta").to_empty(device="cpu")
    convert.load_state_dict(model, convert.t5_state_dict(tree, T5.num_layers))
    _assert_trees_equal(convert_t5_state_dict(_port_sd(model), T5.num_layers), tree)


# the second config has the 5B model's stage layout at narrow widths
@pytest.mark.parametrize("cfg,dec_dim", [
    (VAE, 32),
    (VAEConfig(z_dim=8, base_dim=16, num_res_blocks=2,
               temporal_downsample=(False, True, True)), 24),
], ids=["tiny", "wan22_layout"])
def test_vae22_roundtrip_exact(cfg, dec_dim):
    s = cfg.stride
    tree = _tree(jvae.WanVAE(cfg, dec_dim=dec_dim), 7,
                 jnp.zeros((1, 1 + 2 * s[0], 2 * s[1], 2 * s[2], 3)))
    full = convert.vae22_state_dict(tree, cfg.num_res_blocks)
    _assert_trees_equal(convert_vae22_state_dict(full, cfg.num_res_blocks), tree)
    # the port holds the decoder half; its state dict is a subset of the full one
    model = tvae.WanVAE(port_config(cfg), dec_dim, device="meta").to_empty(device="cpu")
    convert.load_state_dict(model, full, allow_unused=True)
    port = _port_sd(model)
    assert port and all(k.startswith(("decoder.", "conv2.")) for k in port)
    for k, v in port.items():
        np.testing.assert_array_equal(v, full[k], err_msg=k)
