"""The port's CLIP ViT-H visual tower against the JAX model on the CPU:
``CLIPVisual`` (the ``use_31_block`` output) on perturbed parameters,
``preprocess_frames`` (the antialiased cubic resize and the CLIP
normalisation) at a downscale, an upscale and the 14B's 544×960 → 224, and
the released CLIP file's layout read through the port against JAX's
``convert_clip_visual_state_dict`` on a file the test writes.

fp32. Tolerances: the tower 1e-5 (one block's float32 sums in another order
on XLA:CPU and ATen); the resize 1e-5 at the small shapes and 1e-4 at
544×960, where each output sums ~10 taps an axis over 544 and 960 inputs
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, perturb, port_config, torch_threads
from yume_tpu.configs import CLIPConfig
from yume_tpu.models import clip as jclip
from yume_tpu_torch.models import clip as tclip
from yume_tpu_torch.utils.checkpoint import clip_visual_from_released
from yume_tpu_torch.utils.convert import clip_visual_state_dict, load_state_dict

# the 14B's CLIP shape at a small width: 2 of 3 blocks run, head dim 8
TINY = CLIPConfig(image_size=28, patch_size=14, dim=16, num_heads=2, num_layers=3,
                  out_tokens=5)
TOWER_TOL, RESIZE_TOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def towers():
    jmodel = jclip.CLIPVisual(TINY)
    img = jnp.zeros((1, TINY.image_size, TINY.image_size, 3))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, img), jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=81)}
    tmodel = tclip.CLIPVisual(port_config(TINY), torch.float32, device="meta") \
        .to_empty(device="cpu")
    load_state_dict(tmodel, clip_visual_state_dict(params, TINY.num_layers))
    with torch_threads(2):
        yield jmodel, params, tmodel.eval()


def _frames(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_clip_visual_matches_jax(towers):
    jmodel, params, tmodel = towers
    x = np.random.default_rng(82).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 5, 16)
    assert_close(got, want, TOWER_TOL)


@pytest.mark.parametrize("hw,size,tol", [((40, 56), 16, RESIZE_TOL),    # downscale
                                         ((8, 12), 16, RESIZE_TOL),     # upscale
                                         ((16, 40), 16, RESIZE_TOL),    # one axis kept
                                         ((544, 960), 224, 1e-4)])      # the 14B's
def test_preprocess_frames_matches_jax(hw, size, tol):
    frames = _frames(83, (2,) + hw + (3,))
    want = jclip.preprocess_frames(jnp.asarray(frames), size)
    got = tclip.preprocess_frames(torch.from_numpy(frames), size)
    assert got.shape == want.shape == (2, size, size, 3) and got.dtype == torch.float32
    assert_close(got, want, tol)


def test_resize_differs_from_interpolate_bicubic():
    """The Keys a = −0.5 antialiased resize differs from F.interpolate's
    bicubic (a = −0.75, no antialias) by far more than the tolerance."""
    frames = torch.from_numpy(_frames(84, (1, 40, 56, 3)))
    ours = tclip.resize_bicubic(frames, (16, 16))
    theirs = torch.nn.functional.interpolate(frames.permute(0, 3, 1, 2), size=(16, 16),
                                             mode="bicubic").permute(0, 2, 3, 1)
    assert (ours - theirs).abs().max() > 100 * RESIZE_TOL
    np.testing.assert_allclose(tclip.resize_weights(40, 16).sum(0), 1.0, atol=1e-6)


def test_released_clip_layout_matches_jax(towers, tmp_path):
    """A file in the released layout: every ``visual.`` tensor (the last
    block, the post-norm and the head included) and a text-tower tensor.
    JAX's converter and the port's reader take the same tensors from it,
    and the towers agree on an image."""
    jmodel, params, _ = towers
    sd = {f"visual.{k}": torch.from_numpy(v)
          for k, v in clip_visual_state_dict(params, TINY.num_layers).items()}
    rng = np.random.default_rng(85)
    last = TINY.num_layers - 1
    for name, shape in ((f"transformer.{last}.norm1.weight", (16,)),
                        (f"transformer.{last}.attn.to_qkv.weight", (48, 16)),
                        ("post_norm.weight", (16,)), ("head", (16, 8))):
        sd[f"visual.{name}"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    sd["textual.token_embedding.weight"] = torch.zeros(4, 16)
    sd["log_scale"] = torch.zeros(())
    path = tmp_path / "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"
    torch.save(sd, str(path))

    from yume_tpu.utils.checkpoint import convert_clip_visual_state_dict

    loaded = torch.load(str(path))
    jparams = convert_clip_visual_state_dict({k: v.numpy() for k, v in loaded.items()},
                                             num_layers=TINY.num_layers)
    tmodel = tclip.CLIPVisual(port_config(TINY), torch.float32, device="meta") \
        .to_empty(device="cpu")
    load_state_dict(tmodel, clip_visual_from_released(loaded, TINY.num_layers))
    assert set(tmodel.state_dict()) == set(clip_visual_state_dict(params, TINY.num_layers))
    x = _frames(86, (1, 28, 28, 3))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x))
    want = jmodel.apply(jparams, jnp.asarray(x))
    assert_close(got, jmodel.apply(params, jnp.asarray(x)), TOWER_TOL)
    assert_close(got, want, TOWER_TOL)
