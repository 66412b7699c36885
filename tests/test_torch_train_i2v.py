"""The port's 14B i2v training branch against the JAX package on the CPU, on
the tiny i2v DiT of tests/test_train_i2v.py (18 input channels: 8 latent,
2 mask, 8 VAE; 5 CLIP tokens of width 12; the MVDT side block) with
perturbed parameters, in fp32:

* ``flow_pass_i2v``'s loss, denoised tail and every parameter's gradient
  (plain, MVDT, remat), on JAX's draws (its key split three ways);
* two clipped-AdamW train steps and two LoRA steps;
* the LoRA adapter set of the i2v DiT (``k_img`` and ``v_img`` included),
  fp32 adapters over a bf16 base, whose forward equals the fp32-stored
  model's computing in bf16;
* ``build_i2v_train_batch`` on both branches (a v2v history of s0 frames
  too, whose target encodes one frame: the full-size 37-frame read's
  case), a clip that forces i2v, one that is too short, and
  ``synthetic_i2v_batch``'s structure.

Tolerances as tests/test_torch_training.py's: loss 1e-5 and gradients 1e-4
relative (fp32 sums in another order on XLA:CPU and ATen); the train steps'
parameters within 2·lr a step everywhere and 1e-6 at the 99th percentile;
the batch's latents, ``y`` and CLIP features 1e-4 absolute (VAE and CLIP
encodes, as tests/test_torch_i2v.py holds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, close_rel, close_steps, jax_draws, perturb,
                          port_config, torch_threads)
from yume_tpu.configs import CLIPConfig, DiTConfig, PipelineConfig, T5Config, VAEConfig
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.training import i2v_batch as jbatch
from yume_tpu.training import lora as jlora
from yume_tpu.training import train_step as jts
from yume_tpu_torch.models import dit as tdit
from yume_tpu_torch.training import i2v_batch as tbatch
from yume_tpu_torch.training import lora as tlora
from yume_tpu_torch.training import train_step as tts
from yume_tpu_torch.utils import convert

Z, MASK_CH, LFZ = 8, 2, 2
CFG = DiTConfig(model_type="i2v", in_dim=Z + MASK_CH + Z, out_dim=Z, dim=64, ffn_dim=128,
                freq_dim=32, text_dim=16, num_heads=4, num_layers=2, framepack=True,
                mvdt=True, image_context_len=5, image_dim=12)
B, F, H, W = 2, 4, 8, 8
KEEP = 40
N_TOK = tdit.packed_token_count(F - LFZ, LFZ, H, W, CFG.patch_size)
LOSS_REL, GRAD_REL, ENCODE_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def setup():
    jdit = JaxDiT(CFG, dtype=jnp.float32)
    rng = np.random.default_rng(8)
    batch_np = {"latents": rng.standard_normal((B, F, H, W, Z)),
                "y": rng.standard_normal((B, F, H, W, MASK_CH + Z)),
                "context": rng.standard_normal((B, 8, CFG.text_dim)),
                "clip_context": rng.standard_normal((B, 5, 12))}
    batch_np = {k: v.astype(np.float32) for k, v in batch_np.items()}
    shapes = jax.eval_shape(
        lambda k: jdit.init(k, jnp.zeros((B, F, H, W, CFG.in_dim)), jnp.zeros((B, F)),
                            jnp.asarray(batch_np["context"]), packed=True,
                            latent_frame_zero=LFZ,
                            clip_context=jnp.asarray(batch_np["clip_context"]),
                            mvdt_rng=jax.random.PRNGKey(0), mvdt_keep=KEEP),
        jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=13)}
    batch_j = {k: jnp.asarray(v) for k, v in batch_np.items()}
    batch_t = {k: _t(v) for k, v in batch_np.items()}
    return jdit, params, batch_j, batch_t


def _port_model(params, remat=False):
    model = tdit.WanDiT(port_config(CFG), torch.float32, device="meta",
                        remat=remat).to_empty(device="cpu")
    convert.load_state_dict(model, convert.dit_state_dict(params, CFG.num_layers))
    return model


def _draws(rng):
    return jax_draws(rng, (B, F, H, W, Z), N_TOK, i2v=True)


def _tcs(**kw):
    kw.setdefault("latent_frame_zero", LFZ)
    return jts.TrainConfig(**kw), tts.TrainConfig(**kw)


_JAX_LOSS = {}


@pytest.mark.parametrize("mvdt,remat", [(False, False), (True, False), (False, True)],
                         ids=["plain", "mvdt", "remat"])
def test_i2v_loss_and_gradients_match_jax(setup, mvdt, remat):
    jdit, params, batch_j, batch_t = setup
    tc_j, tc_t = _tcs(mvdt=mvdt)
    keep = KEEP if mvdt else None
    if mvdt not in _JAX_LOSS:
        _JAX_LOSS[mvdt] = jax.jit(jax.value_and_grad(
            jts.make_loss_fn(jdit.apply, tc_j, packed=True, mvdt_keep=keep), has_aux=True))
    rng = jax.random.PRNGKey(17)
    (loss_j, tail_j), grads_j = _JAX_LOSS[mvdt](params, batch_j, rng)

    model = _port_model(params, remat=remat)
    draws = _draws(rng)
    assert "hist" not in draws["flow"]
    loss, tail = tts.make_loss_fn(model, tc_t, mvdt_keep=keep)(batch_t, draws)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                                materialize_grads=True)
    close_rel(loss.detach(), loss_j, LOSS_REL)
    assert tail.shape == (B, LFZ, H, W, Z)
    close_rel(tail.detach(), tail_j, LOSS_REL * 10)
    want = convert.dit_state_dict(grads_j, CFG.num_layers)
    assert set(want) == set(names)
    for n, g in zip(names, grads):
        close_rel(g, want[n], GRAD_REL, n)
    # the CLIP branch and the image keys train
    for n in ("img_emb.proj.1.weight", "blocks.0.cross_attn.k_img.weight"):
        assert grads[names.index(n)].abs().sum() > 0, n
    if mvdt:
        assert grads[names.index("mask_token")].abs().sum() > 0


def test_i2v_draws_have_no_history_mask(setup):
    *_, batch_t = setup
    draws = tts.draw_step(batch_t, tts.TrainConfig(latent_frame_zero=LFZ),
                          torch.Generator().manual_seed(0), masked=True)
    assert set(draws["flow"]) == {"t", "x0"} and set(draws["masked"]) == {"t", "x0", "mvdt"}
    plain = {k: v for k, v in batch_t.items() if k in ("latents", "context")}
    assert "hist" in tts.draw_step(plain, tts.TrainConfig(), torch.Generator())["flow"]


def test_i2v_train_steps_match_jax(setup):
    jdit, params, batch_j, batch_t = setup
    lr = 1e-3
    tc_j, tc_t = _tcs(learning_rate=lr, lr_warmup_steps=2, ema_decay=0.9)
    jstep = jax.jit(jts.make_train_step(jdit.apply, tc_j, packed=True))
    st_j = jts.init_train_state(params, tc_j)
    model = _port_model(params)
    state = tts.init_train_state(tts.trainable_params(model), tc_t)
    step = tts.make_train_step(model, tc_t)
    for r in (jax.random.PRNGKey(31), jax.random.PRNGKey(32)):
        st_j, m_j = jstep(st_j, batch_j, r)
        state, m = step(state, batch_t, _draws(r))
        close_rel(m["loss"], m_j["loss"], LOSS_REL)
        close_rel(m["grad_norm"], m_j["grad_norm"], 1e-5)
    assert state.step == 2
    for tree, got in ((st_j.params, state.params), (st_j.ema_params, state.ema_params)):
        for n, w in convert.dit_state_dict(tree, CFG.num_layers).items():
            close_steps(got[n], w, lr, 2, n)


def test_i2v_lora_steps_match_jax(setup):
    jdit, params, batch_j, batch_t = setup
    lr = 1e-3
    tc_j, tc_t = _tcs(learning_rate=lr)
    lora_j = jlora.init_lora(jax.random.PRNGKey(5), params, rank=4)
    jstep = jax.jit(jlora.make_lora_train_step(jdit.apply, tc_j, packed=True))
    st_j = jts.init_train_state(lora_j, tc_j)
    model = _port_model(params)
    lora_t = {k: _t(v).requires_grad_() for k, v in convert.lora_state_dict(lora_j).items()}
    lm = tlora.LoRAModel(model, lora_t)
    state = tts.init_train_state(lora_t, tc_t)
    step = tlora.make_lora_train_step(lm, tc_t)
    for r in (jax.random.PRNGKey(41), jax.random.PRNGKey(42)):
        st_j, m_j = jstep(st_j, params, batch_j, r)
        state, m = step(state, batch_t, _draws(r))
        close_rel(m["loss"], m_j["loss"], LOSS_REL)
        assert m["grad_norm"] > 0
    for n, w in convert.lora_state_dict(st_j.params).items():
        close_steps(state.params[n], w, lr, 2, n)


def test_i2v_lora_adapters_match_jax_and_stay_fp32_over_a_bf16_base(setup):
    _, params, _, _ = setup
    want = convert.lora_state_dict(jlora.init_lora(jax.random.PRNGKey(5), params, rank=4))
    model = _port_model(params)
    got = tlora.init_lora(model, rank=4, generator=torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    # 10 projections a block (the MVDT side block too): q, k, v, o of both
    # attentions, and k_img, v_img; an A and a B each
    assert {k.split(".")[-2] for k in got} == {"q", "k", "v", "o", "k_img", "v_img"}
    assert len(got) == 2 * (CFG.num_layers + 1) * 10
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
    meta = tdit.WanDiT(port_config(CFG), torch.bfloat16, device="meta",
                       param_dtype=torch.float32)
    n_cast = tlora.bf16_base_(meta)
    assert n_cast == sum(m.weight.numel() for n, m in meta.named_modules()
                         if isinstance(m, torch.nn.Linear) and n.startswith("blocks."))
    bf16 = meta.to_empty(device="cpu")
    convert.load_state_dict(bf16, convert.dit_state_dict(params, CFG.num_layers))
    assert bf16.blocks[0].self_attn.q.weight.dtype == torch.bfloat16
    assert bf16.blocks[0].modulation.dtype == bf16.head.head.weight.dtype == torch.float32
    adapters = tlora.init_lora(bf16, rank=4, generator=torch.Generator().manual_seed(0))
    assert all(a.dtype == torch.float32 for a in adapters.values())


def test_bf16_base_forward_equals_the_fp32_stored_model(setup):
    """The bf16-stored blocks compute what the fp32-stored model computes
    in bf16: the forward casts each Linear weight to bf16 either way."""
    _, params, _, batch_t = setup
    sd = convert.dit_state_dict(params, CFG.num_layers)
    outs = []
    for cast in (False, True):
        model = tdit.WanDiT(port_config(CFG), torch.bfloat16, device="meta",
                            param_dtype=torch.float32)
        if cast:
            tlora.bf16_base_(model)
        model = model.to_empty(device="cpu")
        convert.load_state_dict(model, sd)
        x = torch.cat([batch_t["latents"], batch_t["y"]], -1).to(torch.bfloat16)
        t = torch.full((B, F), 500.0)
        with torch.no_grad():
            outs.append(model(x, t, batch_t["context"], latent_frame_zero=LFZ,
                              clip_context=batch_t["clip_context"]))
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------

PIPE_CFG = PipelineConfig(
    name="smoke-i2v", dit=CFG,
    vae=VAEConfig(z_dim=Z, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                  temporal_downsample=(True, False), stride=(2, 4, 4), patchify=1,
                  arch="wan21"),
    t5=T5Config(vocab_size=256, dim=16, dim_attn=16, dim_ffn=24, num_heads=2, num_layers=1,
                text_len=16),
    clip=CLIPConfig(image_size=16, patch_size=8, dim=12, num_heads=2, num_layers=1,
                    out_tokens=5),
    latent_frame_zero=LFZ)


@pytest.fixture(scope="module")
def batch_pipes():
    """JAX's and the port's I2VPipeline without DiT and umT5, on the same
    perturbed VAE and CLIP parameters."""
    from yume_tpu.models.clip import CLIPVisual
    from yume_tpu.models.vae import WanVAE
    from yume_tpu.pipelines.i2v import I2VPipeline as JaxPipeline
    from yume_tpu_torch.pipelines.i2v import I2VPipeline

    def init(model, seed, *args):
        shapes = jax.eval_shape(lambda k: model.init(k, *args), jax.random.PRNGKey(0))
        return {"params": perturb(shapes["params"], seed)}

    vae, clip = WanVAE(PIPE_CFG.vae), CLIPVisual(PIPE_CFG.clip)
    vae_p = init(vae, 51, jnp.zeros((1, 5, 16, 16, 3)))
    clip_p = init(clip, 52, jnp.zeros((1, 16, 16, 3)))
    jpipe = JaxPipeline(PIPE_CFG, None, None, vae, vae_p, None, None, clip, clip_p)
    tpipe = I2VPipeline.from_state_dicts(
        port_config(PIPE_CFG), None,
        convert.vae21_state_dict(vae_p, PIPE_CFG.vae.num_res_blocks), None,
        convert.clip_visual_state_dict(clip_p, PIPE_CFG.clip.num_layers), device="cpu",
        dtype=torch.float32)
    return jpipe, tpipe


def _video(seed, f_px):
    return np.random.default_rng(seed).uniform(-1, 1, (1, f_px, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize("f_px,rand,f_lat", [(11, 0.2, 6), (11, 0.9, 6), (9, 0.9, 5),
                                             (5, 0.9, 3), (3, 0.9, 6)],
                         ids=["i2v", "v2v", "v2v-9", "v2v-one-history-frame",
                              "short-clip-forces-i2v"])
def test_build_i2v_train_batch_matches_jax(batch_pipes, f_px, rand, f_lat):
    jpipe, tpipe = batch_pipes
    video = _video(60 + f_px, f_px)
    ctx = np.random.default_rng(61).standard_normal((1, 16, 16)).astype(np.float32)
    want = jbatch.build_i2v_train_batch(jpipe, jnp.asarray(video), jnp.asarray(ctx),
                                        rand_num_img=rand)
    got = tbatch.build_i2v_train_batch(tpipe, _t(video), _t(ctx), rand_num_img=rand)
    assert set(got) == set(want) == {"latents", "y", "context", "clip_context"}
    assert got["latents"].shape == (1, f_lat, 4, 4, Z)
    assert got["y"].shape == (1, f_lat, 4, 4, MASK_CH + Z)
    for k in ("latents", "y", "clip_context"):
        assert got[k].shape == want[k].shape, k
        assert_close(got[k], want[k], ENCODE_TOL)
    np.testing.assert_array_equal(got["y"][..., :MASK_CH].numpy(),
                                  np.asarray(want["y"])[..., :MASK_CH])
    assert np.abs(np.asarray(want["latents"])).max() > 0.1


def test_build_i2v_train_batch_too_short_raises(batch_pipes):
    _, tpipe = batch_pipes
    with pytest.raises(ValueError, match="too short"):
        tbatch.build_i2v_train_batch(tpipe, _t(_video(62, 1)), torch.zeros(1, 16, 16),
                                     rand_num_img=0.9)


def test_trim_s0n1_and_synthetic_batch():
    for f, s0 in ((35, 4), (33, 4), (36, 4), (37, 4), (8, 2), (1, 4)):
        assert tbatch.trim_s0n1(f, s0) == jbatch.trim_s0n1(f, s0)
    got = tbatch.synthetic_i2v_batch(torch.Generator().manual_seed(3), b=2, f=5, h=4, w=6,
                                     z_dim=Z, mask_ch=MASK_CH, text_len=16, text_dim=16,
                                     image_context_len=5, image_dim=12)
    want = jbatch.synthetic_i2v_batch(jax.random.PRNGKey(3), b=2, f=5, h=4, w=6, z_dim=Z,
                                      mask_ch=MASK_CH, text_len=16, text_dim=16,
                                      image_context_len=5, image_dim=12)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    # the same scales: unit latents and y, context and CLIP features at 0.02
    for k, s in (("latents", 1.0), ("y", 1.0), ("context", 0.02), ("clip_context", 0.02)):
        assert 0.5 * s < got[k].std().item() < 1.5 * s, k
