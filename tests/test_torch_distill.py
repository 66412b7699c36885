"""ADD distillation in the port against the JAX package on the CPU: the
projected discriminator and its parts (spectral-norm conv, virtual-batch
norm, the conv block whose GroupNorm bias and leaky ReLU go through
``bias_act``), the DINO preprocess and the timm weight reader, the hinge
losses, and whole distillation steps on the tiny DiT of
tests/test_distill_step.py.

Inputs and parameters are numpy arrays from a seed, converted with
``utils.convert``. The JAX discriminator's optimizer freezes DINO with
``optax.multi_transform`` and ``set_to_zero``: that is what the reference's
``requires_grad=False`` means, and what the port does. (``yume_tpu/train.py``
uses ``optax.masked``, which passes DINO's raw gradients through as its
updates, so there DINO moves; see ROADMAP queue 3.)

Tolerances, with their reasons:
* discriminator logits 1e-4 of the largest |logit|: fp32 through 12 DINO
  blocks and the heads, summed in another order by XLA:CPU and ATen; the
  spectral vectors 1e-5 (one normalised power iteration);
* the small modules 1e-5 (fp32, a few sums);
* whole steps: losses and the gradient norm 1e-4 relative; ``gan_loss``
  1e-3 (0.01 × a difference of two logit means, through a discriminator
  one Adam step old). The discriminator's gradients pass leaky-ReLU kinks:
  a pre-activation within ~1e-6 of 0 takes the other slope under another
  summation order, and one such flip moved a conv block's input gradient
  by 1% of its largest entry (measured against float64). So parameters
  follow the ``close_steps`` rule (within 2·lr a step; a first Adam step
  maps a last-bit difference near 0 to ±lr) with a 99th percentile of
  1e-5 (generator) and 1e-4 (discriminator, two steps from the same
  start; measured 5.9e-6 and 6.7e-5), spectral vectors and Adam moments
  by relative L2 per tensor (measured 3.1e-4 and 1.5e-2). From JAX's
  state after step 1 a single step agrees more closely (``MID_RUN``).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import (assert_close, close_rel, close_steps, jax_draws, perturb, port_config,
                          rel_l2, torch_threads)
from yume_tpu.configs import DiTConfig
from yume_tpu.models import discriminator as jdisc
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.training import distill as jdistill
from yume_tpu.training import train_step as jts
from yume_tpu_torch.models import discriminator as tdisc
from yume_tpu_torch.models import dit as tdit
from yume_tpu_torch.training import distill as tdistill
from yume_tpu_torch.training import train_step as tts
from yume_tpu_torch.utils import convert

CFG = DiTConfig(model_type="ti2v", in_dim=4, out_dim=4, dim=32, ffn_dim=64, freq_dim=16,
                text_dim=8, text_len=6, num_heads=2, num_layers=2, framepack=True)
LFZ, B, F, H, W = 2, 1, 5, 8, 8
N_TOK = tdit.packed_token_count(F - LFZ, LFZ, H, W, CFG.patch_size)
LR = D_LR = 1e-3
LOGIT_REL, U_REL, STEP_REL, GAN_REL = 1e-4, 1e-5, 1e-4, 1e-3
# state tolerances (see the module docstring): two steps from the same
# start, where leaky-ReLU kinks in the discriminator diverge; and one step
# from JAX's converted state
FROM_START = {"gen_p99": 1e-5, "disc_p99": 1e-4, "u_l2": 1e-3, "moment_l2": 3e-2}
MID_RUN = {"gen_p99": 1e-5, "disc_p99": 1e-5, "u_l2": 1e-4, "moment_l2": 5e-3}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _disc_variables(hw, z_dim, seed):
    """Seeded parameters (``perturb``) and the initial spectral vectors
    (ones/√out, as flax initialises them) of the JAX discriminator."""
    disc = jdisc.ProjectedDiscriminator()
    shapes = jax.eval_shape(disc.init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, z_dim)))
    params = perturb(shapes["params"], seed)
    spectral = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, s.shape[0] ** -0.5, np.float32), shapes["spectral"])
    return disc, params, spectral


def _port_disc(params, spectral, z_dim):
    disc = tdisc.ProjectedDiscriminator(z_dim)
    convert.load_state_dict(disc, convert.disc_state_dict(params, spectral))
    return disc


def _u_vectors(module):
    return {n: b for n, b in module.named_buffers() if n.endswith(".u")}


# ---------------------------------------------------------------------------
# the discriminator and its parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,z_dim,hw", [(2, 4, (8, 8)), (3, 48, (22, 40))],
                         ids=["lfz2-z4-8x8", "z48-22x40"])
def test_discriminator_matches_jax(b, z_dim, hw):
    """Logits, feature-axis logits and the spectral vectors after one call.
    With 2 or 3 frames the feature-axis heads' kernel-7 circular padding
    wraps the frame axis more than once."""
    disc, params, spectral = _disc_variables(hw, z_dim, seed=11)
    x = np.random.default_rng(1).standard_normal((b, *hw, z_dim)).astype(np.float32)
    (logits_j, logits_f_j), mut = jax.jit(
        lambda v, x: disc.apply(v, x, mutable=["spectral"]))(
        {"params": params, "spectral": spectral}, jnp.asarray(x))
    port = _port_disc(params, spectral, z_dim)
    with torch.no_grad():
        logits, logits_f = port(_t(x))
    assert tuple(logits.shape) == logits_j.shape == (b, 5 * 196)
    assert tuple(logits_f.shape) == logits_f_j.shape == (196, 5 * b)
    close_rel(logits, logits_j, LOGIT_REL)
    close_rel(logits_f, logits_f_j, LOGIT_REL)
    want = convert.disc_state_dict(params, mut)
    for name, u in _u_vectors(port).items():
        close_rel(u, want[name], U_REL, name)
    # the conversion inverts
    p_back, s_back = convert.disc_tree(port.state_dict())
    for name, val in convert.disc_state_dict(p_back, s_back).items():
        np.testing.assert_array_equal(val, port.state_dict()[name].numpy(), err_msg=name)


@pytest.mark.parametrize("hw", [(88, 160), (176, 320)], ids=["up-88x160", "down-176x320"])
def test_dino_preprocess_matches_jax(hw):
    """The antialiased linear resize to 224², upsampling both axes (the
    trainer's grid × 4) and downsampling one (a 720p latent grid × 4)."""
    x = np.random.default_rng(2).uniform(size=(2, *hw, 3)).astype(np.float32)
    want = jdisc.dino_preprocess(jnp.asarray(x))
    got = tdisc.dino_preprocess(_t(x))
    assert tuple(got.shape) == want.shape == (2, 224, 224, 3)
    # XLA:CPU's resize einsum lies up to 7e-6 (upsampling) and 1.2e-5
    # (downsampling, more taps) from a float64 product of the same weights,
    # ATen's within 1.3e-7; the ImageNet std (~0.225) then divides it
    assert_close(got, want, 1e-4)


@pytest.mark.parametrize("kernel,circular,length", [(1, True, 5), (9, True, 5), (7, True, 2),
                                                    (7, False, 5)])
def test_spectral_conv_matches_jax(kernel, circular, length):
    """Output, new u and the weight gradient (σ from the new u and v, no
    gradient through them); ``update_u=False`` keeps u."""
    rng = np.random.default_rng(3)
    mod = jdisc.SpectralConv1d(6, kernel, circular=circular)
    x = rng.standard_normal((2, length, 5)).astype(np.float32)
    g = rng.standard_normal((2, length, 6)).astype(np.float32)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"kernel": rng.standard_normal((kernel, 5, 6)).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    u0 = rng.standard_normal(6).astype(np.float32)
    u0 /= np.linalg.norm(u0)

    def f(p):
        y, mut = mod.apply({"params": p, "spectral": {"u": u0}}, jnp.asarray(x),
                           mutable=["spectral"])
        return jnp.sum(y * g), (y, mut["spectral"]["u"])

    (_, (y_j, u_j)), grads_j = jax.value_and_grad(f, has_aux=True)(params)
    assert variables["params"]["kernel"].shape == params["kernel"].shape
    port = tdisc.SpectralConv1d(5, 6, kernel, circular=circular)
    convert.load_state_dict(port, {"weight": params["kernel"].transpose(2, 1, 0),
                                   "bias": params["bias"], "u": u0})
    y = port(_t(x), update_u=False)
    assert_close(port.u, u0, 0.0)
    y = port(_t(x))
    assert_close(y, y_j, 1e-5)
    assert_close(port.u, u_j, 1e-6)
    gw, gb = torch.autograd.grad(y, [port.weight, port.bias], _t(g))
    assert_close(gw, np.asarray(grads_j["kernel"]).transpose(2, 1, 0), 1e-5)
    assert_close(gb, grads_j["bias"], 1e-5)


def test_batch_norm_local_matches_jax(rng_np):
    mod = jdisc.BatchNormLocal(8)
    x = rng_np.standard_normal((6, 3, 8)).astype(np.float32) * 2 + 1
    params = {"weight": 1 + 0.1 * rng_np.standard_normal(8).astype(np.float32),
              "bias": 0.1 * rng_np.standard_normal(8).astype(np.float32)}
    want = mod.apply({"params": params}, jnp.asarray(x))
    port = tdisc.BatchNormLocal(8)
    convert.load_state_dict(port, params)
    assert_close(port(_t(x)), want, 1e-5)


def test_conv_block_matches_jax(rng_np):
    """Spectral conv → GroupNorm(4) (flax's eps 1e-6, fast variance) →
    leaky ReLU 0.2, the last two through ``bias_act``: output, new u and
    the input gradient."""
    mod = jdisc.ConvBlock(8, 3)
    x = rng_np.standard_normal((2, 5, 8)).astype(np.float32)
    g = rng_np.standard_normal((2, 5, 8)).astype(np.float32)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = perturb(shapes["params"], seed=4)
    u0 = np.full(8, 8 ** -0.5, np.float32)

    def f(x):
        y, mut = mod.apply({"params": params, "spectral": {"conv": {"u": u0}}}, x,
                           mutable=["spectral"])
        return jnp.sum(y * g), (y, mut["spectral"]["conv"]["u"])

    (_, (y_j, u_j)), gx_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    port = tdisc.ConvBlock(8, 8, 3)
    convert.load_state_dict(port, {
        "conv.weight": params["conv"]["kernel"].transpose(2, 1, 0),
        "conv.bias": params["conv"]["bias"], "conv.u": u0,
        "norm.weight": params["norm"]["scale"], "norm.bias": params["norm"]["bias"]})
    xt = _t(x).requires_grad_()
    y = port(xt)
    assert type(y.grad_fn).__name__ == "BiasActBackward"
    assert_close(y, y_j, 1e-5)
    assert_close(port.conv.u, u_j, 1e-6)
    (gx,) = torch.autograd.grad(y, xt, _t(g))
    assert_close(gx, gx_j, 1e-5)


def test_hinge_losses_match_jax(rng_np):
    preds = [rng_np.standard_normal(s).astype(np.float32) * 1.5
             for s in ((2, 980), (196, 10), (2, 980), (196, 10))]
    assert_close(tdistill.hinge_d_loss(*map(_t, preds)),
                 jdistill.hinge_d_loss(*map(jnp.asarray, preds)), 1e-6)
    assert_close(tdistill.gan_g_loss(*map(_t, preds[2:])),
                 jdistill.gan_g_loss(*map(jnp.asarray, preds[2:])), 1e-6)
    ones = torch.ones(2, 10)
    assert float(tdistill.hinge_d_loss(ones, ones, -ones, -ones)) == 0.0


# ---------------------------------------------------------------------------
# whole distillation steps
# ---------------------------------------------------------------------------


def _jax_disc_optimizer():
    """Clipped AdamW on every parameter but DINO's, DINO's updates zero."""
    def labels(params):
        return flax.traverse_util.path_aware_map(
            lambda path, _: "frozen" if path[0] == "dino" else "train", params)

    return optax.multi_transform(
        {"train": optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(D_LR)),
         "frozen": optax.set_to_zero()}, labels)


@pytest.fixture(scope="module")
def steps_j():
    """Two JAX distillation steps (one jitted step function) from seeded
    DiT and discriminator parameters, and everything the port needs to
    start from the same place."""
    jdit = JaxDiT(CFG, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, F, H, W, CFG.in_dim)).astype(np.float32)
    ctx = (0.1 * rng.standard_normal((B, CFG.text_len, CFG.text_dim))).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: jdit.init(k, jnp.asarray(x), jnp.zeros((B, F)), jnp.asarray(ctx),
                            packed=True, latent_frame_zero=LFZ), jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=3)}
    disc, d_params, spectral = _disc_variables((H, W), CFG.out_dim, seed=12)
    d_opt = _jax_disc_optimizer()
    tc = jts.TrainConfig(learning_rate=LR, latent_frame_zero=LFZ, ema_decay=0.9)
    step = jax.jit(jdistill.make_distill_train_step(jdit.apply, tc, disc, d_opt, packed=True))
    batch = {"latents": jnp.asarray(x), "context": jnp.asarray(ctx)}
    states = [(jts.init_train_state(params, tc),
               jdistill.DiscState(d_params, spectral, d_opt.init(d_params)))]
    rngs = [jax.random.PRNGKey(21), jax.random.PRNGKey(22)]
    metrics = []
    for r in rngs:
        st, ds, m = step(*states[-1], batch, r)
        states.append((st, ds))
        metrics.append(m)
    return {"params": params, "d_params": d_params, "spectral": spectral, "rngs": rngs,
            "states": states, "metrics": metrics,
            "batch": {"latents": _t(x), "context": _t(ctx)}}


def _draws(rng):
    return jax_draws(rng, (B, F, H, W, CFG.in_dim), N_TOK)


def _to_port(tree):
    return convert.dit_state_dict(tree, CFG.num_layers)


def _port_setup(params, d_params, spectral, gan_weight=0.01):
    """The port's generator, discriminator and step from JAX trees."""
    tc = tts.TrainConfig(learning_rate=LR, latent_frame_zero=LFZ, ema_decay=0.9)
    model = tdit.WanDiT(port_config(CFG), torch.float32, device="meta").to_empty(device="cpu")
    convert.load_state_dict(model, _to_port(params))
    d_opt = tdistill.disc_optimizer(D_LR)
    disc, d_state = tdistill.init_disc_state(d_opt, z_dim=CFG.out_dim, device="cpu")
    convert.load_state_dict(disc, convert.disc_state_dict(d_params, spectral))
    state = tts.init_train_state(tts.trainable_params(model), tc)
    step = tdistill.make_distill_train_step(model, tc, disc, d_opt, gan_weight=gan_weight)
    return state, disc, d_state, step


def _check_metrics(m, m_j):
    for k in ("loss", "flow_loss", "d_loss", "grad_norm"):
        close_rel(m[k], m_j[k], STEP_REL, k)
    close_rel(m["gan_loss"], m_j["gan_loss"], GAN_REL, "gan_loss")


def _check_states(state, disc, d_state, st_j, ds_j, steps, tol):
    """The port's states against JAX's: parameters by ``close_steps`` with
    ``tol``'s 99th percentiles, spectral vectors and Adam moments by
    relative L2 per tensor."""
    for tree, got in ((st_j.params, state.params), (st_j.ema_params, state.ema_params)):
        for n, w in _to_port(tree).items():
            close_steps(got[n], w, LR, steps, n, p99=tol["gen_p99"])
    want = convert.disc_state_dict(ds_j.params, ds_j.spectral)
    for n, got in disc.state_dict().items():
        if n.endswith(".u"):
            assert rel_l2(got, want[n]) <= tol["u_l2"], (n, rel_l2(got, want[n]))
        else:
            close_steps(got, want[n], D_LR, steps, n, p99=tol["disc_p99"])
    moments = convert.adamw_state(ds_j.opt_state, convert.disc_state_dict)
    assert d_state.opt_state["count"] == moments["count"] == state.step
    assert set(d_state.opt_state["mu"]) == set(moments["mu"]) == set(d_state.params)
    for which in ("mu", "nu"):
        for n, w in moments[which].items():
            err = rel_l2(d_state.opt_state[which][n], w)
            assert err <= tol["moment_l2"], (which, n, err)


def test_distill_steps_match_jax(steps_j):
    """Two whole steps from the same start: metrics, the generator's
    parameters and EMA, the discriminator's parameters, spectral vectors
    and Adam moments; DINO unchanged. Then step 2 again from JAX's state
    after step 1, converted."""
    s = steps_j
    state, disc, d_state, step = _port_setup(s["params"], s["d_params"], s["spectral"])
    dino0 = {n: p.clone() for n, p in disc.dino.named_parameters()}
    for i, r in enumerate(s["rngs"]):
        state, d_state, m = step(state, d_state, s["batch"], _draws(r))
        _check_metrics(m, s["metrics"][i])
    assert state.step == 2
    _check_states(state, disc, d_state, *s["states"][2], steps=2, tol=FROM_START)
    assert all(torch.equal(p, dino0[n]) and not p.requires_grad
               for n, p in disc.dino.named_parameters())
    assert not any(n.startswith("dino.") for n in d_state.params)

    # mid-run: the port from JAX's state after step 1
    st1, ds1 = s["states"][1]
    state, disc, d_state, step = _port_setup(st1.params, ds1.params, ds1.spectral)
    state.step = 1
    gen_opt = convert.adamw_state(st1.opt_state, _to_port)
    d_opt = convert.adamw_state(ds1.opt_state, convert.disc_state_dict)
    for opt, into in ((gen_opt, state.opt_state), (d_opt, d_state.opt_state)):
        into["count"] = opt["count"]
        for which in ("mu", "nu"):
            into[which] = {n: _t(v) for n, v in opt[which].items()}
    state.ema_params = {n: _t(v) for n, v in _to_port(st1.ema_params).items()}
    state, d_state, m = step(state, d_state, s["batch"], _draws(s["rngs"][1]))
    _check_metrics(m, s["metrics"][1])
    _check_states(state, disc, d_state, *s["states"][2], steps=1, tol=MID_RUN)


def test_gan_weight_reaches_the_generator(steps_j):
    """The JAX test's invariant in the port: the same data and draws with
    gan_weight 0 and 10 give the same flow loss and different generator
    gradients; gan_loss scales with the weight."""
    s = steps_j
    out = []
    for weight in (0.0, 10.0):
        state, _, d_state, step = _port_setup(s["params"], s["d_params"], s["spectral"],
                                              gan_weight=weight)
        out.append(step(state, d_state, s["batch"], _draws(s["rngs"][0]))[2])
    m0, m1 = out
    assert float(m0["flow_loss"]) == pytest.approx(float(m1["flow_loss"]), abs=1e-6)
    assert float(m0["grad_norm"]) != pytest.approx(float(m1["grad_norm"]), rel=1e-6)
    assert float(m0["gan_loss"]) == 0.0 and float(m1["gan_loss"]) != 0.0
    assert all(np.isfinite(float(m[k])) for m in out for k in m)


# ---------------------------------------------------------------------------
# DINO weights in timm's layout
# ---------------------------------------------------------------------------


def _timm_dino(gen, dim=384, depth=12, patch=16, img=224):
    """Random ViT-S/16 weights in the key layout of
    dino_deitsmall16_pretrain.pth, with its unused final norm."""
    def rnd(*shape, scale=0.02):
        return torch.randn(shape, generator=gen) * scale

    sd = {"cls_token": rnd(1, 1, dim), "pos_embed": rnd(1, (img // patch) ** 2 + 1, dim),
          "patch_embed.proj.weight": rnd(dim, 3, patch, patch, scale=0.05),
          "patch_embed.proj.bias": rnd(dim), "norm.weight": 1 + rnd(dim),
          "norm.bias": rnd(dim)}
    for i in range(depth):
        p = f"blocks.{i}."
        for name, shape in (("norm1", None), ("norm2", None), ("attn.qkv", (3 * dim, dim)),
                            ("attn.proj", (dim, dim)), ("mlp.fc1", (4 * dim, dim)),
                            ("mlp.fc2", (dim, 4 * dim))):
            sd[p + name + ".weight"] = 1 + rnd(dim) if shape is None else rnd(*shape, scale=0.05)
            sd[p + name + ".bias"] = rnd(dim if shape is None else shape[0])
    return sd


def _timm_forward(sd, x, heads=6, depth=12, patch=16):
    """timm's ViT forward (pre-norm blocks, exact GELU), x [B, 3, H, W]:
    the tokens after every block, then the embedded tokens."""
    fn = torch.nn.functional
    b, dim = x.shape[0], sd["cls_token"].shape[-1]
    h = fn.conv2d(x, sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"], stride=patch)
    h = torch.cat([sd["cls_token"].expand(b, -1, -1), h.flatten(2).transpose(1, 2)], 1)
    h = embedded = h + sd["pos_embed"]
    out = []
    for i in range(depth):
        p = f"blocks.{i}."
        y = fn.layer_norm(h, (dim,), sd[p + "norm1.weight"], sd[p + "norm1.bias"], eps=1e-6)
        qkv = fn.linear(y, sd[p + "attn.qkv.weight"], sd[p + "attn.qkv.bias"])
        q, k, v = qkv.reshape(b, -1, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
        att = ((q @ k.transpose(-2, -1)) * (dim // heads) ** -0.5).softmax(-1)
        h = h + fn.linear((att @ v).transpose(1, 2).reshape(b, -1, dim),
                          sd[p + "attn.proj.weight"], sd[p + "attn.proj.bias"])
        y = fn.layer_norm(h, (dim,), sd[p + "norm2.weight"], sd[p + "norm2.bias"], eps=1e-6)
        y = fn.gelu(fn.linear(y, sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"]))
        h = h + fn.linear(y, sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"])
        out.append(h)
    return out + [embedded]


def test_dino_weights_load_through_dino_path(tmp_path):
    """A timm-layout ViT-S/16 state dict saved as a .pth and loaded by
    ``init_disc_state(dino_path=...)`` (what ``train.py --dino_path``
    calls): the hooks (blocks 2, 5, 8, 11, then the embedded tokens) equal
    an inline timm forward on the same weights."""
    sd = _timm_dino(torch.Generator().manual_seed(0))
    path = tmp_path / "dino_deitsmall16_pretrain.pth"
    torch.save(sd, path)
    disc, _ = tdistill.init_disc_state(tdistill.disc_optimizer(), z_dim=4,
                                       dino_path=str(path), device="cpu")
    for name, p in disc.dino.named_parameters():
        assert torch.equal(p, sd[name]) and not p.requires_grad, name
    x = torch.rand((1, 3, 224, 224), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = _timm_forward(sd, x)
        got = disc.dino(x.permute(0, 2, 3, 1))
    want = [want[i] for i in (2, 5, 8, 11)] + [want[-1]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close_rel(g, w, 2e-4)
