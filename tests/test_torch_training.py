"""The port's training path against the JAX package on the CPU: Transport,
the history masks, the loss and every parameter's gradient (plain and MVDT,
with and without remat), the optimizers given the same gradients, and
whole train steps (full and LoRA), on the tiny DiT of tests/test_training.py
with perturbed parameters, in fp32.

The JAX functions draw from PRNG keys; the tests reproduce those draws
(the same splits) and hand the numbers to the port, whose draws are explicit.

Tolerances, with their reasons:
* loss 1e-5 relative, gradients 1e-4 of each parameter's largest gradient:
  fp32 sums in another order in XLA:CPU and ATen, through 2 blocks, the
  MVDT side block and the head;
* optimizer on the same gradients: 1e-6 absolute on parameters and
  moments (the same fp32 formulas); adam8bit codes equal, scales 1e-6
  relative;
* whole train steps: a first Adam step maps a gradient that differs only
  in its last bits near 0 to ±lr, so parameters agree within 2·lr per step
  everywhere and within 1e-6 at the 99th percentile.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import assert_close, perturb, port_config, to_np
from yume_tpu.configs import DiTConfig
from yume_tpu.diffusion import transport as jtransport
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.training import lora as jlora
from yume_tpu.training import train_step as jts
from yume_tpu.utils import masks as jmasks
from yume_tpu_torch.diffusion import transport as ttransport
from yume_tpu_torch.models import dit as tdit
from yume_tpu_torch.training import lora as tlora
from yume_tpu_torch.training import train_step as tts
from yume_tpu_torch.utils import convert
from yume_tpu_torch.utils import masks as tmasks

CFG = DiTConfig(model_type="ti2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128,
                freq_dim=32, text_dim=16, num_heads=4, num_layers=2,
                framepack=True, mvdt=True)
LFZ, B, F, H, W = 2, 2, 4, 8, 8
KEEP = 40
N_TOK = tdit.packed_token_count(F - LFZ, LFZ, H, W, CFG.patch_size)
LOSS_REL, GRAD_REL = 1e-5, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# Transport and masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("snr", ["lognorm", "uniform"])
def test_transport_matches_jax(rng_np, snr):
    key = jax.random.PRNGKey(3)
    jt = jtransport.Transport(shift=3.0, snr_type=snr)
    tt = ttransport.Transport(shift=3.0, snr_type=snr)
    draw = (jax.random.normal if snr == "lognorm" else jax.random.uniform)(
        key, (5,), dtype=jnp.float32)
    t_j = jt.sample_t(key, 5)
    t_t = tt.sample_t(_t(draw))
    assert_close(t_t, t_j, 1e-7)
    x0, x1, v = (rng_np.standard_normal((5, 3, 2, 2, 4)).astype(np.float32) for _ in range(3))
    for got, want in zip(tt.plan(t_t, _t(x0), _t(x1)),
                         jt.plan(t_j, jnp.asarray(x0), jnp.asarray(x1))):
        assert_close(got, want, 1e-6)
    assert_close(tt.score_from_velocity(_t(v), _t(x1), t_t),
                 jt.score_from_velocity(jnp.asarray(v), jnp.asarray(x1), t_j), 1e-5)
    assert_close(tt.loss(_t(v), _t(x0), tail_frames=2),
                 jt.loss(jnp.asarray(v), jnp.asarray(x0), tail_frames=2), 1e-6)


@pytest.mark.parametrize("seed,p", [(0, 0.2), (1, 1.0), (2, 0.0)])
def test_masks_like_and_timesteps_match_jax(seed, p):
    shape = (2, 6, 2, 3, 4)
    key = jax.random.PRNGKey(seed)
    r_rng, n_rng = jax.random.split(key)
    draws = (_t(jax.random.uniform(r_rng, ())), _t(jax.random.normal(n_rng, ())))
    want = jmasks.masks_like(shape, zero=True, rng=key, p=p, latent_frame_zero=2)
    got = tmasks.masks_like(shape, zero=True, draws=draws, p=p, latent_frame_zero=2)
    for g, w in zip(got, want):
        assert_close(g, w, 1e-7)
    for zero in (False, True):
        for g, w in zip(tmasks.masks_like(shape, zero=zero, latent_frame_zero=2),
                        jmasks.masks_like(shape, zero=zero, latent_frame_zero=2)):
            assert_close(g, w, 0.0)
    t = np.array([0.3, 0.9], np.float32)
    assert_close(tmasks.per_frame_timesteps(got[0][:, :, 0, 0, 0], _t(t), 2),
                 jmasks.per_frame_timesteps(want[0][:, :, 0, 0, 0], jnp.asarray(t), 2), 0.0)
    assert tmasks.best_output_size(1280, 720, 32, 32, 704 * 1280) == \
        jmasks.best_output_size(1280, 720, 32, 32, 704 * 1280)


# ---------------------------------------------------------------------------
# the tiny DiT in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jdit = JaxDiT(CFG, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, F, H, W, CFG.in_dim)).astype(np.float32)
    ctx = rng.standard_normal((B, 8, CFG.text_dim)).astype(np.float32)
    shapes = jax.eval_shape(
        lambda k: jdit.init(k, jnp.asarray(x), jnp.zeros((B, F)), jnp.asarray(ctx),
                            packed=True, latent_frame_zero=LFZ,
                            mvdt_rng=jax.random.PRNGKey(0), mvdt_keep=KEEP),
        jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=3)}
    batch_j = {"latents": jnp.asarray(x), "context": jnp.asarray(ctx)}
    batch_t = {"latents": _t(x), "context": _t(ctx)}
    return jdit, params, batch_j, batch_t


def _port_model(params, remat=False, cfg=CFG):
    model = tdit.WanDiT(port_config(cfg), torch.float32, device="meta",
                        remat=remat).to_empty(device="cpu")
    convert.load_state_dict(model, convert.dit_state_dict(params, cfg.num_layers))
    return model


def _draws(rng):
    """The draws of the JAX loss_fn for key ``rng`` (its splits), in the
    port's explicit form."""
    flow_rng, mask_rng = jax.random.split(rng)
    out = {}
    for name, key in (("flow", flow_rng), ("masked", mask_rng)):
        t_rng, n_rng, m_rng, mv_rng = jax.random.split(key, 4)
        r_rng, nn_rng = jax.random.split(m_rng)
        out[name] = {"t": _t(jax.random.normal(t_rng, (B,), dtype=jnp.float32)),
                     "x0": _t(jax.random.normal(n_rng, (B, F, H, W, CFG.in_dim))),
                     "hist": (_t(jax.random.uniform(r_rng, ())),
                              _t(jax.random.normal(nn_rng, ())))}
        out[name]["mvdt"] = _t(jax.random.uniform(mv_rng, (B, N_TOK)))
    return out


def _tcs(**kw):
    kw.setdefault("latent_frame_zero", LFZ)
    return jts.TrainConfig(**kw), tts.TrainConfig(**kw)


def _close_rel(got, want, rel, name=""):
    want = to_np(want)
    np.testing.assert_allclose(to_np(got), want, atol=rel * np.abs(want).max() + 1e-7,
                               rtol=0, err_msg=name)


_JAX_LOSS = {}


@pytest.mark.parametrize("mvdt,remat", [(False, False), (False, True), (True, False),
                                        (True, True)])
def test_loss_and_gradients_match_jax(setup, mvdt, remat):
    jdit, params, batch_j, batch_t = setup
    # p = 1: the history takes the pseudo-sigma branch of masks_like
    tc_j, tc_t = _tcs(mvdt=mvdt, mask_history_p=1.0)
    keep = KEEP if mvdt else None
    if mvdt not in _JAX_LOSS:
        _JAX_LOSS[mvdt] = jax.jit(jax.value_and_grad(
            jts.make_loss_fn(jdit.apply, tc_j, packed=True, mvdt_keep=keep), has_aux=True))
    rng = jax.random.PRNGKey(7)
    (loss_j, tail_j), grads_j = _JAX_LOSS[mvdt](params, batch_j, rng)

    model = _port_model(params, remat=remat)
    loss, tail = tts.make_loss_fn(model, tc_t, mvdt_keep=keep)(batch_t, _draws(rng))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                                materialize_grads=True)
    _close_rel(loss.detach(), loss_j, LOSS_REL)
    _close_rel(tail.detach(), tail_j, LOSS_REL * 10)
    want = convert.dit_state_dict(grads_j, CFG.num_layers)
    assert set(want) == set(names)
    for n, g in zip(names, grads):
        _close_rel(g, want[n], GRAD_REL, n)
    if mvdt:  # the masked pass reaches the side block and the mask token
        assert grads[names.index("mask_token")].abs().sum() > 0


def test_remat_gives_the_same_gradients(setup):
    _, params, _, batch_t = setup
    _, tc = _tcs(mvdt=True)
    draws = _draws(jax.random.PRNGKey(2))
    out = []
    for remat in (False, True):
        model = _port_model(params, remat=remat)
        loss, _ = tts.make_loss_fn(model, tc, mvdt_keep=KEEP)(batch_t, draws)
        out.append(torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                                       materialize_grads=True))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_w8a8_refuses_gradients(setup):
    """W8A8 has no gradient: a model that requires grad raises instead of
    silently training without it; under no_grad it serves."""
    _, params, _, batch_t = setup
    cfg = dataclasses.replace(CFG, w8a8=True)
    model = _port_model(params, cfg=cfg)
    t = torch.zeros((B, F))
    with pytest.raises(RuntimeError, match="W8A8"):
        model(batch_t["latents"], t, batch_t["context"], latent_frame_zero=LFZ)
    with torch.no_grad():
        model(batch_t["latents"], t, batch_t["context"], latent_frame_zero=LFZ)


# ---------------------------------------------------------------------------
# optimizers on the same gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt,warmup", [("adamw", 0), ("adamw", 2), ("adam8bit", 0),
                                        ("adam8bit", 2)])
def test_optimizer_matches_optax(rng_np, opt, warmup):
    shapes = {"w": (48, 30), "b": (300,), "m": (1, 6, 20)}
    p0 = {k: (0.1 * rng_np.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    # the first gradient's global norm exceeds the clip, the others do not
    grads = [{k: (sc * rng_np.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for sc in (1.0, 0.01, 0.02)]
    tc_j, tc_t = _tcs(learning_rate=1e-2, weight_decay=1e-2, optimizer=opt,
                      lr_warmup_steps=warmup)
    opt_j = jts.make_optimizer(tc_j)
    p_j = {k: jnp.asarray(v) for k, v in p0.items()}
    st_j = opt_j.init(p_j)
    p_t = {k: _t(v) for k, v in p0.items()}
    st_t = tts.make_optimizer(tc_t).init(p_t)
    chain = tts.make_optimizer(tc_t)
    for g in grads:
        upd, st_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, st_j, p_j)
        p_j = optax.apply_updates(p_j, upd)
        norm = chain.update_(p_t, {k: _t(v) for k, v in g.items()}, st_t)
        _close_rel(norm, optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}), 1e-6)
        for k in shapes:
            assert_close(p_t[k], p_j[k], 1e-6)
        if opt == "adamw":
            adam = convert._adam_leaves(st_j, "adam")
            for k in shapes:
                assert_close(st_t["mu"][k], adam.mu[k], 1e-7)
                assert_close(st_t["nu"][k], adam.nu[k], 1e-7)
        else:
            leaves = convert._adam_leaves(st_j, "adam8bit").leaves
            for k in shapes:
                for f in ("m_q", "v_q"):
                    np.testing.assert_array_equal(st_t["leaves"][k][f].numpy(),
                                                  np.asarray(getattr(leaves[k], f)))
                for f in ("m_scale", "v_scale"):
                    np.testing.assert_allclose(st_t["leaves"][k][f].numpy(),
                                               np.asarray(getattr(leaves[k], f)), rtol=1e-6)
    assert st_t["count"] == 3


def test_adam8bit_state_converts(rng_np):
    """A mid-run JAX adam8bit state carries over: same-layout leaves keep
    their codes (scales within an ulp), so the next update agrees."""
    shapes = {"b": (300,), "m": (1, 6, 20)}
    p0 = {k: (0.1 * rng_np.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng_np.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tc_j, tc_t = _tcs(optimizer="adam8bit", learning_rate=1e-2)
    opt_j = jts.make_optimizer(tc_j)
    st_j = opt_j.init(p0)
    _, st_j = opt_j.update(g, st_j, p0)
    st_t = convert.adam8bit_state(st_j, lambda tree: dict(tree), p0)
    assert st_t["count"] == 1
    for k in shapes:
        leaf_j = convert._adam_leaves(st_j, "adam8bit").leaves[k]
        for f in ("m_q", "v_q"):
            np.testing.assert_array_equal(st_t["leaves"][k][f].numpy(),
                                          np.asarray(getattr(leaf_j, f)))
        for f in ("m_scale", "v_scale"):
            np.testing.assert_allclose(st_t["leaves"][k][f].numpy(),
                                       np.asarray(getattr(leaf_j, f)), rtol=1e-6)


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


def _close_steps(got, want, lr, steps, name=""):
    diff = np.abs(to_np(got) - to_np(want))
    assert diff.max() <= 2 * lr * steps + 1e-6, (name, diff.max())
    assert np.percentile(diff, 99) <= 1e-6, (name, np.percentile(diff, 99))


def test_train_steps_match_jax(setup):
    """Two steps of clipped AdamW with warmup and EMA from the same start;
    then step 2 again from JAX's state after step 1 converted (params,
    moments, EMA)."""
    jdit, params, batch_j, batch_t = setup
    lr = 1e-3
    tc_j, tc_t = _tcs(learning_rate=lr, lr_warmup_steps=2, ema_decay=0.9)
    jstep = jax.jit(jts.make_train_step(jdit.apply, tc_j, packed=True))
    rngs = [jax.random.PRNGKey(11), jax.random.PRNGKey(12)]
    states_j = [jts.init_train_state(params, tc_j)]
    metrics_j = []
    for r in rngs:
        st, m = jstep(states_j[-1], batch_j, r)
        states_j.append(st)
        metrics_j.append(m)

    to_port = lambda tree: convert.dit_state_dict(tree, CFG.num_layers)  # noqa: E731
    model = _port_model(params)
    state = tts.init_train_state(tts.trainable_params(model), tc_t)
    step = tts.make_train_step(model, tc_t)
    for i, r in enumerate(rngs):
        state, m = step(state, batch_t, _draws(r))
        _close_rel(m["loss"], metrics_j[i]["loss"], LOSS_REL)
        _close_rel(m["grad_norm"], metrics_j[i]["grad_norm"], 1e-5)
    assert state.step == 2 and state.opt_state["count"] == 2
    for tree, got in ((states_j[2].params, state.params),
                      (states_j[2].ema_params, state.ema_params)):
        for n, w in to_port(tree).items():
            _close_steps(got[n], w, lr, 2, n)

    # mid-run: port from JAX's state after step 1
    model2 = _port_model(states_j[1].params)
    st1 = states_j[1]
    state2 = tts.TrainState(
        step=1, params=tts.trainable_params(model2),
        opt_state=convert.adamw_state(st1.opt_state, to_port),
        ema_params={n: _t(v) for n, v in to_port(st1.ema_params).items()})
    state2.opt_state["mu"] = {n: _t(v) for n, v in state2.opt_state["mu"].items()}
    state2.opt_state["nu"] = {n: _t(v) for n, v in state2.opt_state["nu"].items()}
    state2, m = tts.make_train_step(model2, tc_t)(state2, batch_t, _draws(rngs[1]))
    _close_rel(m["loss"], metrics_j[1]["loss"], LOSS_REL)
    for n, w in to_port(states_j[2].params).items():
        _close_steps(state2.params[n], w, lr, 1, n)


def test_lora_train_steps_match_jax(setup):
    jdit, params, batch_j, batch_t = setup
    lr = 1e-3
    tc_j, tc_t = _tcs(learning_rate=lr)
    lora_j = jlora.init_lora(jax.random.PRNGKey(5), params, rank=4)
    jstep = jax.jit(jlora.make_lora_train_step(jdit.apply, tc_j, packed=True))
    st_j = jts.init_train_state(lora_j, tc_j)
    model = _port_model(params)
    lora_t = {k: _t(v).requires_grad_() for k, v in convert.lora_state_dict(lora_j).items()}
    assert tlora.count_params(lora_t) == jlora.count_params(lora_j)
    lm = tlora.LoRAModel(model, lora_t)
    state = tts.init_train_state(lora_t, tc_t)
    step = tlora.make_lora_train_step(lm, tc_t)
    for r in (jax.random.PRNGKey(21), jax.random.PRNGKey(22)):
        st_j, m_j = jstep(st_j, params, batch_j, r)
        state, m = step(state, batch_t, _draws(r))
        _close_rel(m["loss"], m_j["loss"], LOSS_REL)
        assert m["grad_norm"] > 0
    for n, w in convert.lora_state_dict(st_j.params).items():
        _close_steps(state.params[n], w, lr, 2, n)
    # the frozen base got no gradient; the merged weights equal JAX's merge
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())
    merged = tlora.merge_lora(
        {k: _t(v) for k, v in convert.dit_state_dict(params, CFG.num_layers).items()},
        {k: v.detach() for k, v in state.params.items()})
    want = convert.dit_state_dict({"params": jlora.merge_lora(params["params"],
                                  convert.lora_tree(state.params))}, CFG.num_layers)
    for n, w in want.items():
        assert_close(merged[n], w, 1e-6)
