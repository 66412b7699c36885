"""Sequence-parallel training of the port against the JAX package on the
CPU: four spawned processes in a gloo group (``torch_parity.RankPool``, one
for the module) run the port's SP train step, and JAX runs
``make_train_step`` over ``sp_dit_apply`` (``shard_map`` on 4 of the 8
virtual CPU devices) on the same weights (carried by ``utils/convert.py``)
and the same draws (``torch_parity.jax_draws``).

* Ulysses, ring and USP (2 × 2) attention: dq, dk and dv of a padded
  sequence whose pad key is masked, against the gradients of the
  whole-sequence ``plain_attention``; the masked key gets zero dK and dV.
* The SP train step for each kind against JAX's: the loss, the grad norm,
  every parameter's reduced gradient (JAX's, tapped where the parameters
  enter ``sp_dit_apply``: after its ``shard_map`` has summed them over
  ``sp``) and the parameters after the step. Every rank ends the step with
  the same gradients and parameters, bit for bit.
* ``--remat`` against no remat, for each kind: the same bits.
* The 14B i2v step (``flow_pass_i2v`` with ``clip_context``) with Ulysses
  against JAX's.
* The SP distillation step (ring) against the port's dense one: the
  discriminator's inputs are the gathered tails, the same on every rank,
  so its update is not reduced.

The tiny DiT of tests/test_train_sp.py (dim 64, 8 heads, 2 layers), every
parameter perturbed (the head included), at 86 packed tokens, padded to 88
over 4 ranks. Tolerances as tests/test_torch_training.py's: loss 1e-5
relative, gradients 1e-4 of each parameter's largest, whole steps by
``close_steps``; attention 1e-5 as tests/test_torch_sp.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import (assert_close, close_rel, close_steps, jax_draws, perturb,
                          port_config, torch_threads, tree_map)
from yume_tpu.configs import DiTConfig
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.parallel.mesh import make_mesh, make_usp_mesh
from yume_tpu.parallel.sp_forward import sp_dit_apply
from yume_tpu.training import train_step as jts
from yume_tpu_torch.models import dit as tdit
from yume_tpu_torch.ops.flash_attention import plain_attention
from yume_tpu_torch.training import distill as tdistill
from yume_tpu_torch.training import train_step as tts
from yume_tpu_torch.utils import convert

WORLD = 4
KINDS = ["ulysses", "ring", "usp"]
LFZ, B, F, H, W = 2, 1, 4, 8, 10
CFG = DiTConfig(model_type="ti2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128, freq_dim=32,
                text_dim=16, num_heads=8, num_layers=2, framepack=True)
I2V = DiTConfig(model_type="i2v", in_dim=18, out_dim=8, dim=64, ffn_dim=128, freq_dim=32,
                text_dim=16, num_heads=8, num_layers=2, framepack=True,
                image_context_len=5, image_dim=12)
N_TOK = tdit.packed_token_count(F - LFZ, LFZ, H, W, CFG.patch_size)
LR = 1e-3
ATTN_TOL, LOSS_REL, GRAD_REL = 1e-5, 1e-5, 1e-4
# XLA:CPU codegen without its expensive LLVM passes: the same arithmetic,
# compiled in about two thirds of the time
FAST_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = torch_parity.RankPool(WORLD, str(tmp_path_factory.mktemp("sp") / "rendezvous"))
    yield pool
    pool.close()


def _mesh(kind):
    devices = jax.devices()[:WORLD]
    if kind == "usp":
        return make_usp_mesh(data=1, fsdp=1, sp_u=2, sp_r=WORLD // 2, devices=devices)
    return make_mesh(data=1, fsdp=1, sp=WORLD, devices=devices)


def _setup(cfg, seed):
    """(JAX DiT, its perturbed parameters, a numpy batch, the port's state
    dict) of ``cfg``; an i2v batch carries ``y`` and ``clip_context``."""
    jdit = JaxDiT(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    batch = {"latents": rng.standard_normal((B, F, H, W, cfg.out_dim)),
             "context": 0.3 * rng.standard_normal((B, 8, cfg.text_dim))}
    kw = {}
    if cfg.model_type == "i2v":
        batch["y"] = rng.standard_normal((B, F, H, W, cfg.in_dim - cfg.out_dim))
        batch["clip_context"] = rng.standard_normal((B, cfg.image_context_len, cfg.image_dim))
        kw["clip_context"] = jnp.asarray(batch["clip_context"], jnp.float32)
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    shapes = jax.eval_shape(
        lambda k: jdit.init(k, jnp.zeros((B, F, H, W, cfg.in_dim)), jnp.zeros((B, F)),
                            jnp.asarray(batch["context"]), packed=True,
                            latent_frame_zero=LFZ, **kw),
        jax.random.PRNGKey(0))
    params = {"params": perturb(shapes["params"], seed=seed)}
    return jdit, params, batch, convert.dit_state_dict(params, cfg.num_layers)


@pytest.fixture(scope="module")
def dense():
    return _setup(CFG, 3)


def _draws(rng, cfg):
    draws = jax_draws(rng, (B, F, H, W, cfg.out_dim), N_TOK, i2v=cfg.model_type == "i2v")
    return tree_map(lambda t: t.numpy(), draws)


def _tcs():
    kw = dict(learning_rate=LR, latent_frame_zero=LFZ)
    return jts.TrainConfig(**kw), tts.TrainConfig(**kw)


def _port_model(cfg, sd):
    model = tdit.WanDiT(port_config(cfg), torch.float32, device="meta").to_empty(device="cpu")
    convert.load_state_dict(model, sd)
    return model


def _jax_sp_step(jdit, params, kind, tc, batch, rng):
    """JAX's ``make_train_step`` over ``sp_dit_apply``: (state, metrics,
    the gradients it stepped with). The gradients are tapped by an identity
    with a custom VJP on the parameters ``sp_dit_apply`` takes, the loss's
    one use of them: outside its ``shard_map``, whose transpose has summed
    the replicated parameters' gradients over ``sp``."""
    mesh = _mesh(kind)
    tapped = {}

    @jax.custom_vjp
    def tap(p):
        return p

    def tap_bwd(_, g):
        jax.debug.callback(lambda g: tapped.update(grads=g), g)
        return (g,)

    tap.defvjp(lambda p: (p, None), tap_bwd)

    def apply(p, x, t, c, *, packed=True, latent_frame_zero=LFZ, clip_context=None, **kw):
        assert packed and not kw
        return sp_dit_apply(jdit, tap(p), mesh, x, t, c, latent_frame_zero=latent_frame_zero,
                            clip_context=clip_context, kind=kind)

    state = jts.init_train_state(params, tc)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jts.make_train_step(apply, tc, packed=True)).lower(state, bj, rng)
    state, metrics = jax.block_until_ready(step.compile(FAST_XLA)(state, bj, rng))
    jax.effects_barrier()
    # the tap saw the gradients the step clipped and applied
    norm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                       for g in jax.tree_util.tree_leaves(tapped["grads"])))
    close_rel(np.float32(norm), metrics["grad_norm"], LOSS_REL)
    return state, metrics, tapped["grads"]


def _same_on_every_rank(trees):
    for tree in trees[1:]:
        for n, a in tree.items():
            np.testing.assert_array_equal(a, trees[0][n], err_msg=n)


def _check_step(got, cfg, jax_state, jax_metrics, jax_grads):
    """Every rank's SP step against JAX's: loss, grad norm, every reduced
    gradient and the parameters after it; the same bits on every rank."""
    metrics, grads, params = got[0]
    _same_on_every_rank([g[1] for g in got])
    _same_on_every_rank([g[2] for g in got])
    assert all(g[0] == metrics for g in got)
    close_rel(np.float32(metrics["loss"]), jax_metrics["loss"], LOSS_REL)
    close_rel(np.float32(metrics["grad_norm"]), jax_metrics["grad_norm"], LOSS_REL)
    jax_grads = convert.dit_state_dict(jax_grads, cfg.num_layers)
    assert set(grads) == set(jax_grads)
    for n, g in jax_grads.items():
        close_rel(grads[n], g, GRAD_REL, n)
    for n, w in convert.dit_state_dict(jax_state.params, cfg.num_layers).items():
        close_steps(params[n], w, LR, 1, n)


@pytest.mark.parametrize("kind", KINDS)
def test_sp_attention_gradients(ranks, kind):
    """23 live tokens padded to 24 with a pad key that is not zero: kv_len
    alone must mask it, forward and backward."""
    b, l_true, l_pad, n, d = 1, 23, 24, 8, 16
    rng = np.random.default_rng(41)
    q, k, v, dout = (rng.standard_normal((b, l_pad, n, d)).astype(np.float32)
                     for _ in range(4))
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = plain_attention(qt, kt, vt, kv_len=torch.full((b,), l_true, dtype=torch.int32))
    (out * torch.from_numpy(dout)).sum().backward()
    got = ranks.run("rank_sp_attention_grads", kind, q, k, v, dout, l_true)
    for i, want in enumerate((qt.grad, kt.grad, vt.grad)):
        grad = np.concatenate([r[i] for r in got], axis=1)
        assert np.isfinite(grad).all()
        assert_close(grad, want, ATTN_TOL)
        if i:
            assert not grad[:, l_true:].any()    # the masked key: zero dK and dV


@pytest.mark.parametrize("kind", KINDS)
def test_sp_train_step_matches_jax(ranks, dense, kind):
    jdit, params, batch, sd = dense
    tc_j, tc_t = _tcs()
    rng = jax.random.PRNGKey(42)
    draws = _draws(rng, CFG)
    ranks.start("rank_sp_train_step", kind, port_config(CFG), sd, tc_t, batch, draws)
    want = _jax_sp_step(jdit, params, kind, tc_j, batch, rng)
    _check_step(ranks.results(), CFG, *want)


@pytest.mark.parametrize("kind", KINDS)
def test_sp_remat_gives_the_same_step(ranks, dense, kind):
    """Per-block remat reruns each block's collectives in the backward, in
    the same order on every rank: the same gradients and parameters."""
    _, _, batch, sd = dense
    _, tc = _tcs()
    draws = _draws(jax.random.PRNGKey(7), CFG)
    plain, remat = (ranks.run("rank_sp_train_step", kind, port_config(CFG), sd, tc, batch,
                              draws, r) for r in (False, True))
    for a, b in zip(plain, remat):
        assert a[0] == b[0]
        for i in (1, 2):
            for n, t in a[i].items():
                np.testing.assert_array_equal(b[i][n], t, err_msg=n)


def test_sp_i2v_train_step_matches_jax(ranks):
    """The 14B branch: x_t and ``y`` concatenated, the CLIP tokens in the
    context of every rank's cross-attention."""
    jdit, params, batch, sd = _setup(I2V, 13)
    tc_j, tc_t = _tcs()
    rng = jax.random.PRNGKey(5)
    draws = _draws(rng, I2V)
    ranks.start("rank_sp_train_step", "ulysses", port_config(I2V), sd, tc_t, batch, draws)
    want = _jax_sp_step(jdit, params, "ulysses", tc_j, batch, rng)
    _check_step(ranks.results(), I2V, *want)


def test_sp_distill_step_matches_dense(ranks, dense):
    _, _, batch, sd = dense
    _, tc = _tcs()
    draws = _draws(jax.random.PRNGKey(9), CFG)
    ranks.start("rank_sp_distill_step", "ring", port_config(CFG), sd, tc, batch, draws, 4)
    model = _port_model(CFG, sd)
    d_opt = tdistill.disc_optimizer()
    disc, disc_state = tdistill.init_disc_state(d_opt, z_dim=CFG.out_dim, device="cpu",
                                                generator=torch.Generator().manual_seed(4))
    captured = {}

    def keep(grads):
        captured.update({n: g.clone() for n, g in grads.items()})

    state = tts.init_train_state(tts.trainable_params(model), tc)
    step = tdistill.make_distill_train_step(model, tc, disc, d_opt, reduce_grads=keep)
    state, disc_state, want = step(state, disc_state, torch_parity.torch_tree(batch),
                                   torch_parity.torch_tree(draws))
    got = ranks.results()
    metrics, grads, params, disc_params = got[0]
    for i in (1, 2, 3):
        _same_on_every_rank([g[i] for g in got])
    for key in ("flow_loss", "gan_loss", "d_loss", "grad_norm"):
        close_rel(np.float32(metrics[key]), want[key], LOSS_REL, key)
    for n, g in captured.items():
        close_rel(grads[n], g, GRAD_REL, n)
    for n, p in state.params.items():
        close_steps(params[n], p, LR, 1, n)
    for n, p in disc_state.params.items():
        close_steps(disc_params[n], p, 1e-5, 1, n)
