"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py)."""

import contextlib
import dataclasses

import numpy as np
import torch

from yume_tpu_torch import configs as port_configs

_NORM_LEAVES = ("weight", "gamma", "scale")


def perturb(tree, seed: int):
    """Replace every leaf of a JAX parameter tree (arrays, or shapes from
    ``jax.eval_shape``) with seeded noise: norm
    weights 1 + 0.1·N(0, 1), everything else 0.1·N(0, 1). Zero-initialised
    layers (the DiT head, the VAE attention projection) would otherwise make
    a parity test pass on biases alone."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        shape = tuple(node.shape)
        noise = 0.1 * rng.standard_normal(shape).astype(np.float32)
        is_norm = path[-1] in _NORM_LEAVES and any("norm" in p for p in path)
        return noise + 1.0 if is_norm else noise

    return walk(tree, ())


def to_np(x):
    """torch tensor or JAX array → float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=tol, rtol=0)


@contextlib.contextmanager
def torch_threads(n: int):
    """Run with ``n`` intra-op threads. The tier-1 suite runs six workers
    on one machine; a torch-heavy module at the default of one thread a
    core oversubscribes the cores, and OpenMP's waiting threads then made
    its CPU steps some 40× slower than alone."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def close_rel(got, want, rel, name=""):
    """Within ``rel`` of the largest |want| (plus 1e-7), elementwise."""
    want = to_np(want)
    np.testing.assert_allclose(to_np(got), want, atol=rel * np.abs(want).max() + 1e-7,
                               rtol=0, err_msg=name)


def close_steps(got, want, lr, steps, name="", p99=1e-6):
    """Parameters after ``steps`` Adam steps of rate ``lr`` from the same
    start: a gradient that differs only in its last bits near 0 maps to
    ±lr on a first step, so within 2·lr per step everywhere and ``p99``
    at the 99th percentile."""
    diff = np.abs(to_np(got) - to_np(want))
    assert diff.max() <= 2 * lr * steps + 1e-6, (name, diff.max())
    assert np.percentile(diff, 99) <= p99, (name, np.percentile(diff, 99))


def rel_l2(got, want) -> float:
    want = to_np(want)
    return float(np.linalg.norm(to_np(got) - want) / max(np.linalg.norm(want), 1e-30))


def port_config(cfg):
    """The port's copy of a JAX config dataclass (``yume_tpu.configs``),
    field for field, nested configs included; tuples stay tuples."""
    cls = getattr(port_configs, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def jax_draws(rng, x_shape, n_tok, i2v=False):
    """The draws of the JAX ``make_loss_fn`` for PRNG key ``rng`` (its
    splits), in the port's explicit form (``training.train_step.draw_step``):
    latents of ``x_shape`` [B, F, H, W, C], ``n_tok`` packed tokens for the
    MVDT noise. ``i2v``: the 14B pass (``flow_pass_i2v``), which splits its
    key three ways (t, x0, the MVDT noise) and draws no history mask."""
    import jax
    import jax.numpy as jnp

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    flow_rng, mask_rng = jax.random.split(rng)
    out = {}
    for name, key in (("flow", flow_rng), ("masked", mask_rng)):
        if i2v:
            t_rng, n_rng, mv_rng = jax.random.split(key, 3)
        else:
            t_rng, n_rng, m_rng, mv_rng = jax.random.split(key, 4)
        out[name] = {"t": t(jax.random.normal(t_rng, (x_shape[0],), dtype=jnp.float32)),
                     "x0": t(jax.random.normal(n_rng, x_shape)),
                     "mvdt": t(jax.random.uniform(mv_rng, (x_shape[0], n_tok)))}
        if not i2v:
            r_rng, nn_rng = jax.random.split(m_rng)
            out[name]["hist"] = (t(jax.random.uniform(r_rng, ())),
                                 t(jax.random.normal(nn_rng, ())))
    return out


# ---------------------------------------------------------------------------
# ranks of a sequence-parallel run on the CPU (tests/test_torch_sp.py)
#
# A spawned rank imports this module, never jax (jax_draws imports it when
# called): the functions below run the port on the rank's side of a gloo
# group.
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 120


class RankPool:
    """``world`` spawned processes joined in a gloo group through a
    ``file://`` rendezvous at ``init_file`` (one torch thread each).
    :meth:`run` calls one of this module's ``rank_*`` functions on every
    rank with the same arguments and returns the results in rank order."""

    def __init__(self, world: int, init_file: str):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.outbox = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, world, init_file, self.inboxes[r], self.outbox))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn: str, *args):
        self.start(fn, *args)
        return self.results()

    def start(self, fn: str, *args):
        """Hand every rank ``fn(*args)`` and return at once: the caller
        computes its reference meanwhile and then collects
        :meth:`results`."""
        for box in self.inboxes:
            box.put((fn, args))

    def results(self):
        results = dict(self.outbox.get(timeout=RANK_TIMEOUT_S) for _ in self.procs)
        errors = [f"rank {r}:\n{v}" for r, (status, v) in sorted(results.items())
                  if status == "error"]
        if errors:
            raise RuntimeError("\n".join(errors))
        return [results[r][1] for r in range(len(self.procs))]

    def close(self):
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self.procs)


def _rank_main(rank, world, init_file, inbox, outbox):
    import datetime
    import traceback

    import torch.distributed as dist

    from yume_tpu_torch.parallel.mesh import SPGroups, make_sp_groups, make_usp_groups

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    sp = make_sp_groups(world)
    state = {"groups": {"ulysses": sp, "ring": sp, "usp": make_usp_groups(2, world // 2)},
             "models": {}}
    # ranks 0 and 1 as a sequence-parallel group of 2 (the others sit out)
    pair = dist.new_group([0, 1])
    state["groups"]["sp2"] = SPGroups(group=pair, sp=2, rank=rank) if rank < 2 else None
    try:
        for fn, args in iter(inbox.get, None):
            try:
                outbox.put((rank, ("ok", globals()[fn](state, *args))))
            except Exception:  # reported to the test, which fails
                outbox.put((rank, ("error", traceback.format_exc())))
    finally:
        dist.destroy_process_group()


def _chunk(x: np.ndarray, state):
    """This rank's chunk of the token axis (dim 1) of a padded array."""
    g = state["groups"]["ring"]
    ls = x.shape[1] // g.sp
    return torch.from_numpy(np.ascontiguousarray(x[:, g.rank * ls:(g.rank + 1) * ls]))


def rank_layout(state):
    """(rank, i_u, i_r, Ulysses group ranks, ring group ranks) of USP."""
    import torch.distributed as dist

    g = state["groups"]["usp"]
    return (g.rank, g.i_u, g.i_r, dist.get_process_group_ranks(g.ulysses),
            dist.get_process_group_ranks(g.ring))


def rank_agree(state):
    """agree() of a flag that only rank 0 holds, and of its negation."""
    from yume_tpu_torch.parallel.ulysses import agree

    g = state["groups"]["ring"].group
    rank = state["groups"]["ring"].rank
    return agree(rank == 0, g), agree(rank != 0, g)


def rank_sp_attention(state, kind, q, k, v, l_true):
    """This rank's output chunk of SP attention over padded [B, L, N, D]
    inputs with ``kv_len = l_true``."""
    from yume_tpu_torch.parallel.ulysses import sp_attention

    groups = state["groups"][kind]
    kv_len = torch.full((q.shape[0],), l_true, dtype=torch.int32)
    out = sp_attention(groups, kind)(*(_chunk(t, state) for t in (q, k, v)), kv_len=kv_len)
    return out.numpy()


def rank_load_dit(state, key, cfg, sd):
    """Build an fp32 port DiT from a state dict and keep it under ``key``
    (with its W8A8 twin on the same parameters)."""
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.utils.convert import load_state_dict

    dit = WanDiT(cfg, torch.float32, device="meta").to_empty(device="cpu")
    load_state_dict(dit, sd)
    state["models"][key] = dit.eval()


def rank_sp_dit(state, key, kind, x, t, ctx, lfz, cache_list=(), block_cache=None,
                return_cache=False, clip=None):
    """``sp_dit_forward`` of the DiT under ``key``: the velocity (every
    rank's whole), and with ``return_cache`` this rank's residual chunks;
    ``block_cache``: the whole [n, B, L_pad, dim] cache, of which the rank
    feeds back its own chunk; ``clip``: the 14B model's CLIP context."""
    from yume_tpu_torch.parallel.sp_forward import sp_dit_forward

    if block_cache is not None:
        block_cache = [_chunk(c, state) for c in block_cache]
    with torch.no_grad():
        out = sp_dit_forward(state["models"][key], state["groups"][kind], torch.from_numpy(x),
                             torch.from_numpy(t), torch.from_numpy(ctx), latent_frame_zero=lfz,
                             clip_context=None if clip is None else torch.from_numpy(clip),
                             kind=kind, cache_list=tuple(cache_list), block_cache=block_cache,
                             return_cache=return_cache)
    if return_cache:
        return out[0].numpy(), [c.float().numpy() for c in out[1]]
    return out.numpy()


def rank_sp_segment(state, key, pipe_cfg, kind, w8a8, history, ctx, noise, kw):
    """``generate_segment`` of a DiT-only pipeline on the DiT under ``key``
    with this rank's SP groups: (latents, n_full or None)."""
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline

    pipe = TI2VPipeline(pipe_cfg, state["models"][key], None,
                        sp_groups=state["groups"][kind], sp_kind=kind)
    if w8a8:
        pipe = pipe.with_w8a8()
    out = pipe.generate_segment(torch.from_numpy(history), torch.from_numpy(ctx),
                                noise=torch.from_numpy(noise), **kw)
    return out.numpy(), pipe.last_teacache_n_full


# -- sequence-parallel training (tests/test_torch_sp_train.py) ---------------


def rank_sp_attention_grads(state, kind, q, k, v, dout, l_true):
    """This rank's (dq, dk, dv) chunks of Σ out·dout for SP attention over
    padded [B, L, N, D] inputs with ``kv_len = l_true``."""
    from yume_tpu_torch.parallel.ulysses import sp_attention

    groups = state["groups"][kind]
    kv_len = torch.full((q.shape[0],), l_true, dtype=torch.int32)
    q, k, v = (_chunk(t, state).requires_grad_() for t in (q, k, v))
    out = sp_attention(groups, kind)(q, k, v, kv_len=kv_len)
    (out * _chunk(dout, state)).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


def tree_map(fn, tree):
    """``fn`` of every leaf of nested dicts, tuples and lists (the draws of
    ``jax_draws`` cross to the ranks as numpy and back)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def torch_tree(tree):
    """``tree`` with its numpy leaves as tensors."""
    return tree_map(lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a, tree)


def _sp_model(cfg, sd, remat=False):
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.utils.convert import load_state_dict

    model = WanDiT(cfg, torch.float32, device="meta", remat=remat).to_empty(device="cpu")
    load_state_dict(model, sd)
    return model


def _sp_step_kw(state, kind, model, grads_out):
    """The sequence-parallel ``forward`` and ``reduce_grads`` of the train
    step over this rank's ``kind`` groups; the reduced gradients are also
    copied into ``grads_out``."""
    import functools

    from yume_tpu_torch.parallel.mesh import all_reduce_sum_
    from yume_tpu_torch.parallel.sp_forward import sp_dit_forward

    groups = state["groups"][kind]

    def reduce_grads(grads):
        all_reduce_sum_(grads.values(), groups.group)
        grads_out.update({n: g.numpy().copy() for n, g in grads.items()})

    return dict(forward=functools.partial(sp_dit_forward, model, groups, kind=kind),
                reduce_grads=reduce_grads)


def rank_sp_train_step(state, kind, cfg, sd, tc, batch, draws, remat=False):
    """One SP train step of a DiT built from ``sd``: (metrics, the reduced
    gradients, the parameters after the step)."""
    from yume_tpu_torch.training.train_step import (init_train_state, make_train_step,
                                                    trainable_params)

    model = _sp_model(cfg, sd, remat)
    grads = {}
    st = init_train_state(trainable_params(model), tc)
    step = make_train_step(model, tc, **_sp_step_kw(state, kind, model, grads))
    st, m = step(st, torch_tree(batch), torch_tree(draws))
    return ({k: float(v) for k, v in m.items()}, grads,
            {n: p.detach().numpy().copy() for n, p in st.params.items()})


def rank_sp_distill_step(state, kind, cfg, sd, tc, batch, draws, seed):
    """One SP distillation step (the discriminator from ``seed``):
    (metrics, the reduced generator gradients, the generator's and the
    discriminator's parameters after the step)."""
    from yume_tpu_torch.training.distill import (disc_optimizer, init_disc_state,
                                                 make_distill_train_step)
    from yume_tpu_torch.training.train_step import init_train_state, trainable_params

    model = _sp_model(cfg, sd)
    d_opt = disc_optimizer()
    disc, disc_state = init_disc_state(d_opt, z_dim=cfg.out_dim, device="cpu",
                                       generator=torch.Generator().manual_seed(seed))
    grads = {}
    st = init_train_state(trainable_params(model), tc)
    step = make_distill_train_step(model, tc, disc, d_opt,
                                   **_sp_step_kw(state, kind, model, grads))
    st, disc_state, m = step(st, disc_state, torch_tree(batch), torch_tree(draws))
    return ({k: float(v) for k, v in m.items()}, grads,
            {n: p.detach().numpy().copy() for n, p in st.params.items()},
            {n: p.detach().numpy().copy() for n, p in disc_state.params.items()})


# -- pipeline parallelism and the 14B pipeline (tests/test_torch_pp.py,
# tests/test_torch_sp.py) ---------------------------------------------------


def _port_dit(cfg, sd):
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.utils.convert import load_state_dict

    dit = WanDiT(cfg, torch.float32, device="meta").to_empty(device="cpu")
    load_state_dict(dit, sd)
    return dit.eval()


def _maybe(a):
    return None if a is None else torch.from_numpy(a)


def rank_pp_dit(state, cfg, sd, x, t, ctx, clip, packed, lfz, microbatches=None):
    """``pp_dit_forward`` over the pool (a stage a rank) of a DiT built from
    ``sd``, against the one-rank forward of the same DiT here: (velocity,
    whether they are equal, bytes held after staging, bytes before, the
    blocks' bytes before)."""
    import torch.distributed as dist

    from yume_tpu_torch.parallel.pipeline import (held_bytes, keep_stage_, make_pp_groups,
                                                  pp_dit_forward)

    dit = _port_dit(cfg, sd)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    kw = dict(packed=packed, latent_frame_zero=lfz, clip_context=_maybe(clip))
    one = dit(*args, **kw)
    total, blocks = held_bytes(dit), held_bytes(dit.blocks)
    groups = make_pp_groups(dist.get_world_size())
    held = keep_stage_(dit, groups)
    got = pp_dit_forward(dit, groups, *args, num_microbatches=microbatches, **kw)
    return got.numpy(), torch.equal(got, one), held, total, blocks


def rank_pp_ti2v(state, pipe_cfg, sd, method, args, kw):
    """``TI2VPipeline.<method>(*args, **kw)`` (``generate_segment`` or
    ``generate_t2v``) of a DiT-only pipeline, staged over the pool."""
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline

    pipe = TI2VPipeline(pipe_cfg, _port_dit(pipe_cfg.dit, sd), None)
    pipe.parallelize_pp(torch.distributed.get_world_size())
    args = [torch.from_numpy(a) for a in args]
    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return getattr(pipe, method)(*args, **kw).numpy()


def rank_i2v_generate(state, kind, pipe_cfg, sds, img, ctx, ctx_null, noise, kw,
                      kind_name=None):
    """``I2VPipeline.generate`` as one rank of a ``kind`` run ("pp", or
    sequence parallel over ``state["groups"][kind]`` with attention
    ``kind_name``): rank 0 holds the VAE, umT5 and CLIP, the other ranks
    the DiT alone and the image as a meta tensor. (latents, n_full, video
    or None); None on a rank outside the group."""
    from yume_tpu_torch.pipelines.i2v import I2VPipeline

    groups = None if kind == "pp" else state["groups"][kind]
    rank = torch.distributed.get_rank()
    if kind != "pp" and groups is None:
        return None
    encoders = rank == 0
    pipe = I2VPipeline.from_state_dicts(
        pipe_cfg, sds["dit"], sds["vae"] if encoders else None,
        sds["t5"] if encoders else None, sds["clip"] if encoders else None, device="cpu",
        dtype=torch.float32)
    if kind == "pp":
        pipe.parallelize_pp(torch.distributed.get_world_size())
    else:
        pipe.sp_groups, pipe.sp_kind = groups, kind_name
    pipe.cfg_parallel = kw.pop("cfg_parallel", False)
    image = torch.from_numpy(img) if encoders else torch.empty(img.shape, device="meta")
    lat, video = pipe.generate(image, torch.from_numpy(ctx), _maybe(ctx_null),
                               noise=torch.from_numpy(noise), **kw)
    return (lat.numpy(), pipe.last_teacache_n_full,
            video.numpy() if encoders else tuple(video.shape))


def rank_webapp_decode_failure(rank, args):
    """One rank of a parallel webapp (``parallel.mesh.launch``) whose rank
    0 fails its first decode: each request's (status, progress) on this
    rank, for that request and the one after it."""
    from yume_tpu_torch.serving.webapp import WebApp

    torch.set_num_threads(1)
    app = WebApp(args, rank)
    app.load_models()
    if rank.rank == 0:
        decode, calls = app.pipe.decode_auto, []

        def fail_once(z):
            calls.append(z)
            if len(calls) == 1:
                raise RuntimeError("decode failed on rank 0")
            return decode(z)
        app.pipe.decode_auto = fail_once
    out = []
    for req in ({"mode": "t2v", "steps": 2, "segments": 2, "seed": 5},
                {"mode": "t2v", "steps": 2, "seed": 6}):
        if app.leader:
            app.lock.acquire()   # the HTTP handler's, which generate releases
        app.generate(req)
        out.append((app.status, app.progress))
    app.close()
    return out
