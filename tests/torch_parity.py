"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py)."""

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


def port_config(cfg):
    """The port's copy of a JAX config dataclass (``yume_tpu.configs``),
    field for field, nested configs included; tuples stay tuples."""
    cls = getattr(port_configs, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


# ---------------------------------------------------------------------------
# ranks of a sequence-parallel run on the CPU (tests/test_torch_sp.py)
#
# A spawned rank imports this module, never jax: the functions below run
# the port on the rank's side of a gloo group.
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
        for box in self.inboxes:
            box.put((fn, args))
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

    from yume_tpu_torch.parallel.mesh import make_sp_groups, make_usp_groups

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    sp = make_sp_groups(world)
    state = {"groups": {"ulysses": sp, "ring": sp, "usp": make_usp_groups(2, world // 2)},
             "models": {}}
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
                return_cache=False):
    """``sp_dit_forward`` of the DiT under ``key``: the velocity (every
    rank's whole), and with ``return_cache`` this rank's residual chunks;
    ``block_cache``: the whole [n, B, L_pad, dim] cache, of which the rank
    feeds back its own chunk."""
    from yume_tpu_torch.parallel.sp_forward import sp_dit_forward

    if block_cache is not None:
        block_cache = [_chunk(c, state) for c in block_cache]
    out = sp_dit_forward(state["models"][key], state["groups"][kind], torch.from_numpy(x),
                         torch.from_numpy(t), torch.from_numpy(ctx), latent_frame_zero=lfz,
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
