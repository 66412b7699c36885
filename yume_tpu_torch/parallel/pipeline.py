"""Pipeline parallelism of the DiT trunk (counterpart of
yume_tpu/parallel/pipeline.py).

The N blocks split into S contiguous stages of N/S blocks, stage ``p`` on
rank ``p`` of a :class:`PPGroups` group, which keeps only its stage's block
weights (:func:`keep_stage_`): the embeddings, the time, text and image
embeds and the head stay on every rank, as the JAX package's ``other``.

A forward (:func:`pp_dit_forward`) embeds on every rank. The batch splits
into M microbatches (M = B by default) that flow through the GPipe
schedule: stage ``p`` runs microbatch ``m`` on the activations stage
``p − 1`` sent it, point to point, and sends its own on; the ticks the
JAX tick loop spends idle are the waits of ``recv``. The last stage runs
the head and broadcasts the result, as the JAX masked ``psum`` replicates
it, so every rank returns the same velocity. At batch 1 the stages run in
turn: the gain is memory (1/S of the trunk a rank), not time.

The activations travel in their own dtype, so the forward is the one-rank
forward bit for bit: the same blocks on the same inputs, in the same
order. Serving only: the transfers carry no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..models.dit import Modulation, WanDiT
from .mesh import broadcast_, staged


@dataclasses.dataclass(frozen=True)
class PPGroups:
    """The group of a pipeline-parallel run: ``stages`` ranks, stage ``p``
    on rank ``p`` of ``group``; this rank is stage ``stage``."""

    group: dist.ProcessGroup
    stages: int
    stage: int

    def holds(self, dit: WanDiT) -> bool:
        """Whether ``dit`` is a trunk staged over these groups
        (:func:`keep_stage_`): the next stage's first block is on the meta
        device."""
        n = len(dit.blocks) // self.stages
        first = dit.blocks[(self.stage + 1) % self.stages * n]
        return next(first.parameters()).is_meta


def make_pp_groups(stages: int) -> PPGroups:
    """One pipeline over the whole default group (``make_pp_mesh(pp)``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_pp_groups: initialise the default process group first")
    world = dist.get_world_size()
    if stages != world:
        raise ValueError(f"make_pp_groups: {stages} stages in a world of {world}")
    return PPGroups(group=dist.group.WORLD, stages=stages, stage=dist.get_rank())


def stage_blocks(num_layers: int, stages: int, stage: int) -> range:
    """The blocks of stage ``stage``: the ``stage``-th of ``stages``
    contiguous runs of ``num_layers / stages`` blocks. ``stages`` must
    divide the layer count (the 5B's 30 layers take 2, 3, 5 or 6 stages,
    the 14B's 40 take 2, 4, 5 or 8)."""
    if stages < 1 or num_layers % stages:
        raise ValueError(f"--pp {stages} does not divide the DiT's {num_layers} layers")
    n = num_layers // stages
    return range(stage * n, (stage + 1) * n)


def stage_keep(num_layers: int, stages: int, stage: int):
    """A predicate on the DiT's parameter names: True for what the rank of
    ``stage`` keeps (its blocks, and everything that is not a block)."""
    mine = stage_blocks(num_layers, stages, stage)

    def keep(name: str) -> bool:
        parts = name.split(".")
        return parts[0] != "blocks" or int(parts[1]) in mine
    return keep


def held_bytes(module: torch.nn.Module) -> int:
    """Bytes of ``module``'s parameters and buffers that hold storage (a
    block of another stage lives on the meta device)."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()) if not t.is_meta)


def keep_stage_(dit: WanDiT, groups: PPGroups) -> int:
    """Free the blocks of the other stages (moved to the meta device, so the
    names stay); returns the DiT's bytes that this rank still holds."""
    mine = stage_blocks(len(dit.blocks), groups.stages, groups.stage)
    for i, block in enumerate(dit.blocks):
        if i not in mine:
            block.to("meta")
    return held_bytes(dit)


def _microbatch(mod: Modulation, sl: slice) -> Modulation:
    return Modulation(mod.e[sl], mod.e0[sl], None if mod.idx is None else mod.idx[sl])


def _order(like: torch.Tensor) -> list:
    """The dimensions of ``like`` from its largest stride to its smallest:
    the activations keep the embedding's memory layout through the trunk
    (the unpacked one is transposed), and a stage must receive them in it,
    or the next products round otherwise."""
    return sorted(range(like.dim()), key=lambda d: -like.stride(d))


def _send(t: torch.Tensor, like: torch.Tensor, dst: int, group):
    """Start sending ``t`` (laid out as ``like``) to global rank ``dst``;
    (work, buffer kept alive)."""
    buf = t.permute(_order(like)).contiguous()
    if staged(buf, group):
        buf = buf.cpu()
    return dist.isend(buf, dst, group=group), buf


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """What :func:`_send` sent, with ``like``'s shape, dtype, device and
    layout."""
    order = _order(like)
    buf = torch.empty([like.shape[d] for d in order], dtype=like.dtype,
                      device="cpu" if staged(like, group) else like.device)
    dist.recv(buf, src, group=group)
    inverse = sorted(range(like.dim()), key=order.__getitem__)
    return buf.to(like.device).permute(inverse)


@torch.no_grad()
def pp_dit_forward(
    dit: WanDiT,
    groups: PPGroups,
    x: torch.Tensor,
    t_frame: torch.Tensor,
    context: torch.Tensor,
    *,
    packed: bool = True,
    latent_frame_zero: int = 8,
    clip_context: Optional[torch.Tensor] = None,
    num_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """This rank's part of ``dit(x, t_frame, context, packed=...,
    latent_frame_zero=..., clip_context=...)`` with the trunk staged over
    ``groups`` (``pp_dit_apply``). Every rank of the group calls it with the
    same inputs and gets the whole velocity. ``num_microbatches`` splits
    the batch (default: one sample a microbatch)."""
    s, p = groups.stages, groups.stage
    emb = (dit.embed_packed(x, t_frame, context, latent_frame_zero, clip_context)
           if packed else dit.embed_unpacked(x, t_frame, context, clip_context))
    tokens, ctx, cos, sin = emb["tokens"], emb["ctx"], emb["cos"], emb["sin"]
    mod = dit._time_mod(emb["t_values"], emb["idx"])
    b = tokens.shape[0]
    m_count = num_microbatches or b
    if b % m_count:
        raise ValueError(f"{m_count} microbatches do not split a batch of {b}")
    mb = b // m_count
    blocks = [dit.blocks[i] for i in stage_blocks(len(dit.blocks), s, p)]
    group = groups.group

    def rank_of(stage):
        return dist.get_global_rank(group, stage)

    sends, outs = [], []
    for m in range(m_count):
        sl = slice(m * mb, (m + 1) * mb)
        h = tokens[sl] if p == 0 else _recv(tokens[sl], rank_of(p - 1), group)
        mod_m = _microbatch(mod, sl)
        for block in blocks:
            h = block(h, mod_m, ctx[sl], cos, sin)
        if p < s - 1:
            sends.append(_send(h, tokens[sl], rank_of(p + 1), group))
        else:
            outs.append(h)
    for work, _ in sends:
        work.wait()
    if p == s - 1:
        # one microbatch keeps its layout for the head, as in one rank's trunk
        out = dit.head(torch.cat(outs) if len(outs) > 1 else outs[0], mod)
    else:
        c = dit.cfg
        width = c.patch_size[0] * c.patch_size[1] * c.patch_size[2] * c.out_dim
        out = torch.empty((b, tokens.shape[1], width), dtype=torch.float32,
                          device=tokens.device)
    broadcast_(out, rank_of(s - 1), group)
    return dit._unpatchify(out[:, emb["l_hist"]:], emb["tail_grid"])
