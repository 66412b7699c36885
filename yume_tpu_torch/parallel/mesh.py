"""Process groups of sequence-parallel serving (counterpart of
yume_tpu/parallel/mesh.py).

The JAX package names its devices with a ``Mesh`` whose ``sp`` axis (or,
for USP, ``sp_u`` × ``sp_r`` axes) shards the token axis. Here each device
runs its own process, and a ``torch.distributed`` process group takes the
place of each mesh axis: :class:`SPGroups` holds them with this rank's
place in them. The default group must be initialised first
(``torch.distributed.init_process_group``, with its address, world size
and rank given by the caller); NCCL across cards, or gloo.

Token chunk ``j`` of the sharded sequence lives on rank ``j`` of the sp
group. For USP the rank order is the one of ``make_usp_mesh``'s reshape,
Ulysses-major: ``rank = i_u·sp_r + i_r``, so the chunk order is the
``P(None, ("sp_u", "sp_r"))`` order of the JAX package.

The ``data`` and ``fsdp`` axes and the parameter-sharding rules wait for
FSDP: every rank of the default group is one sequence-parallel rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class SPGroups:
    """The groups one rank of a sequence-parallel run talks over.

    ``group`` holds every rank of the run (size ``sp``; this rank is
    ``rank`` in it): the token axis is cut into ``sp`` chunks over it, the
    DiT head's output is gathered over it, and Ulysses or ring attention
    (kinds ``"ulysses"``, ``"ring"``) run over it. For USP (kind ``"usp"``)
    ``ulysses`` (size ``sp_u``, index ``i_u``) holds the ranks that share
    ``i_r`` and ``ring`` (size ``sp_r``, index ``i_r``) those that share
    ``i_u``."""

    group: dist.ProcessGroup
    sp: int
    rank: int
    ulysses: Optional[dist.ProcessGroup] = None
    ring: Optional[dist.ProcessGroup] = None
    sp_u: int = 1
    sp_r: int = 1
    i_u: int = 0
    i_r: int = 0


def _world(n: int, what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: initialise the default process group first")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"{what}: {n} sequence-parallel ranks in a world of {world} "
                         "(data and fsdp axes are not ported)")
    return dist.get_rank()


def make_sp_groups(sp: int) -> SPGroups:
    """One sequence-parallel group over the whole default group (the
    ``make_mesh(data=1, fsdp=1, sp=sp)`` of the JAX package)."""
    rank = _world(sp, "make_sp_groups")
    return SPGroups(group=dist.group.WORLD, sp=sp, rank=rank)


def make_usp_groups(sp_u: int, sp_r: int) -> SPGroups:
    """The 2D groups of USP attention (``make_usp_mesh(data=1, fsdp=1,
    sp_u, sp_r)``): Ulysses over ``sp_u`` ranks, ring over ``sp_r``.
    Every rank builds every group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    rank = _world(sp_u * sp_r, "make_usp_groups")
    i_u, i_r = divmod(rank, sp_r)
    ulysses = ring = None
    for j_r in range(sp_r):
        g = dist.new_group([j_u * sp_r + j_r for j_u in range(sp_u)])
        if j_r == i_r:
            ulysses = g
    for j_u in range(sp_u):
        g = dist.new_group([j_u * sp_r + j_r for j_r in range(sp_r)])
        if j_u == i_u:
            ring = g
    return SPGroups(group=dist.group.WORLD, sp=sp_u * sp_r, rank=rank, ulysses=ulysses,
                    ring=ring, sp_u=sp_u, sp_r=sp_r, i_u=i_u, i_r=i_r)
