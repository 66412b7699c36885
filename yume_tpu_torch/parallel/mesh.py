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

:func:`launch` starts the ranks of a multi-device run from one command
(the JAX package drives its devices from one process): it spawns one
process a rank, joins them in the default group over a ``file://``
rendezvous, and gives each its device, ``cuda:(rank % cards)``. The
backend is NCCL when every rank has a card of its own, else gloo, which
the collectives here stage through host memory. :func:`from_rank0` hands
every rank what only rank 0 computes (the encoders and the VAE live
there).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import tempfile
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises
COLLECTIVE_TIMEOUT_S = 1800


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


# -- launching the ranks of one run ------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rank:
    """One process of a :func:`launch`: its rank in the default group of
    ``world`` ranks, its device and the group's backend."""

    rank: int
    world: int
    device: torch.device
    backend: str


def backend_for(device_type: str, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo (NCCL refuses
    two ranks on one device; gloo serves ranks that share a card, or the
    CPU)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_entry(rank, world, init_file, device, fn, args, results):
    """A spawned rank: join the default group, run ``fn``, report its result
    or its traceback to the parent and leave the group."""
    try:
        dev = torch.device(device)
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % cards)
            torch.cuda.set_device(dev)
        backend = backend_for(dev.type, world)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            if rank == 0:
                print(f"launch: {world} ranks over {backend}, {cards} card(s)", flush=True)
            out = fn(Rank(rank, world, dev, backend), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:  # the parent reports it and stops every rank
        results.put((rank, "error", traceback.format_exc()))
        sys.exit(1)


def launch(world: int, fn: Callable, *args, device: str = "cuda") -> list:
    """``fn(Rank, *args)`` on ``world`` spawned processes joined in one
    default group; their results in rank order. ``fn`` and ``args`` must
    pickle (a module-level function). Rank 0 prints the backend, the world
    size and the card count. A rank that raises or dies stops every rank
    and raises here with its traceback, so a failed run ends, never hangs;
    each collective gives up after ``COLLECTIVE_TIMEOUT_S``."""
    import multiprocessing
    import queue
    import signal
    import threading

    main_thread = threading.current_thread() is threading.main_thread()
    if main_thread:
        # a terminated parent still stops its ranks (the finally below)
        on_term = signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="yume_launch_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(r, world, init_file, str(device), fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            while len(out) < world:
                try:
                    rank, status, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode}") from None
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join()
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            if main_thread:
                signal.signal(signal.SIGTERM, on_term)
    return [out[r] for r in range(world)]


# -- what rank 0 computes, on every rank --------------------------------------


def staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses the group through host memory. Gloo runs its
    collectives on host buffers and its point-to-point send and recv take
    CPU tensors only, so under gloo a CUDA tensor is copied to the host
    and back explicitly, in one place, instead of relying on what each gloo
    collective does with device memory. NCCL sends device tensors
    directly."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` overwritten with global rank ``src``'s, in place; returns it.
    A strided ``t`` (a permuted view) crosses as a contiguous copy: the
    collective sends a tensor's storage in memory order."""
    buf = t.contiguous()
    if staged(buf, group):
        buf = buf.cpu()
    dist.broadcast(buf, src=src, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


# the bytes of one flat bucket of :func:`all_reduce_sum_`
BUCKET_BYTES = 256 << 20


def all_reduce_sum_(tensors, group):
    """Every tensor of ``tensors`` replaced, in place, by its sum over the
    ranks of ``group``: the gradient reduction of sequence-parallel
    training. The tensors go in flat buckets of one dtype of up to
    :data:`BUCKET_BYTES` (a tensor larger than that is a bucket of its own),
    one all-reduce a bucket in the same order on every rank, rather than a
    collective a tensor; under gloo each bucket crosses through host
    memory (:func:`staged`). Every rank ends with the same bits."""
    buckets, filling = [], {}  # dtype -> (its open bucket, the bucket's bytes)
    for t in tensors:
        n = t.numel() * t.element_size()
        bucket, size = filling.get(t.dtype, (None, 0))
        if bucket is None or (size and size + n > BUCKET_BYTES):
            bucket, size = [], 0
            buckets.append(bucket)
        bucket.append(t)
        filling[t.dtype] = (bucket, size + n)
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        buf = flat.cpu() if staged(flat, group) else flat
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if buf is not flat:
            flat.copy_(buf)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _spec(out):
    if out is None:
        return None
    if torch.is_tensor(out):
        return (tuple(out.shape), out.dtype)
    return type(out), [_spec(o) for o in out]


def _empty(spec, device):
    if spec is None:
        return None
    if isinstance(spec[0], type):
        return spec[0](_empty(s, device) for s in spec[1])
    return torch.empty(spec[0], dtype=spec[1], device=device)


def _leaves(out):
    if out is None:
        return []
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in _leaves(o)]


def _rank0_says(fn: Callable[[], Any], group, describe: Callable[[Any], Any]):
    """(``fn()`` on rank 0 of ``group``, None on the others; ``describe``
    of it on the others, None on rank 0). Rank 0 tells the others whether
    ``fn`` raised; its exception is raised on every rank (a RuntimeError
    that names it on the others), so all leave the step together."""
    src = dist.get_global_rank(group, 0)
    if dist.get_rank(group) == 0:
        try:
            out = fn()
        except Exception as e:
            dist.broadcast_object_list([("error", f"{type(e).__name__}: {e}")], src=src,
                                       group=group)
            raise
        dist.broadcast_object_list([("ok", describe(out))], src=src, group=group)
        return out, None
    box = [None]
    dist.broadcast_object_list(box, src=src, group=group)
    status, said = box[0]
    if status == "error":
        raise RuntimeError(f"rank 0 failed: {said}")
    return None, said


def from_rank0(fn: Callable[[], Any], group, device) -> Any:
    """``fn()`` computed on rank 0 of ``group`` only, its result on every
    rank: a tensor, None, or a tuple or list of them, on ``device`` on the
    other ranks. An exception of ``fn`` on rank 0 is raised on every rank
    (a RuntimeError that names it on the others), so no rank waits for a
    result that will not come. Without a group, ``fn()``."""
    if group is None:
        return fn()
    out, spec = _rank0_says(fn, group, _spec)
    if dist.get_rank(group) != 0:
        out = _empty(spec, device)
    src = dist.get_global_rank(group, 0)
    for t in _leaves(out):
        broadcast_(t, src, group)
    return out


def on_rank0_only(fn: Callable[[], Any], group, elsewhere: Callable[[], Any] = lambda: None):
    """``fn()`` on rank 0 of ``group`` (a step only rank 0 can take: a
    decode, the encoders' offload), ``elsewhere()`` on the other ranks; an
    exception of ``fn`` is raised on every rank, as :func:`from_rank0`'s,
    so no rank goes on to the next collective alone. Without a group,
    ``fn()``."""
    if group is None:
        return fn()
    out, _ = _rank0_says(fn, group, lambda _: None)
    return out if dist.get_rank(group) == 0 else elsewhere()
