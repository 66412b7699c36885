"""Sequence-parallel attention: Ulysses all-to-all, ring attention and
their USP hybrid (counterpart of yume_tpu/parallel/ulysses.py).

Each function runs on one rank of a ``torch.distributed`` group and takes
this rank's chunk of the token axis, [B, L/sp, N, D]; every rank of the
group calls it with the same shapes. Where the JAX package calls
``all_to_all`` and ``ppermute`` inside ``shard_map``, these call
:func:`_all_to_all` and :func:`_ring_shift`. Ring attention's blocks run on
the partial flash attention K7 (:func:`flash_attention_partial`) on the
card, its plain version on the CPU. Serving only: the collectives carry no
gradient.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from ..ops.attention import attention
from ..ops.flash_attention import flash_attention_partial
from .mesh import SPGroups

# the lse a ring starts from (the reference's): below every real lse, far
# above the kernel's MASKED_LSE, so a block with no live key weighs nothing
_INITIAL_LSE = -1e30


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses the group through host memory. Gloo runs its
    collectives on host buffers and its point-to-point send and recv take
    CPU tensors only, so under gloo a CUDA tensor is copied to the host
    and back explicitly, in one place, instead of relying on what each gloo
    collective does with device memory. NCCL sends device tensors
    directly."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _all_to_all(x: torch.Tensor, group, scatter_dim: int, gather_dim: int) -> torch.Tensor:
    """Tiled all-to-all (``jax.lax.all_to_all(..., tiled=True)``): cut
    ``x`` into ``sp`` chunks along ``scatter_dim``, send chunk j to rank j
    of ``group``, and concatenate the chunks received along ``gather_dim``
    in rank order."""
    sp = dist.get_world_size(group)
    if x.shape[scatter_dim] % sp:
        raise ValueError(f"all_to_all: dim {scatter_dim} of {tuple(x.shape)} "
                         f"does not split over {sp} ranks")
    send = torch.stack(x.chunk(sp, dim=scatter_dim))  # [sp, ...] contiguous
    staged = _staged(x, group)
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    return torch.cat(recv.unbind(0), dim=gather_dim)


def _ring_shift(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's (``ppermute`` with ``perm = [(i, i + 1 mod sp)]``)."""
    sp = dist.get_world_size(group)
    i = dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + 1) % sp)
    src = dist.get_global_rank(group, (i - 1) % sp)
    sends = [t.cpu() if _staged(t, group) else t.contiguous() for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = ([dist.P2POp(dist.isend, s, dst, group) for s in sends]
           + [dist.P2POp(dist.irecv, r, src, group) for r in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    send = x.contiguous()
    staged = _staged(x, group)
    if staged:
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def agree(flag: bool, group) -> bool:
    """Rank 0's ``flag``, on every rank of ``group``: a decision that
    chooses which collectives run next (TeaCache's full or cached step)
    must be the same on all ranks, or they wait on each other forever."""
    device = "cuda" if dist.get_backend(group) == dist.Backend.NCCL else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return bool(t.item())


def ulysses_attention(q, k, v, group, *, kv_len=None):
    """All-to-all attention: [B, L/sp, N, D] sequence-sharded in, swap to
    [B, L, N/sp, D] head-sharded, attention over the whole sequence (K1 on
    the card), swap back. ``kv_len``: optional [B] global live key count
    (masks the pad tokens that round L up to a multiple of sp)."""
    out = attention(*(_all_to_all(t, group, 2, 1) for t in (q, k, v)), kv_len=kv_len)
    return _all_to_all(out, group, 1, 2)


def _merge_partials(o1, lse1, o2, lse2):
    """Merge two normalized partial-attention results by their logsumexps,
    o = (o1·e^lse1 + o2·e^lse2)/(e^lse1 + e^lse2), stably, in fp32.
    o: [B, Lq, N, D]; lse: [B, N, Lq]."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    den = w1 + w2
    lse = m + torch.log(den)

    def tr(x):  # [B, N, Lq] → [B, Lq, N, 1]
        return x.transpose(1, 2)[..., None]

    return (o1 * tr(w1) + o2 * tr(w2)) / tr(den), lse


def ring_attention(q, k, v, group, *, kv_len=None, kv_starts=None):
    """Ring attention over a sequence-sharded kv: each hop runs K7 of the
    local q against the kv block it holds, merges the block's (out, lse)
    into the running result in fp32, and passes the block on to the next
    rank (``sp − 1`` shifts; the reference's scan makes one more, whose
    result it drops). Full (non-causal) attention.

    q, k, v: [B, L/sp, N, D], the same chunk layout. ``kv_len``: optional
    [B] global live key count: keys at global position >= kv_len are
    masked. ``kv_starts``: optional [R] global start positions of the R
    equal runs that make up the local kv block (the USP layout, where the
    Ulysses gather interleaves chunks); they travel with their block, and
    each run's live length is ``kv_len − start`` clipped to [0, run]. By
    default one run at ``rank·Lk``."""
    sp = dist.get_world_size(group)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if kv_starts is None:
        kv_starts = torch.tensor([dist.get_rank(group) * lk], dtype=torch.int32,
                                 device=q.device)
    starts = kv_starts.to(device=q.device, dtype=torch.int32)
    runs = starts.numel()
    run_len = lk // runs
    if runs * run_len != lk:
        raise ValueError(f"ring_attention: {runs} runs do not split {lk} keys")
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32)
    o = torch.zeros((b, lq, n, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, n, lq), _INITIAL_LSE, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for hop in range(sp):
        for j in range(runs):
            run = slice(j * run_len, (j + 1) * run_len)
            klen = None if kv_len is None else (kv_len - starts[j]).clamp(0, run_len)
            o_j, lse_j = flash_attention_partial(q, kb[:, run], vb[:, run], kv_len=klen)
            o, lse = _merge_partials(o, lse, o_j.float(), lse_j)
        if hop < sp - 1:
            kb, vb, starts = _ring_shift([kb, vb, starts], group)
    return o.to(q.dtype)


def usp_attention(q, k, v, groups: SPGroups, *, kv_len=None):
    """USP hybrid attention, Ulysses × ring over the 2D groups of
    :func:`make_usp_groups`: the Ulysses all-to-all trades heads for
    sequence within ``groups.ulysses`` ([B, L/sp_r, N/sp_u, D], chunks
    interleaved), ring attention over ``groups.ring`` covers the rest,
    with each run's global start carried round the ring for ``kv_len``."""
    if groups.ulysses is None or groups.ring is None:
        raise ValueError("usp_attention needs the groups of make_usp_groups")
    lc = q.shape[1]
    qs, ks, vs = (_all_to_all(t, groups.ulysses, 2, 1) for t in (q, k, v))
    # the gathered kv is sp_u runs of lc tokens: chunk j_u·sp_r + i_r for
    # each Ulysses rank j_u, in j_u order
    starts = (torch.arange(groups.sp_u, dtype=torch.int32, device=q.device) * groups.sp_r
              + groups.i_r) * lc
    out = ring_attention(qs, ks, vs, groups.ring, kv_len=kv_len, kv_starts=starts)
    return _all_to_all(out, groups.ulysses, 1, 2)


def sp_attention(groups: SPGroups, kind: str) -> Callable:
    """The DiT's self-attention hook ``attn_fn(q, k, v, kv_len=None)`` for
    one sequence-parallel kind, ``"ulysses"``, ``"ring"`` or ``"usp"``
    (the counterpart of ``sp_shard_map_attention`` and
    ``usp_shard_map_attention``). Inside an SP forward each rank already
    holds its chunk, so nothing is sharded here."""
    if kind == "ulysses":
        return lambda q, k, v, kv_len=None: ulysses_attention(q, k, v, groups.group,
                                                              kv_len=kv_len)
    if kind == "ring":
        return lambda q, k, v, kv_len=None: ring_attention(q, k, v, groups.group,
                                                           kv_len=kv_len)
    if kind == "usp":
        return lambda q, k, v, kv_len=None: usp_attention(q, k, v, groups, kv_len=kv_len)
    raise ValueError(f"unknown sequence-parallel kind {kind!r}")
