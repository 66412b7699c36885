"""Sequence-parallel DiT forward (counterpart of
yume_tpu/parallel/sp_forward.py): one rank's part of a packed forward
whose token axis is sharded over an sp group between embedding and
unpatchify.

Every rank embeds the whole input (cheap, and the same on every rank;
the 14B's CLIP tokens with the text context), pads L to a multiple of sp,
and runs the blocks and the head on its own chunk of tokens with their
per-token modulation indices and RoPE rows (the reference's rank-sliced
RoPE). Self-attention goes through Ulysses, ring or USP attention with
``kv_len`` masking the pad tokens; cross-attention is local. A batch of
two (batched CFG) passes through as it is. The head's output is gathered
from every rank, cut to the true length and unpatchified, so every rank
returns the same velocity.

The forward is differentiable (the collectives of :mod:`.ulysses` carry
gradients): sequence-parallel training calls it in place of the model,
and each rank's parameter gradients then hold its own tokens' share,
which the train step sums over the group. Pad query rows are cut before
the loss, so their gradient is zero; pad keys stay masked by ``kv_len``.
Serving calls it under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.dit import WanDiT
from .mesh import SPGroups
from .ulysses import _all_gather, sp_attention


def _pad_to(x: torch.Tensor, mult: int, dim: int):
    """``x`` zero-padded along ``dim`` to a multiple of ``mult``, and the
    pad length."""
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x, 0
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, widths), pad


def sp_dit_forward(
    dit: WanDiT,
    groups: SPGroups,
    x: torch.Tensor,
    t_frame: torch.Tensor,
    context: torch.Tensor,
    *,
    latent_frame_zero: int = 8,
    clip_context: Optional[torch.Tensor] = None,
    kind: str = "ulysses",
    packed: bool = True,
    cache_list: tuple = (),
    block_cache: Optional[list] = None,
    return_cache: bool = False,
):
    """This rank's part of ``dit(x, t_frame, context, latent_frame_zero=...,
    clip_context=...)`` with the trunk sequence-sharded over ``groups``
    (kind ``"ulysses"``, ``"ring"`` or ``"usp"``; USP needs
    :func:`make_usp_groups`). Every rank
    of the group calls it with the same inputs and gets the whole tail
    velocity [B, latent_frame_zero, H, W, C_out]. ``packed`` is there for
    the model's call signature (the train step's ``forward``): only the
    packed forward is sequence-parallel.

    TeaCache (the reference's cached model under FSDP,
    fastvideo/sample/sample.py:979-985): ``return_cache=True`` also returns
    the ``cache_list`` blocks' residuals of this rank's tokens [B, L_pad/sp,
    dim], which stay on the rank; ``block_cache`` feeds them back on a
    cached step."""
    if not packed:
        raise ValueError("sp_dit_forward runs the packed forward only")
    emb = dit.embed_packed(x, t_frame, context, latent_frame_zero, clip_context)
    tokens = emb["tokens"]
    b, l_true, _ = tokens.shape
    sp = groups.sp
    tokens, _ = _pad_to(tokens, sp, 1)
    idx, _ = _pad_to(emb["idx"], sp, 1)
    cos, _ = _pad_to(emb["cos"], sp, 0)
    sin, _ = _pad_to(emb["sin"], sp, 0)
    ls = tokens.shape[1] // sp
    mine = slice(groups.rank * ls, (groups.rank + 1) * ls)
    kv_len = torch.full((b,), l_true, dtype=torch.int32, device=tokens.device)

    out = dit.trunk_head(
        tokens[:, mine].contiguous(), emb["t_values"], idx[:, mine].contiguous(), emb["ctx"],
        cos[mine].contiguous(), sin[mine].contiguous(), attn_fn=sp_attention(groups, kind),
        kv_len=kv_len, block_cache=block_cache, cache_list=cache_list,
        return_cache=return_cache)
    out, cache = out if return_cache else (out, None)
    out = _all_gather(out, groups.group, dim=1)[:, :l_true]
    v = dit._unpatchify(out[:, emb["l_hist"]:], emb["tail_grid"])
    return (v, cache) if return_cache else v
