"""A pipeline's place in a multi-device serving run: its process group,
whether this process is the run's rank 0, the DiT forward every sampler
calls, and the staging of the trunk.

Both pipelines (:mod:`..pipelines.ti2v`, :mod:`..pipelines.i2v`) carry
``sp_groups`` (:class:`.mesh.SPGroups`, with ``sp_kind``) or ``pp_groups``
(:class:`.pipeline.PPGroups`); :func:`dit_forward` picks the sequence-
parallel, the staged or the one-rank forward from them, so the samplers
hold no parallel branch of their own.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..models.quantized import is_quantized
from .pipeline import PPGroups, keep_stage_, make_pp_groups, pp_dit_forward, stage_blocks
from .sp_forward import sp_dit_forward


def run_group(pipe):
    """The process group of a sequence- or pipeline-parallel pipeline, or
    None."""
    if pipe.sp_groups is not None:
        return pipe.sp_groups.group
    return None if pipe.pp_groups is None else pipe.pp_groups.group


def on_rank0(pipe) -> bool:
    """Whether this process is rank 0 of the pipeline's run (or runs
    alone): the rank that holds the encoders and the VAE."""
    group = run_group(pipe)
    return group is None or dist.get_rank(group) == 0


def decoded_placeholder(z: torch.Tensor, stride) -> torch.Tensor:
    """What a rank other than 0 gets for the decode of latents ``z`` [B, F,
    h, w, C]: a meta tensor of the video's shape [B, 1 + (F − 1)·s_t, h·s_h,
    w·s_w, 3]."""
    b, f, h, w = z.shape[:4]
    return torch.empty((b, 1 + (f - 1) * stride[0], h * stride[1], w * stride[2], 3),
                       device="meta")


def stage_dit(pipe, stages: int, groups: Optional[PPGroups]) -> int:
    """``parallelize_pp`` of either pipeline: stage its bf16 trunk over
    ``groups`` (default :func:`.pipeline.make_pp_groups`), freeing the
    other stages' blocks; returns the DiT bytes this rank holds."""
    if pipe.dit is None or is_quantized(pipe.dit):
        raise NotImplementedError(
            "pipeline parallelism stages the bf16 trunk; the int8/int4 trunk is not staged "
            "(drop --int8/--int4, or --pp)")
    if pipe.sp_groups is not None:
        raise NotImplementedError("sequence and pipeline parallelism do not combine")
    groups = make_pp_groups(stages) if groups is None else groups
    if groups.stages != stages:
        raise ValueError(f"{groups.stages} stage groups for {stages} stages")
    stage_blocks(len(pipe.dit.blocks), stages, groups.stage)   # stages divide the layers
    pipe.pp_groups = groups
    return keep_stage_(pipe.dit, groups)


def dit_forward(pipe, dit, x: torch.Tensor, t_frame: torch.Tensor, context: torch.Tensor,
                *, packed: bool = True, **kw):
    """``dit(x, t_frame, context, packed=packed, **kw)`` as a sampler of
    ``pipe`` runs it on every rank of its run: a packed forward with the
    tokens sharded over ``pipe.sp_groups`` (the unpacked t2v forward runs
    whole, as outside the JAX mesh); a forward of a trunk staged over
    ``pipe.pp_groups`` through its stages; any other alone."""
    if pipe.sp_groups is not None and packed:
        return sp_dit_forward(dit, pipe.sp_groups, x, t_frame, context, kind=pipe.sp_kind,
                              **kw)
    if pipe.pp_groups is not None and pipe.pp_groups.holds(dit):
        return pp_dit_forward(dit, pipe.pp_groups, x, t_frame, context, packed=packed, **kw)
    return dit(x, t_frame, context, packed=packed, **kw)
