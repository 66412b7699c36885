"""yume_tpu_torch — the PyTorch/CUDA port of yume_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``yume_tpu``. Module and function
names mirror the reference so each counterpart is easy to find; public
tensors keep the reference layouts (videos and latents channels-last
``[B, F, H, W, C]``, tokens ``[B, L, D]``, attention ``[B, L, N, Dh]``).

Every Pallas kernel on the ported path has a hand-written Hopper kernel
here (CUDA C++ under ``csrc/``, built by :mod:`._build`: flash attention and
the W8A8 int8 matmul; Triton for the memory-bound glue passes in
:mod:`.ops.fused_adaln`). Each kernel wrapper runs its plain PyTorch version
on CPU tensors and launches the kernel (or raises) on CUDA tensors.

This package imports neither ``jax`` nor anything of the JAX package
``yume_tpu``: it keeps its own copies of the configs, the sigma schedule and
the tokenizer (pinned equal to the reference's by the tests).

Layout:
    configs.py  model and pipeline config dataclasses
    ops/        RoPE, attention dispatch, flash attention and its partial
                (ring) form (CUDA), W8A8 int8 matmul (CUDA), fused glue
                (Triton)
    models/     WanDiT (5B, FramePack-packed, W8A8, TeaCache hooks), umT5
                encoder, Wan2.2 VAE decoder
    diffusion/  Euler and TeaCache (interval, adaptive) segment samplers,
                sigma schedules
    pipelines/  TI2VPipeline (text encode, segment sampling, decode; one
                rank of a sequence-parallel run with ``sp_groups``)
    parallel/   sequence parallelism over torch.distributed process groups:
                Ulysses, ring and USP attention, the sharded DiT forward
    data/       offline tokenizer
    utils/      JAX parameter tree → state-dict conversion
"""

__version__ = "0.1.0"
