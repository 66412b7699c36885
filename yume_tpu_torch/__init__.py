"""yume_tpu_torch — the PyTorch/CUDA port of yume_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``yume_tpu``. Module and function
names mirror the reference so each counterpart is easy to find; public
tensors keep the reference layouts (videos and latents channels-last
``[B, F, H, W, C]``, tokens ``[B, L, D]``, attention ``[B, L, N, Dh]``).

Every Pallas kernel on the ported path has a hand-written Hopper kernel
here (CUDA C++ under ``csrc/``, built by :mod:`._build`; Triton for the
memory-bound glue passes in :mod:`.ops.fused_adaln`). Each kernel wrapper
runs its plain PyTorch version on CPU tensors and launches the kernel (or
raises) on CUDA tensors.

This package never imports ``jax``. From the reference it reuses only the
jax-free modules ``yume_tpu.configs``, ``yume_tpu.diffusion.schedule`` and
``yume_tpu.data.tokenizer``.

Layout:
    ops/        RoPE, attention dispatch, flash attention (CUDA), fused glue (Triton)
    models/     WanDiT (5B, FramePack-packed), umT5 encoder, Wan2.2 VAE decoder
    diffusion/  Euler segment sampler
    pipelines/  TI2VPipeline (text encode, segment sampling, decode)
    utils/      JAX parameter tree → state-dict conversion
"""

__version__ = "0.1.0"
