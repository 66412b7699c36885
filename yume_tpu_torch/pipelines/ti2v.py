"""Yume-1.5 (Wan2.2-TI2V-5B) generation pipeline in PyTorch (counterpart of
yume_tpu/pipelines/ti2v.py).

One request is one autoregressive continuation segment: the umT5 prompt
encode (:meth:`TI2VPipeline.encode_text`), the Euler segment sampler over
the FramePack-packed DiT (:meth:`TI2VPipeline.generate_segment`) and the
streaming VAE decode of the new tail (:meth:`TI2VPipeline.decode_auto`).
:meth:`TI2VPipeline.generate_long` runs one segment per caption.

Ported: the ``sampler="euler"`` path. Not ported yet: TeaCache, the TTS
samplers, W8A8, t2v/i2v entry points, the VAE encode, tiled decode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from yume_tpu.configs import PipelineConfig
from yume_tpu.diffusion.schedule import sampling_sigmas

from ..diffusion import samplers
from ..models.dit import WanDiT
from ..models.t5 import T5Encoder, encode_text
from ..models.vae import WanVAE, streaming_decode
from ..utils.convert import load_state_dict


def _materialize(factory: Callable[..., nn.Module], device) -> nn.Module:
    """Build a module without allocating or initialising on the host: on
    the meta device first, then uninitialised storage on ``device``."""
    return factory(device="meta").to_empty(device=device)


@torch.no_grad()
def _random_init_(module: nn.Module, generator: torch.Generator, std: float = 0.02):
    """Random weights for smoke runs: N(0, std) for every tensor with more
    than one element, zero for scalars (as the reference's bf16 init)."""
    for p in module.parameters():
        if p.numel() > 1:
            p.normal_(0.0, std, generator=generator)
        else:
            p.zero_()


@dataclasses.dataclass(eq=False)
class TI2VPipeline:
    """The 5B generation stack: DiT, VAE decoder and (optionally) umT5."""

    config: PipelineConfig
    dit: WanDiT
    vae: WanVAE
    t5: Optional[T5Encoder] = None

    @property
    def device(self) -> torch.device:
        return next(self.dit.parameters()).device

    # -- construction --------------------------------------------------------

    @classmethod
    def from_config(cls, config: PipelineConfig, *, device, seed: int = 0,
                    init_t5: bool = False,
                    dtype: torch.dtype = torch.bfloat16) -> "TI2VPipeline":
        """Random-initialised pipeline at the config's full width, allocated
        and initialised directly on ``device`` from a seeded
        ``torch.Generator`` (real weights come from checkpoints)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        dit = _materialize(lambda device: WanDiT(
            config.dit, dtype, device=device, param_dtype=dtype), device)
        vae = _materialize(lambda device: WanVAE(
            config.vae, device=device, dtype=dtype), device)
        t5 = None
        if init_t5:
            t5 = _materialize(lambda device: T5Encoder(
                config.t5, dtype, device=device, param_dtype=dtype), device)
        for m in (dit, vae, t5):
            if m is not None:
                _random_init_(m, gen)
        return cls(config, dit.eval(), vae.eval(), t5.eval() if t5 is not None else None)

    @classmethod
    def from_state_dicts(cls, config: PipelineConfig, dit_sd: Mapping,
                         vae_sd: Mapping, t5_sd: Optional[Mapping] = None, *,
                         device="cpu",
                         dtype: torch.dtype = torch.bfloat16) -> "TI2VPipeline":
        """Pipeline from reference-named state dicts (torch tensors or numpy
        arrays, e.g. from :mod:`..utils.convert`), stored and computed in
        ``dtype``."""
        dit = _materialize(lambda device: WanDiT(
            config.dit, dtype, device=device, param_dtype=dtype), device)
        load_state_dict(dit, dit_sd)
        vae = _materialize(lambda device: WanVAE(
            config.vae, device=device, dtype=dtype), device)
        load_state_dict(vae, vae_sd, allow_unused=True)
        t5 = None
        if t5_sd is not None:
            t5 = _materialize(lambda device: T5Encoder(
                config.t5, dtype, device=device, param_dtype=dtype), device)
            load_state_dict(t5, t5_sd)
        return cls(config, dit.eval(), vae.eval(), t5.eval() if t5 is not None else None)

    # -- conditioning --------------------------------------------------------

    @torch.no_grad()
    def encode_text(self, ids, mask) -> torch.Tensor:
        """[B, text_len] ids and mask → [B, text_len, text_dim] fp32 context
        with the padding zeroed."""
        assert self.t5 is not None, "pipeline built without a text encoder"
        ids = torch.as_tensor(np.asarray(ids), device=self.device)
        mask = torch.as_tensor(np.asarray(mask), device=self.device)
        return encode_text(self.t5, ids, mask).float()

    # -- generation ----------------------------------------------------------

    @torch.no_grad()
    def generate_segment(
        self,
        history_latents: torch.Tensor,
        ctx: torch.Tensor,
        *,
        steps: int = 4,
        shift: float = 7.0,
        seed: int = 0,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One autoregressive continuation: append ``latent_frame_zero``
        noise frames after the history, denoise them with the packed DiT
        (per-frame timesteps, Euler), return the grown latent sequence.
        ``noise`` overrides the seeded tail noise."""
        lfz = self.config.latent_frame_zero
        b, f_hist, h, w, c = history_latents.shape
        device = history_latents.device
        if noise is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            noise = torch.randn((b, lfz, h, w, c), generator=gen, device=device,
                                dtype=torch.float32)
        latent = torch.cat([history_latents, noise.to(history_latents.dtype)], dim=1)
        history_t = torch.zeros((b, f_hist), dtype=torch.float32, device=device)

        def denoise(lat, t_frame):
            # the reference feeds the DiT a bf16 latent whatever its dtype
            out = self.dit(lat.to(torch.bfloat16), t_frame, ctx,
                           latent_frame_zero=lfz).to(lat.dtype)
            pad = torch.zeros_like(lat[:, : lat.shape[1] - lfz])
            return torch.cat([pad, out], dim=1)

        return samplers.euler_sample_segment(
            denoise, latent, sampling_sigmas(steps, shift), lfz, history_t=history_t)

    @torch.no_grad()
    def decode_auto(self, z: torch.Tensor) -> torch.Tensor:
        """Streaming decode in chunks of 2 latent frames, in the VAE's
        parameter dtype, without width tiling (the reference's tiling was
        sized for a 16 GB chip); equal to ``WanVAE.decode``."""
        vae_dtype = next(self.vae.parameters()).dtype
        return streaming_decode(self.vae, z.to(vae_dtype), chunk_latent_frames=2)

    def generate_long(
        self,
        ctxs: List[torch.Tensor],
        first_segment: torch.Tensor,
        *,
        steps: int = 4,
        shift: float = 7.0,
        seed: int = 0,
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Autoregressive rollout: one segment per context in ``ctxs`` after
        ``first_segment`` [B, F0, h, w, z]. Returns (full latent sequence,
        decoded tail videos)."""
        latents = first_segment
        videos = []
        for s, ctx in enumerate(ctxs):
            latents = self.generate_segment(latents, ctx, steps=steps, shift=shift,
                                            seed=seed + s + 1)
            videos.append(self.decode_auto(latents[:, -self.config.latent_frame_zero:]))
        return latents, videos
