"""Yume-1.0 (Wan2.1-I2V-14B) generation pipeline in PyTorch (counterpart of
yume_tpu/pipelines/i2v.py).

A segment (:meth:`I2VPipeline.generate`) is conditioned on pixel frames:
one image, or in history mode the decoded video so far. The frames become
the 20-channel ``y`` (:meth:`I2VPipeline.make_conditioning`: 4 mask
channels and the Wan2.1 VAE's latents of the frames, zero-padded to the
segment's length) and the CLIP features of one frame
(:meth:`I2VPipeline.clip_features`). The CFG segment sampler then runs the
packed 14B DiT on ``[latent | y]``, re-noising the history prefix every
step (:mod:`..diffusion.samplers`' ``cfg_*`` samplers), and the latents are
decoded (:meth:`I2VPipeline.decode_auto`). :meth:`I2VPipeline.generate_next`
continues a video by ``frame_zero`` pixel frames, its VAE encode resuming
from the previous segment's carried caches.

Samplers: 'euler', 'teacache' (fixed interval or adaptive threshold, one
residual cache per CFG branch), and the TTS samplers 'sde', 'time_travel'
and 'tts'. ``ctx_null=None`` is the distilled serving mode: one cond-only
forward a step, Euler only. W8A8 through ``config.dit.w8a8``
(:meth:`I2VPipeline.with_w8a8` builds it on the same DiT parameters).
``cfg_parallel`` runs the Euler sampler's cond and uncond forwards as one
batch-2B forward. The int8/int4 trunk (:meth:`I2VPipeline.quantize_int8`,
or built block by block by :func:`..models.quantized.quantize_host_blocks`
into a pipeline made with ``init_dit=False``) runs every sampler,
TeaCache in the reference's delta-cache form (``cache_edge``).

Not ported yet, refused with its ROADMAP queue 1 item: pipeline and
sequence parallelism (``parallelize_pp``, a mesh; item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs import PipelineConfig
from ..diffusion import samplers
from ..diffusion.schedule import sampling_sigmas
from ..models.clip import CLIPVisual, preprocess_frames
from ..models.dit import WanDiT
from ..models.quantized import is_quantized, quantize_dit_blocks
from ..models.t5 import T5Encoder, encode_text
from ..models.vae import WanVAE, streaming_decode
from .ti2v import build_modules, module_factories, w8a8_twin

_TTS_SAMPLERS = ("sde", "time_travel", "tts")
# the churn noise of a TTS segment comes from a generator seeded seed + this,
# as the reference's PRNGKey(seed + 7777)
_TTS_SEED_OFFSET = 7777
# decode_auto decodes the full clip while out pixels x 96 channels x 4 bytes
# stay under this, and streams otherwise (the reference's rule)
_FULL_DECODE_BYTES = 2 << 30


def build_mask_channels(frame_num: int, lat_h: int, lat_w: int, *, cond_pixel_frames: int,
                        batch: int = 1, stride_t: int = 4, device=None) -> torch.Tensor:
    """The latent-frame conditioning mask ``msk`` (reference
    wan/image2video.py:300-320): a per-pixel-frame indicator (1 for the
    leading ``cond_pixel_frames`` conditioning frames), its first frame
    repeated ``stride_t`` times, grouped ``stride_t`` to a latent frame;
    channel c is the offset in the group. Returns [B, F_lat, lat_h, lat_w,
    stride_t] fp32."""
    m = np.zeros((frame_num,), np.float32)
    m[:cond_pixel_frames] = 1.0
    m = np.concatenate([np.repeat(m[:1], stride_t), m[1:]])
    m = torch.from_numpy(m.reshape(len(m) // stride_t, stride_t)).to(device)
    return m[None, :, None, None, :].expand(batch, -1, lat_h, lat_w, -1).contiguous()


def _factories(config: PipelineConfig, dtype: torch.dtype, *, t5: bool, clip: bool):
    """The DiT's, the VAE's, umT5's and CLIP's factories; None for an
    encoder left out."""
    dit_f, vae_f, t5_f = module_factories(config, dtype)
    clip_f = (lambda device: CLIPVisual(config.clip, dtype, device=device,
                                        param_dtype=dtype))
    return dit_f, vae_f, t5_f if t5 else None, clip_f if clip else None


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"not ported yet: {what} (ROADMAP queue 1, item {item})")


@dataclasses.dataclass(eq=False)
class I2VPipeline:
    """The 14B generation stack: DiT, Wan2.1 VAE, umT5 and CLIP ViT-H."""

    config: PipelineConfig
    dit: WanDiT
    vae: WanVAE
    t5: Optional[T5Encoder] = None
    clip: Optional[CLIPVisual] = None
    # called with "vae" before the conditioning (VAE and CLIP), "dit" before
    # the sampler and "vae" before the decode, so a caller can move models
    # between host and device (--memory_optimization)
    phase_cb: Optional[Callable[[str], None]] = None
    # full-DiT steps of the last sampler="teacache" segment
    last_teacache_n_full: Optional[int] = None
    # CFG parallelism: the Euler sampler's cond and uncond forwards as one
    # batch-2B forward (the reference's xDiT cfg_degree)
    cfg_parallel: bool = False
    # the streaming VAE encoder's state after the last history encode
    # (_encode_history_incremental)
    _cond_cache: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return next((self.dit if self.dit is not None else self.vae).parameters()).device

    # -- construction --------------------------------------------------------

    @classmethod
    def from_config(cls, config: PipelineConfig, *, device="cuda", seed: int = 0,
                    init_t5: bool = True, init_clip: bool = True, init_dit: bool = True,
                    dtype: torch.dtype = torch.bfloat16) -> "I2VPipeline":
        """Random-initialised pipeline at the config's full width: N(0, 0.02)
        weights allocated and drawn directly on ``device`` from a seeded
        ``torch.Generator`` (a host fp32 init of the 14B would take ~66 GB;
        real weights come from checkpoints). ``init_dit=False`` leaves the
        DiT out (``dit`` None): the quantized 14B path streams its trunk in
        (:func:`..models.quantized.quantize_host_blocks`) without the bf16
        trunk ever being made."""
        gen = torch.Generator(device=device).manual_seed(seed)
        dit_f, vae_f, t5_f, clip_f = _factories(
            config, dtype, t5=init_t5, clip=init_clip and config.clip is not None)
        return cls(config, *build_modules((dit_f if init_dit else None, vae_f, t5_f, clip_f),
                                          device, generator=gen))

    @classmethod
    def from_state_dicts(cls, config: PipelineConfig, dit_sd: Optional[Mapping],
                         vae_sd: Mapping,
                         t5_sd: Optional[Mapping] = None, clip_sd: Optional[Mapping] = None,
                         *, device="cuda",
                         dtype: torch.dtype = torch.bfloat16) -> "I2VPipeline":
        """Pipeline from the port's state dicts (reference names; torch
        tensors or numpy arrays), loaded strictly, stored and computed in
        ``dtype``. ``clip_sd`` holds the visual tower's tensors without the
        released file's ``visual.`` prefix; ``dit_sd=None`` leaves the DiT
        out."""
        dit_f, vae_f, t5_f, clip_f = _factories(config, dtype, t5=t5_sd is not None,
                                                clip=clip_sd is not None)
        return cls(config, *build_modules((dit_f if dit_sd is not None else None, vae_f, t5_f,
                                           clip_f), device,
                                          state_dicts=(dit_sd, vae_sd, t5_sd, clip_sd)))

    def with_w8a8(self) -> "I2VPipeline":
        """This pipeline with ``config.dit.w8a8`` on (:func:`.ti2v.w8a8_twin`),
        beside the same VAE and encoders."""
        config, dit = w8a8_twin(self.config, self.dit)
        return dataclasses.replace(self, config=config, dit=dit, last_teacache_n_full=None,
                                   _cond_cache=None)

    def quantize_int8(self, bits: int = 8):
        """Quantize the DiT trunk in place (int8, or int4 with ``bits=4``;
        :func:`..models.quantized.quantize_dit_blocks`): its bf16 block
        weights are freed. A no-op on a quantized trunk."""
        if not is_quantized(self.dit):
            quantize_dit_blocks(self.dit, bits)

    def parallelize_pp(self, stages: int, *, devices=None):
        _not_ported("pipeline-parallel staging of the 14B trunk", 8)

    # -- conditioning --------------------------------------------------------

    def _phase(self, name: str):
        if self.phase_cb is not None:
            self.phase_cb(name)

    @torch.no_grad()
    def encode_text(self, ids, mask) -> torch.Tensor:
        """[B, text_len] ids and mask → [B, text_len, text_dim] fp32 context
        with the padding zeroed."""
        assert self.t5 is not None, "pipeline built without a text encoder"
        # umT5's own device: under the phase shuttle the DiT may be parked
        device = next(self.t5.parameters()).device
        ids = torch.as_tensor(np.asarray(ids), device=device)
        mask = torch.as_tensor(np.asarray(mask), device=device)
        return encode_text(self.t5, ids, mask).float()

    @torch.no_grad()
    def clip_features(self, frame: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [-1, 1] → [B, 257, 1280] CLIP features of the
        conditioning frame (reference wan/image2video.py:339-344)."""
        return self.clip(preprocess_frames(frame, self.config.clip.image_size))

    @torch.no_grad()
    def decode_auto(self, z: torch.Tensor) -> torch.Tensor:
        """Memory-aware decode, with the reference's rule: the full clip
        while out_pixels·96·4 bytes stay under 2 GiB, otherwise the streaming
        decode (latent frame 0, then one frame a chunk) from bf16 latents.
        Both compute the same function (the de-normalisation promotes the
        latents back to fp32)."""
        s = self.config.vae.stride
        out_px = z.shape[1] * s[0] * z.shape[2] * s[1] * z.shape[3] * s[2]
        if out_px * 96 * 4 < _FULL_DECODE_BYTES:
            return self.vae.decode(z)
        return streaming_decode(self.vae, z.to(torch.bfloat16))

    @torch.no_grad()
    def make_conditioning(self, cond_frames: torch.Tensor, frame_num: int, *,
                          history_mode: bool = False) -> torch.Tensor:
        """The 20-channel ``y`` (reference wan/image2video.py:288-369): the
        mask channels and the VAE latents of ``cond_frames`` [B, Fc, H, W, 3]
        zero-padded to ``frame_num`` pixel frames, [B, F_lat, h, w, 4 + z].
        Image mode (one frame) resets the encoder cache; history mode encodes
        only the frames new since the last call when it can
        (:meth:`_encode_history_incremental`)."""
        b, fc, h, w, _ = cond_frames.shape
        s = self.config.vae.stride
        pad_frames = frame_num - fc
        if history_mode:
            z_cond = self._encode_history_incremental(cond_frames, pad_frames)
        else:
            self._cond_cache = None
            padded = torch.cat(
                [cond_frames, cond_frames.new_zeros((b, pad_frames, h, w, 3))], dim=1)
            # a 4n+1-frame clip streams: the same function as one full-clip
            # encode, in bounded memory
            z_cond = (self._stream_encode(padded, None)[0] if frame_num % 4 == 1
                      else self.vae.encode(padded))
        msk = build_mask_channels(frame_num, h // s[1], w // s[2],
                                  cond_pixel_frames=fc if history_mode else 1, batch=b,
                                  stride_t=s[0], device=z_cond.device)
        return torch.cat([msk, z_cond], dim=-1)

    def _stream_encode(self, frames, caches):
        """Chunked VAE encode resuming from ``caches`` (None: a fresh stream,
        pixel frame 0 alone first), then chunks of 4 frames. Returns
        (latents, the caches after the last chunk)."""
        outs, start = [], 0
        if caches is None:
            mu, caches = self.vae.encode_chunk(frames[:, :1], None)
            outs.append(mu)
            start = 1
        for i in range(start, frames.shape[1], 4):
            mu, caches = self.vae.encode_chunk(frames[:, i:i + 4], caches)
            outs.append(mu)
        return torch.cat(outs, dim=1), caches

    def _encode_history_incremental(self, frames, pad_frames):
        """The history's latents and the zero tail's: when the frames extend
        those of the cached encode by a multiple of 4, only the new frames
        are encoded, from the cached encoder state; a 4n+1-frame history is
        encoded afresh as a stream and cached; any other length falls back to
        one full encode, uncached. Exact by the causal VAE's carried
        caches."""
        b, fc, h, w, _ = frames.shape
        cache = self._cond_cache
        if (cache is not None and 0 < cache["frames"] < fc
                and (fc - cache["frames"]) % 4 == 0 and cache["hw"] == (h, w)):
            z_new, carry = self._stream_encode(frames[:, cache["frames"]:], cache["carry"])
            z_hist = torch.cat([cache["z_hist"], z_new], dim=1)
        elif fc % 4 == 1:
            z_hist, carry = self._stream_encode(frames, None)
        else:
            self._cond_cache = None
            return self.vae.encode(torch.cat(
                [frames, frames.new_zeros((b, pad_frames, h, w, 3))], dim=1))
        self._cond_cache = dict(frames=fc, carry=carry, z_hist=z_hist, hw=(h, w))
        z_tail, _ = self._stream_encode(frames.new_zeros((b, pad_frames, h, w, 3)), carry)
        return torch.cat([z_hist, z_tail], dim=1)

    # -- sampling ------------------------------------------------------------

    def _forward(self, y, clip_ctx):
        """(latent, t_frame, context) → the packed DiT's velocity on
        ``[latent | y]`` in bf16 (as the reference feeds it), zeros over the
        history, in the latent's dtype; ``**kw`` reaches the DiT (TeaCache).
        A latent batch that is a multiple of y's (batched CFG) tiles y and
        the CLIP features to it."""
        lfz = self.config.latent_frame_zero
        dit = self.dit

        def fwd(latent, t_frame, context, **kw):
            reps = latent.shape[0] // y.shape[0]
            y_ = y.repeat(reps, *([1] * (y.dim() - 1))) if reps > 1 else y
            clip_ = (clip_ctx.repeat(reps, 1, 1) if reps > 1 and clip_ctx is not None
                     else clip_ctx)
            x_in = torch.cat([latent, y_.to(latent.dtype)], dim=-1).to(torch.bfloat16)
            out = dit(x_in, t_frame, context, latent_frame_zero=lfz, clip_context=clip_, **kw)
            out, cache = out if kw.get("return_cache") else (out, None)
            pad = torch.zeros_like(latent[:, : latent.shape[1] - lfz])
            v = torch.cat([pad, out.to(latent.dtype)], dim=1)
            return (v, cache) if kw.get("return_cache") else v
        return fwd

    def _latent0(self, y, noise):
        """[clean history | tail noise]: the clean history is the
        conditioning latent after y's stride_t mask channels."""
        lfz = self.config.latent_frame_zero
        clean_hist = y[..., self.config.vae.stride[0]:]
        return torch.cat([clean_hist[:, : noise.shape[1] - lfz].to(noise.dtype),
                          noise[:, -lfz:]], dim=1)

    def _sample_cfg(self, noise, y, ctx, ctx_null, clip_ctx, steps, shift, guide_scale):
        """CFG Euler with history re-noising (reference
        fastvideo/sample/sample.py:756-790)."""
        return samplers.cfg_euler_sample_segment(
            self._forward(y, clip_ctx), self._latent0(y, noise), noise, ctx, ctx_null,
            sampling_sigmas(steps, shift), self.config.latent_frame_zero, guide_scale,
            batched_cfg=self.cfg_parallel)

    def _sample_cfg_teacache(self, noise, y, ctx, ctx_null, clip_ctx, steps, shift,
                             guide_scale, cache_interval=2, cache_edge=None,
                             cache_threshold=None):
        """CFG sampling with TeaCache block-residual reuse (reference
        wan/modules/model.py:977-998): the full DiT every ``cache_interval``
        steps per branch, or whenever the accumulated rel-L1 change of the
        tail reaches ``cache_threshold``; ``cache_edge`` live blocks per side
        on cached steps (None → num_layers // 4). On a quantized trunk the
        reference's delta cache over its default edges, ``max(1,
        num_layers // 4)`` a side, whatever ``cache_edge``. Returns
        (latent, n_full)."""
        n = self.config.dit.num_layers
        edge = n // 4 if cache_edge is None else max(1, int(cache_edge))
        # a quantized trunk caches the middle chunk's delta at the reference
        # int8_dit_apply's default edge, the bf16 one each middle block's residual
        kw = (dict(cache_edge=n // 4) if is_quantized(self.dit)
              else dict(cache_list=tuple(range(edge, n - edge))))
        fwd = self._forward(y, clip_ctx)

        def full(lat, t_frame, context):
            return fwd(lat, t_frame, context, return_cache=True, **kw)

        def cached(lat, t_frame, context, cache):
            return fwd(lat, t_frame, context, block_cache=cache, **kw)

        args = (full, cached, self._latent0(y, noise), noise, ctx, ctx_null,
                sampling_sigmas(steps, shift), self.config.latent_frame_zero, guide_scale)
        if cache_threshold is not None:
            return samplers.cfg_euler_sample_segment_cached_adaptive(
                *args, threshold=cache_threshold)
        out = samplers.cfg_euler_sample_segment_cached(*args, cache_interval=cache_interval)
        return out, -(-steps // cache_interval)

    def _sample_cfg_tts(self, noise, y, ctx, ctx_null, clip_ctx, steps, shift, guide_scale,
                        interval, sde, noise_fn):
        """The 14B TTS loop (reference fastvideo/sample/sample_tts.py:690-854):
        CFG Euler with history re-noising, time-travel splice-back
        (``interval`` > 0) and/or SDE churn (``sde``)."""
        return samplers.cfg_time_travel_sample_segment(
            self._forward(y, clip_ctx), self._latent0(y, noise), noise, ctx, ctx_null,
            sampling_sigmas(steps, shift), self.config.latent_frame_zero, guide_scale,
            interval=interval, sde=sde, noise_fn=noise_fn)

    @torch.no_grad()
    def generate(
        self,
        cond_frames: torch.Tensor,
        ctx: torch.Tensor,
        ctx_null: Optional[torch.Tensor],
        *,
        frame_num: int = 81,
        steps: int = 50,
        shift: Optional[float] = None,
        guide_scale: float = 5.0,
        history_mode: bool = False,
        seed: int = 0,
        sampler: str = "euler",
        teacache_interval: int = 3,
        teacache_edge: Optional[int] = None,
        teacache_threshold: Optional[float] = None,
        noise: Optional[torch.Tensor] = None,
        churn_noise: Optional[Iterable[torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One 14B segment of ``frame_num`` pixel frames conditioned on
        ``cond_frames`` [B, Fc, H, W, 3] in [-1, 1] (one image, or the video
        so far with ``history_mode``; CLIP sees its first frame, or in
        history mode its last). Returns (latents [B, F_lat, h, w, 16],
        video [B, frame_num, H, W, 3]).

        ``sampler``: 'euler'; 'teacache' (the full DiT every
        ``teacache_interval``-th step, or with ``teacache_threshold``
        adaptively; ``teacache_edge`` live blocks per side; the full-DiT step
        count is left in ``last_teacache_n_full``); 'sde' (churn),
        'time_travel' (lookahead) or 'tts' (both), whose churn draws come
        from a generator seeded ``seed + 7777``, or in order from
        ``churn_noise``. ``ctx_null=None`` is the distilled mode: one
        cond-only forward a step, Euler only. ``noise`` [B, F_lat, h, w, z]
        overrides the seeded fp32 noise."""
        shift = self.config.sample_shift if shift is None else shift
        b, _, h, w, _ = cond_frames.shape
        s = self.config.vae.stride
        f_lat = (frame_num - 1) // s[0] + 1
        if sampler not in ("euler", "teacache") + _TTS_SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        if ctx_null is None and sampler != "euler":
            raise NotImplementedError(
                f"distilled (ctx_null=None) serving supports the euler sampler, got {sampler!r}")
        if sampler == "teacache" and teacache_interval < 1:
            raise ValueError(f"teacache_interval must be >= 1, got {teacache_interval}")
        if self.dit is None:
            raise ValueError("the pipeline has no DiT: build its quantized trunk "
                             "(models/quantized.py: quantize_host_blocks) first")

        self._phase("vae")
        y = self.make_conditioning(cond_frames, frame_num, history_mode=history_mode)
        clip_frame = cond_frames[:, -1] if history_mode else cond_frames[:, 0]
        clip_ctx = self.clip_features(clip_frame) if self.clip is not None else None
        self._phase("dit")
        device = y.device
        if noise is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            noise = torch.randn((b, f_lat, h // s[1], w // s[2], self.config.vae.z_dim),
                                generator=gen, device=device, dtype=torch.float32)
        noise = noise.to(device)
        args = (noise, y, ctx, ctx_null, clip_ctx, steps, shift, guide_scale)
        if sampler == "teacache":
            latents, self.last_teacache_n_full = self._sample_cfg_teacache(
                *args, teacache_interval, teacache_edge, teacache_threshold)
        elif sampler in _TTS_SAMPLERS:
            if churn_noise is None:
                gen = torch.Generator(device=device).manual_seed(seed + _TTS_SEED_OFFSET)

                def noise_fn(shape):
                    return torch.randn(shape, generator=gen, device=device,
                                       dtype=torch.float32)
            else:
                draws = iter(churn_noise)

                def noise_fn(shape):
                    return next(draws).to(device).reshape(shape)
            # 'sde' = churn only, 'time_travel' = lookahead only, 'tts' = both
            latents = self._sample_cfg_tts(*args, 0 if sampler == "sde" else 2,
                                           sampler in ("sde", "tts"), noise_fn)
        else:
            latents = self._sample_cfg(*args)
        self._phase("vae")
        return latents, self.decode_auto(latents)

    def generate_next(self, history_video: torch.Tensor, ctx: torch.Tensor,
                      ctx_null: Optional[torch.Tensor], *, frame_zero: int = 32,
                      **kw) -> Tuple[torch.Tensor, torch.Tensor]:
        """Autoregressive continuation (reference wan/image2video.py:404-534):
        re-condition on the decoded ``history_video`` [B, Fh, H, W, 3] and
        denoise ``frame_zero`` new pixel frames; ``kw`` as :meth:`generate`.
        Returns the latents and the whole video, history included."""
        frame_num = history_video.shape[1] + frame_zero
        return self.generate(history_video, ctx, ctx_null, frame_num=frame_num,
                             history_mode=True, **kw)
