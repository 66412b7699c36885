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

Multi-device serving, as the TI2V pipeline's (:mod:`.ti2v`): with
``sp_groups`` every DiT forward of every sampler shards its tokens over
the group (:func:`..parallel.sp_forward.sp_dit_forward` with the CLIP
context; kind ``sp_kind``), the adaptive TeaCache decision is rank 0's;
with ``pp_groups`` (:meth:`I2VPipeline.parallelize_pp`) the CFG Euler
sampler's forwards run staged (:func:`..parallel.pipeline.pp_dit_forward`).
Either way umT5, CLIP and the VAE live on rank 0: the conditioning, the
contexts and the seeded noise are computed there and handed to every rank,
the decode runs there alone, and the other ranks' videos are meta tensors
of their shape, so every rank makes the same calls with the same arguments.
"""

from __future__ import annotations

import dataclasses
import functools
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
from ..parallel.mesh import SPGroups, from_rank0
from ..parallel.pipeline import PPGroups
from ..parallel.route import decoded_placeholder, dit_forward, on_rank0, run_group, stage_dit
from ..parallel.ulysses import agree
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


def _factories(config: PipelineConfig, dtype: torch.dtype, *, dit: bool, vae: bool, t5: bool,
               clip: bool):
    """The DiT's, the VAE's, umT5's and CLIP's factories; None for a module
    left out."""
    dit_f, vae_f, t5_f = module_factories(config, dtype)
    clip_f = (lambda device: CLIPVisual(config.clip, dtype, device=device,
                                        param_dtype=dtype))
    return (dit_f if dit else None, vae_f if vae else None, t5_f if t5 else None,
            clip_f if clip else None)


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
    # sequence-parallel serving: this rank's groups and the attention kind
    sp_groups: Optional[SPGroups] = None
    sp_kind: str = "ulysses"
    # pipeline-parallel serving: this rank's stage (parallelize_pp)
    pp_groups: Optional[PPGroups] = None

    @property
    def device(self) -> torch.device:
        return next((self.dit if self.dit is not None else self.vae).parameters()).device

    # -- construction --------------------------------------------------------

    @classmethod
    def from_config(cls, config: PipelineConfig, *, device="cuda", seed: int = 0,
                    init_t5: bool = True, init_clip: bool = True, init_dit: bool = True,
                    init_vae: bool = True, dit_keep: Optional[Callable[[str], bool]] = None,
                    dtype: torch.dtype = torch.bfloat16) -> "I2VPipeline":
        """Random-initialised pipeline at the config's full width: N(0, 0.02)
        weights allocated and drawn directly on ``device`` from a seeded
        ``torch.Generator`` (a host fp32 init of the 14B would take ~66 GB;
        real weights come from checkpoints). ``init_dit=False`` leaves the
        DiT out (``dit`` None): the quantized 14B path streams its trunk in
        (:func:`..models.quantized.quantize_host_blocks`) without the bf16
        trunk ever being made. ``init_vae=False`` leaves the VAE out (a
        parallel run's rank other than 0); ``dit_keep`` builds a pipeline
        stage's DiT (:meth:`.ti2v.TI2VPipeline.from_config`)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        factories = _factories(config, dtype, dit=init_dit, vae=init_vae, t5=init_t5,
                               clip=init_clip and config.clip is not None)
        return cls(config, *build_modules(factories, device, generator=gen, dit_keep=dit_keep))

    @classmethod
    def from_state_dicts(cls, config: PipelineConfig, dit_sd: Optional[Mapping],
                         vae_sd: Optional[Mapping],
                         t5_sd: Optional[Mapping] = None, clip_sd: Optional[Mapping] = None,
                         *, device="cuda", dit_keep: Optional[Callable[[str], bool]] = None,
                         dtype: torch.dtype = torch.bfloat16) -> "I2VPipeline":
        """Pipeline from the port's state dicts (reference names; torch
        tensors or numpy arrays), loaded strictly, stored and computed in
        ``dtype``. ``clip_sd`` holds the visual tower's tensors without the
        released file's ``visual.`` prefix; a state dict of None leaves its
        module out; ``dit_keep`` as :meth:`from_config`."""
        factories = _factories(config, dtype, dit=dit_sd is not None, vae=vae_sd is not None,
                               t5=t5_sd is not None, clip=clip_sd is not None)
        return cls(config, *build_modules(factories, device, dit_keep=dit_keep,
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

    def parallelize_pp(self, stages: int, groups: Optional[PPGroups] = None) -> int:
        """Stage the bf16 trunk over ``stages`` ranks (``groups``, default the
        whole default group), the unquantized route to a multi-card 14B: this
        rank keeps its stage's blocks and the CFG Euler sampler runs through
        :func:`..parallel.pipeline.pp_dit_forward`. Returns the DiT bytes this
        rank holds. Refuses a quantized trunk."""
        return stage_dit(self, stages, groups)

    # -- conditioning --------------------------------------------------------

    def _phase(self, name: str):
        if self.phase_cb is not None:
            self.phase_cb(name)

    def _from_rank0(self, fn):
        """``fn()`` on rank 0 of a parallel run, its result on every rank."""
        return from_rank0(fn, run_group(self), self.device)

    @torch.no_grad()
    def encode_text(self, ids, mask) -> torch.Tensor:
        """[B, text_len] ids and mask → [B, text_len, text_dim] fp32 context
        with the padding zeroed (umT5 on rank 0 of a parallel run)."""

        def encode():
            assert self.t5 is not None, "pipeline built without a text encoder"
            # umT5's own device: under the phase shuttle the DiT may be parked
            device = next(self.t5.parameters()).device
            return encode_text(self.t5, torch.as_tensor(np.asarray(ids), device=device),
                               torch.as_tensor(np.asarray(mask), device=device)).float()
        return self._from_rank0(encode)

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
        latents back to fp32). On a parallel run's rank other than 0, the
        video's shape on the meta device."""
        s = self.config.vae.stride
        if not on_rank0(self):
            return decoded_placeholder(z, s)
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
        the CLIP features to it. Sequence-parallel when ``sp_groups`` is set,
        pipelined when ``pp_groups`` is."""
        lfz = self.config.latent_frame_zero
        dit = self.dit

        def fwd(latent, t_frame, context, **kw):
            reps = latent.shape[0] // y.shape[0]
            y_ = y.repeat(reps, *([1] * (y.dim() - 1))) if reps > 1 else y
            clip_ = (clip_ctx.repeat(reps, 1, 1) if reps > 1 and clip_ctx is not None
                     else clip_ctx)
            x_in = torch.cat([latent, y_.to(latent.dtype)], dim=-1).to(torch.bfloat16)
            out = dit_forward(self, dit, x_in, t_frame, context, latent_frame_zero=lfz,
                              clip_context=clip_, **kw)
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
            decide = None
            if self.sp_groups is not None:
                decide = functools.partial(agree, group=self.sp_groups.group)
            return samplers.cfg_euler_sample_segment_cached_adaptive(
                *args, threshold=cache_threshold, decide=decide)
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
        overrides the seeded fp32 noise.

        With ``sp_groups`` or ``pp_groups`` set every rank makes this call
        with the same arguments. Rank 0 computes the conditioning, the
        seeded noise and churn draws and hands them to every rank; the other
        ranks use ``cond_frames`` for its shape only (a meta tensor will do)
        and get the video as a meta tensor of its shape."""
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
        if self.pp_groups is not None and sampler != "euler":
            raise NotImplementedError(f"pp trunk supports the euler sampler, got {sampler!r}")
        if self.sp_groups is not None and is_quantized(self.dit):
            raise NotImplementedError(
                "the int8/int4 storage trunk is single-chip; use --w8a8 (dynamic int8 "
                "matmuls) for quantized SP serving")

        def condition():
            y = self.make_conditioning(cond_frames, frame_num, history_mode=history_mode)
            clip_frame = cond_frames[:, -1] if history_mode else cond_frames[:, 0]
            return y, self.clip_features(clip_frame) if self.clip is not None else None

        self._phase("vae")
        y, clip_ctx = self._from_rank0(condition)
        self._phase("dit")
        device = y.device
        if noise is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            noise = self._from_rank0(lambda: torch.randn(
                (b, f_lat, h // s[1], w // s[2], self.config.vae.z_dim), generator=gen,
                device=device, dtype=torch.float32))
        noise = noise.to(device)
        args = (noise, y, ctx, ctx_null, clip_ctx, steps, shift, guide_scale)
        if sampler == "teacache":
            latents, self.last_teacache_n_full = self._sample_cfg_teacache(
                *args, teacache_interval, teacache_edge, teacache_threshold)
        elif sampler in _TTS_SAMPLERS:
            if churn_noise is None:
                gen = torch.Generator(device=device).manual_seed(seed + _TTS_SEED_OFFSET)

                def noise_fn(shape):
                    return self._from_rank0(lambda: torch.randn(
                        shape, generator=gen, device=device, dtype=torch.float32))
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
