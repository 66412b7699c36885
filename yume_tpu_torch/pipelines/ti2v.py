"""Yume-1.5 (Wan2.2-TI2V-5B) generation pipeline in PyTorch (counterpart of
yume_tpu/pipelines/ti2v.py).

A rollout starts from a prompt with the text-to-video first segment
(:meth:`TI2VPipeline.generate_t2v`: every latent frame at full resolution
through the unpacked DiT). Each later request is one autoregressive
continuation segment: the umT5 prompt encode
(:meth:`TI2VPipeline.encode_text`), a segment sampler over the
FramePack-packed DiT (:meth:`TI2VPipeline.generate_segment`) and the
streaming VAE decode of the new tail (:meth:`TI2VPipeline.decode_auto`).
:meth:`TI2VPipeline.generate_long` runs one segment per caption. A rollout
can also start from video: :meth:`TI2VPipeline.encode_auto` (a decoded
first segment, re-encoded before the CLI continues it) or
:meth:`TI2VPipeline.encode_image_conditioning` (repeated image frames).

Ported: ``generate_t2v`` with Euler (the 5B t2v path), UniPC of order 2 and
3 and DPM++2M, the multistep solvers with classifier-free guidance
(``ctx_null``); ``generate_t2v_dmd``, the distillation teacher's cond-only
rollout; the segment samplers ``euler`` (with ``progress_cb``),
``teacache`` (fixed interval and adaptive threshold) and the TTS samplers
``sde``, ``time_travel`` and ``tts`` (both); W8A8 through
``config.dit.w8a8`` (:meth:`TI2VPipeline.with_w8a8` builds it on the same
DiT parameters), in both forwards; the VAE encode and the width-tiled
decode (:meth:`TI2VPipeline.decode_tiled`). The 14B i2v pipeline is
:mod:`.i2v`.

The int8/int4 trunk (:meth:`TI2VPipeline.quantize_int8`,
:mod:`..models.quantized`) replaces the bf16 one in place and runs
``generate_t2v`` (Euler and the multistep solvers) and the segment samplers
``euler`` and ``teacache`` (in the reference's delta-cache form,
``cache_edge``), the samplers the reference routes to its
``int8_dit_apply``; the TTS samplers and sequence parallelism refuse it, as
the reference's do.

Sequence-parallel serving (the JAX pipeline's ``mesh``/``sp_kind``): with
``sp_groups`` set, the pipeline is one rank of a run in which every rank
holds the whole DiT and calls :meth:`TI2VPipeline.generate_segment` with
the same arguments; each DiT forward of a segment shards its tokens over
the group (:func:`..parallel.sp_forward.sp_dit_forward`, kind ``sp_kind``)
and every rank gets the same latents. The t2v first segment runs unsharded,
as the JAX pipeline runs it outside its mesh, once on rank 0, whose latents
the other ranks receive. W8A8 composes: each rank quantizes its own tokens.
TeaCache's residual cache stays on each rank's tokens, and the adaptive
refresh decision is rank 0's on every rank, so the ranks always run the
same collectives.

Pipeline-parallel serving (the JAX ``parallelize_pp``): with ``pp_groups``
set (:meth:`TI2VPipeline.parallelize_pp`) each rank holds one stage of the
bf16 trunk, and every DiT forward of ``generate_t2v`` (Euler and the
multistep solvers) and of the Euler segment sampler runs through
:func:`..parallel.pipeline.pp_dit_forward`, the same on every rank.

In either run only rank 0 needs umT5 and the VAE (``from_config(init_t5=
False, init_vae=False)`` elsewhere): :meth:`TI2VPipeline.encode_text`, the
VAE encodes, the seeded noise and a sequence-parallel t2v segment are
computed there and handed to every rank (:func:`..parallel.mesh.from_rank0`),
and the decodes run there alone. On the other ranks a decoded video is a
meta tensor of its shape, so every rank can make the same calls.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import PipelineConfig
from ..diffusion import multistep, samplers
from ..diffusion.schedule import sampling_sigmas, unipc_sigmas
from ..models.dit import WanDiT
from ..models.quantized import is_quantized, quantize_dit_blocks
from ..models.t5 import T5Encoder, encode_text
from ..models.vae import WanVAE, streaming_decode, streaming_encode
from ..parallel.mesh import SPGroups, from_rank0
from ..parallel.pipeline import PPGroups
from ..parallel.route import decoded_placeholder, dit_forward, on_rank0, run_group, stage_dit
from ..parallel.ulysses import agree
from ..utils.convert import load_state_dict
from ..utils.masks import masks_like
from .tiled_decode import tiled_decode

# the samplers whose every DiT call goes through _dit (and so through the
# sequence-parallel forward when sp_groups is set)
_SP_SAMPLERS = ("euler", "teacache")
_TTS_SAMPLERS = ("sde", "time_travel", "tts")
# the churn noise of a TTS segment comes from a generator seeded seed + this,
# as the reference's PRNGKey(seed + 7919)
_TTS_SEED_OFFSET = 7919
# generate_t2v's solvers; the UniPC ones with their order
_T2V_SOLVERS = {"euler": None, "dpmpp": None, "unipc": 2, "unipc3": 3}


def _materialize(factory: Callable[..., nn.Module], device,
                 keep: Optional[Callable[[str], bool]] = None) -> nn.Module:
    """Build a module without allocating or initialising on the host: on
    the meta device first, then uninitialised storage on ``device``; with
    ``keep``, only for the parameters whose names it accepts (the others
    stay on the meta device: a pipeline stage's DiT)."""
    module = factory(device="meta")
    if keep is None:
        return module.to_empty(device=device)
    for name, sub in module.named_modules():
        for attr, p in list(sub.named_parameters(recurse=False)):
            if keep(f"{name}.{attr}" if name else attr):
                sub.register_parameter(attr, nn.Parameter(torch.empty_like(p, device=device),
                                                          requires_grad=p.requires_grad))
    return module


@torch.no_grad()
def _random_init_(module: nn.Module, generator: torch.Generator, std: float = 0.02):
    """Random weights for smoke runs: N(0, std) for every tensor with more
    than one element, zero for scalars (as the reference's bf16 init). A
    parameter on the meta device is drawn and dropped, so the ones kept get
    the values they have in the whole module."""
    for p in module.parameters():
        if p.numel() <= 1:
            p.zero_()
        elif p.is_meta:
            torch.empty(p.shape, dtype=p.dtype, device=generator.device).normal_(
                0.0, std, generator=generator)
        else:
            p.normal_(0.0, std, generator=generator)


def module_factories(config: PipelineConfig, dtype: torch.dtype):
    """The DiT's, the VAE's and umT5's factories (``factory(device=...)``),
    stored and computed in ``dtype``."""
    return (lambda device: WanDiT(config.dit, dtype, device=device, param_dtype=dtype),
            lambda device: WanVAE(config.vae, device=device, dtype=dtype),
            lambda device: T5Encoder(config.t5, dtype, device=device, param_dtype=dtype))


def build_modules(factories, device, *, generator: Optional[torch.Generator] = None,
                  state_dicts: Optional[tuple] = None,
                  dit_keep: Optional[Callable[[str], bool]] = None) -> list:
    """One module a factory (None: left out), built on ``device`` in eval
    mode: loaded strictly from the state dict in the same place of
    ``state_dicts`` or, without them, drawn in order from ``generator``.
    ``dit_keep`` materializes only the first module's (the DiT's)
    parameters it accepts (:func:`_materialize`)."""
    out = []
    for i, factory in enumerate(factories):
        module = None
        if factory is not None:
            module = _materialize(factory, device, dit_keep if i == 0 else None)
            if state_dicts is None:
                _random_init_(module, generator)
            else:
                load_state_dict(module, state_dicts[i])
            module.eval()
        out.append(module)
    return out


def w8a8_twin(config: PipelineConfig, dit: WanDiT) -> Tuple[PipelineConfig, WanDiT]:
    """``config`` with ``dit.w8a8`` on, and a second ``WanDiT`` in that mode
    whose parameters are ``dit``'s own tensors (no copy). Its int8 weights
    are made on first use."""
    dit_cfg = dataclasses.replace(config.dit, w8a8=True)
    twin = WanDiT(dit_cfg, dit.dtype, device="meta")
    twin.load_state_dict(dit.state_dict(), assign=True)
    return dataclasses.replace(config, dit=dit_cfg), twin.eval()


@dataclasses.dataclass(eq=False)
class TI2VPipeline:
    """The 5B generation stack: DiT, VAE and (optionally) umT5."""

    config: PipelineConfig
    dit: WanDiT
    vae: WanVAE
    t5: Optional[T5Encoder] = None
    # full-DiT steps of the last sampler="teacache" segment
    last_teacache_n_full: Optional[int] = None
    # sequence-parallel serving: this rank's groups and the attention kind
    # ("ulysses", "ring" or "usp")
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
                    init_t5: bool = False, init_dit: bool = True, init_vae: bool = True,
                    dit_keep: Optional[Callable[[str], bool]] = None,
                    dtype: torch.dtype = torch.bfloat16) -> "TI2VPipeline":
        """Random-initialised pipeline at the config's full width, allocated
        and initialised directly on ``device`` from a seeded
        ``torch.Generator`` (real weights come from checkpoints). Without
        ``init_dit`` it holds only the encoders and the VAE (the trainer's
        encode path); without ``init_vae`` no VAE (a parallel run's rank
        other than 0). ``dit_keep`` builds only the DiT parameters it
        accepts (a pipeline stage, :func:`..parallel.pipeline.stage_keep`),
        with the values they have in the whole DiT."""
        gen = torch.Generator(device=device).manual_seed(seed)
        dit_f, vae_f, t5_f = module_factories(config, dtype)
        return cls(config, *build_modules((dit_f if init_dit else None,
                                           vae_f if init_vae else None,
                                           t5_f if init_t5 else None), device, generator=gen,
                                          dit_keep=dit_keep))

    @classmethod
    def from_state_dicts(cls, config: PipelineConfig, dit_sd: Optional[Mapping],
                         vae_sd: Optional[Mapping], t5_sd: Optional[Mapping] = None, *,
                         device="cuda", dit_keep: Optional[Callable[[str], bool]] = None,
                         dtype: torch.dtype = torch.bfloat16) -> "TI2VPipeline":
        """Pipeline from reference-named state dicts (torch tensors or numpy
        arrays, e.g. from :mod:`..utils.convert`), loaded strictly, stored
        and computed in ``dtype``; a state dict of None leaves its module
        out; ``dit_keep`` as :meth:`from_config`."""
        dit_f, vae_f, t5_f = module_factories(config, dtype)
        return cls(config, *build_modules(
            (dit_f if dit_sd is not None else None, vae_f if vae_sd is not None else None,
             t5_f if t5_sd is not None else None),
            device, state_dicts=(dit_sd, vae_sd, t5_sd), dit_keep=dit_keep))

    def with_w8a8(self) -> "TI2VPipeline":
        """This pipeline with ``config.dit.w8a8`` on (:func:`w8a8_twin`),
        beside the same VAE and text encoder."""
        config, dit = w8a8_twin(self.config, self.dit)
        return dataclasses.replace(self, config=config, dit=dit, last_teacache_n_full=None)

    def quantize_int8(self, bits: int = 8):
        """Quantize the DiT trunk in place (int8, or int4 with ``bits=4``;
        :func:`..models.quantized.quantize_dit_blocks`): its bf16 block
        weights are freed. A no-op on a quantized trunk."""
        if not is_quantized(self.dit):
            quantize_dit_blocks(self.dit, bits)

    def parallelize_pp(self, stages: int, groups: Optional[PPGroups] = None) -> int:
        """Stage the bf16 trunk over ``stages`` ranks (``groups``, default
        the whole default group): this rank keeps its stage's blocks, and
        ``generate_t2v`` and the Euler segment sampler run through
        :func:`..parallel.pipeline.pp_dit_forward`. Returns the DiT bytes
        this rank holds. Refuses a quantized trunk (the JAX
        ``parallelize_pp`` skips it and serves it unstaged)."""
        return stage_dit(self, stages, groups)

    # -- conditioning --------------------------------------------------------

    def _from_rank0(self, fn):
        """``fn()`` on rank 0 of a parallel run, its result on every rank
        (:func:`..parallel.mesh.from_rank0`); alone, ``fn()``."""
        return from_rank0(fn, run_group(self), self.device)

    @torch.no_grad()
    def encode_text(self, ids, mask) -> torch.Tensor:
        """[B, text_len] ids and mask → [B, text_len, text_dim] fp32 context
        with the padding zeroed (umT5 on rank 0 of a parallel run)."""

        def encode():
            assert self.t5 is not None, "pipeline built without a text encoder"
            dev = next(self.t5.parameters()).device
            return encode_text(self.t5, torch.as_tensor(np.asarray(ids), device=dev),
                               torch.as_tensor(np.asarray(mask), device=dev)).float()
        return self._from_rank0(encode)

    # -- generation ----------------------------------------------------------

    def _dit(self, lat, t_frame, ctx, **kw):
        """Packed DiT forward on ``lat``, sequence-parallel when
        ``sp_groups`` is set, pipelined when ``pp_groups`` is; the
        reference feeds the DiT a bf16 latent whatever its dtype."""
        return dit_forward(self, self.dit, lat.to(torch.bfloat16), t_frame, ctx,
                           latent_frame_zero=self.config.latent_frame_zero, **kw)

    @staticmethod
    def _pad_v(lat, out):
        """Tail velocity spliced into a full-length tensor (zeros over the
        history)."""
        pad = torch.zeros_like(lat[:, : lat.shape[1] - out.shape[1]])
        return torch.cat([pad, out.to(lat.dtype)], dim=1)

    def _sample_segment_teacache(self, latent, ctx, history_t, steps, shift,
                                 cache_interval=2, cache_edge=None,
                                 cache_threshold=None):
        """Euler tail sampling with block-residual caching (TeaCache;
        reference wan/modules/model.py:977-998): the full DiT every
        ``cache_interval`` steps, or whenever the accumulated rel-L1 change
        reaches ``cache_threshold``; in between, the middle blocks are
        skipped and their stored residuals added back. ``cache_edge`` live
        blocks per side are recomputed on cached steps (None → n // 4).
        Returns (latent, n_full)."""
        sig = sampling_sigmas(steps, shift)
        lfz = self.config.latent_frame_zero
        n = self.config.dit.num_layers
        edge = n // 4 if cache_edge is None else max(1, int(cache_edge))
        # a quantized trunk caches the middle chunk's delta (as the
        # reference's int8_dit_apply), the bf16 one each middle block's residual
        kw = (dict(cache_edge=edge) if is_quantized(self.dit)
              else dict(cache_list=tuple(range(edge, n - edge))))

        def full(lat, t_frame):
            out, cache = self._dit(lat, t_frame, ctx, return_cache=True, **kw)
            return self._pad_v(lat, out), cache

        def cached(lat, t_frame, cache):
            return self._pad_v(lat, self._dit(lat, t_frame, ctx, block_cache=cache, **kw))

        if cache_threshold is not None:
            decide = None
            if self.sp_groups is not None:
                decide = functools.partial(agree, group=self.sp_groups.group)
            return samplers.euler_sample_segment_cached_adaptive(
                full, cached, latent, sig, lfz, threshold=cache_threshold,
                history_t=history_t, decide=decide)
        out = samplers.euler_sample_segment_cached(
            full, cached, latent, sig, lfz, cache_interval=cache_interval,
            history_t=history_t)
        return out, -(-steps // cache_interval)

    def _sample_segment_tts(self, latent, ctx, history_t, steps, shift, mode, noise_fn):
        """The TTS samplers (reference sample_tts.py): 'sde' churn,
        'time_travel' lookahead, or 'tts', both."""
        lfz = self.config.latent_frame_zero
        sig = sampling_sigmas(steps, shift)

        def denoise(lat, t_frame):
            return self._pad_v(lat, self._dit(lat, t_frame, ctx))

        if mode == "sde":
            return samplers.sde_euler_sample_segment(denoise, latent, sig, lfz, noise_fn,
                                                     history_t=history_t)
        return samplers.time_travel_sample_segment(denoise, latent, sig, lfz,
                                                   history_t=history_t, sde=mode == "tts",
                                                   noise_fn=noise_fn)

    @torch.no_grad()
    def generate_segment(
        self,
        history_latents: torch.Tensor,
        ctx: torch.Tensor,
        *,
        steps: int = 4,
        shift: float = 7.0,
        seed: int = 0,
        sampler: str = "euler",
        progress_cb: Optional[Callable[[float], None]] = None,
        noise: Optional[torch.Tensor] = None,
        churn_noise: Optional[Iterable[torch.Tensor]] = None,
        teacache_interval: int = 3,
        teacache_edge: Optional[int] = None,
        teacache_threshold: Optional[float] = None,
    ) -> torch.Tensor:
        """One autoregressive continuation: append ``latent_frame_zero``
        noise frames after the history, denoise them with the packed DiT
        (per-frame timesteps), return the grown latent sequence. ``noise``
        overrides the seeded tail noise.

        ``sampler``: 'euler'; 'teacache' (block-residual caching: the full
        DiT every ``teacache_interval``-th step, or, with
        ``teacache_threshold``, whenever the accumulated rel-L1 change of
        the tail reaches it; ``teacache_edge`` live blocks per side on
        cached steps, None → num_layers // 4; the segment's full-DiT step
        count is left in ``last_teacache_n_full``); or the TTS samplers
        'sde' (SDE churn), 'time_travel' (lookahead) and 'tts' (both), whose
        churn draws come from a generator seeded ``seed + 7919``, or in
        order from ``churn_noise``.

        ``progress_cb(t)`` is called once per Euler step (sampler 'euler'
        only, as the reference) with the step's timestep σ_i·1000, the value
        the reference's callback receives, computed on the host from the
        sigma table: it reads nothing from the device.

        With ``sp_groups`` or ``pp_groups`` set every rank of the group makes
        this call with the same arguments (the same history, context, seed or
        noise); the seeded noise is rank 0's."""
        if self.sp_groups is not None and sampler not in _SP_SAMPLERS:
            raise NotImplementedError(
                f"SP serving runs the samplers {_SP_SAMPLERS}, not {sampler!r}")
        if self.pp_groups is not None and sampler != "euler":
            raise NotImplementedError(f"pp trunk supports the euler sampler, got {sampler!r}")
        if sampler not in _SP_SAMPLERS + _TTS_SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}")
        if is_quantized(self.dit) and sampler not in _SP_SAMPLERS:
            raise NotImplementedError(
                f"int8 trunk supports euler/teacache samplers, got {sampler!r}")
        if is_quantized(self.dit) and self.sp_groups is not None:
            raise NotImplementedError(
                "the int8/int4 storage trunk is single-chip; use --w8a8 (dynamic int8 "
                "matmuls) for quantized SP serving")
        if sampler == "teacache" and teacache_interval < 1:
            raise ValueError(f"teacache_interval must be >= 1, got {teacache_interval}")
        lfz = self.config.latent_frame_zero
        b, f_hist, h, w, c = history_latents.shape
        device = history_latents.device
        if noise is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            noise = self._from_rank0(lambda: torch.randn(
                (b, lfz, h, w, c), generator=gen, device=device, dtype=torch.float32))
        # jnp.concatenate promotes: a bf16 history with fp32 noise is an fp32
        # latent, so the tail integrates in fp32
        dtype = torch.promote_types(history_latents.dtype, noise.dtype)
        latent = torch.cat([history_latents.to(dtype), noise.to(dtype)], dim=1)
        history_t = torch.zeros((b, f_hist), dtype=torch.float32, device=device)
        if sampler == "teacache":
            out, self.last_teacache_n_full = self._sample_segment_teacache(
                latent, ctx, history_t, steps, shift, teacache_interval,
                teacache_edge, teacache_threshold)
            return out
        if sampler in _TTS_SAMPLERS:
            if churn_noise is None:
                gen = torch.Generator(device=device).manual_seed(seed + _TTS_SEED_OFFSET)

                def noise_fn(shape):
                    return torch.randn(shape, generator=gen, device=device,
                                       dtype=torch.float32)
            else:
                draws = iter(churn_noise)

                def noise_fn(shape):
                    return next(draws).to(device).reshape(shape)
            return self._sample_segment_tts(latent, ctx, history_t, steps, shift, sampler,
                                            noise_fn)
        sig = sampling_sigmas(steps, shift)

        def denoise(lat, t_frame):
            return self._pad_v(lat, self._dit(lat, t_frame, ctx))

        if progress_cb is not None:
            t_steps = iter(np.float32(sig[:-1]) * np.float32(1000.0))
            dit_fn = denoise

            def denoise(lat, t_frame):
                progress_cb(float(next(t_steps)))
                return dit_fn(lat, t_frame)

        return samplers.euler_sample_segment(denoise, latent, sig, lfz, history_t=history_t)

    # -- text to video: the first segment ------------------------------------

    def _t2v_dit(self, params) -> WanDiT:
        """The DiT a t2v rollout runs: this pipeline's, or ``params`` (a
        :class:`WanDiT`, bf16 or quantized, e.g. a distillation teacher)."""
        if params is None:
            return self.dit
        if isinstance(params, WanDiT):
            return params
        if isinstance(params, tuple):
            raise NotImplementedError(
                "the port's quantized trunk is a WanDiT (models/quantized.py: "
                "quantize_dit_blocks), not the reference's (other, stacked) tuple")
        raise NotImplementedError(
            f"DiT parameters of type {type(params).__name__}: pass a WanDiT (pipeline "
            "parallelism, ROADMAP queue 1 item 8, stages a pipeline's own trunk with "
            "parallelize_pp, not the reference's PPParams)")

    def _unpacked_fn(self, dit: WanDiT):
        """The unpacked forward on a bf16 latent (as the reference feeds the
        DiT), its velocity cast back to the latent's dtype (fp32); pipelined
        when ``dit`` is this pipeline's staged trunk."""

        def fwd(x, t_frame, ctx):
            return dit_forward(self, dit, x.to(torch.bfloat16), t_frame, ctx,
                               packed=False).to(x.dtype)
        return fwd

    def _sample_t2v(self, dit, noise, ctx, steps, shift):
        fwd = self._unpacked_fn(dit)
        return samplers.euler_sample(lambda lat, t_frame: fwd(lat, t_frame, ctx), noise,
                                     sampling_sigmas(steps, shift))

    def _sample_t2v_multistep(self, dit, noise, ctx, ctx_null, steps, shift, solver,
                              guide_scale):
        """The stock multistep t2v loop (reference WanT2V.generate,
        wan/text2video.py:110-267): UniPC or DPM++, with CFG when
        ``ctx_null`` is given: cond and uncond as two forwards of the
        latent's batch, blended in fp32."""
        fwd = self._unpacked_fn(dit)
        b, f = noise.shape[:2]

        def model(x, sigma):
            t_frame = (sigma[:, None] * 1000.0).expand(b, f)
            v = fwd(x, t_frame, ctx)
            if ctx_null is not None:
                v_u = fwd(x, t_frame, ctx_null)
                v = v_u + guide_scale * (v - v_u)
            return v

        if solver == "dpmpp":
            return multistep.sample_dpmpp_2m(model, noise, sampling_sigmas(steps, shift))
        # UniPC: the scheduler's own ladder (σ_max = 1 − 1/N)
        return multistep.sample_unipc(model, noise, unipc_sigmas(steps, shift),
                                      order=_T2V_SOLVERS[solver])

    def _t2v(self, dit, ctx, size, frame_num, steps, shift, seed, solver, ctx_null,
             guide_scale, return_latents, noise):
        if solver not in _T2V_SOLVERS:
            raise ValueError(f"solver must be one of {sorted(_T2V_SOLVERS)}, got {solver!r}")
        cfgv = self.config.vae
        f_lat = (frame_num - 1) // cfgv.stride[0] + 1
        h_lat, w_lat = size[1] // cfgv.stride[1], size[0] // cfgv.stride[2]

        def draw():
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return torch.randn((ctx.shape[0], f_lat, h_lat, w_lat, cfgv.z_dim),
                               generator=gen, device=self.device, dtype=torch.float32)

        def sample(noise):
            if solver == "euler":
                return self._sample_t2v(dit, noise, ctx, steps, shift)
            return self._sample_t2v_multistep(dit, noise, ctx, ctx_null, steps, shift,
                                              solver, guide_scale)
        if self.sp_groups is not None:
            # dense, as outside the JAX mesh: once, on rank 0
            latent = self._from_rank0(lambda: sample(draw() if noise is None else noise))
        else:
            # every stage of a pipelined trunk runs it, on rank 0's noise
            latent = sample(self._from_rank0(draw) if noise is None else noise)
        return latent if return_latents else self.decode_auto(latent)

    @torch.no_grad()
    def generate_t2v(
        self,
        ctx: torch.Tensor,
        *,
        size: Tuple[int, int] = (1280, 704),
        frame_num: int = 121,
        steps: int = 50,
        shift: Optional[float] = None,
        seed: int = 0,
        solver: str = "euler",
        ctx_null: Optional[torch.Tensor] = None,
        guide_scale: float = 5.0,
        return_latents: bool = False,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Text to video, the first segment of a rollout: ``frame_num``
        frames of ``size`` (width, height), every latent frame denoised at
        full resolution by the unpacked DiT. ``solver='euler'`` is the 5B
        t2v path (no CFG); 'unipc', 'unipc3' (order 3) and 'dpmpp' are the
        stock Wan T2V multistep loop, with CFG at ``guide_scale`` when
        ``ctx_null`` is given. ``noise`` [B, F_lat, H_lat, W_lat, z]
        overrides the seeded fp32 noise. Returns the latents
        (``return_latents``, the history :meth:`generate_segment` continues)
        or the video [B, frame_num, H, W, 3] in [-1, 1]. With ``sp_groups``
        rank 0 runs the segment unsharded and hands its latents to every
        rank; with ``pp_groups`` every rank runs it, staged."""
        shift = self.config.sample_shift if shift is None else shift
        return self._t2v(self.dit, ctx, size, frame_num, steps, shift, seed, solver,
                         ctx_null, guide_scale, return_latents, noise)

    @torch.no_grad()
    def generate_t2v_dmd(
        self,
        ctx: torch.Tensor,
        *,
        teacher_params: Optional[WanDiT] = None,
        size: Tuple[int, int] = (1280, 704),
        frame_num: int = 81,
        steps: int = 8,
        shift: float = 5.0,
        solver: str = "unipc",
        seed: int = 0,
        noise: Optional[torch.Tensor] = None,
        return_latents: bool = True,
    ) -> torch.Tensor:
        """DMD teacher rollout (reference ``t2v_dmd``,
        wan23/textimage2video.py:519-653): a cond-only few-step trajectory
        (guidance baked into the teacher) on ``teacher_params``, a
        :class:`WanDiT` (this pipeline's DiT when None). Returns latents by
        default (distillation targets)."""
        return self._t2v(self._t2v_dit(teacher_params), ctx, size, frame_num, steps,
                         shift, seed, solver, None, 1.0, return_latents, noise)

    @torch.no_grad()
    def decode_auto(self, z: torch.Tensor) -> torch.Tensor:
        """Streaming decode in chunks of 2 latent frames, in the VAE's
        parameter dtype, without width tiling (the reference's tiling was
        sized for a 16 GB chip); equal to ``WanVAE.decode``. On a parallel
        run's rank other than 0, the video's shape on the meta device."""
        if not on_rank0(self):
            return decoded_placeholder(z, self.config.vae.stride)
        vae_dtype = next(self.vae.parameters()).dtype
        return streaming_decode(self.vae, z.to(vae_dtype), chunk_latent_frames=2)

    def decode_tiled(self, z: torch.Tensor, n_tiles: int = 5) -> torch.Tensor:
        """Width-tiled decode with blended overlaps (the webapp's large-frame
        decode; :func:`.tiled_decode.tiled_decode`), each tile through the
        streaming :meth:`decode_auto`, which bounds its peak."""
        if not on_rank0(self):
            return decoded_placeholder(z, self.config.vae.stride)
        return tiled_decode(self.decode_auto, z, n_tiles=n_tiles,
                            scale_factor=self.config.vae.stride[1])

    # -- video to latents ----------------------------------------------------

    @torch.no_grad()
    def encode_auto(self, video: torch.Tensor) -> torch.Tensor:
        """Video [B, T, H, W, 3] in [-1, 1] → normalised latents: one
        full-clip encode in the video's dtype while its largest activation
        (T·H·W·160 channels·2 bytes) stays under 2 GiB, otherwise the
        streaming encode (pixel frame 0, then chunks of 4) in the VAE's
        parameter dtype. Both compute the same function. On rank 0 of a
        parallel run, handed to every rank (``video`` is read there only)."""

        def encode():
            pixels = video.shape[1] * video.shape[2] * video.shape[3]
            if pixels * 160 * 2 < (2 << 30):
                return self.vae.encode(video)
            vae_dtype = next(self.vae.parameters()).dtype
            return streaming_encode(self.vae, video.to(vae_dtype))
        return self._from_rank0(encode)

    @torch.no_grad()
    def encode_image_conditioning(self, img: torch.Tensor,
                                  frame_num: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """i2v conditioning (reference wan23/textimage2video.py:381-517):
        encode the (repeated) conditioning frames ``img`` [B, T, H, W, 3],
        zero-pad the latents to ``frame_num``'s latent length, and return
        them with ``masks_like``'s mask2 (zero over the history, one over
        the trailing ``latent_frame_zero`` frames). Encoded on rank 0 of a
        parallel run, handed to every rank."""
        z = self._from_rank0(lambda: self.vae.encode(img))
        f_target = (frame_num - 1) // self.config.vae.stride[0] + 1
        pad = f_target - z.shape[1]
        if pad > 0:
            z = torch.cat([z, z.new_zeros((z.shape[0], pad) + tuple(z.shape[2:]))], dim=1)
        _, mask2 = masks_like(tuple(z.shape), zero=True,
                              latent_frame_zero=self.config.latent_frame_zero,
                              device=z.device)
        return z, mask2

    def generate_long(
        self,
        ctxs: List[torch.Tensor],
        first_segment: torch.Tensor,
        *,
        steps: int = 4,
        shift: float = 7.0,
        seed: int = 0,
        sampler: str = "euler",
        teacache_interval: int = 3,
        teacache_edge: Optional[int] = None,
        teacache_threshold: Optional[float] = None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Autoregressive rollout: one segment per context in ``ctxs`` after
        ``first_segment`` [B, F0, h, w, z], each with the sampler arguments
        of :meth:`generate_segment`. Returns (full latent sequence, decoded
        tail videos)."""
        latents = first_segment
        videos = []
        for s, ctx in enumerate(ctxs):
            latents = self.generate_segment(
                latents, ctx, steps=steps, shift=shift, seed=seed + s + 1,
                sampler=sampler, teacache_interval=teacache_interval,
                teacache_edge=teacache_edge, teacache_threshold=teacache_threshold)
            videos.append(self.decode_auto(latents[:, -self.config.latent_frame_zero:]))
        return latents, videos
