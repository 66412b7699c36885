"""Sampling entry point (counterpart of yume_tpu/sample.py). The 5B model
(``--config ti2v-5B``): a text-to-video or image-conditioned first segment,
then autoregressive continuation segments, one per caption. The 14B model
(``--config i2v-14B``, Yume-1.0): an image-conditioned first segment of
``frame_num`` frames with classifier-free guidance, then one
``generate_next`` of 32 new frames per caption, each re-conditioned on the
whole video so far.

The video-input mode (``--input_video`` clip.mp4, or ``--video_root_dir``
scanning ``<dir>/<category>/*.mp4`` with sibling ``.txt`` control files,
the reference's ``mp4_data`` over ``test_video/``) continues generation
from the first ``--video_frames`` frames of each clip, captioned from its
key/mouse controls: on the 5B the clip is VAE-encoded as history latents
and ``--sample_num`` segments continue it; on the 14B its first frame is
repeated in front of it and each ``generate_next`` re-conditions on the
growing decoded video. Each sample writes ``video<NNN>_seg<SSS>.mp4``.

    python -m yume_tpu_torch.sample --smoke --device cpu --t2v --sample_num 2
    python -m yume_tpu_torch.sample --t2v --steps 4 --w8a8 --teacache   # 5B on the card
    python -m yume_tpu_torch.sample --jpg_dir ./jpg --caption_file caption.txt \
        --ckpt_dir ./Yume-5B-720P
    python -m yume_tpu_torch.sample --video_root_dir ./test_video --sample_num 2
    python -m yume_tpu_torch.sample --config i2v-14B --smoke --device cpu \
        --jpg_dir ./jpg --sample_num 2
    python -m yume_tpu_torch.sample --config i2v-14B --jpg_dir ./jpg --width 960 \
        --height 544 --steps 50 --ckpt_dir ./Yume-I2V-540P   # 14B on the card
    python -m yume_tpu_torch.sample --config i2v-14B --input_video clip.mp4 \
        --width 960 --height 544

Same flags as the reference's CLI, plus ``--device`` (default ``cuda``).
``--smoke`` runs the reference's tiny smoke config; the model computes in
fp32 on the CPU and in bf16 on the card. Without ``--ckpt_dir`` the weights
are random, made from ``--seed`` (speed and capability runs only);
``--ckpt_dir`` loads the released layout (DiT safetensors, sharded with an
index or not, ``Wan2.2_VAE.pth`` or for the 14B ``Wan2.1_VAE.pth``,
``models_t5_umt5-xxl-enc-bf16.pth``, and for the 14B
``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``) strictly.
``--teacache`` refreshes adaptively at a rel-L1 threshold of 0.1 (the
headline configuration) unless ``--teacache_interval`` asks for a fixed
interval. The 14B takes ``--distilled`` (one cond-only forward a step, no
negative prompt); its image mode's continuations run Euler whatever the
sampler, as the reference's, while its video mode passes the sampler to
every ``generate_next``, as the reference's does.

``--int8`` and ``--int4`` store the DiT trunk quantized
(:mod:`.models.quantized`): the 5B quantizes its trunk in place after
loading (a multistep-solver t2v run after its first segment); the 14B never
builds its bf16 trunk: the blocks stream one at a time, from ``--ckpt_dir``'s
safetensors or made from ``--seed`` on the device, into int8 or int4
storage, and under ``--memory_optimization`` the quantized trunk joins the
phase shuttle too. ``--cfg_parallel`` (14B) runs each CFG step's cond and
uncond forwards as one batch-2 forward.

Multi-device serving, from the one command: ``--sp N --sp_kind
{ulysses,ring,usp}`` (sequence parallelism: every rank holds the DiT and
takes 1/N of each forward's tokens) or ``--pp N`` (pipeline parallelism:
rank p holds the p-th of N contiguous stages of the bf16 trunk, the
unquantized route to a multi-card 14B) spawns N ranks itself
(:func:`.parallel.mesh.launch`): NCCL when every rank has a card of its
own, else gloo, the ranks sharing the card. Rank 0 alone holds umT5, the
VAE and CLIP, encodes, decodes and writes; it hands every rank what they
need. The parent prints one line a rank: the DiT bytes it holds, its peak
device memory and its kernel launches. Refused, as the reference refuses
them: ``--sp`` with the int8/int4 trunk or the 5B's TTS samplers, ``--pp``
with a sampler other than Euler. Refused by the port: ``--pp`` with
``--int8/--int4`` (the reference would serve that trunk unstaged) and
``--sp`` with ``--pp``.

``--save_latents`` also writes each segment's latents beside its video
(``segment_000.pt``: the whole latent sequence after it, ``torch.save``).

    python -m yume_tpu_torch.sample --t2v --int8 --w8a8 --teacache       # 5B, int8 trunk
    python -m yume_tpu_torch.sample --config i2v-14B --jpg_dir ./jpg --width 960 \
        --height 544 --int4 --w8a8 --memory_optimization --cfg_parallel
    python -m yume_tpu_torch.sample --jpg_dir ./jpg --sp 4 --sp_kind ulysses  # 4 ranks
    python -m yume_tpu_torch.sample --config i2v-14B --jpg_dir ./jpg --width 960 \
        --height 544 --pp 2                                               # 2 stages
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import warnings

import numpy as np
import torch

# the headline's adaptive TeaCache refresh threshold, --teacache's default
TEACACHE_THRESHOLD = 0.1
DIT_FILES = "DiT (*.safetensors [+ diffusion_pytorch_model.safetensors.index.json])"
VAE_FILE = "Wan2.2_VAE.pth"
VAE21_FILE = "Wan2.1_VAE.pth"
T5_FILE = "models_t5_umt5-xxl-enc-bf16.pth"
CLIP_FILE = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"
# pixel frames each 14B continuation adds (the reference's frame_zero)
I2V_FRAME_ZERO = 32


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="yume_tpu_torch sampling")
    p.add_argument("--config", default="ti2v-5B", choices=["ti2v-5B", "i2v-14B"])
    p.add_argument("--ckpt_dir", default=None, help="dir with DiT/VAE/T5 torch checkpoints")
    p.add_argument("--t2v", action="store_true")
    p.add_argument("--prompt", default="Person moves forward (W).Camera remains still (·).")
    p.add_argument("--neg_prompt", default="")
    p.add_argument("--jpg_dir", default=None,
                   help="image mode: the first .jpg/.png there, repeated 16 frames, "
                        "conditions the first segment")
    p.add_argument("--caption_file", default=None,
                   help="per-line segment control captions (≙ caption.txt)")
    p.add_argument("--video_root_dir", default=None,
                   help="video-input mode: continue generation from each "
                        "<dir>/<category>/*.mp4, captioned from its sibling .txt "
                        "control file (≙ the reference's mp4_data over test_video/)")
    p.add_argument("--input_video", default=None,
                   help="continue generation from one .mp4 (caption from --prompt, "
                        "or a sibling .txt control file)")
    p.add_argument("--video_frames", type=int, default=33,
                   help="frames read from each input video (the reference's 33)")
    p.add_argument("--num_euler_timesteps", "--steps", dest="steps", type=int, default=50)
    p.add_argument("--shift", type=float, default=None)
    p.add_argument("--guide_scale", type=float, default=5.0)
    p.add_argument("--frame_num", type=int, default=None)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=704)
    p.add_argument("--sample_num", type=int, default=1, help="autoregressive segments")
    p.add_argument("--sample_solver", default="euler",
                   choices=["euler", "unipc", "unipc3", "dpmpp"],
                   help="t2v solver (unipc/unipc3/dpmpp = the stock Wan multistep "
                        "loop with CFG)")
    p.add_argument("--sde", action="store_true", help="TTS SDE churn sampling")
    p.add_argument("--time_travel", action="store_true", help="TTS lookahead sampling")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantize the DiT trunk (half the bf16 weight bytes)")
    p.add_argument("--int4", action="store_true",
                   help="group-wise int4 DiT trunk (a quarter of the bf16 weight bytes)")
    p.add_argument("--teacache", action="store_true",
                   help="block-residual caching between the segments' denoise steps; "
                        f"by default the full DiT runs when the accumulated rel-L1 "
                        f"change of the tail reaches {TEACACHE_THRESHOLD} (the headline "
                        f"configuration)")
    p.add_argument("--teacache_interval", type=int, default=None,
                   help="with --teacache: a fixed interval instead of the adaptive "
                        "threshold, the full DiT every N-th step (1 full : N-1 cached). "
                        "A larger N is faster and further from the uncached result; "
                        "pick the largest N whose output quality you accept (the "
                        "reference's default of 3 lost quality to the threshold, 2 is "
                        "more conservative)")
    p.add_argument("--teacache_edge", type=int, default=None,
                   help="with --teacache: live blocks recomputed per side on cached "
                        "steps (default num_layers//4)")
    p.add_argument("--teacache_threshold", type=float, default=None,
                   help=f"with --teacache: the adaptive refresh threshold (default "
                        f"{TEACACHE_THRESHOLD}); not with --teacache_interval")
    p.add_argument("--distilled", action="store_true",
                   help="14B: distilled weights, one cond-only forward a step (no "
                        "negative prompt, Euler)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree: spawns that many ranks, each with the "
                        "whole DiT and 1/N of every forward's tokens")
    p.add_argument("--sp_kind", default="ulysses", choices=["ulysses", "ring", "usp"],
                   help="the attention of --sp: Ulysses all-to-all, ring, or USP (2 x N/2)")
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline-parallel stages of the bf16 trunk: spawns that many "
                        "ranks, each holding 1/N of the blocks (the unquantized route to "
                        "a multi-card 14B); Euler only")
    p.add_argument("--cfg_parallel", action="store_true",
                   help="14B: each CFG step's cond and uncond forwards as one batch-2 "
                        "forward")
    p.add_argument("--w8a8", action="store_true",
                   help="int8 × int8 matmuls for the DiT blocks' projections")
    p.add_argument("--memory_optimization", action="store_true",
                   help="keep umT5 and the VAE (and the 14B's CLIP) in host memory, "
                        "each on the device only for its phase")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_dir", default="./outputs")
    p.add_argument("--smoke", action="store_true", help="tiny shapes, random weights")
    p.add_argument("--tokenizer", default=None,
                   help="local umt5-xxl tokenizer dir (auto-discovered inside "
                        "--ckpt_dir); 'hash' forces the fallback")
    p.add_argument("--refine_prompt", action="store_true",
                   help="refine prompts with the template refiner")
    p.add_argument("--refiner_model", default=None,
                   help="not ported: the HF and remote refiners need model files or a "
                        "network")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler chrome trace of the run here")
    p.add_argument("--device", default="cuda",
                   help="device of the pipeline (cuda or cpu)")
    p.add_argument("--save_latents", action="store_true",
                   help="also write each segment's latents (the whole latent sequence "
                        "after it) beside its video, as <video name>.pt")
    return p


def parallel_world(args) -> int:
    """The ranks a run spawns: ``--sp`` or ``--pp`` when above 1, else 1."""
    return max(args.sp, args.pp, 1)


def refuse_unported(args, webapp: bool = False):
    """Refuse, with a message, the flags that mean nothing for the model
    asked for and the combinations the reference (or the port) refuses;
    the webapp's flags too (the webapp serves the 5B)."""
    i2v = args.config == "i2v-14B"
    if getattr(args, "distilled", False) and not i2v:
        raise SystemExit("--distilled is the 14B pipeline's cond-only serving "
                         "(--config i2v-14B); the 5B segment sampler runs no CFG")
    if getattr(args, "cfg_parallel", False) and not i2v:
        raise SystemExit("--cfg_parallel batches the 14B pipeline's CFG forwards "
                         "(--config i2v-14B); the 5B segment sampler runs no CFG")
    if webapp and args.config != "ti2v-5B":
        raise NotImplementedError(
            "the webapp serves the 5B: its requests run generate_t2v, generate_segment "
            "and the 5B VAE's encodes, which the 14B's I2VPipeline does not have (nor "
            "does the reference's, whose webapp calls them on any --config)")
    bits = _bits(args) or getattr(args, "quant", "none") != "none"
    tts = getattr(args, "sde", False) or getattr(args, "time_travel", False)
    refused = [
        (args.sp > 1 and args.pp > 1,
         "--sp and --pp do not combine: give one of them"),
        (args.sp > 1 and bits,
         "the int8/int4 storage trunk is single-chip; use --w8a8 (dynamic int8 matmuls) "
         "for quantized SP serving"),
        (args.sp > 1 and tts and not i2v,
         "multi-chip SP serving of the 5B supports the euler and teacache samplers; drop "
         "--sp or --sde/--time_travel"),
        (args.pp > 1 and (tts or getattr(args, "teacache", False)),
         "pp trunk supports the euler sampler; drop --teacache/--sde/--time_travel"),
        (args.pp > 1 and bits,
         "--pp stages the bf16 trunk; the int8/int4 trunk is not staged (the reference "
         "would serve it unstaged): drop --int8/--int4 or --pp"),
        (args.sp > 1 and args.sp_kind == "usp" and args.sp % 2,
         f"--sp_kind usp splits the ranks 2 x N/2; --sp {args.sp} is odd"),
    ]
    for flag, why in refused:
        if flag:
            raise NotImplementedError(why)


def teacache_settings(args):
    """(interval, threshold) of ``--teacache``: the adaptive threshold (0.1
    by default), or a fixed interval when ``--teacache_interval`` is given."""
    if args.teacache_interval is None:
        threshold = (TEACACHE_THRESHOLD if args.teacache_threshold is None
                     else args.teacache_threshold)
        return 3, threshold
    if args.teacache_threshold is not None:
        raise SystemExit("give --teacache_interval (fixed) or --teacache_threshold "
                         "(adaptive), not both")
    if args.teacache_interval < 1:
        raise SystemExit(f"--teacache_interval must be >= 1, got {args.teacache_interval}")
    return args.teacache_interval, None


def smoke_config(cfg):
    """The reference's tiny smoke config of the 5B or the 14B
    (yume_tpu/sample.py): the 14B's keeps the msk/y channels and the CLIP
    branch."""
    from .configs import CLIPConfig, DiTConfig, T5Config, VAEConfig

    if cfg.name == "i2v-14B":
        return dataclasses.replace(
            cfg,
            dit=DiTConfig(model_type="i2v", in_dim=18, out_dim=8, dim=128, ffn_dim=256,
                          freq_dim=64, text_dim=32, text_len=32, num_heads=4, num_layers=2,
                          framepack=True, image_context_len=5, image_dim=12),
            vae=VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                          temporal_downsample=(True, False), stride=(2, 4, 4), patchify=1,
                          arch="wan21"),
            t5=T5Config(vocab_size=4096, dim=32, dim_attn=32, dim_ffn=48, num_heads=2,
                        num_layers=1, text_len=32),
            clip=CLIPConfig(image_size=16, patch_size=8, dim=12, num_heads=2, num_layers=1,
                            out_tokens=5),
            latent_frame_zero=2,
        ).check_i2v_channels()
    return dataclasses.replace(
        cfg,
        dit=DiTConfig(model_type="ti2v", in_dim=8, out_dim=8, dim=128, ffn_dim=256,
                      freq_dim=64, text_dim=32, text_len=32, num_heads=4, num_layers=2,
                      framepack=True),
        vae=VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                      temporal_downsample=(True, False), stride=(2, 8, 8), patchify=2),
        t5=T5Config(vocab_size=4096, dim=32, dim_attn=32, dim_ffn=48, num_heads=2,
                    num_layers=1, text_len=32),
        latent_frame_zero=2,
    )


def run_config(args):
    """The pipeline config ``args`` ask for: the smoke or the full one, W8A8
    with ``--w8a8``."""
    from .configs import CONFIGS

    cfg = CONFIGS[args.config]()
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.w8a8:
        cfg = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, w8a8=True))
    return cfg


def load_pipeline(args, rank=None):
    """(config, pipeline) on ``args.device``: a TI2VPipeline for the 5B, an
    I2VPipeline for the 14B, at the smoke or the full config, W8A8 with
    ``--w8a8``; released weights from ``--ckpt_dir``, otherwise random ones
    from ``--seed``. The pipeline computes in fp32 on the CPU and in bf16 on
    the card. With ``--int8``/``--int4`` the 14B pipeline comes without its
    DiT, which :func:`quantize_trunk` streams in.

    ``rank`` (a :class:`.parallel.mesh.Rank` of a ``--sp``/``--pp`` run):
    the pipeline is that rank's. Only rank 0 builds umT5, the VAE and CLIP;
    under ``--pp`` the DiT holds the rank's stage only (its blocks made or
    loaded alone, with the values they have in the whole model)."""
    from .parallel.pipeline import stage_keep
    from .pipelines.i2v import I2VPipeline
    from .pipelines.ti2v import TI2VPipeline

    refuse_unported(args)
    cfg = run_config(args)
    device = torch.device(args.device)
    dtype = _dtype(device)
    encoders = rank is None or rank.rank == 0
    dit_keep = (stage_keep(cfg.dit.num_layers, args.pp, rank.rank)
                if rank is not None and args.pp > 1 else None)
    # the 14B quantized trunk never exists in bf16: quantize_trunk streams it
    with_dit = not (cfg.name == "i2v-14B" and _bits(args))
    if args.ckpt_dir:
        if not os.path.isdir(args.ckpt_dir):
            raise SystemExit(f"--ckpt_dir {args.ckpt_dir!r} is not a directory")
        pipe = load_torch_weights(cfg, args.ckpt_dir, device=device, dtype=dtype,
                                  load_dit=with_dit, encoders=encoders, dit_keep=dit_keep)
    else:
        if not args.smoke:
            warnings.warn(
                "no --ckpt_dir: running with RANDOM weights (capability/perf runs only; "
                "outputs are noise). Pass --ckpt_dir with the released torch checkpoints "
                "for real generation.", stacklevel=2)
        kw = dict(device=device, seed=args.seed, dtype=dtype, init_t5=encoders,
                  init_vae=encoders, dit_keep=dit_keep)
        if cfg.name == "i2v-14B":
            pipe = I2VPipeline.from_config(cfg, init_dit=with_dit, init_clip=encoders, **kw)
        else:
            pipe = TI2VPipeline.from_config(cfg, **kw)
    if rank is not None:
        _join_run(args, pipe)
    return cfg, pipe


def _join_run(args, pipe):
    """Make ``pipe`` this rank's part of the ``--sp``/``--pp`` run."""
    from .parallel.mesh import make_sp_groups, make_usp_groups

    if args.pp > 1:
        pipe.parallelize_pp(args.pp)
    elif args.sp_kind == "usp":
        pipe.sp_groups, pipe.sp_kind = make_usp_groups(2, args.sp // 2), "usp"
    else:
        pipe.sp_groups, pipe.sp_kind = make_sp_groups(args.sp), args.sp_kind


def load_torch_weights(config, ckpt_dir: str, *, device="cuda", dtype=torch.bfloat16,
                       load_dit: bool = True, encoders: bool = True, dit_keep=None):
    """A TI2VPipeline (5B) or an I2VPipeline (14B) from released torch
    checkpoints in ``ckpt_dir``: the DiT's safetensors (one file, several,
    or shards with an index), the VAE's (``Wan2.2_VAE.pth`` or
    ``Wan2.1_VAE.pth``) and umT5's ``.pth``, and the 14B's CLIP ``.pth``.
    Strict, as the reference: a missing file raises before anything loads,
    and so does a missing or unknown tensor (wrapper segments such as
    ``module.`` are dropped from the DiT's keys). ``load_dit=False`` builds
    a pipeline without a DiT (the 5B trainer's encode path, the 14B's
    quantized load; the reference's ``load_dit=False``); ``encoders=False``
    one without the VAE, umT5 and CLIP (a parallel run's rank other than
    0); ``dit_keep`` loads a pipeline stage's DiT, the other blocks' tensors
    dropped as they are read."""
    from .pipelines.i2v import I2VPipeline
    from .pipelines.ti2v import TI2VPipeline
    from .utils.checkpoint import (clip_visual_from_released, load_safetensors_state_dict,
                                   load_torch_state_dict, normalize_torch_keys)

    i2v = config.name == "i2v-14B"
    vae_file = VAE21_FILE if config.vae.arch == "wan21" else VAE_FILE
    files = [vae_file, T5_FILE] + ([CLIP_FILE] if i2v else [])
    has_dit = not load_dit or any(f.endswith(".safetensors") for f in os.listdir(ckpt_dir))
    missing = ([] if has_dit else [DIT_FILES]) + [
        f for f in files if not os.path.exists(os.path.join(ckpt_dir, f))]
    if missing:
        raise RuntimeError(f"checkpoint dir {ckpt_dir!r} is missing: {', '.join(missing)}; "
                           "refusing to run with random-init modules")
    dit_sd = None
    if load_dit:
        dit_sd = normalize_torch_keys(load_safetensors_state_dict(ckpt_dir))
        if dit_keep is not None:
            # strict all the same: a block of another stage stays on the meta device
            dit_sd = {k: (v if dit_keep(k) else v.to("meta")) for k, v in dit_sd.items()}
    vae_sd = t5_sd = clip_sd = None
    if encoders:
        vae_sd, t5_sd = (load_torch_state_dict(os.path.join(ckpt_dir, f)) for f in files[:2])
    kw = dict(device=device, dtype=dtype, dit_keep=dit_keep)
    if i2v:
        if encoders:
            clip_sd = clip_visual_from_released(
                load_torch_state_dict(os.path.join(ckpt_dir, CLIP_FILE)),
                config.clip.num_layers)
        return I2VPipeline.from_state_dicts(config, dit_sd, vae_sd, t5_sd, clip_sd, **kw)
    return TI2VPipeline.from_state_dicts(config, dit_sd, vae_sd, t5_sd, **kw)


def offload_slot(cfg, pipe, device):
    """``--memory_optimization``'s phase shuttle: umT5 and the VAE (with the
    14B's CLIP) wait in host memory, each on the device only for its phase;
    the DiT stays resident (the 14B's quantized trunk joins the shuttle in
    :func:`quantize_trunk`)."""
    from .utils.offload import OffloadSlot

    slot = OffloadSlot(device)
    slot.register("t5", pipe.t5)
    if cfg.name == "i2v-14B":
        slot.register("vae", torch.nn.ModuleList([pipe.vae, pipe.clip]))
        pipe.phase_cb = lambda name: slot.use("vae") if name == "vae" else slot.park()
    else:
        slot.register("vae", pipe.vae)
    return slot


def _dtype(device: torch.device) -> torch.dtype:
    """The pipelines' compute dtype: fp32 on the CPU, bf16 on the card."""
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def _bits(args) -> int:
    """The trunk's storage bits asked for: 4 (``--int4``, which wins, as in
    the reference), 8 (``--int8``) or 0."""
    return 4 if getattr(args, "int4", False) else 8 if getattr(args, "int8", False) else 0


def quantize_trunk(args, cfg, pipe, slot=None):
    """The ``--int8``/``--int4`` trunk, unless a multistep-solver t2v run
    needs the bf16 one for its first segment (:func:`_run` quantizes after
    it). The 5B quantizes its resident trunk in place; the 14B streams its
    blocks into quantized storage (:func:`.models.quantized.quantize_host_blocks`)
    from ``--ckpt_dir``'s safetensors, or made from ``--seed`` on the
    device, and under ``--memory_optimization`` registers the trunk in
    ``slot`` as ``dit_q``: it visits the device for the DiT phase only, as
    umT5, the VAE and CLIP visit it for theirs."""
    bits = _bits(args)
    if not bits:
        return
    if pipe.dit is not None:
        if not (args.t2v and args.sample_solver != "euler"):
            pipe.quantize_int8(bits)
        return
    from .models.quantized import quantize_host_blocks
    from .utils.checkpoint import load_safetensors_state_dict, normalize_torch_keys

    sd = None
    if args.ckpt_dir:
        sd = normalize_torch_keys(load_safetensors_state_dict(args.ckpt_dir))
        if not sd:
            raise RuntimeError(f"checkpoint dir {args.ckpt_dir!r} is missing: {DIT_FILES}")
    device = torch.device(args.device)
    pipe.dit = quantize_host_blocks(cfg.dit, bits, state_dict=sd, seed=args.seed,
                                    device=device, dtype=_dtype(device))
    del sd
    if slot is not None:
        slot.register("dit_q", pipe.dit)
        pipe.phase_cb = lambda name: slot.use("vae" if name == "vae" else "dit_q")


def _first_image(jpg_dir: str) -> str:
    images = sorted(os.path.join(jpg_dir, f) for f in os.listdir(jpg_dir)
                    if f.lower().endswith((".jpg", ".png", ".jpeg")))
    if not images:
        raise FileNotFoundError(f"no .jpg/.jpeg/.png image in {jpg_dir}")
    return images[0]


def rank_stats(rank, pipe) -> dict:
    """What a rank of a ``--sp``/``--pp`` run reports: the DiT bytes it
    holds, its peak device memory and its kernel launches."""
    from .ops import kernel_launches
    from .parallel.pipeline import held_bytes

    cuda = rank.device.type == "cuda"
    return {"rank": rank.rank, "device": str(rank.device), "backend": rank.backend,
            "dit_bytes": held_bytes(pipe.dit),
            "peak_gib": torch.cuda.max_memory_allocated(rank.device) / 2**30 if cuda else None,
            "launches": kernel_launches()}


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    teacache = teacache_settings(args) if args.teacache else (3, None)
    video_mode = bool(args.input_video or args.video_root_dir)
    if args.config == "i2v-14B" and not (args.jpg_dir or video_mode):
        raise SystemExit("the 14B i2v pipeline needs --jpg_dir (image mode), "
                         "--input_video, or --video_root_dir")
    refuse_unported(args)
    world = parallel_world(args)
    if world == 1:
        _serve(args, teacache)
        return 0
    if args.pp > 1:
        from .parallel.pipeline import stage_blocks

        try:
            stage_blocks(run_config(args).dit.num_layers, args.pp, 0)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    from .parallel.mesh import launch

    for st in launch(world, _serve_rank, args, teacache, device=args.device):
        print(f"rank {st['rank']} of {world}: {json.dumps(st)}")
    return 0


def _serve_rank(rank, args, teacache) -> dict:
    """One rank of a ``--sp``/``--pp`` run (:func:`.parallel.mesh.launch`)."""
    args = argparse.Namespace(**{**vars(args), "device": str(rank.device)})
    pipe = _serve(args, teacache, rank)
    return rank_stats(rank, pipe)


def _serve(args, teacache, rank=None):
    """The run of :func:`main`, alone or as ``rank`` of a parallel run
    (every rank makes the same pipeline calls; rank 0 alone writes and
    prints). Returns the pipeline."""
    from .data.tokenizer import Tokenizer, resolve_tokenizer_path
    from .parallel.route import on_rank0
    from .utils.logging_ import PhaseTimer

    video_mode = bool(args.input_video or args.video_root_dir)
    cfg, pipe = load_pipeline(args, rank)
    leader = on_rank0(pipe)
    if leader:
        os.makedirs(args.output_dir, exist_ok=True)
    device = torch.device(args.device)
    timer = PhaseTimer(device)
    slot = None
    if args.cfg_parallel:
        pipe.cfg_parallel = True
    if args.memory_optimization and leader:
        slot = offload_slot(cfg, pipe, device)
    # after the shuttle is set up: umT5 has left the device when the 14B's
    # quantized trunk streams in
    quantize_trunk(args, cfg, pipe, slot)
    tok = Tokenizer(resolve_tokenizer_path(args.tokenizer, args.ckpt_dir),
                    seq_len=cfg.t5.text_len, vocab_size=cfg.t5.vocab_size,
                    warn_fallback=not args.smoke)

    def encode(text):
        with timer.phase("t5_encode"):
            if slot is not None:
                slot.use("t5")
            return pipe.encode_text(*tok([text]))

    if args.smoke:
        size, frame_num, steps = (32, 32), 5, 2
    else:
        size = (args.width, args.height)
        frame_num = args.frame_num or cfg.frame_num
        steps = args.steps
    captions = [args.prompt]
    if args.caption_file:
        with open(args.caption_file) as f:
            captions = [line.strip() for line in f if line.strip()] or [args.prompt]
    if args.refine_prompt:
        from .data.prompt_refine import get_refiner

        refiner = get_refiner(args.refiner_model)
        captions = [refiner(c) for c in captions]
    sampler = ("tts" if args.sde and args.time_travel else
               "sde" if args.sde else
               "time_travel" if args.time_travel else
               "teacache" if args.teacache else "euler")
    with contextlib.ExitStack() as stack:
        prof = None
        if args.profile_dir and leader:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(activities=acts))
        if video_mode:
            _run_video(args, cfg, pipe, encode, sampler, teacache, size, steps, slot, timer,
                       device=device, shard=rank is None)
        elif cfg.name == "i2v-14B":
            _run_i2v(args, cfg, pipe, encode, captions, sampler, teacache, size, frame_num,
                     steps, slot, timer, device=device)
        else:
            _run(args, cfg, pipe, encode, captions, sampler, teacache, size, frame_num, steps,
                 slot, timer)
    if prof is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}")
    if leader:
        timer.summary()
    return pipe


def _writer(args, cfg, pipe):
    """(save, say): ``save(video [T, H, W, 3], name, latents)`` writes the
    video under ``--output_dir`` (and with ``--save_latents`` the latents
    beside it) and returns its path; ``say`` prints. Both do nothing on a
    parallel run's rank other than 0."""
    from .parallel.route import on_rank0
    from .utils.video import save_video

    if not on_rank0(pipe):
        return (lambda video, name, latents=None: name), (lambda msg: None)

    def save(video, name, latents=None):
        path = os.path.join(args.output_dir, name)
        if args.save_latents and latents is not None:
            torch.save(latents.detach().cpu(), os.path.splitext(path)[0] + ".pt")
        return save_video(video.float().cpu().numpy(), path, fps=cfg.sample_fps)
    return save, print


# the camera-metrics suffix of every video-mode caption: a constant in the
# reference (fastvideo/sample/sample.py:689), not computed from the clip
_VIDEO_METRICS_SUFFIX = (
    "Actual distance moved:4.3697374288015297 at 100 meters per second."
    "Angular change rate (turn speed):4.520279996588001."
    "View rotation speed:4.14601429683874179.")


def iter_video_samples(args, size, shard: bool = True):
    """Yield (video [1, F, H, W, 3] in [-1, 1] on the host, caption, tag)
    from ``--input_video`` and then ``--video_root_dir``, whose
    ``<category>/*.mp4`` scan is strided by the ``torch.distributed`` rank
    so that each process serves other clips (the reference's
    ``(step-1)*world_size+rank``, fastvideo/sample/sample.py:667; not with
    ``shard=False``, where the ranks of one ``--sp``/``--pp`` run serve every
    clip together). A clip's sibling ``.txt`` control file gives the
    key/mouse caption; tags count the scan's global index, so ranks sharing
    an output directory do not collide."""
    import glob

    from .data.controls import control_caption, parse_control_txt
    from .data.dataset import read_video_frames
    from .data.loader import process_rank

    n_frames = 5 if args.smoke else args.video_frames

    def load(mp4, caption):
        txt = mp4[:-4] + ".txt"
        if os.path.exists(txt):
            keys, mouse, _, _ = parse_control_txt(txt)
            if keys is not None or mouse is not None:
                caption = control_caption(keys or "None", mouse or "·")
        video = read_video_frames(mp4, list(range(n_frames)), size=(size[1], size[0]))
        return torch.from_numpy(video)[None], caption

    if args.input_video:
        yield load(args.input_video, args.prompt) + ("video000",)
    if args.video_root_dir:
        rank, world = process_rank() if shard else (0, 1)
        files = [mp4 for sub in sorted(glob.glob(os.path.join(args.video_root_dir, "*/")))
                 for mp4 in sorted(glob.glob(os.path.join(sub, "*.mp4")))]
        for i, mp4 in enumerate(files[rank::world]):
            yield load(mp4, args.prompt) + (f"video{rank + i * world:03d}",)


def _run_video(args, cfg, pipe, encode, sampler, teacache, size, steps, slot, timer,
               device=None, shard=True):
    """The video-input mode (reference sample_one's video branch,
    fastvideo/sample/sample.py:686-714). 5B: ``encode_auto`` of the clip
    gives the history latents, then ``--sample_num`` segments, each tail
    decoded and written. 14B: the clip's first frame repeated ``rep`` times
    in front of it (16 at the 14B's temporal stride 4; ``rep`` makes the
    history 1 mod the stride, so the causal VAE streams it exactly), then
    ``generate_next`` of ``(latent_frame_zero - 1)·stride`` frames per
    sample, the history growing by the decoded video each time. The clips
    go to ``device`` (default the pipeline's; the 14B's quantized trunk may
    be parked on the host when they are read). ``shard``: as
    :func:`iter_video_samples`."""
    interval, threshold = teacache
    seg_kw = dict(sampler=sampler, teacache_interval=interval,
                  teacache_edge=args.teacache_edge, teacache_threshold=threshold)
    lfz, s0 = cfg.latent_frame_zero, cfg.vae.stride[0]
    save, say = _writer(args, cfg, pipe)

    n_out = 0
    for video, caption, tag in iter_video_samples(args, size, shard):
        ctx = encode(caption + _VIDEO_METRICS_SUFFIX)
        video = video.to(pipe.device if device is None else device)
        t0 = time.time()
        if cfg.name == "i2v-14B":
            # --distilled: cond-only, as the image mode
            ctx_null = None if args.distilled else encode(args.neg_prompt
                                                          or cfg.sample_neg_prompt)
            rep = 4 * s0 + ((1 - video.shape[1] - 4 * s0) % s0)
            history = torch.cat([video[:, :1].expand(-1, rep, -1, -1, -1), video], dim=1)
            frame_zero = (lfz - 1) * s0
            for s in range(args.sample_num):
                with timer.phase("generate_next"):
                    latents, history = pipe.generate_next(
                        history, ctx, ctx_null, frame_zero=frame_zero, steps=steps,
                        shift=args.shift, guide_scale=args.guide_scale, seed=args.seed + s,
                        **seg_kw)
                save(history[0, -frame_zero:], f"{tag}_seg{s:03d}.mp4", latents)
                n_out += 1
        else:
            with timer.phase("vae_encode"):
                if slot is not None:
                    slot.use("vae")
                latents = pipe.encode_auto(video)
            for s in range(args.sample_num):
                with timer.phase("generate"):
                    latents = pipe.generate_segment(latents, ctx, steps=steps,
                                                    shift=args.shift or cfg.sample_shift,
                                                    seed=args.seed + s, **seg_kw)
                with timer.phase("vae_decode"):
                    if slot is not None:
                        slot.use("vae")
                    tail = pipe.decode_auto(latents[:, -lfz:])
                save(tail[0], f"{tag}_seg{s:03d}.mp4", latents)
                n_out += 1
        say(f"--> {tag}: {args.sample_num} segment(s) in {time.time() - t0:.1f}s "
            f"({caption[:60]})")
    if n_out == 0:
        raise FileNotFoundError(
            f"no input videos found under {args.video_root_dir or args.input_video}")


def _run(args, cfg, pipe, encode, captions, sampler, teacache, size, frame_num, steps,
         slot, timer):
    """The 5B branches: a t2v first segment re-encoded to latents
    (``encode_auto``), or an image-conditioned one (``--jpg_dir``); then one
    continuation segment per remaining sample, each with the next caption."""
    from .utils.video import load_image

    lfz = cfg.latent_frame_zero
    interval, threshold = teacache
    seg_kw = dict(sampler=sampler, teacache_interval=interval,
                  teacache_edge=args.teacache_edge, teacache_threshold=threshold)
    save, say = _writer(args, cfg, pipe)

    def vae_phase():
        if slot is not None:
            slot.use("vae")

    t0 = time.time()
    if args.t2v or args.jpg_dir is None:
        ctx = encode(captions[0])
        # umT5 work ends before the VAE's phase: under --memory_optimization
        # each encode() brings umT5 back and parks the VAE
        ctx_null = (encode(args.neg_prompt or cfg.sample_neg_prompt)
                    if args.sample_solver != "euler" else None)
        with timer.phase("generate"):
            vae_phase()     # the t2v latents are decoded here
            first = pipe.generate_t2v(ctx, size=size, frame_num=frame_num, steps=steps,
                                      shift=args.shift, seed=args.seed,
                                      solver=args.sample_solver, ctx_null=ctx_null,
                                      guide_scale=args.guide_scale, return_latents=True)
            video = pipe.decode_auto(first)
        with timer.phase("vae_encode"):
            vae_phase()
            latents = pipe.encode_auto(video)
        if _bits(args) and args.sample_solver != "euler":
            # a multistep t2v run quantizes after its first segment
            pipe.quantize_int8(_bits(args))
    else:
        img = load_image(_first_image(args.jpg_dir), size=(size[1], size[0]))
        # repeat-N first-frame conditioning (16 frames, clamped to the duration)
        frames = torch.from_numpy(np.repeat(img[None], min(16, frame_num), 0))[None]
        with timer.phase("vae_encode"):
            vae_phase()
            latents, _ = pipe.encode_image_conditioning(frames.to(pipe.device), frame_num)
        ctx = encode(captions[0])
        with timer.phase("generate"):
            latents = pipe.generate_segment(latents[:, :-lfz], ctx, steps=steps,
                                            shift=args.shift or cfg.sample_shift,
                                            seed=args.seed, **seg_kw)
        with timer.phase("vae_decode"):
            vae_phase()
            video = pipe.decode_auto(latents)
        first = latents
    out = save(video[0], "segment_000.mp4", first)
    say(f"--> segment 0 written to {out} ({time.time() - t0:.1f}s, frames={video.shape[1]})")
    del video

    for s in range(1, args.sample_num):
        ctx = encode(captions[min(s, len(captions) - 1)])
        t1 = time.time()
        with timer.phase("generate"):
            latents = pipe.generate_segment(latents, ctx, steps=steps, shift=args.shift or 7.0,
                                            seed=args.seed + s, **seg_kw)
        with timer.phase("vae_decode"):
            vae_phase()
            tail = pipe.decode_auto(latents[:, -lfz:])
        out = save(tail[0], f"segment_{s:03d}.mp4", latents)
        say(f"--> segment {s} written to {out} ({time.time() - t1:.4f} s)")


def _run_i2v(args, cfg, pipe, encode, captions, sampler, teacache, size, frame_num, steps,
             slot, timer, device=None):
    """The 14B branch (reference fastvideo/sample/sample.py): the image in
    ``--jpg_dir`` conditions a CFG segment of ``frame_num`` frames
    (``segment_000``); then each further sample re-conditions on the whole
    video so far and adds 32 frames (``generate_next``), written alone. As
    the reference, the continuations take no sampler and run Euler. The
    image goes to ``device`` (as :func:`_run_video`)."""
    from .utils.video import load_image

    interval, threshold = teacache
    save, say = _writer(args, cfg, pipe)
    ctx = encode(captions[0])
    ctx_null = None if args.distilled else encode(args.neg_prompt or cfg.sample_neg_prompt)
    img = load_image(_first_image(args.jpg_dir), size=(size[1], size[0]))
    t0 = time.time()
    with timer.phase("generate"):
        latents, video = pipe.generate(
            torch.from_numpy(img)[None, None].to(pipe.device if device is None else device),
            ctx, ctx_null,
            frame_num=frame_num, steps=steps, shift=args.shift, guide_scale=args.guide_scale,
            seed=args.seed, sampler=sampler, teacache_interval=interval,
            teacache_edge=args.teacache_edge, teacache_threshold=threshold)
    out = save(video[0], "segment_000.mp4", latents)
    say(f"--> segment 0 written to {out} ({time.time() - t0:.1f}s, frames={video.shape[1]})")
    for s in range(1, args.sample_num):
        ctx = encode(captions[min(s, len(captions) - 1)])
        t1 = time.time()
        with timer.phase("generate_next"):
            latents, video = pipe.generate_next(video, ctx, ctx_null,
                                                frame_zero=I2V_FRAME_ZERO, steps=steps,
                                                shift=args.shift, guide_scale=args.guide_scale,
                                                seed=args.seed + s)
        out = save(video[0, -I2V_FRAME_ZERO:], f"segment_{s:03d}.mp4", latents)
        say(f"--> segment {s} written to {out} ({time.time() - t1:.4f} s)")


if __name__ == "__main__":
    raise SystemExit(main())
