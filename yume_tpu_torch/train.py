"""Training entry point: flow-matching (+ MVDT, + ADD distillation, + LoRA)
fine-tuning of the 5B DiT or the Yume-1.0 i2v-14B DiT on one GPU, or
sequence-parallel over N ranks with ``--sp N`` (counterpart of
yume_tpu/train.py).

    python -m yume_tpu_torch.train --smoke --device cpu            # tiny synthetic run
    python -m yume_tpu_torch.train --smoke --Distil --device cpu   # with the ADD discriminator
    python -m yume_tpu_torch.train --smoke --config i2v-14B --device cpu
    python -m yume_tpu_torch.train --lora_rank 16 --remat          # 5B LoRA on the card
    python -m yume_tpu_torch.train --config i2v-14B --lora_rank 16 --remat   # 14B LoRA
    python -m yume_tpu_torch.train --smoke --device cpu --data_dir ./mp4_frame
    python -m yume_tpu_torch.train --data_dir ./mp4_frame --ckpt_dir ./Yume-5B-720P \
        --lora_rank 16 --remat --export_torch_dir ./exported
    python -m yume_tpu_torch.train --smoke --device cpu --sp 2 --sp_kind ring --Distil

Same flags and smoke configs as the reference's train.py, plus ``--device``
(default ``cuda``). Without ``--data_dir`` the batches are synthetic latents
made from a seed per step (the 14B's with the i2v ``y`` and CLIP features).
With it, a :class:`ControlVideoDataset` over the directory feeds a
two-thread :class:`PrefetchLoader`, and each batch's clips and captions are
encoded on the device: umT5 gives the context; for the 5B a full-clip VAE
encode gives the latents (``(num_frames - 1) / 4 + 1`` latent frames, the
last ``latent_frame_zero`` of them the target); for the 14B
:func:`.training.i2v_batch.build_i2v_train_batch` gives the latents, ``y``
and the CLIP features, its i2v or v2v branch drawn on the host from
``random.Random(seed + 31)``. The encoders load strictly from
``--encoders_dir``, else ``--ckpt_dir`` (the VAE's and umT5's ``.pth``, the
14B's CLIP ``.pth``; the tokenizer from ``--tokenizer_path`` or found
there); without either they are random and a warning says so. ``--smoke
--data_dir`` reads 9 frames of 64×64 through the reference's smoke
encoders. The MVDT keep counts are shares of each batch's own packed token
count. On the card the DiT computes in bf16 (the attention kernels take
bf16), on the CPU the smoke run computes in fp32 as the reference's does.

The DiT is random (flax's initialisers), or with ``--ckpt_dir`` loaded
strictly from the released sharded safetensors (a missing or unknown tensor
raises). Its parameters are stored in fp32, as flax creates them, except
under ``--lora_rank`` on the card, where the frozen blocks' Linear weights
are stored in bf16 (:func:`.training.lora.bf16_base_`: the forward casts
them to bf16 anyway) and the adapters stay fp32; that is how the 14B's
16.6B parameters fit one 80 GB card. A full 14B fine-tune on a CUDA device
is refused: its fp32 state needs FSDP (ROADMAP queue 1, item 8); it runs at
``--smoke`` and on the CPU.

``--checkpointing_steps N`` saves the train state every N steps through an
async :class:`.utils.checkpoint.Checkpointer` (the newest three
``checkpoint-<step>.pt`` are kept; ``--resume`` restores the newest).
``--export_torch_dir`` writes the EMA DiT after the last step, LoRA merged
in, as the released layout's sharded safetensors, which ``python -m
yume_tpu_torch.sample --ckpt_dir`` loads beside the VAE and umT5 files.

``--Distil`` adds the ADD discriminator (fp32, random weights, DINO frozen;
``--dino_path`` loads DINO ViT-S/16 weights in timm's layout) and runs
``make_distill_train_step``; it composes with ``--MVDT``. As in the
reference, ``--resume`` restores the generator and starts a fresh
discriminator.

``--sp N`` (N > 1) trains with sequence parallelism (the reference's
``sp_dit_apply`` inside the train step): the command spawns N processes, a
rank each, through :func:`.parallel.mesh.launch` (NCCL when every rank has
a card of its own, else gloo, the ranks sharing the card or the CPU's
cores). Every rank builds the same model from the same seed (or
``--ckpt_dir``) and draws the same batches and draws; the train step's
forward is :func:`.parallel.sp_forward.sp_dit_forward` over
``make_sp_groups(N)`` (``--sp_kind ulysses`` or ``ring``) or
``make_usp_groups(2, N // 2)`` (``usp``), differentiable through its
collectives, and each rank's gradients, which hold its own tokens' share,
are summed over the group (:func:`.parallel.mesh.all_reduce_sum_`) before
the clipping, so every rank takes the same update. A ``--data_parallel``
batch is every rank's batch. Rank 0 alone prints, saves, validates (the
dense forward of its EMA), exports, and under ``--data_dir`` reads and
encodes each batch and hands it to the others; the others wait at the next
collective, and a failure there is raised on every rank. ``--resume``
restores the same file on every rank. ``main.last_run`` holds rank 0's
record with every rank's parameter checksum and launch counts. ``--sp``
refuses ``--MVDT`` and ``--lora_rank``, as the reference's asserts.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import os
import random
import time

import numpy as np
import torch
from torch import nn


def build_argparser():
    p = argparse.ArgumentParser(description="yume_tpu_torch training")
    p.add_argument("--config", default="ti2v-5B", choices=["ti2v-5B", "i2v-14B"])
    p.add_argument("--data_dir", default=None)
    p.add_argument("--full_mp4_dir", default=None)
    p.add_argument("--ckpt_dir", default=None,
                   help="released checkpoint dir: the DiT's sharded safetensors (loaded "
                        "strictly) and, for --data_dir without --encoders_dir, the "
                        "encoders' .pth files")
    p.add_argument("--encoders_dir", default=None,
                   help="dir with the VAE's and umT5's .pth (and the 14B's CLIP .pth) for "
                        "the --data_dir encode path (defaults to --ckpt_dir)")
    p.add_argument("--tokenizer_path", default=None,
                   help="local umt5-xxl tokenizer dir (found inside --encoders_dir)")
    p.add_argument("--output_dir", default="./checkpoints")
    p.add_argument("--max_train_steps", type=int, default=100)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adam8bit"])
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--checkpointing_steps", type=int, default=25)
    p.add_argument("--validation_steps", type=int, default=0)
    p.add_argument("--MVDT", action="store_true")
    p.add_argument("--Distil", action="store_true")
    p.add_argument("--dino_path", default=None,
                   help="DINO ViT-S/16 weights (dino_deitsmall16_pretrain.pth, timm "
                        "layout) for the frozen discriminator projector")
    p.add_argument("--num_frames", type=int, default=33)
    p.add_argument("--height", type=int, default=352)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--data_parallel", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--sp_kind", default="ulysses", choices=["ulysses", "ring", "usp"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing per DiT block")
    p.add_argument("--lora_rank", type=int, default=0,
                   help="train LoRA adapters of this rank instead of full "
                        "params (base frozen, bf16 on the card; single-GPU 5B and 14B)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export_torch_dir", default=None,
                   help="after training, write the EMA DiT (LoRA merged) to this dir as the "
                        "released layout's sharded safetensors")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler chrome trace of the steps in "
                        "--profile_steps to this directory")
    p.add_argument("--profile_steps", default="2,5")
    p.add_argument("--device", default="cuda",
                   help="device of the model and the batches (cuda or cpu)")
    return p


def _refuse(args, device: torch.device):
    """What the reference refuses with ``--sp`` (its asserts, as
    ValueErrors), and what the port does not do yet."""
    if args.sp > 1:
        if args.MVDT:
            raise ValueError("--sp composes with the plain/Distil flow step; MVDT token "
                             "masking is dense-only")
        if args.lora_rank:
            raise ValueError("--sp with --lora_rank is not supported")
        if args.sp_kind == "usp" and args.sp % 2:
            raise ValueError(f"--sp_kind usp runs Ulysses over 2 ranks and ring over "
                             f"sp / 2: --sp {args.sp} is odd")
    if (args.config == "i2v-14B" and device.type == "cuda" and not args.smoke
            and not args.lora_rank):
        raise NotImplementedError(
            "not ported yet: a full i2v-14B fine-tune keeps ~333 GB of fp32 state "
            "(parameters, EMA, two moments, gradients of 16.6B parameters), which needs "
            "FSDP across cards (ROADMAP queue 1, item 8); on one card train LoRA "
            "(--lora_rank 16 --remat)")


def smoke_config(mvdt: bool, i2v: bool = False):
    """The smoke pipeline config of the reference's train.py: the tiny DiT
    with a tiny VAE and umT5, so that ``--data_dir`` encodes at smoke size;
    for the 14B (``i2v``) the tiny i2v DiT (16 → 8 latent and 20 → 10
    conditioning channels, 5 CLIP tokens of width 12), a Wan2.1 VAE of
    stride (2, 4, 4) and a tiny CLIP."""
    from .configs import CLIPConfig, DiTConfig, PipelineConfig, T5Config, VAEConfig

    t5 = T5Config(vocab_size=256, dim=16, dim_attn=16, dim_ffn=24, num_heads=2,
                  num_layers=1, text_len=16)
    if i2v:
        return PipelineConfig(
            name="smoke-i2v",
            dit=DiTConfig(model_type="i2v", in_dim=18, out_dim=8, dim=64, ffn_dim=128,
                          freq_dim=32, text_dim=16, text_len=16, num_heads=4, num_layers=2,
                          framepack=True, mvdt=mvdt, image_context_len=5, image_dim=12),
            vae=VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                          temporal_downsample=(True, False), stride=(2, 4, 4), patchify=1,
                          arch="wan21"),
            t5=t5,
            clip=CLIPConfig(image_size=16, patch_size=8, dim=12, num_heads=2, num_layers=1,
                            out_tokens=5),
            latent_frame_zero=2).check_i2v_channels()
    return PipelineConfig(
        name="smoke",
        dit=DiTConfig(model_type="ti2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128,
                      freq_dim=32, text_dim=16, text_len=16, num_heads=4, num_layers=2,
                      framepack=True, mvdt=mvdt),
        vae=VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                      temporal_downsample=(True, False), stride=(2, 8, 8), patchify=2),
        t5=t5,
        latent_frame_zero=2)


def load_dit_checkpoint(model: nn.Module, ckpt_dir: str):
    """The DiT's released safetensors in ``ckpt_dir`` (one file, several,
    or shards with an index) into ``model``'s parameters, each cast to its
    parameter's dtype. Strict, as the reference's converter: a tensor the
    model has and the files lack raises, and so does one the model lacks
    (wrapper segments such as ``module.`` are dropped from the keys)."""
    from .utils.checkpoint import load_safetensors_state_dict, normalize_torch_keys
    from .utils.convert import load_state_dict

    if not os.path.isdir(ckpt_dir) or not any(
            f.endswith(".safetensors") for f in os.listdir(ckpt_dir)):
        raise SystemExit(f"--ckpt_dir {ckpt_dir!r} holds no DiT safetensors")
    load_state_dict(model, normalize_torch_keys(load_safetensors_state_dict(ckpt_dir)))


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator):
    """Random parameters after flax's initialisers, as the reference's
    ``dit.init``: lecun-normal (std 1/sqrt(fan_in)) Linear and conv
    weights, zero biases, unit norm scales, modulation N(0, 1)/sqrt(dim),
    and a zero head projection and mask token."""
    from .models.dit import RMSNorm

    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (RMSNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        if hasattr(m, "modulation") and isinstance(m.modulation, nn.Parameter):
            m.modulation.normal_(0.0, 1.0, generator=generator)
            m.modulation.div_(m.modulation.shape[-1] ** 0.5)
    model.head.head.weight.zero_()
    model.head.head.bias.zero_()
    if hasattr(model, "mask_token"):
        model.mask_token.zero_()


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    _refuse(args, device)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.sp > 1:
        from .parallel.mesh import launch

        runs = launch(args.sp, _train_rank, args, device=args.device)
        main.last_run = dict(runs[0], param_checksums=[r["param_checksum"] for r in runs],
                             launches_per_rank=[r["launches"] for r in runs])
    else:
        main.last_run = _train(args, device)
    return 0


def _train_rank(rank, args) -> dict:
    """One rank of a ``--sp`` run (:func:`.parallel.mesh.launch`): the ranks
    share the CPU's cores, or each takes its card."""
    if rank.device.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // rank.world))
    args = argparse.Namespace(**{**vars(args), "device": str(rank.device)})
    return _train(args, rank.device, rank)


def param_checksum(params) -> str:
    """sha256 of the parameters' bytes in name order: ranks that hold the
    same bits hold the same digest."""
    h = hashlib.sha256()
    for name in sorted(params):
        t = params[name].detach().reshape(-1).cpu()
        h.update(name.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _train(args, device: torch.device, rank=None) -> dict:
    """The run of :func:`main`, alone or as ``rank`` of a ``--sp`` run;
    returns its record (``main.last_run``). Every rank builds the same
    model from the same seed (or ``--ckpt_dir``), draws the same batches
    and the same draws, and steps through the sequence-parallel forward
    with its gradients summed over the group. Rank 0 alone prints, reads
    and encodes ``--data_dir``'s batches (handed to the others), saves,
    validates and exports; the others wait for it at the next collective,
    and a failure there is raised on every rank."""
    from .configs import CONFIGS
    from .models.dit import WanDiT, packed_token_count
    from .ops import kernel_launches
    from .parallel.mesh import on_rank0_only
    from .training.train_step import (TrainConfig, draw_step, init_train_state,
                                      make_train_step, trainable_params)
    from .utils.checkpoint import Checkpointer, restore_checkpoint

    group, lead = None, True
    if rank is not None:
        group, lead = torch.distributed.group.WORLD, rank.rank == 0
    say = print if lead else (lambda *a, **k: None)

    cfg = CONFIGS[args.config]()
    is_i2v = cfg.dit.model_type == "i2v"
    if args.smoke:
        cfg = smoke_config(args.MVDT, is_i2v)
        args.max_train_steps = min(args.max_train_steps, 5)
        if args.data_dir:
            args.num_frames, args.height, args.width = 9, 64, 64
    elif args.MVDT:
        cfg = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, mvdt=True))
    dit_cfg, lfz = cfg.dit, cfg.latent_frame_zero

    dtype = torch.float32 if args.smoke and device.type == "cpu" else torch.bfloat16
    model = WanDiT(dit_cfg, dtype, device="meta", param_dtype=torch.float32,
                   remat=args.remat)
    if args.lora_rank and dtype == torch.bfloat16:
        from .training.lora import bf16_base_

        bf16_base_(model)
    model = model.to_empty(device=device)
    if args.ckpt_dir:
        load_dit_checkpoint(model, args.ckpt_dir)
        say(f"DiT loaded from {args.ckpt_dir}", flush=True)
    else:
        init_params_(model, _generator(device, args.seed))

    # the sequence-parallel forward and the gradient sum over its group
    sp_kw = {}
    if rank is not None:
        from .parallel.mesh import all_reduce_sum_, make_sp_groups, make_usp_groups
        from .parallel.sp_forward import sp_dit_forward

        groups = (make_usp_groups(2, args.sp // 2) if args.sp_kind == "usp"
                  else make_sp_groups(args.sp))
        sp_kw = dict(forward=functools.partial(sp_dit_forward, model, groups,
                                               kind=args.sp_kind),
                     reduce_grads=lambda grads: all_reduce_sum_(grads.values(), groups.group))
        say(f"sequence-parallel training: {args.sp} ranks, {args.sp_kind}", flush=True)

    # latent geometry
    if args.smoke:
        b, f, h, w = 1, 3 + lfz, 8, 8
    else:
        b = args.data_parallel
        f = (args.num_frames - 1) // cfg.vae.stride[0] + 1 + lfz
        h = args.height // cfg.vae.stride[1]
        w = args.width // cfg.vae.stride[2]
    text_len, text_dim = dit_cfg.text_len, dit_cfg.text_dim

    def mvdt_keeps(latent_shape):
        # the reference samples mask_ratio ~ U[0.3, 0.5] per step
        # (wan23/modules/model.py:766-767), quantised to 9 ratios; the keep
        # count is a share of the packed tokens of the batch the step masks
        _, f_b, h_b, w_b = latent_shape[:4]
        n_tok = packed_token_count(f_b - lfz, lfz, h_b, w_b, dit_cfg.patch_size)
        return [int(n_tok * (1.0 - (0.30 + 0.025 * i))) for i in range(9)]

    tc = TrainConfig(learning_rate=args.learning_rate, latent_frame_zero=lfz,
                     optimizer=args.optimizer, lr_warmup_steps=args.lr_warmup_steps,
                     mvdt=args.MVDT)
    lora_model = None
    if args.lora_rank:
        if args.MVDT or args.Distil:
            raise ValueError("--lora_rank composes with the plain flow-matching step")
        from .training.lora import LoRAModel, count_params, init_lora, make_lora_train_step

        lora = init_lora(model, rank=args.lora_rank,
                         generator=_generator(device, args.seed + 2))
        n_total = sum(p.numel() for p in model.parameters())
        lora_model = LoRAModel(model, lora)
        print(f"LoRA rank {args.lora_rank}: {count_params(lora):,} trainable / "
              f"{n_total:,} total params", flush=True)
        state = init_train_state(lora, tc)
        lora_step = make_lora_train_step(lora_model, tc)

        def step_fn(state, batch, draws, step):
            return lora_step(state, batch, draws)
    else:
        state = init_train_state(trainable_params(model), tc)
        if args.Distil:
            # the ADD discriminator (reference train.py:237-266); its own
            # clipped AdamW over every parameter but DINO's
            from .training.distill import (disc_optimizer, init_disc_state,
                                           make_distill_train_step)

            d_opt = disc_optimizer()
            disc, disc_state = init_disc_state(d_opt, z_dim=dit_cfg.out_dim,
                                               dino_path=args.dino_path, device=device,
                                               generator=_generator(device, args.seed + 1))

            def make_step(keep):
                return functools.partial(_distill_step, make_distill_train_step(
                    model, tc, disc, d_opt, mvdt_keep=keep, **sp_kw), disc_state)
        else:
            def make_step(keep):
                return make_train_step(model, tc, mvdt_keep=keep, **sp_kw)
        step_fns = {}

        def step_fn(state, batch, draws, step):
            # a keep count per step, drawn from (seed, step) so a resumed
            # run takes the same ones
            keeps = mvdt_keeps(batch["latents"].shape) if args.MVDT else [None]
            keep = random.Random(args.seed * 1000003 + step).choice(keeps)
            if keep not in step_fns:
                step_fns[keep] = make_step(keep)
            return step_fns[keep](state, batch, draws)

    def synthetic_batch(step):
        gen = _generator(device, step)
        if is_i2v:
            from .training.i2v_batch import synthetic_i2v_batch

            return synthetic_i2v_batch(
                gen, b=b, f=f, h=h, w=w, z_dim=dit_cfg.out_dim, mask_ch=cfg.vae.stride[0],
                text_len=text_len, text_dim=text_dim,
                image_context_len=dit_cfg.image_context_len, image_dim=dit_cfg.image_dim)
        return {"latents": torch.randn((b, f, h, w, dit_cfg.in_dim), generator=gen,
                                       device=device),
                "context": torch.randn((b, text_len, text_dim), generator=gen,
                                       device=device) * 0.02}

    get_batch, loader, pipe, timing = synthetic_batch, None, None, None
    if args.data_dir:
        if lead:
            get_batch, loader, pipe = data_batches(args, cfg, device, b)
            timing = get_batch.timing
        if group is not None:
            get_batch = _batches_from_rank0(get_batch if lead else None, group, device)

    start_step = 0
    if args.resume and os.path.isdir(args.output_dir):
        try:
            state = restore_checkpoint(args.output_dir, state)
            start_step = state.step
            say(f"resumed at step {start_step}", flush=True)
        except FileNotFoundError as e:
            say(f"resume failed: {e}", flush=True)

    prof_lo, prof_hi = (int(s) for s in args.profile_steps.split(","))
    profiler = None
    ckpter = None  # the async Checkpointer, made at the first save
    times, losses, grad_norms, gan_losses, d_losses = [], [], [], [], []
    try:
        for step in range(start_step, args.max_train_steps):
            if args.profile_dir and lead and step == prof_lo:
                profiler = torch.profiler.profile()
                profiler.__enter__()
            t_start = time.time()
            batch = get_batch(step)
            draws = draw_step(batch, tc, _generator(device, args.seed * 1000003 + step),
                              masked=args.MVDT)
            state, metrics = step_fn(state, batch, draws, step)
            loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
            times.append(time.time() - t_start)
            losses.append(loss)
            grad_norms.append(grad_norm)
            loss_str = f"loss={loss:.4f}"
            if args.Distil:
                gan_losses.append(float(metrics["gan_loss"]))
                d_losses.append(float(metrics["d_loss"]))
                loss_str += f" gan_loss={gan_losses[-1]:.4f} d_loss={d_losses[-1]:.4f}"
            if profiler is not None and step == prof_hi:
                _stop_profile(profiler, args.profile_dir)
                profiler = None
            say(f"step {step + 1}/{args.max_train_steps} {loss_str} "
                f"grad_norm={grad_norm:.3f} step_time={np.mean(times[-100:]):.2f}s",
                flush=True)
            if args.checkpointing_steps and (step + 1) % args.checkpointing_steps == 0:
                if ckpter is None and lead:
                    ckpter = Checkpointer(args.output_dir)
                on_rank0_only(lambda: ckpter.save(state), group)
                say(f"checkpoint save started at step {step + 1} (async)", flush=True)
            if args.validation_steps and (step + 1) % args.validation_steps == 0:
                on_rank0_only(functools.partial(_validation_rollout, args, model, state, batch,
                                                lfz, step + 1, lora_model, pipe), group)
    finally:
        if ckpter is not None:
            ckpter.close()  # drain the save in flight
        if loader is not None:
            loader.close()
    if profiler is not None:
        _stop_profile(profiler, args.profile_dir)
    run = {"losses": losses, "grad_norms": grad_norms, "step_times": times,
           "trainable": sum(p.numel() for p in state.params.values()),
           "save_hold_s": [] if ckpter is None else ckpter.hold_s}
    if args.Distil:
        run.update(gan_losses=gan_losses, d_losses=d_losses)
    if timing is not None:
        run.update(timing)
    if args.export_torch_dir:
        run["export"] = on_rank0_only(
            lambda: export_ema(args.export_torch_dir, model, state, lora_model), group)
    if rank is not None:
        run.update(rank=rank.rank, param_checksum=param_checksum(state.params),
                   launches=kernel_launches())
    return run


def _batches_from_rank0(get_batch, group, device):
    """``get_batch`` of rank 0 on every rank of ``group``: rank 0 reads and
    encodes the batch (``get_batch`` is None elsewhere) and hands it to the
    others (:func:`.parallel.mesh.from_rank0`)."""
    from .parallel.mesh import from_rank0

    keys = ("latents", "context", "y", "clip_context")

    def rank0_batch(step):
        batch = get_batch(step)
        return tuple(batch.get(k) for k in keys)

    def batch_from_rank0(step):
        vals = from_rank0(lambda: rank0_batch(step), group, device)
        return {k: v for k, v in zip(keys, vals) if v is not None}

    return batch_from_rank0


def export_ema(out_dir: str, model: nn.Module, state, lora_model=None) -> dict:
    """Write the EMA DiT (the EMA adapters merged into the frozen base under
    LoRA) to ``out_dir`` as the released layout's sharded safetensors (the
    reference's ``--export_torch_dir``). Returns the tensor count, the bytes
    written and the writer's seconds."""
    from .training.lora import base_state_dict
    from .utils.checkpoint import export_dit_state_dict, save_sharded_safetensors

    base = base_state_dict(model)
    if lora_model is not None:
        sd = export_dit_state_dict(base, state.ema_params)
    else:
        sd = export_dit_state_dict({**base, **state.ema_params})
    t0 = time.perf_counter()
    n_bytes = save_sharded_safetensors(sd, out_dir)
    out = {"tensors": len(sd), "bytes": n_bytes, "write_s": time.perf_counter() - t0}
    print(f"exported {len(sd)} EMA DiT tensors to {out_dir} (reference torch layout)",
          flush=True)
    return out


main.last_run = None


def data_batches(args, cfg, device, batch_size):
    """``--data_dir``'s batches (reference train.py:326-392): a
    :class:`ControlVideoDataset` behind a two-thread
    :class:`PrefetchLoader`, and the encoders (from ``--encoders_dir`` or
    ``--ckpt_dir``, else random) on ``device`` without a DiT: umT5 and the
    VAE for the 5B, an :class:`I2VPipeline` with umT5, CLIP and the Wan2.1
    VAE for the 14B. Returns (get_batch, loader, pipeline);
    ``get_batch(step)`` gives the 5B's ``{"latents", "context"}`` (the
    full-clip VAE encode of the clips in the VAE's dtype and their
    captions' context) or the 14B's :func:`build_i2v_train_batch`, its
    branch drawn from ``random.Random(seed + 31)``. ``get_batch.timing``
    keeps each batch's host wait and device encode in seconds and, for the
    14B, its branch and its packed token count."""
    from .data.dataset import ControlVideoDataset
    from .data.loader import PrefetchLoader
    from .data.tokenizer import Tokenizer, resolve_tokenizer_path
    from .models.dit import packed_token_count
    from .pipelines.i2v import I2VPipeline
    from .pipelines.ti2v import TI2VPipeline
    from .sample import load_torch_weights
    from .training.i2v_batch import build_i2v_train_batch, takes_i2v_branch

    is_i2v = cfg.dit.model_type == "i2v"
    ds = ControlVideoDataset(args.data_dir, full_mp4_dir=args.full_mp4_dir,
                             n_sample_frames=args.num_frames, height=args.height,
                             width=args.width)
    print(f"dataset: {len(ds)} clips", flush=True)
    # the encoders need real weights (reference init_model,
    # distill_model.py:720-737); a random encoder feeds noise latents
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    weights_dir = args.encoders_dir or args.ckpt_dir
    if weights_dir:
        pipe = load_torch_weights(cfg, weights_dir, device=device, dtype=dtype,
                                  load_dit=False)
    else:
        print("WARNING: --data_dir without --ckpt_dir/--encoders_dir — VAE/T5 encoders "
              "are randomly initialised", flush=True)
        if is_i2v:
            pipe = I2VPipeline.from_config(cfg, device=device, seed=0, init_t5=True,
                                           init_clip=True, init_dit=False, dtype=dtype)
        else:
            pipe = TI2VPipeline.from_config(cfg, device=device, seed=0, init_t5=True,
                                            init_dit=False, dtype=dtype)
    tokenizer = Tokenizer(resolve_tokenizer_path(args.tokenizer_path, weights_dir),
                          seq_len=cfg.dit.text_len, vocab_size=cfg.t5.vocab_size,
                          warn_fallback=not args.smoke)
    # the host draw of the 14B's i2v/v2v branch (reference train.py:305, 380-387)
    rand_i2v = random.Random(args.seed + 31)

    def sample_fn(i):
        s = ds[i % len(ds)]
        return {"video": s["video"], "caption": s["caption"]}

    # worker threads decode ahead of the step; no CUDA call leaves this thread
    loader = PrefetchLoader(sample_fn, batch_size=batch_size, num_workers=2)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def get_batch(step):
        t0 = time.perf_counter()
        raw = next(loader)
        t1 = time.perf_counter()
        video = torch.from_numpy(raw["video"]).to(device, dtype)
        ids, mask = tokenizer(raw["caption"])
        with torch.no_grad():
            ctx = pipe.encode_text(ids, mask)
            if is_i2v:
                draw = rand_i2v.random()
                batch = build_i2v_train_batch(pipe, video, ctx, rand_num_img=draw)
            else:
                batch = {"latents": pipe.vae.encode(video), "context": ctx}
        sync()
        timing = get_batch.timing
        timing["batch_wait_s"].append(t1 - t0)
        timing["encode_s"].append(time.perf_counter() - t1)
        if is_i2v:
            _, f_b, h_b, w_b = batch["latents"].shape[:4]
            lfz = cfg.latent_frame_zero
            s0 = cfg.vae.stride[0]
            i2v = takes_i2v_branch(video.shape[1], draw, (lfz - 1) * s0 + 1, s0)
            timing["branch"].append("i2v" if i2v else "v2v")
            timing["packed_tokens"].append(
                packed_token_count(f_b - lfz, lfz, h_b, w_b, cfg.dit.patch_size))
        return batch

    get_batch.timing = {"batch_wait_s": [], "encode_s": []}
    if is_i2v:
        get_batch.timing.update(branch=[], packed_tokens=[])
    return get_batch, loader, pipe


def _distill_step(fn, disc_state, state, batch, draws):
    """A distillation step in the plain step's form; the discriminator's
    state is updated in place."""
    state, _, metrics = fn(state, disc_state, batch, draws)
    return state, metrics


def _stop_profile(profiler, profile_dir):
    profiler.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"trace written to {path}", flush=True)


def _validation_rollout(args, model, state, batch, lfz, step, lora_model=None, pipe=None):
    """In-training validation: denoise the batch's tail from the EMA
    parameters with the Euler segment sampler (reference train.py:481-534;
    an i2v batch's ``y`` and CLIP features condition the DiT) and save the
    latents, or with ``--data_dir``'s ``pipe`` the decoded
    generated and ground-truth clips as ``val_step<N>_{gen,gt}.mp4``."""
    from .diffusion import samplers
    from .diffusion.schedule import sampling_sigmas

    latents, ctx = batch["latents"][:1], batch["context"][:1]
    # an i2v batch's conditioning (the 14B): y after the latent, CLIP features
    y = batch.get("y")
    kw = {} if batch.get("clip_context") is None else {
        "clip_context": batch["clip_context"][:1]}
    b, f = latents.shape[:2]
    noise = torch.randn(tuple(latents.shape), generator=_generator(latents.device, step),
                        device=latents.device)
    latent0 = torch.cat([latents[:, : f - lfz], noise[:, f - lfz:]], dim=1)

    def ema_forward(lat, t_frame):
        x_in = lat if y is None else torch.cat([lat, y[:1].to(lat.dtype)], dim=-1)
        if lora_model is not None:
            return lora_model(x_in, t_frame, ctx, packed=True, latent_frame_zero=lfz, **kw)
        return torch.func.functional_call(
            model, state.ema_params, (x_in, t_frame, ctx),
            dict(packed=True, latent_frame_zero=lfz, **kw), strict=False)

    def denoise(lat, t_frame):
        out = ema_forward(lat, t_frame)
        return torch.cat([torch.zeros_like(lat[:, : f - lfz]), out.to(lat.dtype)], dim=1)

    if lora_model is not None:
        lora_model.adapters = state.ema_params
    try:
        sig = sampling_sigmas(10 if args.smoke else 50, 3.0)
        rolled = samplers.euler_sample_segment(
            denoise, latent0, sig, lfz,
            history_t=torch.zeros((b, f - lfz), device=latents.device))
    finally:
        if lora_model is not None:
            lora_model.adapters = state.params
    out_dir = os.path.join(args.output_dir, "generated_test_video")
    os.makedirs(out_dir, exist_ok=True)
    mse = float(((rolled[:, -lfz:] - latents[:, -lfz:]) ** 2).mean())
    if pipe is not None:
        from .utils.video import save_video

        for name, z in (("gen", rolled), ("gt", latents)):
            video = pipe.decode_auto(z[:1])[0].float().cpu().numpy()
            path = save_video(video, os.path.join(out_dir, f"val_step{step}_{name}.mp4"),
                              fps=pipe.config.sample_fps)
    else:
        path = os.path.join(out_dir, f"val_latents_step{step}.npy")
        np.save(path, rolled.float().cpu().numpy())
    print(f"validation @ step {step}: tail-latent MSE {mse:.4f} → {path}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
