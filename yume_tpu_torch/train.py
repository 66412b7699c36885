"""Training entry point: flow-matching (+ MVDT, + LoRA) fine-tuning of the 5B DiT
on one GPU (counterpart of yume_tpu/train.py).

    python -m yume_tpu_torch.train --smoke --device cpu    # tiny synthetic run
    python -m yume_tpu_torch.train --lora_rank 16 --remat  # 5B LoRA on the card

Same flags and smoke configs as the reference's train.py, plus ``--device``
(default ``cuda``). Batches are synthetic latents made from a seed per step;
the parameters are random (a checkpoint reader is not ported). On the card
the DiT computes in bf16 (the attention kernels take bf16), on the CPU the
smoke run computes in fp32 as the reference's does. Parameters are stored
in fp32, as flax creates them.

Not ported, and refused with the ROADMAP item that brings them:
``--data_dir`` (the VAE encoder and real videos, queue 1 item 3),
``--ckpt_dir`` and ``--export_torch_dir`` (a safetensors reader and writer,
queue 1 item 7), ``--Distil`` (the ADD discriminator, queue 1 item 7),
``--sp > 1`` (sequence-parallel training, queue 1 item 8; SP serving is
ported) and ``--config i2v-14B`` (queue 1 item 6).
"""

from __future__ import annotations

import argparse
import dataclasses
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
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--encoders_dir", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--output_dir", default="./checkpoints")
    p.add_argument("--max_train_steps", type=int, default=100)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adam8bit"])
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--checkpointing_steps", type=int, default=25)
    p.add_argument("--validation_steps", type=int, default=0)
    p.add_argument("--MVDT", action="store_true")
    p.add_argument("--Distil", action="store_true")
    p.add_argument("--dino_path", default=None)
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
                        "params (base frozen; single-GPU 5B finetune)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export_torch_dir", default=None)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler chrome trace of the steps in "
                        "--profile_steps to this directory")
    p.add_argument("--profile_steps", default="2,5")
    p.add_argument("--device", default="cuda",
                   help="device of the model and the batches (cuda or cpu)")
    return p


def _refuse_unported(args):
    unported = [
        (args.data_dir, "--data_dir needs the VAE encoder and real videos "
                        "(ROADMAP queue 1, item 3)"),
        (args.ckpt_dir, "--ckpt_dir needs a safetensors reader (ROADMAP queue 1, item 7)"),
        (args.export_torch_dir, "--export_torch_dir needs a safetensors writer "
                                "(ROADMAP queue 1, item 7)"),
        (args.Distil, "--Distil needs the ADD discriminator (ROADMAP queue 1, item 7)"),
        (args.sp > 1, "--sp > 1 is sequence-parallel training, which needs a "
                      "differentiable all-to-all and a ring backward that sends dK/dV "
                      "round the ring (ROADMAP queue 1, item 8); sequence-parallel "
                      "serving is TI2VPipeline with sp_groups"),
        (args.config == "i2v-14B", "--config i2v-14B needs the 14B modules "
                                   "(ROADMAP queue 1, item 6)"),
    ]
    for flag, why in unported:
        if flag:
            raise NotImplementedError(f"not ported yet: {why}")


def smoke_dit_config(mvdt: bool):
    """The tiny ti2v smoke DiT of the reference's train.py."""
    from .configs import DiTConfig

    return DiTConfig(model_type="ti2v", in_dim=8, out_dim=8, dim=64, ffn_dim=128,
                     freq_dim=32, text_dim=16, text_len=16, num_heads=4,
                     num_layers=2, framepack=True, mvdt=mvdt)


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
    _refuse_unported(args)
    os.makedirs(args.output_dir, exist_ok=True)

    from .configs import CONFIGS
    from .models.dit import WanDiT, packed_token_count
    from .training.train_step import (TrainConfig, draw_step, init_train_state,
                                      make_train_step, trainable_params)
    from .utils.checkpoint import restore_checkpoint, save_checkpoint

    device = torch.device(args.device)
    cfg = CONFIGS[args.config]()
    dit_cfg, lfz = cfg.dit, cfg.latent_frame_zero
    if args.smoke:
        dit_cfg, lfz = smoke_dit_config(args.MVDT), 2
        args.max_train_steps = min(args.max_train_steps, 5)
    elif args.MVDT:
        dit_cfg = dataclasses.replace(dit_cfg, mvdt=True)

    dtype = torch.float32 if args.smoke and device.type == "cpu" else torch.bfloat16
    model = WanDiT(dit_cfg, dtype, device="meta", param_dtype=torch.float32,
                   remat=args.remat).to_empty(device=device)
    init_params_(model, _generator(device, args.seed))

    # latent geometry
    if args.smoke:
        b, f, h, w = 1, 3 + lfz, 8, 8
    else:
        b = args.data_parallel
        f = (args.num_frames - 1) // cfg.vae.stride[0] + 1 + lfz
        h = args.height // cfg.vae.stride[1]
        w = args.width // cfg.vae.stride[2]
    text_len, text_dim = dit_cfg.text_len, dit_cfg.text_dim

    mvdt_keeps = None
    if args.MVDT:
        # the reference samples mask_ratio ~ U[0.3, 0.5] per step
        # (wan23/modules/model.py:766-767), quantised to 9 ratios; the keep
        # count is a share of the packed tokens the step masks
        n_tok = packed_token_count(f - lfz, lfz, h, w, dit_cfg.patch_size)
        mvdt_keeps = [int(n_tok * (1.0 - (0.30 + 0.025 * i))) for i in range(9)]

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
        keeps = mvdt_keeps or [None]
        step_fns = {k: make_train_step(model, tc, mvdt_keep=k) for k in set(keeps)}

        def step_fn(state, batch, draws, step):
            # a keep count per step, drawn from (seed, step) so a resumed
            # run takes the same ones
            return step_fns[random.Random(args.seed * 1000003 + step).choice(keeps)](
                state, batch, draws)

    def synthetic_batch(step):
        gen = _generator(device, step)
        return {"latents": torch.randn((b, f, h, w, dit_cfg.in_dim), generator=gen,
                                       device=device),
                "context": torch.randn((b, text_len, text_dim), generator=gen,
                                       device=device) * 0.02}

    start_step = 0
    if args.resume and os.path.isdir(args.output_dir):
        try:
            state = restore_checkpoint(args.output_dir, state)
            start_step = state.step
            print(f"resumed at step {start_step}", flush=True)
        except FileNotFoundError as e:
            print(f"resume failed: {e}", flush=True)

    prof_lo, prof_hi = (int(s) for s in args.profile_steps.split(","))
    profiler = None
    times, losses, grad_norms = [], [], []
    for step in range(start_step, args.max_train_steps):
        if args.profile_dir and step == prof_lo:
            profiler = torch.profiler.profile()
            profiler.__enter__()
        t_start = time.time()
        batch = synthetic_batch(step)
        draws = draw_step(batch, tc, _generator(device, args.seed * 1000003 + step),
                          masked=args.MVDT)
        state, metrics = step_fn(state, batch, draws, step)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        times.append(time.time() - t_start)
        losses.append(loss)
        grad_norms.append(grad_norm)
        if profiler is not None and step == prof_hi:
            _stop_profile(profiler, args.profile_dir)
            profiler = None
        print(f"step {step + 1}/{args.max_train_steps} loss={loss:.4f} "
              f"grad_norm={grad_norm:.3f} step_time={np.mean(times[-100:]):.2f}s",
              flush=True)
        if args.checkpointing_steps and (step + 1) % args.checkpointing_steps == 0:
            path = save_checkpoint(args.output_dir, state)
            print(f"checkpoint saved at step {step + 1}: {path}", flush=True)
        if args.validation_steps and (step + 1) % args.validation_steps == 0:
            _validation_rollout(args, model, state, batch, lfz, step + 1, lora_model)
    if profiler is not None:
        _stop_profile(profiler, args.profile_dir)
    main.last_run = {"losses": losses, "grad_norms": grad_norms, "step_times": times,
                     "trainable": sum(p.numel() for p in state.params.values())}
    return 0


main.last_run = None


def _stop_profile(profiler, profile_dir):
    profiler.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"trace written to {path}", flush=True)


def _validation_rollout(args, model, state, batch, lfz, step, lora_model=None):
    """In-training validation: denoise the batch's tail from the EMA
    parameters with the Euler segment sampler and save the latents
    (the reference's rollout without a pipeline, train.py:481-534)."""
    from .diffusion import samplers
    from .diffusion.schedule import sampling_sigmas

    latents, ctx = batch["latents"][:1], batch["context"][:1]
    b, f = latents.shape[:2]
    noise = torch.randn(tuple(latents.shape), generator=_generator(latents.device, step),
                        device=latents.device)
    latent0 = torch.cat([latents[:, : f - lfz], noise[:, f - lfz:]], dim=1)

    def ema_forward(lat, t_frame):
        if lora_model is not None:
            return lora_model(lat, t_frame, ctx, packed=True, latent_frame_zero=lfz)
        return torch.func.functional_call(
            model, state.ema_params, (lat, t_frame, ctx),
            dict(packed=True, latent_frame_zero=lfz), strict=False)

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
    path = os.path.join(out_dir, f"val_latents_step{step}.npy")
    np.save(path, rolled.float().cpu().numpy())
    print(f"validation @ step {step}: tail-latent MSE {mse:.4f} → {path}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
