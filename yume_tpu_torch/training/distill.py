"""Adversarial distillation (ADD) training step (counterpart of
yume_tpu/training/distill.py): hinge loss on the projected discriminator
over the one-step denoised tail latents against the real tail latents, plus
a 0.01-weighted generator GAN term added to the flow-matching loss.

The denoised sample is the one-step x0 estimate x̂₁ = x_t − t·v̂, which
``make_loss_fn`` returns beside the loss. The step keeps ONE DiT graph for
both terms, as the reference's retained autograd graph: the discriminator
update and the GAN term run on detached copies of x̂₁, and one backward
through the DiT takes the flow loss's cotangent 1 and the GAN term's
gradient with respect to x̂₁.

The discriminator's parameters other than DINO's train with their own
clipped AdamW (:func:`disc_optimizer`, the reference's
``optax.masked(chain(clip_by_global_norm(1.0), adamw(1e-5)), not_dino)``):
DINO's parameters are frozen (``requires_grad`` off) and have no optimizer
state, and the clipping norm covers the other gradients only. Gradients
still flow through DINO's activations. As elsewhere in the port, the
updates happen in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..models.discriminator import ProjectedDiscriminator, random_init_
from .train_step import AdamChain, TrainConfig, make_loss_fn, make_optimizer, trainable_params


@dataclasses.dataclass
class DiscState:
    """The discriminator's trained parameters by name (the module's own
    tensors: every parameter but DINO's) and their optimizer state. The
    spectral vectors are the module's ``u`` buffers."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]


def disc_optimizer(learning_rate: float = 1e-5) -> AdamChain:
    """The discriminator's clipped AdamW (clip 1.0, weight decay 1e-4)."""
    return AdamChain(TrainConfig(learning_rate=learning_rate))


def init_disc_state(optimizer: AdamChain, z_dim: int = 16, dino_path: Optional[str] = None, *,
                    device="cuda", generator: Optional[torch.Generator] = None
                    ) -> Tuple[ProjectedDiscriminator, DiscState]:
    """A randomly initialised fp32 discriminator on ``device`` with DINO
    frozen, and its state. ``dino_path``: DINO ViT-S/16 weights in timm's
    layout (``dino_deitsmall16_pretrain.pth``) for the projector. (The JAX
    package's ``latent_hw`` only shaped flax's init; the modules here need
    ``z_dim`` alone.)"""
    disc = ProjectedDiscriminator(z_dim).to(device)
    random_init_(disc, generator if generator is not None else torch.Generator(device=device))
    if dino_path:
        from ..utils.checkpoint import load_torch_state_dict
        from ..utils.convert import dino_state_dict, load_state_dict

        load_state_dict(disc.dino, dino_state_dict(load_torch_state_dict(dino_path),
                                                   depth=len(disc.dino.blocks)))
    disc.dino.requires_grad_(False)
    params = trainable_params(disc)
    return disc, DiscState(params=params, opt_state=optimizer.init(params))


def hinge_d_loss(pred_real, pred_real_f, pred_fake, pred_fake_f) -> torch.Tensor:
    loss_real = torch.relu(1.0 - pred_real).mean() + torch.relu(1.0 - pred_real_f).mean()
    loss_fake = torch.relu(1.0 + pred_fake).mean() + torch.relu(1.0 + pred_fake_f).mean()
    return (loss_real + loss_fake) / 2.0


def gan_g_loss(pred_fake, pred_fake_f) -> torch.Tensor:
    return -pred_fake.mean() - pred_fake_f.mean()


def _disc_hinge_update(disc: ProjectedDiscriminator, optimizer: AdamChain, state: DiscState,
                       real: torch.Tensor, fake: torch.Tensor):
    """One hinge-loss update on detached (real, fake) frame batches
    [N, H, W, C]: the real pass updates the spectral vectors, the fake pass
    starts from them and its vectors are kept."""
    pr, prf = disc(real.detach())
    pf, pff = disc(fake.detach())
    loss = hinge_d_loss(pr, prf, pf, pff)
    names = list(state.params)
    grads = dict(zip(names, torch.autograd.grad(loss, [state.params[n] for n in names])))
    optimizer.update_(state.params, grads, state.opt_state)
    return state, loss.detach()


def make_disc_step(disc: ProjectedDiscriminator, optimizer: AdamChain) -> Callable:
    """``step(state, real, fake) -> (state, d_loss)`` on (real, fake) tail
    frames, each [F, H, W, C] (frames as batch)."""

    def step(state: DiscState, real, fake):
        return _disc_hinge_update(disc, optimizer, state, real, fake)

    return step


def generator_gan_term(disc: ProjectedDiscriminator, fake_tail: torch.Tensor,
                       weight: float = 0.01) -> torch.Tensor:
    """``weight · (−D(fake_tail))`` with the discriminator frozen: its
    parameters get no gradient and its spectral vectors are left as they
    were (one power iteration runs and is dropped)."""
    params = {n: p.detach() for n, p in disc.named_parameters()}
    pf, pff = torch.func.functional_call(disc, params, (fake_tail,), {"update_u": False})
    return weight * gan_g_loss(pf, pff)


def _frames(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def make_distill_train_step(model: torch.nn.Module, cfg: TrainConfig,
                            disc: ProjectedDiscriminator, disc_opt: AdamChain, *,
                            packed: bool = True, mvdt_keep: Optional[int] = None,
                            gan_weight: float = 0.01, forward: Optional[Callable] = None,
                            reduce_grads: Optional[Callable] = None) -> Callable:
    """The ADD distillation step, ``step(state, disc_state, batch, draws) ->
    (state, disc_state, metrics)``:

    1. the generator's forward (flow loss, + the MVDT pass) and x̂₁, with
       its graph kept;
    2. a discriminator update on (real tail, detached x̂₁);
    3. the GAN term through the *updated* discriminator, and its gradient
       with respect to x̂₁ alone;
    4. one backward through the DiT with cotangents (1, that gradient);
    5. clipped AdamW and EMA on the generator, as ``make_train_step``.

    ``forward`` and ``reduce_grads`` as :func:`.train_step.make_train_step`'s:
    the reduction takes the generator's gradients after step 4; the
    discriminator's are not reduced, as its inputs (the real and the
    gathered denoised tails) are the same on every rank.

    Metrics: ``loss`` (flow + GAN), ``flow_loss``, ``gan_loss``, ``d_loss``,
    ``grad_norm``. Each part is a named range for torch.profiler."""
    optimizer = make_optimizer(cfg)
    loss_fn = make_loss_fn(model, cfg, packed=packed, mvdt_keep=mvdt_keep, forward=forward)
    lfz = cfg.latent_frame_zero

    def step(state, disc_state: DiscState, batch, draws):
        names = list(state.params)
        with record_function("generator_forward"):
            loss, denoised = loss_fn(batch, draws)
        real = batch["latents"][:, -lfz:].float()
        with record_function("discriminator_update"):
            disc_state, d_loss = _disc_hinge_update(disc, disc_opt, disc_state,
                                                    _frames(real), _frames(denoised))
        with record_function("generator_gan_term"):
            dt = denoised.detach().requires_grad_()
            gan_loss = generator_gan_term(disc, _frames(dt), gan_weight)
            (g_dt,) = torch.autograd.grad(gan_loss, dt)
        with record_function("generator_backward"):
            grads = dict(zip(names, torch.autograd.grad(
                [loss, denoised], [state.params[n] for n in names],
                [torch.ones_like(loss), g_dt], allow_unused=True, materialize_grads=True)))
            if reduce_grads is not None:
                reduce_grads(grads)
        with record_function("optimizer"):
            grad_norm = optimizer.update_(state.params, grads, state.opt_state)
        d = cfg.ema_decay
        with record_function("ema"), torch.no_grad():
            for n in names:
                state.ema_params[n].mul_(d).add_(state.params[n], alpha=1.0 - d)
        state.step += 1
        loss, gan_loss = loss.detach(), gan_loss.detach()
        return state, disc_state, {"loss": loss + gan_loss, "flow_loss": loss,
                                   "gan_loss": gan_loss, "d_loss": d_loss,
                                   "grad_norm": grad_norm}

    return step


def teacher_rollout(pipe, ctx: torch.Tensor, teacher_params: Optional[torch.nn.Module], *,
                    size: Tuple[int, int] = (1280, 704), frame_num: int = 81,
                    steps: int = 8, shift: float = 5.0, solver: str = "unipc",
                    seed: int = 0, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-latent targets for distillation (the reference's
    ``teacher_rollout``, yume_tpu/training/distill.py:190-210): a cond-only
    multistep rollout of the frozen teacher DiT ``teacher_params`` through
    ``pipe.generate_t2v_dmd`` (reference ``t2v_dmd`` with
    ``teacher_transformer``, wan23/textimage2video.py:519-653). Returns the
    latents; ``noise`` replaces the seeded initial noise."""
    return pipe.generate_t2v_dmd(ctx, teacher_params=teacher_params, size=size,
                                 frame_num=frame_num, steps=steps, shift=shift, solver=solver,
                                 seed=seed, noise=noise, return_latents=True)
