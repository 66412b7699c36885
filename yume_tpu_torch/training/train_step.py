"""Training step: flow matching (+ the optional MVDT masked pass), clipped
AdamW or 8-bit Adam with warmup, EMA (counterpart of
yume_tpu/training/train_step.py).

The reference's step is a pure function over an explicit state; here the
state's parameter tensors are the model's own (for a full fine-tune) or the
LoRA adapters, and the step updates them, the moments and the EMA in place,
one tensor at a time: a fused update over all 5.2 B parameters of the 5B
DiT would allocate a temporary of 10–20 GB.

Random draws are explicit (:func:`draw_step`), so a test can hand the port
and the JAX package the same numbers: the timestep draw, the x0 noise, the
history-mask draws (not on the 14B's i2v pass, which noises the whole
latent) and, for the masked pass, the MVDT token noise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..diffusion.transport import Transport
from ..utils.masks import draw_history, masks_like
from . import optim


@dataclasses.dataclass
class TrainState:
    """step, the trained tensors by name, the optimizer state and the EMA
    (a separate copy of ``params``)."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    ema_params: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    ema_decay: float = 0.995
    shift: float = 3.0
    latent_frame_zero: int = 8
    mvdt: bool = False
    mask_history_p: float = 0.2  # masks_like noisy-history probability
    optimizer: str = "adamw"  # 'adamw' | 'adam8bit' (int8 moments, optim.py)
    lr_warmup_steps: int = 0  # linear warmup from 0, then constant


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ Σ t²) over tensors, summed in fp32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class AdamChain:
    """The reference's optax chain: ``clip_by_global_norm(grad_clip)``, then
    Adam (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt; moments in the
    parameter dtype, as optax's ``mu_dtype=None``) or 8-bit Adam, decoupled
    weight decay, and the (warmed-up) learning rate. ``update_`` changes the
    parameters and the state in place, one tensor at a time."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("adamw", "adam8bit"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        if self.cfg.optimizer == "adam8bit":
            return {"count": 0, "leaves": {n: optim.init_leaf(p) for n, p in params.items()}}
        return {"count": 0, "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def learning_rate(self, count: int) -> float:
        """The rate of the update after ``count`` earlier updates (optax's
        linear_schedule(0, lr, warmup) then constant, in fp32)."""
        lr, w = self.cfg.learning_rate, self.cfg.lr_warmup_steps
        if not w or count >= w:
            return lr
        frac = np.float32(1.0) - np.float32(count) / np.float32(w)
        return float(np.float32(-lr) * frac + np.float32(lr))

    def _adam(self, g, mu, nu, bc1, bc2):
        mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        return (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: Dict[str, Any]) -> torch.Tensor:
        """Apply one update; ``grads`` is emptied as it goes (each gradient
        is freed once used). Returns the unclipped global norm."""
        cfg = self.cfg
        g_norm = global_norm(grads.values())
        clip = not bool(g_norm < cfg.grad_clip)
        step_size = -self.learning_rate(state["count"])
        state["count"] += 1
        # the bias corrections 1 − b**count in fp32, on the device once per
        # update (a host scalar copied per tensor would synchronise each time)
        device = g_norm.device
        bc = [torch.tensor(np.float32(1.0) - np.float32(b) ** np.float32(state["count"]),
                           device=device) for b in (self.b1, self.b2)]
        # per dtype: the clip divisor and, as optax's astype(moment dtype),
        # the bias corrections rounded to the moments' dtype
        scalars = {}
        for name in list(grads):
            g, p = grads.pop(name), params[name]
            if g.dtype not in scalars:
                scalars[g.dtype] = [t.to(g.dtype) for t in [g_norm] + bc]
            norm, bc1, bc2 = scalars[g.dtype]
            if clip:
                g = (g / norm) * cfg.grad_clip
            if cfg.optimizer == "adam8bit":
                u = optim.adam8bit_update_(g, state["leaves"][name], *bc,
                                           self.b1, self.b2, self.eps)
                if cfg.weight_decay:
                    u = u + cfg.weight_decay * p
            else:
                u = self._adam(g, state["mu"][name], state["nu"][name], bc1, bc2)
                u = u + cfg.weight_decay * p
            del g
            p.add_(u * step_size)
        return g_norm


def make_optimizer(cfg: TrainConfig) -> AdamChain:
    """Clipped AdamW, or 8-bit Adam with ``optimizer='adam8bit'``."""
    return AdamChain(cfg)


def init_train_state(params: Dict[str, torch.Tensor], cfg: TrainConfig) -> TrainState:
    """State over ``params`` (name → tensor; kept, not copied); the EMA
    starts as a separate copy."""
    return TrainState(step=0, params=dict(params),
                      opt_state=make_optimizer(cfg).init(params),
                      ema_params={n: p.detach().clone() for n, p in params.items()})


def trainable_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters of ``model`` that require grad, by name."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------


def draw_flow(batch, generator: torch.Generator, transport: Transport) -> Dict[str, Any]:
    """The draws of one flow pass: ``t`` (the standard draw behind the
    timestep, [B]), ``x0`` (noise like the latents, fp32) and, unless the
    batch is an i2v one (it carries ``y``), ``hist`` (the two history-mask
    draws)."""
    x1 = batch["latents"]
    draws = {"t": transport.draw_t(x1.shape[0], generator),
             "x0": torch.randn(tuple(x1.shape), generator=generator,
                               device=generator.device)}
    if "y" not in batch:
        draws["hist"] = draw_history(generator)
    return draws


def draw_step(batch, cfg: TrainConfig, generator: torch.Generator, *,
              masked: bool = False) -> Dict[str, Any]:
    """All draws of one train step from ``generator``: ``flow`` for the
    plain pass and, with ``masked``, ``masked`` for the MVDT pass, whose
    token noise (``mvdt``) the model draws from the generator itself."""
    transport = Transport(shift=cfg.shift)
    draws = {"flow": draw_flow(batch, generator, transport)}
    if masked:
        draws["masked"] = dict(draw_flow(batch, generator, transport), mvdt=generator)
    return draws


# ---------------------------------------------------------------------------
# loss and step
# ---------------------------------------------------------------------------


def make_loss_fn(model: nn.Module, cfg: TrainConfig, *, packed: bool = True,
                 mvdt_keep: Optional[int] = None,
                 forward: Optional[Callable] = None) -> Callable:
    """``loss_fn(batch, draws) -> (loss, denoised_tail)`` over ``model``'s
    current parameters. The MVDT masked pass (``cfg.mvdt`` and
    ``mvdt_keep``) is a second forward whose loss adds to the total, as the
    reference's two sequential backwards (distill_model.py:289-318).
    ``forward``: what runs the DiT, with ``model.__call__``'s signature
    (the reference's ``fwd_apply``; the sequence-parallel forward under
    ``--sp``); ``model`` by default."""
    transport = Transport(shift=cfg.shift)
    lfz = cfg.latent_frame_zero
    fwd = model if forward is None else forward

    def flow_pass_i2v(batch, d, *, masked: bool):
        """The 14B i2v pass (reference Transport.training_losses with
        distill_model.py:275-318): the whole latent, history and tail, is
        noised at one t a sample; the clean conditioning rides in ``y``
        (mask channels and the VAE latents of the history), concatenated
        after x_t as the DiT's input; the CLIP features reach the i2v
        cross-attention; the loss covers the tail frames only."""
        x1, y, ctx = batch["latents"], batch["y"], batch["context"]
        b, f = x1.shape[:2]
        t = transport.sample_t(d["t"].to(x1.device))
        xt, ut = transport.plan(t, d["x0"].to(device=x1.device, dtype=x1.dtype), x1)
        t_frame = t[:, None].expand(b, f) * 1000.0
        kw = dict(mvdt_noise=d["mvdt"], mvdt_keep=mvdt_keep) if masked else {}
        if batch.get("clip_context") is not None:
            kw["clip_context"] = batch["clip_context"]
        v = fwd(torch.cat([xt, y.to(xt.dtype)], dim=-1), t_frame, ctx, packed=packed,
                latent_frame_zero=lfz, **kw)
        return _tail_loss(v, xt, ut, t)

    def flow_pass(batch, d, *, masked: bool):
        """One conditioning-masked flow pass: (loss, x̂₁ = x_t − t·v̂ on the
        tail frames)."""
        if "y" in batch:
            return flow_pass_i2v(batch, d, masked=masked)
        x1, ctx = batch["latents"], batch["context"]
        b, f = x1.shape[:2]
        t = transport.sample_t(d["t"].to(x1.device))
        xt, ut = transport.plan(t, d["x0"].to(device=x1.device, dtype=x1.dtype), x1)
        # clean (or pseudo-noised) history, diffused tail
        mask1, mask2 = masks_like(tuple(x1.shape), zero=True, draws=d["hist"],
                                  p=cfg.mask_history_p, latent_frame_zero=lfz,
                                  device=x1.device)
        xt = (1.0 - mask2) * x1 + mask2 * xt
        # per-frame timesteps: history at its pseudo-sigma (0 when clean)
        hist_t = mask1[:, : f - lfz, 0, 0, 0]
        t_frame = torch.cat([hist_t, t[:, None].expand(b, lfz)], dim=1) * 1000.0
        kw = dict(mvdt_noise=d["mvdt"], mvdt_keep=mvdt_keep) if masked else {}
        v = fwd(xt, t_frame, ctx, packed=packed, latent_frame_zero=lfz, **kw)
        return _tail_loss(v, xt, ut, t)

    def _tail_loss(v, xt, ut, t):
        """(velocity MSE over the tail frames, x̂₁ = x_t − t·v̂ there)."""
        v_tail = v[:, -lfz:].float()
        loss = torch.mean((v_tail - ut[:, -lfz:].float()) ** 2)
        denoised_tail = xt[:, -lfz:].float() - t[:, None, None, None, None] * v_tail
        return loss, denoised_tail

    def loss_fn(batch, draws):
        loss, denoised_tail = flow_pass(batch, draws["flow"], masked=False)
        if cfg.mvdt and mvdt_keep is not None:
            loss = loss + flow_pass(batch, draws["masked"], masked=True)[0]
        return loss, denoised_tail

    return loss_fn


def make_train_step(model: nn.Module, cfg: TrainConfig, *, packed: bool = True,
                    mvdt_keep: Optional[int] = None, forward: Optional[Callable] = None,
                    reduce_grads: Optional[Callable] = None) -> Callable:
    """``step(state, batch, draws) -> (state, metrics)``: loss and gradients
    of ``state.params``, the optimizer update and the EMA
    ``e·d + p·(1 − d)`` (in the parameter dtype), all in place. Batch:
    ``latents`` [B, F, H, W, C] clean latents (history + tail), ``context``
    [B, text_len, text_dim]; an i2v batch (the 14B) adds ``y`` [B, F, H, W,
    s0 + z] and ``clip_context`` (see :mod:`.i2v_batch`).

    ``forward``: see :func:`make_loss_fn`. ``reduce_grads(grads)``, given
    the gradients by name, reduces them in place before the global-norm
    clipping: under sequence parallelism each rank's gradients hold its own
    tokens' share and the reduction sums them over the group."""
    optimizer = make_optimizer(cfg)
    loss_fn = make_loss_fn(model, cfg, packed=packed, mvdt_keep=mvdt_keep, forward=forward)

    def train_step(state: TrainState, batch, draws) -> Tuple[TrainState, dict]:
        names = list(state.params)
        # the three parts are named for torch.profiler traces
        with record_function("loss_and_grads"):
            loss, _ = loss_fn(batch, draws)
            # parameters the step does not reach (FramePack convs of unused
            # scales) get zero gradients, as under jax.grad
            grads = dict(zip(names, torch.autograd.grad(
                loss, [state.params[n] for n in names], allow_unused=True,
                materialize_grads=True)))
            if reduce_grads is not None:
                reduce_grads(grads)
        with record_function("optimizer"):
            grad_norm = optimizer.update_(state.params, grads, state.opt_state)
        d = cfg.ema_decay
        with record_function("ema"), torch.no_grad():
            for n in names:
                state.ema_params[n].mul_(d).add_(state.params[n], alpha=1.0 - d)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step
