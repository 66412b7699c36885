"""LoRA adapters for parameter-efficient fine-tuning (counterpart of
yume_tpu/training/lora.py).

Adapters are kept in ``nn.Linear`` layout, as peft does: for a layer with
weight W [out, in], ``lora_a`` [rank, in] and ``lora_b`` [out, rank], and
the effective weight is W + scale·(lora_b @ lora_a) (the reference's
W + scale·(A @ B) with A [in, rank] = lora_aᵀ and B [rank, out] = lora_bᵀ).
The adapters live in a flat dict ``{"<layer>.lora_a": ..., "<layer>.lora_b":
...}``, which is what the train step updates. They are fp32, as the
reference's are, also over a bf16 base (:func:`bf16_base_`, the 14B on one
card).

:class:`LoRAModel` merges them inside each layer's forward through a
parametrization of its weight: the merged weight exists only while the
layer runs (and is recomputed under remat), the frozen base keeps no merged
copy and gets no gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

DEFAULT_TARGETS = ("self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
                   "cross_attn.q", "cross_attn.k", "cross_attn.v", "cross_attn.o")


def _targets(model: nn.Module, targets) -> Dict[str, nn.Linear]:
    """Linear layers whose weight path contains one of ``targets`` (the
    reference matches "<target>" inside ".../kernel" paths)."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, nn.Linear) and any(t in f"{name}.weight" for t in targets)}


def init_lora(model: nn.Module, *, rank: int = 16,
              targets: Tuple[str, ...] = DEFAULT_TARGETS,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """(A, B) pairs for every targeted Linear: A ~ N(0, 1)/sqrt(in), B zero,
    so the merged model equals the base at step 0. fp32 (the reference's
    adapters and Adam moments are fp32 whatever the base's dtype), on the
    weights' device."""
    lora = {}
    for name, layer in _targets(model, targets).items():
        w = layer.weight
        d_out, d_in = w.shape
        a = torch.randn((rank, d_in), generator=generator, device=w.device,
                        dtype=torch.float32) / d_in ** 0.5
        lora[f"{name}.lora_a"] = a.requires_grad_()
        lora[f"{name}.lora_b"] = torch.zeros((d_out, rank), device=w.device,
                                             dtype=torch.float32).requires_grad_()
    return lora


def bf16_base_(model: nn.Module) -> int:
    """Store the blocks' Linear weights in bf16, in place (a model on the
    ``meta`` device stays there, to be materialised by ``to_empty``): the
    frozen base of a LoRA fine-tune on one card. The forward casts these
    weights to its compute dtype, bf16 on the card, so it is unchanged;
    biases, norm scales, modulation, the embeddings and the head keep their
    dtype. Returns the number of parameters cast."""
    n = 0
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear) and name.startswith("blocks."):
            m.weight = nn.Parameter(m.weight.detach().to(torch.bfloat16),
                                    requires_grad=False)
            n += m.weight.numel()
    return n


def base_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` under the plain parameter names: a
    :class:`LoRAModel`'s layers hold their frozen weight as
    ``<layer>.parametrizations.weight.original``, given here as
    ``<layer>.weight``."""
    return {k.replace(".parametrizations.weight.original", ".weight"): v
            for k, v in model.state_dict().items()}


def merge_lora(state_dict: Dict[str, torch.Tensor], lora: Dict[str, torch.Tensor], *,
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """A state dict with W + scale·(B @ A) at every adapted ``<layer>.weight``
    (for export or evaluation; training merges per layer, see
    :class:`LoRAModel`), in fp32 where W is of lower precision (a bf16
    base)."""
    out = dict(state_dict)
    for key in lora:
        if key.endswith(".lora_a"):
            layer = key[: -len(".lora_a")]
            w = state_dict[f"{layer}.weight"]
            out[f"{layer}.weight"] = w + scale * (lora[f"{layer}.lora_b"] @ lora[key])
    return out


def count_params(tree) -> int:
    """Elements in a (nested) dict of tensors."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())


class _Merged(nn.Module):
    """Parametrization W ↦ W + scale·(B @ A), reading the adapters of one
    layer from a shared holder, so the EMA adapters can be swapped in. A
    bf16 W is added to the fp32 product in fp32 and rounded once."""

    def __init__(self, holder: "LoRAModel", layer: str):
        super().__init__()
        self.holder, self.layer = [holder], layer  # a list: not a submodule

    def forward(self, w):
        holder = self.holder[0]
        a = holder.adapters[f"{self.layer}.lora_a"]
        b = holder.adapters[f"{self.layer}.lora_b"]
        return (w + holder.scale * (b @ a)).to(w.dtype)


class LoRAModel:
    """A model whose targeted Linear weights read W + scale·(B @ A) from
    ``adapters`` (a flat adapter dict; reassign it to evaluate other
    adapters, e.g. the EMA). The base parameters are frozen."""

    def __init__(self, model: nn.Module, adapters: Dict[str, torch.Tensor], *,
                 scale: float = 1.0):
        self.model, self.adapters, self.scale = model, adapters, scale
        for p in model.parameters():
            p.requires_grad_(False)
        for key in adapters:
            if key.endswith(".lora_a"):
                layer = key[: -len(".lora_a")]
                parametrize.register_parametrization(
                    model.get_submodule(layer), "weight", _Merged(self, layer),
                    unsafe=True)

    def __call__(self, *args, **kwargs):
        return self.model(*args, **kwargs)


def make_lora_train_step(lora_model: LoRAModel, train_cfg, *,
                         packed: bool = True) -> Callable:
    """Train step over the adapters only (base frozen):
    ``step(state, batch, draws) -> (state, metrics)`` with ``state.params``
    the adapter dict, which the model reads during the step."""
    from .train_step import make_train_step

    inner = make_train_step(lora_model, train_cfg, packed=packed)

    def step(state, batch, draws):
        lora_model.adapters = state.params
        return inner(state, batch, draws)

    return step
