"""Int8 and int4 storage of the DiT trunk (counterpart of
yume_tpu/models/quantized.py): the 14B on one card without its bf16 trunk.

The block projections (self-attention q, k, v, o; cross-attention q, k, v,
o and the 14B's k_img, v_img; ffn.0 and ffn.2) are stored as int8 with one
fp32 scale per output channel (:class:`..ops.quant_matmul.Q8`), or as
nibble-packed int4 with one fp32 scale per (output channel, group of 128
inputs) (:class:`..ops.quant_matmul.Q4`); the embeddings, the time and
text layers, the CLIP projection, the head and the blocks' biases, norms and
modulation keep their dtype. A quantized trunk is the same :class:`WanDiT`
whose block projections are :class:`..models.dit.QLinear` modules (their
tensors are buffers, so :class:`..utils.offload.OffloadSlot` parks it as a
whole), marked by ``quant_bits``. Self-attention q, k and v are stored as
one ``self_attn.qkv`` of ``[3·dim, dim]``, the one product the reference
concatenates them into on every call; its codes and scales are those of
the three apart (both are per output channel). Sizes of the stored blocks:
the 14B's 40 × 403.7 M weights are 32.3 GB in bf16, 16.2 GB in int8 and
8.6 GB in int4.

The reference's ``int8_dit_apply`` is :meth:`WanDiT.forward` on this trunk:
a plain loop over the layers (the reference's single ``lax.scan`` and its
per-layer gather are XLA lessons). Under W8A8 (``cfg.w8a8``) the stored
weights go to K6 as they are, int4 relayed to int8 on each call
(:func:`..ops.quant_matmul.q4_to_q8`); without it each projection is
dequantized to the compute dtype (``QLinear.dequant``, the reference's
``_dequantize_leaf``) and computed exactly. Its TeaCache form, one cached
tensor for the middle chunk's delta ``x_out − x_in`` instead of one
residual a block, is ``forward(cache_edge=...)``.

Not ported: ``int8_dit_apply(pipelined=True)``, which no entry point uses,
and ``bits=16`` (stacking without quantizing, an XLA compile-time device).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..configs import DiTConfig
from ..ops.quant_matmul import Q4, Q8
from .dit import DiTBlock, QLinear, WanDiT

Leaf = Union[torch.Tensor, Q8, Q4]


def _quantizable(w: torch.Tensor) -> bool:
    return w.dim() >= 2 and w.shape[-1] >= 128 and w.shape[-2] >= 128


def _divide(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` in t's dtype, rounded once from the exact quotient (the
    divisor a tensor: CUDA divides by a Python scalar through its
    reciprocal)."""
    return t / torch.tensor(d, dtype=t.dtype, device=t.device)


def _quantize_leaf(w: torch.Tensor) -> Leaf:
    """A ``[N, K]`` weight → :class:`Q8` (the reference's ``_quantize_leaf``
    on its ``[K, N]`` kernel); smaller leaves come back unchanged. The scale
    ``max|w| / 127`` is computed in w's dtype (a bf16 quotient for a bf16
    weight) and kept in fp32; ``round(w / scale)`` divides in fp32, rounding
    half to even; an all-zero channel has scale 0 and codes 0."""
    if not _quantizable(w):
        return w
    scale = _divide(w.abs().amax(-1, keepdim=True), 127.0).float()
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(w / safe), -127, 127).to(torch.int8)
    return Q8(q=q, scale=scale[:, 0])


def _quantize_leaf4(w: torch.Tensor, group: int = 128) -> Leaf:
    """A ``[N, K]`` weight → :class:`Q4` with one scale a (channel, group of
    ``group`` inputs), ``max|w| / 7`` in w's dtype, codes ``round(w /
    scale) + 8`` in [1, 15]; when K does not split into even groups, int8
    (:func:`_quantize_leaf`); smaller leaves come back unchanged."""
    if not _quantizable(w):
        return w
    n, k = w.shape
    group = min(group, k)
    if k % group or group % 2:
        return _quantize_leaf(w)
    wg = w.reshape(n, k // group, group)
    scale = _divide(wg.abs().amax(-1), 7.0).float()                   # [N, G]
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    qi = (torch.clamp(torch.round(wg / safe), -7, 7) + 8).to(torch.uint8)
    q = qi[..., :group // 2] | (qi[..., group // 2:] << 4)
    return Q4(q=q.reshape(n, k // 2), scale=scale)


_QUANTIZE = {8: _quantize_leaf, 4: _quantize_leaf4}


def _projections(block: DiTBlock) -> Iterator[Tuple[nn.Module, str, nn.Module]]:
    """(parent, name, layer) of each projection of a block, in module order."""
    for parent in list(block.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, (nn.Linear, QLinear)):
                yield parent, name, child


@torch.no_grad()
def quantize_block_(block: DiTBlock, bits: int) -> DiTBlock:
    """Replace each quantizable projection of ``block`` by a :class:`QLinear`
    of its weight as stored, self-attention q, k and v by one ``qkv`` (in
    place: the dense weight goes with its module, and so do W8A8 weights
    derived from it)."""
    qfn = _QUANTIZE[bits]
    attn = block.self_attn
    if "qkv" not in attn._modules:
        sib = (attn.q, attn.k, attn.v)
        w = qfn(torch.cat([l.weight.detach() for l in sib]))
        if isinstance(w, (Q8, Q4)):
            attn.qkv = QLinear(w, torch.cat([l.bias.detach() for l in sib]))
            del attn.q, attn.k, attn.v
    for parent, name, layer in _projections(block):
        parent.__dict__.pop("_q8_cache", None)
        if isinstance(layer, QLinear):
            continue
        w = qfn(layer.weight.detach())
        if isinstance(w, (Q8, Q4)):
            setattr(parent, name, QLinear(w, layer.bias.detach()))
    return block


def is_quantized(dit) -> bool:
    """Whether ``dit`` is a quantized trunk (:func:`quantize_dit_blocks`,
    :func:`quantize_host_blocks`, :func:`quantized_dit_from_state_dict`)."""
    return getattr(dit, "quant_bits", None) is not None


def quantize_dit_blocks(dit: WanDiT, bits: int = 8) -> WanDiT:
    """Quantize ``dit``'s blocks in place, ``bits`` 8 (per-channel int8) or 4
    (group-128 int4), from the weights as stored; one block at a time, each
    dense weight freed as its projection is replaced. Returns ``dit``."""
    if bits not in _QUANTIZE:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    for block in dit.blocks:
        quantize_block_(block, bits)
    dit.quant_bits = bits
    return dit


def _sub(state_dict: Mapping, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


@torch.no_grad()
def quantize_host_blocks(config: DiTConfig, bits: int = 8, *,
                         state_dict: Optional[Mapping] = None, seed: int = 0,
                         device="cuda", dtype: torch.dtype = torch.bfloat16) -> WanDiT:
    """A quantized trunk built on ``device`` without its dense trunk ever
    being there: each block is made in bf16, quantized and its bf16 weights
    freed before the next (the reference's ``quantize_host_blocks``, which
    casts every block and the non-block parameters to bf16 first). The
    weights come from ``state_dict`` (reference names, host tensors or
    numpy arrays; strict), or without it N(0, 0.02) from a generator on
    ``device`` seeded ``seed``, drawn in the order a whole bf16
    :class:`WanDiT`'s random initialisation draws them. ``dtype`` is the
    compute dtype."""
    from ..pipelines.ti2v import _random_init_
    from ..utils.convert import load_state_dict

    if bits not in _QUANTIZE:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    dit = WanDiT(config, dtype, device="meta", param_dtype=torch.bfloat16)
    if state_dict is not None:
        own = set(dit.state_dict())
        missing, unused = sorted(own - set(state_dict)), sorted(set(state_dict) - own)
        if missing or unused:
            raise KeyError(f"state dict lacks {len(missing)} keys, e.g. {missing[:5]}, and "
                           f"has {len(unused)} unknown keys, e.g. {unused[:5]}")
    gen = None if state_dict is not None else torch.Generator(device=device).manual_seed(seed)

    def fill(module: nn.Module, prefix: str):
        module.to_empty(device=device)
        if state_dict is None:
            _random_init_(module, gen)
        else:
            load_state_dict(module, _sub(state_dict, prefix))

    for name, child in dit.named_children():
        if name != "blocks":
            fill(child, f"{name}.")
            continue
        for i, block in enumerate(child):
            fill(block, f"blocks.{i}.")
            quantize_block_(block, bits)
    if any(t.is_meta for t in dit.state_dict().values()):
        raise RuntimeError("quantize_host_blocks: a parameter outside the children was "
                           "left unmade")
    dit.quant_bits = bits
    return dit.eval()


@torch.no_grad()
def quantized_dit_from_state_dict(config: DiTConfig, state_dict: Mapping, bits: int, *,
                                  device="cuda", dtype: torch.dtype = torch.bfloat16,
                                  param_dtype: Optional[torch.dtype] = None) -> WanDiT:
    """A quantized trunk from a state dict whose quantized projections are
    ``<name>.q``, ``<name>.scale`` and ``<name>.bias`` (int8 or uint8 codes
    and fp32 scales in the port's layout, as
    :func:`..utils.convert.quantized_dit_state_dict` makes them from JAX's),
    loaded strictly, self-attention q, k and v joined into ``qkv``; the
    other tensors as ``WanDiT``'s, in ``param_dtype``."""
    from ..utils.convert import load_state_dict

    def tensor(v):
        return v if torch.is_tensor(v) else torch.from_numpy(np.array(v))

    sd = dict(state_dict)
    dit = WanDiT(config, dtype, device="meta", param_dtype=param_dtype)
    for i, block in enumerate(dit.blocks):
        attn, pre = block.self_attn, f"blocks.{i}.self_attn."
        if f"{pre}q.q" in sd:
            for leaf in ("q", "scale", "bias"):
                sd[f"{pre}qkv.{leaf}"] = torch.cat([tensor(sd.pop(f"{pre}{a}.{leaf}"))
                                                    for a in "qkv"])
            bias = torch.empty(3 * config.dim, dtype=attn.q.bias.dtype, device="meta")
            attn.qkv = _meta_qlinear(sd[f"{pre}qkv.q"], sd[f"{pre}qkv.scale"], bias)
            del attn.q, attn.k, attn.v
        for parent, name, layer in _projections(block):
            key = f"blocks.{i}.{_path(block, parent)}{name}"
            if isinstance(layer, nn.Linear) and f"{key}.q" in sd:
                setattr(parent, name, _meta_qlinear(sd[f"{key}.q"], sd[f"{key}.scale"],
                                                    layer.bias))
    dit.to_empty(device=device)
    load_state_dict(dit, sd)
    dit.quant_bits = bits
    return dit.eval()


def _meta_qlinear(q, scale, bias: torch.Tensor) -> QLinear:
    """A :class:`QLinear` on the meta device shaped as the codes ``q`` (int8:
    Q8; uint8: Q4; numpy or torch) and ``scale``."""
    q4 = str(q.dtype).endswith("uint8")
    stored = (Q4 if q4 else Q8)(
        q=torch.empty(tuple(q.shape), dtype=torch.uint8 if q4 else torch.int8, device="meta"),
        scale=torch.empty(tuple(scale.shape), dtype=torch.float32, device="meta"))
    return QLinear(stored, bias)


def _path(root: nn.Module, module: nn.Module) -> str:
    """``module``'s dotted path under ``root``, with a trailing dot ('' for
    the root itself)."""
    for name, m in root.named_modules():
        if m is module:
            return f"{name}." if name else ""
    raise ValueError("module not under root")


def quantized_bytes(dit: WanDiT) -> Tuple[int, int]:
    """(stored bytes, bf16-equivalent bytes) of the trunk's blocks, as the
    reference counts them: codes a byte each (int4: two weights a byte),
    scales 4 bytes, every other tensor 2."""
    stored = bf16 = 0
    for block in dit.blocks:
        for name, t in list(block.named_parameters()) + list(block.named_buffers()):
            owner = block.get_submodule(name.rsplit(".", 1)[0]) if "." in name else block
            leaf = name.rsplit(".", 1)[-1]
            if isinstance(owner, QLinear) and leaf == "q":
                stored += t.numel()
                bf16 += t.numel() * 2 * (2 if t.dtype == torch.uint8 else 1)
            elif isinstance(owner, QLinear) and leaf == "scale":
                stored += t.numel() * 4
            else:
                stored += t.numel() * 2
                bf16 += t.numel() * 2
    return stored, bf16
