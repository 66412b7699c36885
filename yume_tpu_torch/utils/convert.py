"""JAX parameter trees → the port's state dicts.

The port's modules use the reference torch naming, so a released checkpoint
loads as it is. These functions take ``yume_tpu`` parameter trees (nested
dicts of numpy arrays, optionally under a top-level ``"params"``) and
produce the same reference-named state dicts, as float32 numpy arrays:

* :func:`dit_state_dict` mirrors ``yume_tpu.utils.checkpoint.export_dit_state_dict``,
  and :func:`quantized_dit_state_dict` carries a quantized trunk across
  with its int8 and int4 bits;
* :func:`t5_state_dict` inverts ``convert_t5_state_dict``;
* :func:`vae22_state_dict` inverts ``convert_vae22_state_dict`` (encoder
  included, with the reference's tensor shapes);
* :func:`vae21_state_dict` inverts ``convert_vae21_state_dict`` (the
  Wan2.1 VAE's flat stage lists);
* :func:`clip_visual_state_dict` inverts ``convert_clip_visual_state_dict``
  (the released file's ``visual.`` tensors, without the prefix);
* :func:`pipeline_state_dicts` applies them to a JAX ``TI2VPipeline``'s or
  ``I2VPipeline``'s parameters, whole: what ``from_state_dicts`` loads
  strictly, and what a checkpoint directory in the released layout holds;
* :func:`disc_state_dict` / :func:`disc_tree` map the ADD discriminator's
  parameters and spectral vectors both ways, and :func:`dino_state_dict`
  selects a timm DINO checkpoint's projector tensors;
* :func:`lora_state_dict` / :func:`lora_tree` map LoRA adapters both ways,
  and :func:`adamw_state` / :func:`adam8bit_state` optimizer states, so a
  test can start both packages from the same mid-run training state.

Each is an exact inverse of the reference converter: feeding the result
back through it reproduces the input tree bit for bit.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _root(params: Mapping) -> Mapping:
    return params.get("params", params)


def get_in(tree: Mapping, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _has(tree: Mapping, path: str) -> bool:
    node = tree
    for k in path.split("/"):
        if not isinstance(node, Mapping) or k not in node:
            return False
        node = node[k]
    return True


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _conv3d(kernel) -> np.ndarray:
    """flax (kT, kH, kW, I, O) → torch Conv3d (O, I, kT, kH, kW)."""
    return _f32(kernel).transpose(4, 3, 0, 1, 2)


class _Stored:
    """One layer of a JAX ``Q8`` (int8 ``q`` [K, N], ``scale`` [1, N]) or
    ``Q4`` (uint8 ``q`` [G, g/2, N], ``scale`` [G, N]) kernel."""

    def __init__(self, q, scale):
        self.q, self.scale = np.array(q), np.array(scale, np.float32)

    def port(self, dst: str) -> Dict[str, np.ndarray]:
        """The port's ``<dst>.q`` and ``<dst>.scale``: Q8 as int8 [N, K] and
        fp32 [N]; Q4 as uint8 [N, K/2] (each group's g/2 bytes in a row) and
        fp32 [N, G]."""
        if self.q.dtype == np.int8:
            q, scale = self.q.T, self.scale.reshape(-1)
        elif self.q.dtype == np.uint8:
            g_count, half, n = self.q.shape
            q, scale = self.q.transpose(2, 0, 1).reshape(n, g_count * half), self.scale.T
        else:
            raise TypeError(f"{dst}: quantized codes of dtype {self.q.dtype}")
        return {f"{dst}.q": np.ascontiguousarray(q), f"{dst}.scale": np.ascontiguousarray(scale)}


def _unstack(node, i: int):
    """Layer ``i`` of a stacked block tree; Q8/Q4 leaves become :class:`_Stored`."""
    if isinstance(node, Mapping):
        return {k: _unstack(v, i) for k, v in node.items()}
    if hasattr(node, "q") and hasattr(node, "scale"):
        return _Stored(np.asarray(node.q)[i], np.asarray(node.scale)[i])
    return np.asarray(node)[i]


def quantized_dit_state_dict(other: Mapping, stacked_q: Mapping,
                             num_layers: int) -> Dict[str, np.ndarray]:
    """JAX's quantized trunk ``(other, stacked_q)`` (``quantize_dit_blocks``
    or ``quantize_host_blocks``: the non-block tree and the blocks stacked
    on a leading layer axis, Q8/Q4 kernels among them) → the state dict
    that ``models.quantized.quantized_dit_from_state_dict`` loads: the
    reference names, each quantized projection as ``<name>.q``,
    ``<name>.scale`` and ``<name>.bias`` in the port's layout, the same
    int8 and int4 bits; the other tensors as :func:`dit_state_dict`'s."""
    tree = dict(_root(other))
    for i in range(num_layers):
        tree[f"blocks_{i}"] = _unstack(stacked_q, i)
    return dit_state_dict(tree, num_layers)


def dit_state_dict(params: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    """WanDiT parameter tree → reference ``WanModel`` state dict (a kernel
    given as :class:`_Stored` → its ``.q`` and ``.scale``)."""
    p = _root(params)
    sd: Dict[str, np.ndarray] = {}

    def dense(src: str, dst: str):
        kernel = get_in(p, f"{src}/kernel")
        if isinstance(kernel, _Stored):
            sd.update(kernel.port(dst))
        else:
            sd[f"{dst}.weight"] = _f32(kernel).T
        if _has(p, f"{src}/bias"):
            sd[f"{dst}.bias"] = _f32(get_in(p, f"{src}/bias"))

    def leaf(src: str, dst: str):
        sd[dst] = _f32(get_in(p, src))

    def conv(src: str, dst: str):
        sd[f"{dst}.weight"] = _conv3d(get_in(p, f"{src}/kernel"))
        sd[f"{dst}.bias"] = _f32(get_in(p, f"{src}/bias"))

    for name in ("patch_embedding", "patch_embedding_2x", "patch_embedding_4x",
                 "patch_embedding_8x", "patch_embedding_16x",
                 "patch_embedding_2x_f"):
        if _has(p, name):
            conv(name, name)
    dense("text_embedding_0", "text_embedding.0")
    dense("text_embedding_2", "text_embedding.2")
    dense("time_embedding_0", "time_embedding.0")
    dense("time_embedding_2", "time_embedding.2")
    dense("time_projection_1", "time_projection.1")
    if _has(p, "img_emb_1"):  # 14B CLIP branch (MLPProj)
        leaf("img_emb_norm1/scale", "img_emb.proj.0.weight")
        leaf("img_emb_norm1/bias", "img_emb.proj.0.bias")
        dense("img_emb_1", "img_emb.proj.1")
        dense("img_emb_3", "img_emb.proj.3")
        leaf("img_emb_norm4/scale", "img_emb.proj.4.weight")
        leaf("img_emb_norm4/bias", "img_emb.proj.4.bias")

    def block(src: str, dst: str):
        leaf(f"{src}/modulation", f"{dst}.modulation")
        for a in ("q", "k", "v", "o"):
            dense(f"{src}/self_attn/{a}", f"{dst}.self_attn.{a}")
        leaf(f"{src}/self_attn/norm_q/weight", f"{dst}.self_attn.norm_q.weight")
        leaf(f"{src}/self_attn/norm_k/weight", f"{dst}.self_attn.norm_k.weight")
        for a in ("q", "k", "v", "o"):
            dense(f"{src}/cross_attn/{a}", f"{dst}.cross_attn.{a}")
        leaf(f"{src}/cross_attn/norm_q/weight", f"{dst}.cross_attn.norm_q.weight")
        leaf(f"{src}/cross_attn/norm_k/weight", f"{dst}.cross_attn.norm_k.weight")
        for a in ("k_img", "v_img"):
            if _has(p, f"{src}/cross_attn/{a}"):
                dense(f"{src}/cross_attn/{a}", f"{dst}.cross_attn.{a}")
        if _has(p, f"{src}/cross_attn/norm_k_img"):
            leaf(f"{src}/cross_attn/norm_k_img/weight",
                 f"{dst}.cross_attn.norm_k_img.weight")
        if _has(p, f"{src}/norm3"):
            leaf(f"{src}/norm3/weight", f"{dst}.norm3.weight")
            leaf(f"{src}/norm3/bias", f"{dst}.norm3.bias")
        dense(f"{src}/ffn_0", f"{dst}.ffn.0")
        dense(f"{src}/ffn_2", f"{dst}.ffn.2")

    for i in range(num_layers):
        block(f"blocks_{i}", f"blocks.{i}")
    if _has(p, "sideblock"):
        block("sideblock", "sideblock")
    if _has(p, "mask_token"):
        leaf("mask_token", "mask_token")
    leaf("head/modulation", "head.modulation")
    dense("head/head", "head.head")
    return sd


def t5_state_dict(params: Mapping, num_layers: int) -> Dict[str, np.ndarray]:
    """T5Encoder parameter tree → reference umT5 encoder state dict."""
    p = _root(params)
    sd = {"token_embedding.weight": _f32(get_in(p, "token_embedding/embedding"))}
    for i in range(num_layers):
        src, dst = f"blocks_{i}", f"blocks.{i}"
        sd[f"{dst}.norm1.weight"] = _f32(get_in(p, f"{src}/norm1/weight"))
        sd[f"{dst}.norm2.weight"] = _f32(get_in(p, f"{src}/norm2/weight"))
        for a in ("q", "k", "v", "o"):
            sd[f"{dst}.attn.{a}.weight"] = _f32(get_in(p, f"{src}/attn/{a}/kernel")).T
        sd[f"{dst}.ffn.gate.0.weight"] = _f32(get_in(p, f"{src}/ffn/gate/kernel")).T
        sd[f"{dst}.ffn.fc1.weight"] = _f32(get_in(p, f"{src}/ffn/fc1/kernel")).T
        sd[f"{dst}.ffn.fc2.weight"] = _f32(get_in(p, f"{src}/ffn/fc2/kernel")).T
        sd[f"{dst}.pos_embedding.embedding.weight"] = _f32(
            get_in(p, f"{src}/pos_embedding"))
    sd["norm.weight"] = _f32(get_in(p, "norm/weight"))
    return sd


def vae22_state_dict(params: Mapping, num_res_blocks: int = 2) -> Dict[str, np.ndarray]:
    """Wan2.2 WanVAE parameter tree → reference ``WanVAE_`` state dict
    (encoder and decoder)."""
    p = _root(params)
    sd: Dict[str, np.ndarray] = {}
    causal, res_block, resample, middle_and_head = _vae_common(p, sd)

    def stages(side: str, stage: str, seq: str, kind: str, n_blocks: int):
        i = 0
        while _has(p, f"{side}/{stage}_{i}"):
            base = f"{side}.{seq}.{i}.{seq}"
            for j in range(n_blocks):
                res_block(f"{side}/{stage}_{i}/block_{j}", f"{base}.{j}")
            if _has(p, f"{side}/{stage}_{i}/{kind}"):
                resample(f"{side}/{stage}_{i}/{kind}", f"{base}.{n_blocks}")
            i += 1

    causal("encoder/conv1", "encoder.conv1")
    stages("encoder", "down", "downsamples", "downsample", num_res_blocks)
    middle_and_head("encoder")
    causal("conv1", "conv1")
    causal("conv2", "conv2")
    causal("decoder/conv1", "decoder.conv1")
    stages("decoder", "up", "upsamples", "upsample", num_res_blocks + 1)
    middle_and_head("decoder")
    return sd


def _vae_common(p: Mapping, sd: Dict[str, np.ndarray]):
    """The leaf mappers shared by both VAE variants, writing into ``sd``."""

    def causal(src: str, dst: str):
        sd[f"{dst}.weight"] = _conv3d(get_in(p, f"{src}/conv/kernel"))
        sd[f"{dst}.bias"] = _f32(get_in(p, f"{src}/conv/bias"))

    def gamma(src: str, dst: str, images: bool = False):
        g = _f32(get_in(p, f"{src}/gamma"))
        sd[f"{dst}.gamma"] = g.reshape((-1, 1, 1) if images else (-1, 1, 1, 1))

    def res_block(src: str, dst: str):
        gamma(f"{src}/norm1", f"{dst}.residual.0")
        causal(f"{src}/conv1", f"{dst}.residual.2")
        gamma(f"{src}/norm2", f"{dst}.residual.3")
        causal(f"{src}/conv2", f"{dst}.residual.6")
        if _has(p, f"{src}/shortcut"):
            causal(f"{src}/shortcut", f"{dst}.shortcut")

    def conv1x1(src: str, dst: str):
        # flax Dense (I, O) → torch 1×1 Conv2d (O, I, 1, 1)
        sd[f"{dst}.weight"] = _f32(get_in(p, f"{src}/kernel")).T[:, :, None, None]
        sd[f"{dst}.bias"] = _f32(get_in(p, f"{src}/bias"))

    def resample(src: str, dst: str):
        # flax (1, kH, kW, I, O) → torch Conv2d (O, I, kH, kW)
        sd[f"{dst}.resample.1.weight"] = _f32(get_in(p, f"{src}/conv_spatial/kernel"))[0] \
            .transpose(3, 2, 0, 1)
        sd[f"{dst}.resample.1.bias"] = _f32(get_in(p, f"{src}/conv_spatial/bias"))
        if _has(p, f"{src}/time_conv"):
            sd[f"{dst}.time_conv.weight"] = _conv3d(get_in(p, f"{src}/time_conv/kernel"))
            sd[f"{dst}.time_conv.bias"] = _f32(get_in(p, f"{src}/time_conv/bias"))

    def middle_and_head(side: str):
        res_block(f"{side}/mid_block_1", f"{side}.middle.0")
        gamma(f"{side}/mid_attn/norm", f"{side}.middle.1.norm", images=True)
        conv1x1(f"{side}/mid_attn/to_qkv", f"{side}.middle.1.to_qkv")
        conv1x1(f"{side}/mid_attn/proj", f"{side}.middle.1.proj")
        res_block(f"{side}/mid_block_2", f"{side}.middle.2")
        gamma(f"{side}/head_norm", f"{side}.head.0")
        causal(f"{side}/head_conv", f"{side}.head.2")

    return causal, res_block, resample, middle_and_head


def vae21_state_dict(params: Mapping, num_res_blocks: int = 2) -> Dict[str, np.ndarray]:
    """Wan2.1 WanVAE (``arch='wan21'``) parameter tree → reference
    ``Wan2.1_VAE.pth`` state dict: the stages' residual blocks and
    resamples in one flat list per side, numbered in order."""
    p = _root(params)
    sd: Dict[str, np.ndarray] = {}
    causal, res_block, resample, middle_and_head = _vae_common(p, sd)

    def flat(side: str, kind: str, seq: str, n_blocks: int):
        k = blk = i = 0
        while _has(p, f"{side}/block_{blk}"):
            for _ in range(n_blocks):
                res_block(f"{side}/block_{blk}", f"{side}.{seq}.{k}")
                k += 1
                blk += 1
            if _has(p, f"{side}/{kind}_{i}"):
                resample(f"{side}/{kind}_{i}", f"{side}.{seq}.{k}")
                k += 1
            i += 1

    causal("encoder/conv1", "encoder.conv1")
    flat("encoder", "downsample", "downsamples", num_res_blocks)
    middle_and_head("encoder")
    causal("conv1", "conv1")
    causal("conv2", "conv2")
    causal("decoder/conv1", "decoder.conv1")
    flat("decoder", "upsample", "upsamples", num_res_blocks + 1)
    middle_and_head("decoder")
    return sd


def clip_visual_state_dict(params: Mapping, num_layers: int = 32) -> Dict[str, np.ndarray]:
    """CLIPVisual parameter tree → the ``CLIPVisual`` state dict: the
    released CLIP file's ``visual.`` tensors, without the prefix, for the
    ``num_layers − 1`` blocks the tower runs."""
    p = _root(params)
    sd = {"patch_embedding.weight": _f32(get_in(p, "patch_embedding/kernel"))
          .transpose(3, 2, 0, 1),                      # HWIO → OIHW
          "cls_embedding": _f32(get_in(p, "cls_embedding")),
          "pos_embedding": _f32(get_in(p, "pos_embedding")),
          "pre_norm.weight": _f32(get_in(p, "pre_norm/scale")),
          "pre_norm.bias": _f32(get_in(p, "pre_norm/bias"))}
    for i in range(num_layers - 1):
        src, dst = f"blocks_{i}", f"transformer.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{dst}.{norm}.weight"] = _f32(get_in(p, f"{src}/{norm}/scale"))
            sd[f"{dst}.{norm}.bias"] = _f32(get_in(p, f"{src}/{norm}/bias"))
        for ours, theirs in (("to_qkv", "attn.to_qkv"), ("proj", "attn.proj"),
                             ("mlp_0", "mlp.0"), ("mlp_2", "mlp.2")):
            sd[f"{dst}.{theirs}.weight"] = _f32(get_in(p, f"{src}/{ours}/kernel")).T
            sd[f"{dst}.{theirs}.bias"] = _f32(get_in(p, f"{src}/{ours}/bias"))
    return sd


def pipeline_state_dicts(pipe) -> Dict[str, Dict[str, np.ndarray]]:
    """A JAX ``TI2VPipeline``'s or ``I2VPipeline``'s DiT, VAE (encoder and
    decoder; Wan2.2 or Wan2.1 by its config), umT5 and CLIP visual tower
    (those it has) → ``{"dit", "vae", "t5", "clip"}`` reference-named state
    dicts, nothing dropped; a quantized trunk through
    :func:`quantized_dit_state_dict`."""
    cfg = pipe.config
    vae = vae21_state_dict if cfg.vae.arch == "wan21" else vae22_state_dict
    if isinstance(pipe.dit_params, tuple):     # a quantized trunk
        dit = quantized_dit_state_dict(*pipe.dit_params, cfg.dit.num_layers)
    else:
        dit = dit_state_dict(pipe.dit_params, cfg.dit.num_layers)
    out = {"dit": dit,
           "vae": vae(pipe.vae_params, cfg.vae.num_res_blocks)}
    if pipe.t5_params is not None:
        out["t5"] = t5_state_dict(pipe.t5_params, cfg.t5.num_layers)
    if getattr(pipe, "clip_params", None) is not None:
        out["clip"] = clip_visual_state_dict(pipe.clip_params, cfg.clip.num_layers)
    return out


# ---------------------------------------------------------------------------
# the ADD discriminator
# ---------------------------------------------------------------------------

# flax layout → the port's, per kind of leaf (each its own inverse but conv2d)
_TO_PORT = {
    None: lambda a: a,
    "dense": lambda a: a.T,                           # (I, O) → Linear (O, I)
    "conv2d": lambda a: a.transpose(3, 2, 0, 1),      # HWIO → OIHW
    "conv1d": lambda a: a.transpose(2, 1, 0),         # (k, I, O) → Conv1d (O, I, k)
}
_TO_JAX = dict(_TO_PORT, conv2d=lambda a: a.transpose(2, 3, 1, 0))
_DISC_HEADS = 5


def _dino_leaves(depth: int):
    """(JAX path, port key, kind) of every DinoViT parameter."""
    out = [("cls_token", "cls_token", None), ("pos_embed", "pos_embed", None),
           ("patch_embed/kernel", "patch_embed.proj.weight", "conv2d"),
           ("patch_embed/bias", "patch_embed.proj.bias", None)]
    for i in range(depth):
        for src, dst, kind in (("norm1/scale", "norm1.weight", None),
                               ("norm1/bias", "norm1.bias", None),
                               ("qkv/kernel", "attn.qkv.weight", "dense"),
                               ("qkv/bias", "attn.qkv.bias", None),
                               ("proj/kernel", "attn.proj.weight", "dense"),
                               ("proj/bias", "attn.proj.bias", None),
                               ("norm2/scale", "norm2.weight", None),
                               ("norm2/bias", "norm2.bias", None),
                               ("mlp_0/kernel", "mlp.fc1.weight", "dense"),
                               ("mlp_0/bias", "mlp.fc1.bias", None),
                               ("mlp_2/kernel", "mlp.fc2.weight", "dense"),
                               ("mlp_2/bias", "mlp.fc2.bias", None)):
            out.append((f"blocks_{i}/{src}", f"blocks.{i}.{dst}", kind))
    return out


def _disc_leaves(depth: int = 12):
    """(collection, JAX path, port key, kind) of every leaf of the
    ProjectedDiscriminator: its parameters and the spectral vectors."""
    out = [("params", "up_conv/kernel", "up_conv.weight", "conv2d"),
           ("params", "up_conv/bias", "up_conv.bias", None)]
    out += [("params", f"dino/{a}", f"dino.{b}", k) for a, b, k in _dino_leaves(depth)]
    for head in ("head", "head_f"):
        for i in range(_DISC_HEADS):
            convs = [f"{head}_{i}/block{j}/conv" for j in (0, 1)] + [f"{head}_{i}/cls"]
            for conv in convs:
                dst = _module_name(conv.split("/"))
                out += [("params", f"{conv}/kernel", f"{dst}.weight", "conv1d"),
                        ("params", f"{conv}/bias", f"{dst}.bias", None),
                        ("spectral", f"{conv}/u", f"{dst}.u", None)]
            for j in (0, 1):
                norm = f"{head}_{i}/block{j}/norm"
                dst = _module_name(norm.split("/"))
                out += [("params", f"{norm}/scale", f"{dst}.weight", None),
                        ("params", f"{norm}/bias", f"{dst}.bias", None)]
    return out


def disc_state_dict(params: Mapping, spectral: Mapping = None) -> Dict[str, np.ndarray]:
    """The JAX ProjectedDiscriminator's ``params`` and ``spectral`` trees →
    the port's ``ProjectedDiscriminator`` state dict (the spectral vectors
    are its ``u`` buffers). Leaves the trees lack, or hold no array for,
    are left out: the spectral vectors without ``spectral``, DINO's in the
    moments of an optimizer that masks it (optax's ``MaskedNode``)."""
    trees = {"params": _root(params),
             "spectral": {} if spectral is None else spectral.get("spectral", spectral)}
    out = {}
    for col, src, dst, kind in _disc_leaves():
        leaf = get_in(trees[col], src) if _has(trees[col], src) else None
        if hasattr(leaf, "shape"):
            out[dst] = _TO_PORT[kind](_f32(leaf))
    return out


def disc_tree(sd: Mapping):
    """Inverse of :func:`disc_state_dict`: a port state dict (tensors or
    arrays) → JAX ``(params, spectral)`` trees of numpy arrays. Keys the
    state dict lacks (e.g. DINO's, for an optimizer moment) are left out."""
    trees: Dict[str, Dict] = {"params": {}, "spectral": {}}
    for col, src, dst, kind in _disc_leaves():
        if dst in sd:
            val = np.asarray(torch.as_tensor(sd[dst]).detach().float().cpu())
            *path, leaf = src.split("/")
            node = trees[col]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = _TO_JAX[kind](val)
    return trees["params"], trees["spectral"]


def dino_state_dict(sd: Mapping, depth: int = 12) -> Dict[str, torch.Tensor]:
    """DINO ViT-S/16 weights in timm's layout
    (``dino_deitsmall16_pretrain.pth``) → the port's ``DinoViT`` state dict
    (the counterpart of ``convert_dino_state_dict``). The port keeps timm's
    names, so this selects the projector's tensors: the final ``norm`` and
    ``head`` are unused (the hooks read raw block activations)."""
    return {key: torch.as_tensor(sd[key]).float() for _, key, _ in _dino_leaves(depth)}


@torch.no_grad()
def load_state_dict(module: nn.Module, sd: Mapping, *, allow_unused: bool = False):
    """Copy a state dict (numpy arrays or tensors) into ``module``, casting
    to each parameter's dtype and device. Every parameter of the module must
    be present with its shape; keys the module lacks raise unless
    ``allow_unused`` (e.g. the encoder half of a VAE checkpoint)."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unused = sorted(set(sd) - set(own))
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} keys, e.g. {missing[:5]}")
    if unused and not allow_unused:
        raise KeyError(f"state dict has {len(unused)} unknown keys, e.g. {unused[:5]}")
    for k, dst in own.items():
        src = torch.as_tensor(np.asarray(sd[k]) if not torch.is_tensor(sd[k]) else sd[k])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{k}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
        dst.copy_(src)


# ---------------------------------------------------------------------------
# training state: LoRA adapters and optimizer moments
# ---------------------------------------------------------------------------


def _module_name(parts) -> str:
    """JAX module path parts → the port's module name
    (``blocks_0/self_attn/q`` → ``blocks.0.self_attn.q``, ``ffn_0`` → ``ffn.0``)."""
    return ".".join(re.sub(r"_(\d+)$", r".\1", p) for p in parts)


def _jax_parts(name: str):
    """Inverse of :func:`_module_name`."""
    parts = name.split(".")
    out = []
    for p in parts:
        if p.isdigit():
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return out


def lora_state_dict(lora: Mapping) -> Dict[str, np.ndarray]:
    """JAX LoRA tree (``{...: {"kernel": {"lora_a": A [in, r], "lora_b": B
    [r, out]}}}``) → the port's flat adapters in Linear layout:
    ``<layer>.lora_a`` = Aᵀ [r, in], ``<layer>.lora_b`` = Bᵀ [out, r]."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if "lora_a" in node:
            layer = _module_name(path[:-1])  # drop the trailing "kernel"
            out[f"{layer}.lora_a"] = _f32(node["lora_a"]).T
            out[f"{layer}.lora_b"] = _f32(node["lora_b"]).T
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(_root(lora), ())
    return out


def lora_tree(lora_sd: Mapping) -> Dict:
    """Inverse of :func:`lora_state_dict`: the port's adapters → a JAX LoRA
    tree (numpy)."""
    tree: Dict = {}
    for key, val in lora_sd.items():
        layer, which = key.rsplit(".", 1)
        node = tree
        for p in _jax_parts(layer) + ["kernel"]:
            node = node.setdefault(p, {})
        node[which] = np.asarray(torch.as_tensor(val).detach().float().cpu()).T
    return tree


def _adam_leaves(opt_state, kind: str):
    """The first ScaleByAdamState (``kind='adam'``) or Adam8bitState
    (``kind='adam8bit'``) inside an optax chain state (or the per-label
    states of ``multi_transform``)."""
    if kind == "adam" and hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if kind == "adam8bit" and hasattr(opt_state, "leaves") and hasattr(opt_state, "count"):
        return opt_state
    if isinstance(opt_state, Mapping):
        opt_state = list(opt_state.values())
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_leaves(s, kind)
            if found is not None:
                return found
    return None


def adamw_state(opt_state, to_port: Callable[[Mapping], Dict[str, np.ndarray]]) -> Dict:
    """The AdamW moments of an optax ``make_optimizer`` state → the port's
    optimizer state (``{"count", "mu", "nu"}``). ``to_port`` maps a
    parameter-shaped JAX tree to the port's names and layouts (e.g.
    ``lambda t: dit_state_dict(t, num_layers)`` or :func:`lora_state_dict`);
    it only transposes, so the moments carry over exactly."""
    adam = _adam_leaves(opt_state, "adam")
    return {"count": int(adam.count), "mu": to_port(adam.mu), "nu": to_port(adam.nu)}


def adam8bit_state(opt_state, to_port: Callable[[Mapping], Dict[str, np.ndarray]],
                   params: Mapping) -> Dict:
    """The int8 moments of an optax ``adam8bit`` state → the port's
    (``{"count", "leaves"}``). ``params`` is the JAX parameter tree (for the
    leaf shapes). Each moment is dequantized, mapped by ``to_port`` and
    requantized over the port tensor's own 256-element blocks: where the
    layout is unchanged the codes carry over and a scale may move by one
    ulp (127·s/127); a transposed leaf is re-blocked."""
    from ..training import optim

    state = _adam_leaves(opt_state, "adam8bit")

    def dequant(leaves, params, which):
        if hasattr(leaves, "m_q"):
            q, s = (leaves.m_q, leaves.m_scale) if which == "m" else (leaves.v_q, leaves.v_scale)
            q, s = torch.from_numpy(np.asarray(q)), torch.from_numpy(np.asarray(s, np.float32))
            deq = optim._dequantize_signed if which == "m" else optim._dequantize_sqrt
            n = int(np.prod(np.shape(params)))
            return deq(q, s)[:n].reshape(np.shape(params)).numpy()
        return {k: dequant(leaves[k], params[k], which) for k in leaves}

    m = to_port(dequant(state.leaves, _root(params), "m"))
    v = to_port(dequant(state.leaves, _root(params), "v"))
    leaves = {}
    for name in m:
        mf, vf = (torch.from_numpy(np.ascontiguousarray(a)).reshape(-1) for a in (m[name], v[name]))
        pad = optim._pad_len(mf.numel()) - mf.numel()
        mq, ms = optim._quantize_signed(torch.nn.functional.pad(mf, (0, pad)))
        vq, vs = optim._quantize_sqrt(torch.nn.functional.pad(vf, (0, pad)))
        leaves[name] = {"m_q": mq, "m_scale": ms, "v_q": vq, "v_scale": vs}
    return {"count": int(state.count), "leaves": leaves}
