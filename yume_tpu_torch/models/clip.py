"""CLIP ViT-H/14 visual encoder of the 14B i2v model in PyTorch (counterpart
of yume_tpu/models/clip.py).

``CLIPVisual`` is the open_clip vision tower's ``use_31_block`` output: the
257 tokens (class token and 16×16 patches) after 31 of its 32 blocks, which
feed the DiT's image cross-attention. Module and parameter names follow the
released CLIP checkpoint's ``visual.`` tensors (``patch_embedding``,
``transformer.{i}.attn.to_qkv`` ...), so they load as they are once the
prefix is dropped (:func:`..utils.checkpoint.clip_visual_from_released`).

Numerics mirror the reference: the LayerNorms compute in fp32 (eps 1e-5)
and return the input's dtype; the projections run in the compute dtype;
attention is a plain fp32 product and softmax (the reference runs no kernel
here either: the head dim is 80, which the flash kernel does not take); the
MLP's GELU is exact.

:func:`preprocess_frames` resizes with the reference's antialiased Keys
cubic (a = −0.5), as separable weight matrices applied by matmul, built once
a shape; ``F.interpolate``'s bicubic (a = −0.75, no antialias) would not
match. ``XLMRobertaText`` is on no serving path and is not ported yet
(ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import CLIPConfig

# OpenAI CLIP normalisation
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in fp32 (eps 1e-5), returned in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__(dim, eps=eps, device=device, dtype=dtype)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _dense(x, layer: nn.Linear):
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class SelfAttention(nn.Module):
    """The fused qkv projection and the output projection of a ViT block."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.to_qkv = nn.Linear(dim, 3 * dim, device=device, dtype=dtype)
        self.proj = nn.Linear(dim, dim, device=device, dtype=dtype)


class VitBlock(nn.Module):
    """Pre-norm attention block with an exact-GELU MLP."""

    def __init__(self, cfg: CLIPConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.norm1 = LayerNorm(cfg.dim, **kw)
        self.attn = SelfAttention(cfg.dim, **kw)
        self.norm2 = LayerNorm(cfg.dim, **kw)
        self.mlp = nn.Sequential(nn.Linear(cfg.dim, hidden, **kw), nn.GELU(),
                                 nn.Linear(hidden, cfg.dim, **kw))

    def forward(self, x):
        c = self.cfg
        n, d = c.num_heads, c.dim // c.num_heads
        b, l, _ = x.shape
        qkv = _dense(self.norm1(x), self.attn.to_qkv).reshape(b, l, 3, n, d)
        q, k, v = qkv.float().unbind(2)
        p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q, k) * (d ** -0.5), dim=-1)
        o = torch.einsum("bnqk,bknd->bqnd", p, v).to(x.dtype).reshape(b, l, c.dim)
        x = x + _dense(o, self.attn.proj)
        h = F.gelu(_dense(self.norm2(x), self.mlp[0]))
        return x + _dense(h, self.mlp[2])


class CLIPVisual(nn.Module):
    """ViT-H/14 visual tower, its ``use_31_block`` output: images
    [B, S, S, 3] (CLIP-normalised, channels-last) → [B, 257, dim] in
    ``dtype``, the compute dtype (bf16 on the card)."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.bfloat16, *,
                 device=None, param_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=param_dtype)
        self.cfg = cfg
        self.dtype = dtype
        n_tok = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.patch_embedding = nn.Conv2d(3, cfg.dim, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False, **kw)
        self.cls_embedding = nn.Parameter(torch.zeros(1, 1, cfg.dim, **kw))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n_tok, cfg.dim, **kw))
        self.pre_norm = LayerNorm(cfg.dim, **kw)
        # use_31_block: the last block's output is never used
        self.transformer = nn.ModuleList(VitBlock(cfg, **kw)
                                         for _ in range(cfg.num_layers - 1))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.patch_embedding.weight.to(self.dtype), stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_embedding.to(x.dtype).expand(x.shape[0], 1, c.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)
        x = self.pre_norm(x)
        for block in self.transformer:
            x = block(x)
        return x


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel, a = −0.5, on |x| (fp32)."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x + np.float32(2.0)
    out = np.where(x >= 1.0, far, out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


@functools.lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] fp32 weights of the antialiased cubic resize of
    one axis (the reference's ``scale_and_translate`` with translation 0):
    the kernel widened by the downscale factor, each output's weights
    normalised to sum 1, zero where the sample falls outside the input."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale)
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    """[B, H, W, C] → [B, size[0], size[1], C] by the antialiased cubic
    resize, in fp32; an axis whose size does not change is left as it is."""
    x = x.float()
    h, w = x.shape[1:3]
    if h != size[0]:
        wh = torch.from_numpy(resize_weights(h, size[0])).to(x.device)
        x = torch.einsum("bhwc,hi->biwc", x, wh)
    if w != size[1]:
        ww = torch.from_numpy(resize_weights(w, size[1])).to(x.device)
        x = torch.einsum("bhwc,wj->bhjc", x, ww)
    return x


def preprocess_frames(frames: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] frames in [-1, 1] → CLIP-normalised [B, S, S, 3] fp32."""
    x = resize_bicubic(frames, (image_size, image_size)) * 0.5 + 0.5
    mean = torch.from_numpy(CLIP_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_STD).to(x.device)
    return (x - mean) / std
