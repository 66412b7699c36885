"""ADD projected discriminator: PixelShuffle upsampler → frozen DINO ViT-S/16
→ spectral-norm conv heads (counterpart of yume_tpu/models/discriminator.py).

* The upsampler: a 3×3 conv from the latent channels to 3·4·4, then a 4×
  pixel shuffle in channel order (3, r, r), which is ``F.pixel_shuffle``.
* DINO ViT-S/16 (:class:`DinoViT`, timm's parameter names) returns the
  activations after blocks 2, 5, 8 and 11 and, last, the embedded tokens.
  Attention is a plain matmul and softmax, as the JAX package computes it.
* Per feature map, :func:`add_readout` adds the cls token to every patch
  token, then a token-axis head (:class:`DiscHead`) and a feature-axis head
  (:class:`DiscHeadF`, tokens as batch, frames as length) of
  :class:`ConvBlock` stacks: spectral-norm conv, GroupNorm(4), leaky ReLU
  0.2. GroupNorm's bias and the leaky ReLU run as one :func:`bias_act`
  (K10 on the card).

The public functions keep the JAX layouts: latent frames [B, H, W, C] and
images [B, H, W, 3] channels last, token features [B, L, C]. Spectral norm
keeps its power-iteration vector ``u`` as a buffer and makes one iteration
per call; ``update_u=False`` runs a call without keeping the new vector
(the generator's GAN term, whose JAX counterpart drops it).
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bias_act import bias_act

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
N_FEATURES = 5  # four block hooks and the embedded tokens


# ---------------------------------------------------------------------------
# DINO ViT-S/16
# ---------------------------------------------------------------------------


class DinoBlock(nn.Module):
    def __init__(self, dim: int = 384, heads: int = 6):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.ModuleDict({"qkv": nn.Linear(dim, 3 * dim), "proj": nn.Linear(dim, dim)})
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(dim, 4 * dim), "fc2": nn.Linear(4 * dim, dim)})

    def forward(self, x):
        b, l, c = x.shape
        n, d = self.heads, c // self.heads
        qkv = self.attn["qkv"](self.norm1(x)).reshape(b, l, 3, n, d)
        q, k, v = qkv.unbind(2)
        p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q, k) * d ** -0.5, dim=-1)
        o = torch.einsum("bnqk,bknd->bqnd", p, v).reshape(b, l, c)
        x = x + self.attn["proj"](o)
        h = self.mlp["fc2"](F.gelu(self.mlp["fc1"](self.norm2(x))))
        return x + h


class DinoViT(nn.Module):
    """ViT-S/16 returning the tokens (cls included) after the given blocks,
    then the embedded tokens, in the reference's order."""

    def __init__(self, dim: int = 384, depth: int = 12, heads: int = 6, patch: int = 16,
                 img_size: int = 224, hooks: Tuple[int, ...] = (2, 5, 8, 11)):
        super().__init__()
        self.dim, self.hooks = dim, tuple(hooks)
        self.patch_embed = nn.ModuleDict({"proj": nn.Conv2d(3, dim, patch, stride=patch)})
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (img_size // patch) ** 2 + 1, dim))
        self.blocks = nn.ModuleList(DinoBlock(dim, heads) for _ in range(depth))

    def forward(self, x) -> List[torch.Tensor]:
        """x: [B, H, W, 3] → [feature after each hook block..., embedded]."""
        b = x.shape[0]
        h = self.patch_embed["proj"](x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        h = torch.cat([self.cls_token.expand(b, 1, self.dim), h], dim=1) + self.pos_embed
        feats = [h]
        for i, blk in enumerate(self.blocks):
            h = blk(h)
            if i in self.hooks:
                feats.append(h)
        return feats[1:] + feats[:1]


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """[n_in, n_out] weights of ``jax.image.resize``'s antialiased linear
    resize along one axis (``compute_weight_mat``, in fp32): a triangle
    kernel stretched by the downsampling factor, columns normalised to sum
    1, samples outside the input zeroed. Made once per device: a copy from
    pageable host memory synchronises with the card."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, f32(0.0)).astype(f32)).to(device, dtype)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device, dtype: torch.dtype):
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def dino_preprocess(x: torch.Tensor, img_size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] → resized to img_size² (as ``jax.image.resize``
    'linear' with antialias, one weight matrix per axis) and
    ImageNet-normalised."""
    for axis in (1, 2):
        if x.shape[axis] != img_size:
            w = _resize_weights(x.shape[axis], img_size, x.device, x.dtype)
            x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    mean, std = _imagenet_stats(x.device, x.dtype)
    return (x - mean) / std


def add_readout(tokens: torch.Tensor) -> torch.Tensor:
    """cls-token readout added to every patch token, cls dropped:
    [B, 197, C] → [B, 196, C]."""
    return tokens[:, 1:] + tokens[:, :1]


# ---------------------------------------------------------------------------
# spectral-norm conv1d heads
# ---------------------------------------------------------------------------


class SpectralConv1d(nn.Module):
    """Conv1d over [B, L, C_in] (circular padding by index, as the JAX
    package: a kernel wider than L wraps more than once) with the weight
    divided by its largest singular value, estimated by one power
    iteration per call from the kept vector ``u``."""

    def __init__(self, cin: int, features: int, kernel: int, circular: bool = True):
        super().__init__()
        self.kernel, self.circular = kernel, circular
        self.weight = nn.Parameter(torch.empty(features, cin, kernel))  # Conv1d layout
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", torch.full((features,), features ** -0.5))

    def forward(self, x, update_u: bool = True):
        out = self.weight.shape[0]
        # [out, k·cin] in the JAX kernel's (k, cin) order
        w2 = self.weight.permute(0, 2, 1).reshape(out, -1)
        with torch.no_grad():
            wd = w2.detach()
            v = wd.t() @ self.u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = wd @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
            if update_u:
                self.u.copy_(u)
        sigma = u @ w2 @ v  # no gradient through u and v
        w_sn = self.weight / sigma
        pad = 0
        if self.circular and self.kernel > 1:
            p, length = self.kernel // 2, x.shape[1]
            x = x[:, torch.arange(-p, length + p, device=x.device) % length]
        elif self.kernel > 1:
            pad = self.kernel // 2  # 'SAME' zero padding, odd kernels
        return F.conv1d(x.transpose(1, 2), w_sn, self.bias, padding=pad).transpose(1, 2)


class BatchNormLocal(nn.Module):
    """Virtual-batch norm over (group, length) per channel, [B, L, C]."""

    def __init__(self, features: int, virtual_bs: int = 3, eps: float = 1e-5):
        super().__init__()
        self.virtual_bs, self.eps = virtual_bs, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        g = -(-x.shape[0] // self.virtual_bs)
        xg = x.reshape(g, -1, x.shape[1], x.shape[2])
        mean = xg.mean(dim=(1, 2), keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        xg = (xg - mean) * torch.rsqrt(var + self.eps)
        return xg.reshape(x.shape) * self.weight + self.bias


class GroupNormParams(nn.Module):
    """The scale (``weight``) and bias of flax's ``GroupNorm``; the norm
    itself is in :class:`ConvBlock`."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


class ConvBlock(nn.Module):
    """SpectralConv1d → GroupNorm(4) → LeakyReLU(0.2), with flax GroupNorm's
    eps 1e-6 and fast variance E[x²] − E[x]² (clamped at 0) over the length
    and the channel group; the norm's bias and the activation are one
    :func:`bias_act`."""

    groups, eps = 4, 1e-6

    def __init__(self, cin: int, features: int, kernel: int):
        super().__init__()
        self.conv = SpectralConv1d(cin, features, kernel)
        self.norm = GroupNormParams(features)

    def forward(self, x, update_u: bool = True):
        x = self.conv(x, update_u)
        b, length, c = x.shape
        xg = x.reshape(b, length, self.groups, c // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp_min((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps)
        rep = c // self.groups
        mean = mean.repeat_interleave(rep, dim=-1).reshape(b, 1, c)
        mul = mul.repeat_interleave(rep, dim=-1).reshape(b, 1, c) * self.norm.weight
        return bias_act((x - mean) * mul, self.norm.bias, dim=-1, act="lrelu", alpha=0.2,
                        gain=1.0)


class DiscHead(nn.Module):
    """Token-axis head: [B, L, C] → [B, L, 1]."""

    def __init__(self, channels: int = 384):
        super().__init__()
        self.block0 = ConvBlock(channels, channels, 1)
        self.block1 = ConvBlock(channels, channels, 9)
        self.cls = SpectralConv1d(channels, 1, 1)

    def forward(self, x, update_u: bool = True):
        h = self.block0(x, update_u)
        h = (h + self.block1(h, update_u)) / math.sqrt(2)  # residual block
        return self.cls(h, update_u)


class DiscHeadF(nn.Module):
    """Feature-axis head: tokens as batch, frames as length:
    [B, L, C] → [L, B, 1]."""

    def __init__(self, channels: int = 384):
        super().__init__()
        self.block0 = ConvBlock(channels, channels, 7)
        self.block1 = ConvBlock(channels, channels, 7)
        self.cls = SpectralConv1d(channels, 1, 7, circular=False)

    def forward(self, x, update_u: bool = True):
        h = self.block0(x.transpose(0, 1), update_u)
        h = (h + self.block1(h, update_u)) / math.sqrt(2)
        return self.cls(h, update_u)


class ProjectedDiscriminator(nn.Module):
    """Latent frames [B, H, W, z_dim] (frames as batch) → (logits
    [B, 5·196], logits_f [196, 5·B]), computed in fp32."""

    def __init__(self, z_dim: int = 16):
        super().__init__()
        self.up_conv = nn.Conv2d(z_dim, 3 * 4 * 4, 3, padding=1)
        # frozen in the parameter sense only (train: requires_grad_(False));
        # gradients flow through its activations to the generator
        self.dino = DinoViT()
        self.head = nn.ModuleList(DiscHead() for _ in range(N_FEATURES))
        self.head_f = nn.ModuleList(DiscHeadF() for _ in range(N_FEATURES))

    def forward(self, x, update_u: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        y = F.pixel_shuffle(self.up_conv(x.permute(0, 3, 1, 2)), 4)  # [B, 3, 4H, 4W]
        feats = self.dino(dino_preprocess(y.permute(0, 2, 3, 1)))
        logits, logits_f = [], []
        for head, head_f, f in zip(self.head, self.head_f, feats):
            t = add_readout(f)
            logits.append(head(t, update_u)[:, :, 0])
            logits_f.append(head_f(t, update_u)[:, :, 0])
        return torch.cat(logits, dim=1), torch.cat(logits_f, dim=1)


@torch.no_grad()
def random_init_(disc: nn.Module, generator: torch.Generator):
    """Random parameters at the scales of flax's initialisers (which
    truncate their normals; these do not): conv and dense weights
    N(0, 1/fan_in) (lecun), spectral conv weights N(0, 2/fan_in) (he),
    biases 0, norm scales 1, cls token 0, position embedding N(0, 0.02²);
    spectral vectors ones/√out."""
    for m in disc.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, SpectralConv1d)):
            gain = 2.0 if isinstance(m, SpectralConv1d) else 1.0
            m.weight.normal_(0.0, (gain / m.weight[0].numel()) ** 0.5, generator=generator)
            m.bias.zero_()
            if isinstance(m, SpectralConv1d):
                m.u.fill_(m.u.numel() ** -0.5)
        elif isinstance(m, (nn.LayerNorm, GroupNormParams, BatchNormLocal)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, DinoViT):
            m.cls_token.zero_()
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
