"""Wan2.2 causal 3D video VAE — decoder half — in PyTorch (counterpart of
yume_tpu/models/vae.py).

Public tensors are channels-last ``[B, T, H, W, C]`` as in the reference;
inside, the decoder runs channels-first ``[B, C, T, H, W]`` for
``F.conv3d``, converting at :meth:`WanVAE.decode` and
:meth:`WanVAE.decode_chunk`. Parameter names and shapes follow the
reference torch VAE (``decoder.upsamples.{i}.upsamples.{j}.residual.2``,
``...resample.1`` ...), so a released state dict loads as it is.

Semantics are the reference's cached (streaming) decode:

* ``CausalConv3d``: 2·(kt//2) leading time frames of zeros, or in streaming
  mode the trailing frames of the previous chunk's input (:class:`CacheIO`);
* the temporal upsample passes frame 0 through un-doubled and convolves the
  rest with frame 0 replaced by zero (the reference's "Rep" marker).

The VAE holds no Pallas kernel, so its convolutions go to cuDNN. Each layer
computes in the dtype of its input, casting its weights to it.

Ported: ``decode``, ``decode_chunk`` and :func:`streaming_decode`. Not
ported yet: the encoder half, ``encode_chunk``, the Wan2.1 variant.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import VAEConfig

# Wan2.2 48-channel latent normalisation
WAN22_LATENT_MEAN = np.array([
    -0.2289, -0.0052, -0.1323, -0.2339, -0.2799, 0.0174, 0.1838, 0.1557,
    -0.1382, 0.0542, 0.2813, 0.0891, 0.1570, -0.0098, 0.0375, -0.1825,
    -0.2246, -0.1207, -0.0698, 0.5109, 0.2665, -0.2108, -0.2158, 0.2502,
    -0.2055, -0.0322, 0.1109, 0.1567, -0.0729, 0.0899, -0.2799, -0.1230,
    -0.0313, -0.1649, 0.0117, 0.0723, -0.2839, -0.2083, -0.0520, 0.3748,
    0.0152, 0.1957, 0.1433, -0.2944, 0.3573, -0.0548, -0.1681, -0.0667,
], np.float32)
WAN22_LATENT_STD = np.array([
    0.4765, 1.0364, 0.4514, 1.1677, 0.5313, 0.4990, 0.4818, 0.5013,
    0.8158, 1.0344, 0.5894, 1.0901, 0.6885, 0.6165, 0.8454, 0.4978,
    0.5759, 0.3523, 0.7135, 0.6804, 0.5833, 1.4146, 0.8986, 0.5659,
    0.7069, 0.5338, 0.4889, 0.4917, 0.4069, 0.4999, 0.6866, 0.4093,
    0.5709, 0.6065, 0.6415, 0.4944, 0.5726, 1.2042, 0.5458, 1.6887,
    0.3971, 1.0600, 0.3943, 0.5537, 0.5444, 0.4089, 0.7468, 0.7744,
], np.float32)


class CacheIO:
    """Streaming feature-cache threading: modules consume caches in call
    order via get() and emit updated ones via put(). caches_in=None marks
    the first chunk (every conv zero-pads and seeds its cache)."""

    def __init__(self, caches_in=None):
        self.caches_in = caches_in
        self.idx = 0
        self.out = []

    def get(self):
        if self.caches_in is None:
            return None
        c = self.caches_in[self.idx]
        self.idx += 1
        return c

    def put(self, c):
        self.out.append(c)


def _conv(x, conv: nn.Conv3d, padding=0):
    return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    padding=padding)


class CausalConv3d(nn.Conv3d):
    """3D conv, causal in time (2·(kt//2) leading frames), SAME in space.
    With ``io`` the time padding is the previous chunk's trailing input
    frames (zeros on the first chunk)."""

    def __init__(self, cin, cout, kernel=(3, 3, 3), *, device=None, dtype=None):
        super().__init__(cin, cout, kernel, device=device, dtype=dtype)

    def forward(self, x, io: CacheIO | None = None):
        kt, kh, kw = self.kernel_size
        tp = 2 * (kt // 2)
        if tp > 0:
            if io is not None:
                cache = io.get()
                if cache is None:
                    cache = x.new_zeros(x.shape[:2] + (tp,) + x.shape[3:])
                x = torch.cat([cache, x], dim=2)
                # a copy: a view would keep this chunk's whole input alive
                io.put(x[:, :, -tp:].clone())
            else:
                x = F.pad(x, (0, 0, 0, 0, tp, 0))
        return _conv(x, self, padding=(0, kh // 2, kw // 2))


class ChannelRMSNorm(nn.Module):
    """L2-normalise over channels, scale by sqrt(C)·gamma (fp32 math).
    ``images`` selects the reference's gamma shape: (C, 1, 1) for the 2D
    attention norm, (C, 1, 1, 1) otherwise."""

    def __init__(self, dim: int, images: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.dim = dim
        shape = (dim, 1, 1) if images else (dim, 1, 1, 1)
        self.gamma = nn.Parameter(torch.ones(shape, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt((xf * xf).sum(1, keepdim=True) + 1e-12)
        g = self.gamma.float().reshape(1, self.dim, 1, 1, 1)
        return (n * (self.dim ** 0.5) * g).to(x.dtype)


class ResBlock(nn.Module):
    """RMSNorm → SiLU → causal conv, twice, with a 1×1×1 conv shortcut when
    the width changes (reference ResidualBlock)."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.residual = nn.ModuleList([
            ChannelRMSNorm(in_dim, **kw), nn.SiLU(), CausalConv3d(in_dim, out_dim, **kw),
            ChannelRMSNorm(out_dim, **kw), nn.SiLU(), nn.Dropout(0.0),
            CausalConv3d(out_dim, out_dim, **kw)])
        self.shortcut = (CausalConv3d(in_dim, out_dim, (1, 1, 1), **kw)
                         if in_dim != out_dim else None)

    def forward(self, x, io: CacheIO | None = None):
        r = self.residual
        h = r[2](F.silu(r[0](x)), io)
        h = r[6](F.silu(r[3](h)), io)
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class SpatialAttention(nn.Module):
    """Single-head per-frame self-attention (reference AttentionBlock)."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = ChannelRMSNorm(dim, images=True, **kw)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1, **kw)
        self.proj = nn.Conv2d(dim, dim, 1, **kw)

    def forward(self, x):
        b, c, t, h, w = x.shape
        idty = x
        y = self.norm(x).permute(0, 2, 3, 4, 1).reshape(b * t, h * w, c)
        qkv = F.linear(y, self.to_qkv.weight[:, :, 0, 0].to(y.dtype),
                       self.to_qkv.bias.to(y.dtype))
        q, k, v = qkv.split(c, dim=-1)
        att = torch.softmax(
            torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * (c ** -0.5), dim=-1)
        y = torch.einsum("bqk,bkc->bqc", att, v.float()).to(x.dtype)
        y = F.linear(y, self.proj.weight[:, :, 0, 0].to(y.dtype),
                     self.proj.bias.to(y.dtype))
        return idty + y.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)


def unpatchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """Channels-last [B, T, H, W, C·p·p] → [B, T, H·p, W·p, C] (channel order
    (c, r, q) as the reference's einops pattern)."""
    if p == 1:
        return x
    b, t, h, w, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, t, h, w, c, p, p)     # c r q
    x = x.permute(0, 1, 2, 6, 3, 5, 4)     # b t h q w r c
    return x.reshape(b, t, h * p, w * p, c)


def dup_up3d(x, out_ch: int, ft: int, fs: int, first_chunk: bool):
    """Repeat-upsample shortcut on [B, C, T, H, W] (reference DupUp3D)."""
    b, c, t, h, w = x.shape
    repeats = out_ch * ft * fs * fs // c
    x = x.repeat_interleave(repeats, dim=1)
    x = x.reshape(b, out_ch, ft, fs, fs, t, h, w)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)  # b out t ft h fs w fs
    x = x.reshape(b, out_ch, t * ft, h * fs, w * fs)
    if first_chunk and ft > 1:
        x = x[:, :, ft - 1:]
    return x


class Upsample(nn.Module):
    """Spatial (and optionally temporal) upsample (reference Resample
    'upsample2d' / 'upsample3d'). ``resample.1`` is the 3×3 spatial conv
    after the nearest 2× upsample; ``time_conv`` doubles the frame count."""

    def __init__(self, dim: int, temporal: bool, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.temporal = temporal
        self.resample = nn.Sequential(nn.Identity(), nn.Conv2d(dim, dim, 3, **kw))
        if temporal:
            self.time_conv = nn.Conv3d(dim, 2 * dim, (3, 1, 1), **kw)

    def _double(self, y, frames):
        """[B, 2C, T, H, W] → [B, C, 2T, H, W], the two halves interleaved."""
        b, c2, _, h, w = y.shape
        y = y.reshape(b, 2, c2 // 2, frames, h, w).permute(0, 2, 3, 1, 4, 5)
        return y.reshape(b, c2 // 2, 2 * frames, h, w)

    def forward(self, x, first_chunk: bool = True, io: CacheIO | None = None):
        if self.temporal:
            b, c, t, h, w = x.shape
            if io is not None:
                cache = io.get()
                if cache is None:
                    # first chunk: passthrough, cache seeds with zeros ("Rep")
                    io.put(x.new_zeros((b, c, 2, h, w)))
                else:
                    x_in = torch.cat([cache, x], dim=2)
                    io.put(x_in[:, :, -2:].clone())
                    x = self._double(_conv(x_in, self.time_conv), t)
            elif first_chunk:
                v = torch.cat([x.new_zeros((b, c, 3, h, w)), x[:, :, 1:]], dim=2)
                y = _conv(v, self.time_conv)[:, :, 1:]
                x = torch.cat([x[:, :, :1], self._double(y, t - 1)], dim=2)
            else:
                v = F.pad(x, (0, 0, 0, 0, 2, 0))
                x = self._double(_conv(v, self.time_conv), t)
        y = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        conv = self.resample[1]
        return F.conv3d(y, conv.weight.to(y.dtype)[:, :, None], conv.bias.to(y.dtype),
                        padding=(0, 1, 1))


class UpStage(nn.Module):
    """Residual blocks + upsample with a dup shortcut (reference
    Up_ResidualBlock)."""

    def __init__(self, in_dim, out_dim, num_blocks, temporal, up, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.out_dim = out_dim
        self.temporal = temporal
        self.up = up
        dims = [in_dim] + [out_dim] * num_blocks
        layers = [ResBlock(dims[i], dims[i + 1], **kw) for i in range(num_blocks)]
        if up:
            layers.append(Upsample(out_dim, temporal, **kw))
        self.upsamples = nn.ModuleList(layers)

    def forward(self, x, first_chunk: bool = True, io: CacheIO | None = None):
        h = x
        for layer in self.upsamples:
            if isinstance(layer, Upsample):
                h = layer(h, first_chunk, io)
            else:
                h = layer(h, io)
        if self.up:
            return h + dup_up3d(x, self.out_dim, 2 if self.temporal else 1, 2,
                                first_chunk)
        return h


class Decoder3d(nn.Module):
    """(reference Decoder3d). dec base dim is 256 in Wan2.2."""

    def __init__(self, cfg: VAEConfig, dec_dim: int = 256, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        mults = tuple(cfg.dim_mult)
        dims = [dec_dim * m for m in (mults[-1],) + mults[::-1]]
        t_up = tuple(reversed(cfg.temporal_downsample))
        self.conv1 = CausalConv3d(cfg.z_dim, dims[0], **kw)
        self.middle = nn.ModuleList([ResBlock(dims[0], dims[0], **kw),
                                     SpatialAttention(dims[0], **kw),
                                     ResBlock(dims[0], dims[0], **kw)])
        self.upsamples = nn.ModuleList(
            UpStage(din, dout, cfg.num_res_blocks + 1,
                    t_up[i] if i < len(t_up) else False,
                    up=i != len(mults) - 1, **kw)
            for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])))
        out_ch = 3 * cfg.patchify * cfg.patchify
        self.head = nn.ModuleList([ChannelRMSNorm(dims[-1], **kw), nn.SiLU(),
                                   CausalConv3d(dims[-1], out_ch, **kw)])

    def forward(self, z, first_chunk: bool = True, io: CacheIO | None = None):
        x = self.conv1(z, io)
        x = self.middle[0](x, io)
        x = self.middle[1](x)
        x = self.middle[2](x, io)
        for stage in self.upsamples:
            x = stage(x, first_chunk, io)
        return self.head[2](F.silu(self.head[0](x)), io)


class WanVAE(nn.Module):
    """Wan2.2 VAE, decoder half, with latent de-normalisation."""

    def __init__(self, cfg: VAEConfig, dec_dim: int = 256, *, device=None,
                 dtype=None):
        super().__init__()
        if cfg.arch != "wan22":
            raise NotImplementedError("only the Wan2.2 VAE is ported")
        self.cfg = cfg
        self.decoder = Decoder3d(cfg, dec_dim, device=device, dtype=dtype)
        self.conv2 = CausalConv3d(cfg.z_dim, cfg.z_dim, (1, 1, 1), device=device,
                                  dtype=dtype)

    def _scale(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.cfg.z_dim
        if z == len(WAN22_LATENT_MEAN):
            mean, std = WAN22_LATENT_MEAN, WAN22_LATENT_STD
        else:
            mean, std = np.zeros(z, np.float32), np.ones(z, np.float32)
        return (torch.from_numpy(mean).to(device), torch.from_numpy(std).to(device))

    def _decode(self, z, first_chunk, io):
        mean, std = self._scale(z.device)
        z = z * std + mean           # promotes to fp32, as the reference does
        x = self.conv2(z.permute(0, 4, 1, 2, 3))
        out = self.decoder(x, first_chunk, io).permute(0, 2, 3, 4, 1)
        return torch.clamp(unpatchify(out, self.cfg.patchify), -1.0, 1.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Normalised latent [B, Tz, h, w, z] → video
        [B, 1+(Tz-1)*4, h*16, w*16, 3] in [-1, 1]."""
        return self._decode(z, True, None)

    def decode_chunk(self, z_chunk, caches):
        """z_chunk: [B, Tz, h, w, z] (normalised); caches: list | None for
        the first chunk. Returns (video chunk, caches for the next chunk)."""
        io = CacheIO(caches)
        return self._decode(z_chunk, caches is None, io), io.out


@torch.no_grad()
def streaming_decode(vae: WanVAE, z: torch.Tensor,
                     chunk_latent_frames: int = 1) -> torch.Tensor:
    """Chunked decode with carried caches — equal to :meth:`WanVAE.decode`
    with bounded activation memory: latent frame 0 alone, then chunks of
    ``chunk_latent_frames``."""
    tz = z.shape[1]
    out, caches = vae.decode_chunk(z[:, :1], None)
    outs = [out]
    for s in range(1, tz, chunk_latent_frames):
        out, caches = vae.decode_chunk(z[:, s:s + chunk_latent_frames], caches)
        outs.append(out)
    return torch.cat(outs, dim=1)
