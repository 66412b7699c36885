"""The Wan2.2 and Wan2.1 causal 3D video VAEs, encoder and decoder, in
PyTorch (counterpart of yume_tpu/models/vae.py).

Public tensors are channels-last ``[B, T, H, W, C]`` as in the reference;
inside, the encoder and decoder run channels-first ``[B, C, T, H, W]`` for
``F.conv3d``, converting at :meth:`WanVAE.encode`, :meth:`WanVAE.decode`
and their chunk forms. Parameter names and shapes follow the reference
torch VAEs (Wan2.2: ``encoder.downsamples.{i}.downsamples.{j}.residual.2``,
``decoder.upsamples.{i}.upsamples.{j}...``; Wan2.1, ``cfg.arch`` 'wan21':
flat ``encoder.downsamples.{k}`` and ``decoder.upsamples.{k}`` lists of
residual blocks and resamples; both ``...resample.1``, ``...time_conv``
...), so a released state dict (``Wan2.2_VAE.pth``, ``Wan2.1_VAE.pth``)
loads as it is. The Wan2.1 stages have no average-pool or repeat
shortcuts, and its upsamples halve the channels.

Semantics are the reference's cached (streaming) encode and decode:

* ``CausalConv3d``: 2·(kt//2) leading time frames of zeros, or in streaming
  mode the trailing frames of the previous chunk's input (:class:`CacheIO`);
* the temporal downsample passes frame 0 through and convolves the rest
  with stride 2, windows anchored at frame 0; streaming, the first chunk
  passes through whole and each later chunk starts from the previous
  chunk's last frame;
* the temporal upsample passes frame 0 through un-doubled and convolves the
  rest with frame 0 replaced by zero (the reference's "Rep" marker).

The VAE holds no Pallas kernel, so its convolutions go to cuDNN. Each layer
computes in the dtype of its input, casting its weights to it.

Ported: ``encode``, ``encode_chunk``, :func:`streaming_encode`, ``decode``,
``decode_chunk`` and :func:`streaming_decode`, for both variants.
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

# Wan2.1 16-channel latent normalisation
WAN21_LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
WAN21_LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
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


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """Channels-last [B, T, H, W, C] → [B, T, H/p, W/p, C·p·p], the p×p
    pixel-unshuffle with the reference's channel order (c, r, q)."""
    if p == 1:
        return x
    b, t, h, w, c = x.shape
    x = x.reshape(b, t, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 2, 4, 6, 5, 3)     # b t h' w' c r q
    return x.reshape(b, t, h // p, w // p, c * p * p)


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


def avg_down3d(x, out_ch: int, ft: int, fs: int):
    """Space-time average-pool shortcut on [B, C, T, H, W] (reference
    AvgDown3D): T front-padded with zeros to a multiple of ``ft``, each
    (ft, fs, fs) block folded into channels in the order (c, ft, fs_h,
    fs_w), then groups of channels averaged down to ``out_ch``."""
    b, c, t, h, w = x.shape
    pad_t = (-t) % ft
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        t += pad_t
    x = x.reshape(b, c, t // ft, ft, h // fs, fs, w // fs, fs)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)  # b c ft fs fs t h w
    x = x.reshape(b, out_ch, c * ft * fs * fs // out_ch, t // ft, h // fs, w // fs)
    return x.mean(dim=2)


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
    after the nearest 2× upsample, to ``out_dim`` channels (``dim`` when
    None; the Wan2.1 upsamples halve them); ``time_conv`` doubles the frame
    count."""

    def __init__(self, dim: int, temporal: bool, out_dim: int | None = None, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.temporal = temporal
        self.resample = nn.Sequential(nn.Identity(),
                                      nn.Conv2d(dim, out_dim or dim, 3, **kw))
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


class Downsample(nn.Module):
    """Spatial (and optionally temporal) downsample (reference Resample
    'downsample2d' / 'downsample3d'). ``resample.1`` is the 3×3 stride-2
    conv after a (0, 1, 0, 1) zero pad, per frame; ``time_conv`` is a
    stride-2 temporal conv whose windows start at frame 0, which passes
    through."""

    def __init__(self, dim: int, temporal: bool, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.temporal = temporal
        self.resample = nn.Sequential(nn.ZeroPad2d((0, 1, 0, 1)),
                                      nn.Conv2d(dim, dim, 3, stride=2, **kw))
        if temporal:
            self.time_conv = nn.Conv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), **kw)

    def _time_conv(self, y):
        if y.shape[2] < 3:
            # no whole window: no output frame, as the reference's VALID conv
            # (a one-frame clip's full encode)
            return y[:, :, :0]
        conv = self.time_conv
        return F.conv3d(y, conv.weight.to(y.dtype), conv.bias.to(y.dtype), stride=(2, 1, 1))

    def forward(self, x, io: CacheIO | None = None):
        conv = self.resample[1]
        y = F.conv3d(F.pad(x, (0, 1, 0, 1)), conv.weight.to(x.dtype)[:, :, None],
                     conv.bias.to(x.dtype), stride=(1, 2, 2))
        if not self.temporal:
            return y
        if io is not None:
            cache = io.get()
            io.put(y[:, :, -1:].clone())
            if cache is None:
                return y          # first chunk: passthrough
            return self._time_conv(torch.cat([cache, y], dim=2))
        return torch.cat([y[:, :, :1], self._time_conv(y)], dim=2)


class DownStage(nn.Module):
    """Residual blocks + downsample with an average-pool shortcut (reference
    Down_ResidualBlock)."""

    def __init__(self, in_dim, out_dim, num_blocks, temporal, down, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.out_dim = out_dim
        self.temporal = temporal
        self.down = down
        dims = [in_dim] + [out_dim] * num_blocks
        layers = [ResBlock(dims[i], dims[i + 1], **kw) for i in range(num_blocks)]
        if down:
            layers.append(Downsample(out_dim, temporal, **kw))
        self.downsamples = nn.ModuleList(layers)

    def forward(self, x, io: CacheIO | None = None):
        shortcut = avg_down3d(x, self.out_dim, 2 if self.temporal else 1,
                              2 if self.down else 1)
        h = x
        for layer in self.downsamples:
            h = layer(h, io)
        return h + shortcut


class Encoder3d(nn.Module):
    """(reference Encoder3d): base width ``cfg.base_dim``, output
    2·z_dim channels (mean and log-variance)."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        mults = tuple(cfg.dim_mult)
        dims = [cfg.base_dim * m for m in (1,) + mults]
        t_down = tuple(cfg.temporal_downsample)
        self.conv1 = CausalConv3d(3 * cfg.patchify * cfg.patchify, dims[0], **kw)
        self.downsamples = nn.ModuleList(
            DownStage(din, dout, cfg.num_res_blocks,
                      t_down[i] if i < len(t_down) else False,
                      down=i != len(mults) - 1, **kw)
            for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])))
        self.middle = nn.ModuleList([ResBlock(dims[-1], dims[-1], **kw),
                                     SpatialAttention(dims[-1], **kw),
                                     ResBlock(dims[-1], dims[-1], **kw)])
        self.head = nn.ModuleList([ChannelRMSNorm(dims[-1], **kw), nn.SiLU(),
                                   CausalConv3d(dims[-1], 2 * cfg.z_dim, **kw)])

    def forward(self, x, io: CacheIO | None = None):
        x = self.conv1(x, io)
        for stage in self.downsamples:
            x = stage(x, io)
        x = self.middle[0](x, io)
        x = self.middle[1](x)
        x = self.middle[2](x, io)
        return self.head[2](F.silu(self.head[0](x)), io)


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


class Wan21Encoder3d(nn.Module):
    """The Wan2.1 encoder (reference wan/modules/vae.py:265-366): residual
    blocks and downsamples in one flat ``downsamples`` list, no shortcuts
    around the stages."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        mults = tuple(cfg.dim_mult)
        dims = [cfg.base_dim * m for m in (1,) + mults]
        t_down = tuple(cfg.temporal_downsample)
        self.conv1 = CausalConv3d(3, dims[0], **kw)
        layers = []
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            for _ in range(cfg.num_res_blocks):
                layers.append(ResBlock(din, dout, **kw))
                din = dout
            if i != len(mults) - 1:
                layers.append(Downsample(dout, t_down[i] if i < len(t_down) else False,
                                         **kw))
        self.downsamples = nn.ModuleList(layers)
        self.middle = nn.ModuleList([ResBlock(dims[-1], dims[-1], **kw),
                                     SpatialAttention(dims[-1], **kw),
                                     ResBlock(dims[-1], dims[-1], **kw)])
        self.head = nn.ModuleList([ChannelRMSNorm(dims[-1], **kw), nn.SiLU(),
                                   CausalConv3d(dims[-1], 2 * cfg.z_dim, **kw)])

    forward = Encoder3d.forward


class Wan21Decoder3d(nn.Module):
    """The Wan2.1 decoder (reference wan/modules/vae.py:369-460): residual
    blocks and upsamples in one flat ``upsamples`` list, each upsample
    halving the channels and the next stage's input halved to match."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        mults = tuple(cfg.dim_mult)
        dims = [cfg.base_dim * m for m in (mults[-1],) + mults[::-1]]
        t_up = tuple(reversed(cfg.temporal_downsample))
        self.conv1 = CausalConv3d(cfg.z_dim, dims[0], **kw)
        self.middle = nn.ModuleList([ResBlock(dims[0], dims[0], **kw),
                                     SpatialAttention(dims[0], **kw),
                                     ResBlock(dims[0], dims[0], **kw)])
        layers = []
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            d = din // 2 if i in (1, 2, 3) else din
            for _ in range(cfg.num_res_blocks + 1):
                layers.append(ResBlock(d, dout, **kw))
                d = dout
            if i != len(mults) - 1:
                layers.append(Upsample(dout, t_up[i] if i < len(t_up) else False,
                                       out_dim=dout // 2, **kw))
        self.upsamples = nn.ModuleList(layers)
        self.head = nn.ModuleList([ChannelRMSNorm(dims[-1], **kw), nn.SiLU(),
                                   CausalConv3d(dims[-1], 3, **kw)])

    def forward(self, z, first_chunk: bool = True, io: CacheIO | None = None):
        x = self.conv1(z, io)
        x = self.middle[0](x, io)
        x = self.middle[1](x)
        x = self.middle[2](x, io)
        for layer in self.upsamples:
            x = layer(x, first_chunk, io) if isinstance(layer, Upsample) else layer(x, io)
        return self.head[2](F.silu(self.head[0](x)), io)


class WanVAE(nn.Module):
    """The Wan VAE with latent normalisation: the encoder (``encoder``, then
    ``conv1`` to mean and log-variance) and the decoder (``conv2``, then
    ``decoder``); Wan2.2's stages or, with ``cfg.arch`` 'wan21', Wan2.1's."""

    def __init__(self, cfg: VAEConfig, dec_dim: int = 256, *, device=None,
                 dtype=None):
        super().__init__()
        if cfg.arch not in ("wan22", "wan21"):
            raise ValueError(f"unknown VAE arch {cfg.arch!r}")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        if cfg.arch == "wan21":
            self.encoder = Wan21Encoder3d(cfg, **kw)
        else:
            self.encoder = Encoder3d(cfg, **kw)
        self.conv1 = CausalConv3d(2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1), **kw)
        if cfg.arch == "wan21":
            self.decoder = Wan21Decoder3d(cfg, **kw)
        else:
            self.decoder = Decoder3d(cfg, dec_dim, **kw)
        self.conv2 = CausalConv3d(cfg.z_dim, cfg.z_dim, (1, 1, 1), **kw)

    def _scale(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.cfg.z_dim
        if z == len(WAN22_LATENT_MEAN):
            mean, std = WAN22_LATENT_MEAN, WAN22_LATENT_STD
        elif z == len(WAN21_LATENT_MEAN):
            mean, std = WAN21_LATENT_MEAN, WAN21_LATENT_STD
        else:
            mean, std = np.zeros(z, np.float32), np.ones(z, np.float32)
        return (torch.from_numpy(mean).to(device), torch.from_numpy(std).to(device))

    def _encode(self, video, io):
        x = patchify(video, self.cfg.patchify).permute(0, 4, 1, 2, 3)
        mu = self.conv1(self.encoder(x, io))[:, :self.cfg.z_dim].permute(0, 2, 3, 4, 1)
        mean, std = self._scale(video.device)
        return (mu - mean) / std     # promotes to fp32, as the reference does

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """Video [B, T, H, W, 3] in [-1, 1] → normalised latent
        [B, 1+(T-1)/s_t, H/s, W/s, z] (the mean; fp32)."""
        return self._encode(video, None)

    def encode_chunk(self, chunk, caches):
        """chunk: [B, Tc, H, W, 3]; caches: list | None for the first chunk.
        Returns (latent chunk, caches for the next chunk)."""
        io = CacheIO(caches)
        return self._encode(chunk, io), io.out

    def _decode(self, z, first_chunk, io):
        mean, std = self._scale(z.device)
        z = z * std + mean           # promotes to fp32, as the reference does
        x = self.conv2(z.permute(0, 4, 1, 2, 3))
        out = self.decoder(x, first_chunk, io).permute(0, 2, 3, 4, 1)
        return torch.clamp(unpatchify(out, self.cfg.patchify), -1.0, 1.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Normalised latent [B, Tz, h, w, z] → video
        [B, 1+(Tz-1)*s_t, h*s, w*s, 3] in [-1, 1]."""
        return self._decode(z, True, None)

    def decode_chunk(self, z_chunk, caches):
        """z_chunk: [B, Tz, h, w, z] (normalised); caches: list | None for
        the first chunk. Returns (video chunk, caches for the next chunk)."""
        io = CacheIO(caches)
        return self._decode(z_chunk, caches is None, io), io.out


@torch.no_grad()
def streaming_encode(vae: WanVAE, video: torch.Tensor) -> torch.Tensor:
    """Chunked encode with carried caches (the reference's production
    encode): pixel frame 0 alone, then chunks of 4. Equal to
    :meth:`WanVAE.encode` with bounded activation memory."""
    t = video.shape[1]
    mu, caches = vae.encode_chunk(video[:, :1], None)
    outs = [mu]
    for s in range(1, t, 4):
        mu, caches = vae.encode_chunk(video[:, s:s + 4], caches)
        outs.append(mu)
    return torch.cat(outs, dim=1)


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
