"""umT5-XXL text encoder in PyTorch (counterpart of yume_tpu/models/t5.py).

T5-style RMS LayerNorm, unscaled attention with an additive per-block
relative-position bias (bidirectional, 32 buckets, max distance 128 — umT5
does not share it across blocks), gated tanh-GELU feed-forward, final norm.
Parameter names follow the reference torch umT5 encoder
(``blocks.{i}.attn.q``, ``blocks.{i}.ffn.gate.0``,
``blocks.{i}.pos_embedding.embedding`` ...).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import T5Config


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int = 32,
                             max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 relative position buckets."""
    nb = num_buckets // 2
    rel_buckets = (rel_pos > 0).astype(np.int64) * nb
    rel_pos = np.abs(rel_pos)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel_pos, 1) / max_exact)
        / np.log(max_dist / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    rel_buckets += np.where(rel_pos < max_exact, rel_pos, large)
    return rel_buckets


def _dense(x, layer: nn.Linear):
    return F.linear(x, layer.weight.to(x.dtype))


class T5LayerNorm(nn.Module):
    """RMS norm without mean subtraction, fp32 math, output in x.dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (n * self.weight.float()).to(x.dtype)


class T5Attention(nn.Module):
    """Unscaled multi-head attention with an additive bias."""

    def __init__(self, cfg: T5Config, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q = nn.Linear(cfg.dim, cfg.dim_attn, **kw)
        self.k = nn.Linear(cfg.dim, cfg.dim_attn, **kw)
        self.v = nn.Linear(cfg.dim, cfg.dim_attn, **kw)
        self.o = nn.Linear(cfg.dim_attn, cfg.dim, **kw)

    def forward(self, x, mask=None, pos_bias=None):
        c = self.cfg
        b, l, _ = x.shape
        n = c.num_heads
        d = c.dim_attn // n
        q = _dense(x, self.q).reshape(b, l, n, d)
        k = _dense(x, self.k).reshape(b, l, n, d)
        v = _dense(x, self.v).reshape(b, l, n, d)
        s = torch.einsum("binc,bjnc->bnij", q.float(), k.float())
        if pos_bias is not None:
            s = s + pos_bias
        if mask is not None:
            s = torch.where(mask[:, None, None, :] > 0, s,
                            torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bnij,bjnc->binc", p, v.float()).to(x.dtype)
        return _dense(o.reshape(b, l, c.dim_attn), self.o)


class T5FeedForward(nn.Module):
    """Gated tanh-GELU FFN."""

    def __init__(self, cfg: T5Config, *, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate = nn.Sequential(nn.Linear(cfg.dim, cfg.dim_ffn, **kw),
                                  nn.GELU(approximate="tanh"))
        self.fc1 = nn.Linear(cfg.dim, cfg.dim_ffn, **kw)
        self.fc2 = nn.Linear(cfg.dim_ffn, cfg.dim, **kw)

    def forward(self, x):
        gate = F.gelu(_dense(x, self.gate[0]), approximate="tanh")
        return _dense(_dense(x, self.fc1) * gate, self.fc2)


class T5RelativeEmbedding(nn.Module):
    """Per-block relative-position bias table [num_buckets, num_heads]."""

    def __init__(self, cfg: T5Config, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.num_buckets, cfg.num_heads,
                                      device=device, dtype=dtype)

    def forward(self, l: int) -> torch.Tensor:
        """fp32 bias [1, N, L, L]."""
        c = self.cfg
        rel = np.arange(l)[None, :] - np.arange(l)[:, None]
        buckets = torch.from_numpy(
            relative_position_bucket(rel, c.num_buckets, c.max_distance)
        ).to(self.embedding.weight.device)
        return self.embedding.weight.float()[buckets].permute(2, 0, 1)[None]


class T5SelfAttentionBlock(nn.Module):
    """Pre-norm self-attention + FFN block with its own relative bias."""

    def __init__(self, cfg: T5Config, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = T5LayerNorm(cfg.dim, **kw)
        self.attn = T5Attention(cfg, **kw)
        self.norm2 = T5LayerNorm(cfg.dim, **kw)
        self.ffn = T5FeedForward(cfg, **kw)
        self.pos_embedding = T5RelativeEmbedding(cfg, **kw)

    def forward(self, x, mask=None):
        pos_bias = self.pos_embedding(x.shape[1])
        x = x + self.attn(self.norm1(x), mask=mask, pos_bias=pos_bias)
        return x + self.ffn(self.norm2(x))


class T5Encoder(nn.Module):
    """umT5 encoder; ``dtype`` is the compute dtype."""

    def __init__(self, cfg: T5Config, dtype: torch.dtype = torch.bfloat16, *,
                 device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        kw = dict(device=device, dtype=param_dtype)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.blocks = nn.ModuleList(T5SelfAttentionBlock(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.norm = T5LayerNorm(cfg.dim, **kw)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.token_embedding.weight[ids.long()].to(self.dtype)
        for block in self.blocks:
            x = block(x, mask)
        return self.norm(x)


def encode_text(model: T5Encoder, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Padded [B, text_len, dim] embeddings with the padding zeroed."""
    ctx = model(ids, mask)
    return ctx * mask[:, :, None].to(ctx.dtype)
