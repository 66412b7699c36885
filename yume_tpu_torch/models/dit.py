"""Wan DiT backbone (5B ti2v: FramePack-packed and unpacked forwards) in
PyTorch (counterpart of yume_tpu/models/dit.py).

Module and parameter names follow the reference torch ``WanModel``
(``blocks.{i}.self_attn.q``, ``time_projection.1``, ``head.head`` ...), so a
released state dict loads as it is; :mod:`..utils.convert` maps JAX
parameter trees onto the same names.

Numerics mirror the reference:

* compact AdaLN modulation: tables for the K distinct timesteps
  ([B, K, 6, dim], fp32) plus a per-token index [B, L]; the row select
  happens inside the fused glue kernels (:mod:`..ops.fused_adaln`);
* fp32 islands: time embedding, modulation arithmetic, norms and the head
  run in fp32 whatever the compute dtype; projections run in the compute
  dtype (bf16 on the card);
* the residual stream stays in the compute dtype (``adaln_residual`` writes
  x.dtype; the cross-attention residual is a plain add);
* GELU is the tanh approximation;
* the text padding is not masked in cross-attention (as in the reference).

Parameters may be stored in any dtype: every layer casts its weights to the
dtype its computation runs in, as flax's ``promote_dtype`` does.

W8A8 (``cfg.w8a8``): the block projections that the reference routes
through ``int8_dot_general`` (``QDense``/``fused_sibling_dense`` with
``w8a8``) run through :func:`..ops.quant_matmul.q8_dot`, kernel K6 on the
card: self-attention q, k and v as one ``[3·dim, dim]`` product (per column
the same as three), self-attention o, cross-attention q and o, ``ffn.0``
and ``ffn.2``. Cross-attention k and v (512 text rows), the head and the
embeddings stay exact. The bias is added after the cast, in the compute
dtype. Each weight is quantized once, from the weight cast to the compute
dtype, and kept until the weight changes: the same int8 bits and scales
the reference derives on every call.

TeaCache hooks (``cache_list``/``return_cache``/``block_cache``): the listed
blocks either store their residual ``x_out − x_in`` in bf16 or are skipped
with the stored residual added back.

Training: every kernel on the path carries a gradient (K1 forward with
K8/K9 backward, K2–K5 through recompute); ``remat`` checkpoints each block;
the MVDT masked pass (``mvdt_noise``/``mvdt_keep``) runs with ``cfg.mvdt``.

Sequence parallelism: :meth:`WanDiT.embed_packed` and
:meth:`WanDiT.trunk_head` split the packed forward where a sequence-parallel
rank shards the tokens (:mod:`..parallel.sp_forward`); ``attn_fn`` replaces
the blocks' self-attention, while the cross-attention stays local against
the replicated text, as in the reference.

The 14B i2v model (``cfg.image_context_len`` > 0) adds the CLIP branch:
``img_emb`` (LayerNorm, Linear, exact GELU, Linear, LayerNorm; eps 1e-6 as
the reference's flax LayerNorm) embeds the 257 CLIP tokens, which go in
front of the embedded text, and every block's cross-attention is
:class:`I2VCrossAttention`: K1 over the text keys and over the image keys,
the two outputs summed in x's dtype.

Ported: the FramePack-packed forward (``forward``), the unpacked
forward over every frame at full resolution (``packed=False``, the t2v
first segment: one AdaLN table row per latent frame, grid RoPE), MVDT and
the 14B i2v branch (``clip_context``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs import DiTConfig
from ..ops import fused_adaln, quant_matmul, rope as rope_lib
from ..ops.attention import attention


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (inputs and params cast to it)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _w8a8_dense(x: torch.Tensor, owner: nn.Module, name: str,
                layers: Sequence[nn.Linear]) -> torch.Tensor:
    """W8A8 ``x @ cat(W).T + cat(b)`` for sibling ``layers`` of one input
    (the reference's ``fused_sibling_dense``/``QDense`` with ``w8a8``), in
    x.dtype. The int8 weight of ``cat(W)`` cast to x.dtype is kept on
    ``owner`` under ``name``, keyed by the weights' storage and version.

    Serving only: the int8 product has no gradient, so a call that autograd
    would have to differentiate raises instead of dropping the gradient."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            l.weight.requires_grad or l.bias.requires_grad for l in layers)):
        raise RuntimeError(
            "W8A8 projections are for serving: run them under torch.no_grad() "
            "or with parameters that do not require grad (train the bf16 DiT)")
    dtype = x.dtype
    key = (dtype, tuple((l.weight.data_ptr(), l.weight._version) for l in layers))
    cache = owner.__dict__.setdefault("_q8_cache", {})
    if name not in cache or cache[name][0] != key:
        cache.pop(name, None)
        w = torch.cat([l.weight.to(dtype) for l in layers])
        cache[name] = (key, quant_matmul.quantize_weight(w))
    y = quant_matmul.q8_dot(x, cache[name][1], dtype)
    return y + torch.cat([l.bias for l in layers]).to(dtype)


# ---------------------------------------------------------------------------
# small layers
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """fp32 RMS norm with learned scale (reference WanRMSNorm)."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (n * self.weight.float()).to(x.dtype)


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[cos | sin] sinusoidal embedding in fp32."""
    half = dim // 2
    pos = position.float()
    inv = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                           device=pos.device) / half)
    ang = pos[..., None] * inv
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


@dataclasses.dataclass
class Modulation:
    """Compact AdaLN modulation: distinct-value tables + per-token index.

    e:   [B, K, dim]     time embedding, fp32
    e0:  [B, K, 6, dim]  projected 6-way modulation, fp32
    idx: [B, L] int32 or None (None ⇒ K == 1)
    """

    e: torch.Tensor
    e0: torch.Tensor
    idx: Optional[torch.Tensor]

    def gathered(self, keep_idx: torch.Tensor) -> "Modulation":
        """Restrict to kept tokens [B, keep] (MVDT masked branch)."""
        if self.idx is None:
            return self
        return Modulation(self.e, self.e0, torch.gather(self.idx, 1, keep_idx))


# ---------------------------------------------------------------------------
# attention blocks
# ---------------------------------------------------------------------------


class SelfAttention(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.q = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.k = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.v = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.o = nn.Linear(cfg.dim, cfg.dim, **kw)
        if cfg.qk_norm:
            self.norm_q = RMSNorm(cfg.dim, cfg.eps, **kw)
            self.norm_k = RMSNorm(cfg.dim, cfg.eps, **kw)

    def forward(self, x, rope_cos, rope_sin, attn_fn=None, kv_len=None):
        """``attn_fn(q, k, v, kv_len=kv_len)`` replaces :func:`attention`
        (a sequence-parallel attention over this rank's tokens)."""
        c = self.cfg
        b, l, _ = x.shape
        n, d = c.num_heads, c.head_dim
        if c.w8a8:
            # one K6 launch over the concatenated [3·dim, dim] weight
            # (K4 reads q and k in place through their row stride)
            q, k, v = _w8a8_dense(x, self, "qkv", (self.q, self.k, self.v)).split(c.dim, -1)
        else:
            q = _dense(x, self.q, x.dtype)
            k = _dense(x, self.k, x.dtype)
            v = _dense(x, self.v, x.dtype)
        if c.qk_norm:
            # RMSNorm(q)·w, RMSNorm(k)·w and RoPE of both in one pass (K4)
            q, k = fused_adaln.qk_norm_rope(q, k, self.norm_q.weight,
                                            self.norm_k.weight, rope_cos,
                                            rope_sin, n, eps=c.eps)
            q = q.reshape(b, l, n, d)
            k = k.reshape(b, l, n, d)
        else:
            q = rope_lib.apply_rope(q.reshape(b, l, n, d), rope_cos, rope_sin)
            k = rope_lib.apply_rope(k.reshape(b, l, n, d), rope_cos, rope_sin)
        o = (attention if attn_fn is None else attn_fn)(
            q, k, v.reshape(b, l, n, d), kv_len=kv_len).reshape(b, l, c.dim)
        if c.w8a8:
            return _w8a8_dense(o, self, "o", (self.o,))
        return _dense(o, self.o, x.dtype)


class CrossAttention(nn.Module):
    """Text cross-attention (reference WanCrossAttention)."""

    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.q = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.k = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.v = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.o = nn.Linear(cfg.dim, cfg.dim, **kw)
        if cfg.qk_norm:
            self.norm_q = RMSNorm(cfg.dim, cfg.eps, **kw)
            self.norm_k = RMSNorm(cfg.dim, cfg.eps, **kw)

    def forward(self, x, context):
        c = self.cfg
        b, l, _ = x.shape
        n, d = c.num_heads, c.head_dim
        if c.w8a8:
            q = _w8a8_dense(x, self, "q", (self.q,))
        else:
            q = _dense(x, self.q, x.dtype)
        # context-side k and v stay exact (512 text rows)
        k = _dense(context, self.k, x.dtype)
        v = _dense(context, self.v, x.dtype)
        if c.qk_norm:
            # q is token-length sized: one fused pass (K5); k is 512 rows
            q = fused_adaln.rms_norm(q, self.norm_q.weight, eps=c.eps)
            k = self.norm_k(k)
        o = attention(q.reshape(b, l, n, d), k.reshape(b, -1, n, d),
                      v.reshape(b, -1, n, d)).reshape(b, l, c.dim)
        if c.w8a8:
            return _w8a8_dense(o, self, "o", (self.o,))
        return _dense(o, self.o, x.dtype)


class I2VCrossAttention(CrossAttention):
    """14B image and text cross-attention (reference
    wan/modules/model.py:336-400): the context is the 257 embedded CLIP
    tokens followed by the text; separate k/v projections for the image
    tokens (``k_img``, ``v_img``, ``norm_k_img``), one attention over each
    part with the same q (K1 twice), the outputs summed in x's dtype."""

    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.k_img = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.v_img = nn.Linear(cfg.dim, cfg.dim, **kw)
        if cfg.qk_norm:
            self.norm_k_img = RMSNorm(cfg.dim, cfg.eps, **kw)

    def forward(self, x, context):
        c = self.cfg
        b, l, _ = x.shape
        n, d = c.num_heads, c.head_dim
        ctx_img, ctx_txt = context[:, :c.image_context_len], context[:, c.image_context_len:]
        if c.w8a8:
            q = _w8a8_dense(x, self, "q", (self.q,))
        else:
            q = _dense(x, self.q, x.dtype)
        if c.qk_norm:
            q = fused_adaln.rms_norm(q, self.norm_q.weight, eps=c.eps)
        q = q.reshape(b, l, n, d)
        # the context-side projections stay exact (512 text and 257 image rows)
        k = _dense(ctx_txt, self.k, x.dtype)
        v = _dense(ctx_txt, self.v, x.dtype)
        k_img = _dense(ctx_img, self.k_img, x.dtype)
        v_img = _dense(ctx_img, self.v_img, x.dtype)
        if c.qk_norm:
            k = self.norm_k(k)
            k_img = self.norm_k_img(k_img)
        o_txt = attention(q, k.reshape(b, -1, n, d), v.reshape(b, -1, n, d))
        o_img = attention(q, k_img.reshape(b, -1, n, d), v_img.reshape(b, -1, n, d))
        o = (o_txt + o_img).reshape(b, l, c.dim)
        if c.w8a8:
            return _w8a8_dense(o, self, "o", (self.o,))
        return _dense(o, self.o, x.dtype)


class DiTBlock(nn.Module):
    """AdaLN-modulated self-attn + cross-attn + FFN block (reference
    WanAttentionBlock). ``attn_fn``/``kv_len`` go to the self-attention
    only: a sequence-parallel rank attends to the replicated text
    locally."""

    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.modulation = nn.Parameter(torch.zeros(1, 6, cfg.dim, **kw))
        self.self_attn = SelfAttention(cfg, **kw)
        cross_cls = I2VCrossAttention if cfg.image_context_len else CrossAttention
        self.cross_attn = cross_cls(cfg, **kw)
        if cfg.cross_attn_norm:
            self.norm3 = nn.LayerNorm(cfg.dim, eps=cfg.eps, **kw)
        self.ffn = nn.Sequential(nn.Linear(cfg.dim, cfg.ffn_dim, **kw),
                                 nn.GELU(approximate="tanh"),
                                 nn.Linear(cfg.ffn_dim, cfg.dim, **kw))

    def forward(self, x, mod: Modulation, context, rope_cos, rope_sin, attn_fn=None,
                kv_len=None):
        c = self.cfg
        m = self.modulation.float()

        def etab(j):
            # fp32 (modulation_j + e0_j) as a compact [B, K, dim] table
            return m[:, j][:, None, :] + mod.e0[:, :, j, :]

        h = fused_adaln.adaln_norm(x, etab(1), etab(0), mod.idx, eps=c.eps)
        y = self.self_attn(h, rope_cos, rope_sin, attn_fn, kv_len)
        x = fused_adaln.adaln_residual(x, y, etab(2), mod.idx)

        if c.cross_attn_norm:
            # affine LayerNorm as the gate=0 form of the fused norm
            h = fused_adaln.adaln_norm(
                x, self.norm3.weight[None, None, :], self.norm3.bias[None, None, :],
                None, eps=c.eps, gate=0.0)
        else:
            h = x
        x = x + self.cross_attn(h, context)

        h = fused_adaln.adaln_norm(x, etab(4), etab(3), mod.idx, eps=c.eps)
        if c.w8a8:
            h = _gelu(_w8a8_dense(h, self, "ffn.0", (self.ffn[0],)))
            y = _w8a8_dense(h, self, "ffn.2", (self.ffn[2],))
        else:
            h = _gelu(_dense(h, self.ffn[0], x.dtype))
            y = _dense(h, self.ffn[2], x.dtype)
        return fused_adaln.adaln_residual(x, y, etab(5), mod.idx)


class Head(nn.Module):
    """Final modulated projection to patch outputs, in fp32."""

    def __init__(self, cfg: DiTConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        out = math.prod(cfg.patch_size) * cfg.out_dim
        self.modulation = nn.Parameter(torch.zeros(1, 2, cfg.dim, device=device,
                                                   dtype=dtype))
        self.head = nn.Linear(cfg.dim, out, device=device, dtype=dtype)

    def forward(self, x, mod: Modulation):
        m = self.modulation.float()
        e0_tab = m[:, 0][:, None, :] + mod.e   # [B, K, dim]
        e1_tab = m[:, 1][:, None, :] + mod.e
        h = fused_adaln.adaln_norm(x, e1_tab, e0_tab, mod.idx, eps=self.cfg.eps,
                                   out_dtype=torch.float32)
        return _dense(h, self.head, torch.float32)


# ---------------------------------------------------------------------------
# FramePack planning (host-side, static per history length)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackChunk:
    start: int       # history frame range [start, stop)
    stop: int
    scale: int       # spatial compression (1,2,4,8,16 → conv stride 2s)
    double_f: bool = False  # bucket-6 extra 2x_f pre-conv


def framepack_plan(f_hist: int) -> List[PackChunk]:
    """Static chunk schedule for a history of ``f_hist`` latent frames: the
    6 bucket regimes of progressively coarser patching for older frames."""
    assert f_hist >= 1
    if f_hist <= 2 + 4:
        if f_hist <= 2:
            mid = [PackChunk(f_hist - 1, f_hist, 2)]
        else:
            mid = [PackChunk(1, f_hist - 1, 2)]
        return [PackChunk(0, 1, 1), *mid, PackChunk(f_hist - 1, f_hist, 1)]
    if f_hist <= 2 + 4 + 16:
        if f_hist <= 6:
            far = [PackChunk(f_hist - 5, f_hist - 4, 4)]
        else:
            far = [PackChunk(1, f_hist - 5, 4)]
        return [
            PackChunk(0, 1, 1), *far,
            PackChunk(f_hist - 5, f_hist - 3, 2),
            PackChunk(f_hist - 3, f_hist, 1),
        ]
    if f_hist <= 2 + 4 + 16 + 64:
        if f_hist <= 22:
            far = [PackChunk(f_hist - 21, f_hist - 20, 8)]
        else:
            far = [PackChunk(1, f_hist - 21, 8)]
        return [
            PackChunk(0, 1, 1), *far,
            PackChunk(f_hist - 21, f_hist - 5, 4),
            PackChunk(f_hist - 5, f_hist - 3, 2),
            PackChunk(f_hist - 3, f_hist, 1),
        ]
    if f_hist <= 2 + 4 + 16 + 64 + 256:
        if f_hist <= 86:
            far = [PackChunk(f_hist - 85, f_hist - 84, 16)]
        else:
            far = [PackChunk(1, f_hist - 85, 16)]
        return [
            PackChunk(0, 1, 2), *far,
            PackChunk(f_hist - 85, f_hist - 21, 8),
            PackChunk(f_hist - 21, f_hist - 5, 4),
            PackChunk(f_hist - 5, f_hist - 3, 2),
            PackChunk(f_hist - 3, f_hist, 1),
        ]
    assert f_hist <= 2 + 4 + 16 + 64 + 256 + 1024, "history exceeds FramePack budget"
    if f_hist <= 342:
        far = [PackChunk(f_hist - 341, f_hist - 340, 16, double_f=True)]
    else:
        far = [PackChunk(1, f_hist - 341, 16, double_f=True)]
    return [
        PackChunk(0, 1, 2), *far,
        PackChunk(f_hist - 341, f_hist - 85, 16),
        PackChunk(f_hist - 85, f_hist - 21, 8),
        PackChunk(f_hist - 21, f_hist - 5, 4),
        PackChunk(f_hist - 5, f_hist - 3, 2),
        PackChunk(f_hist - 3, f_hist, 1),
    ]


@functools.lru_cache(maxsize=8)
def _grid_rope_on(grid: Tuple[int, int, int], head_dim: int, max_len: int, theta: float,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid RoPE tables [F·H·W, head_dim/2] of an unpacked token grid on
    ``device``, made and copied once a grid: every step of a rollout reads
    the same tables."""
    cos, sin = rope_lib.grid_rope(*grid, head_dim, max_len=max_len, theta=theta)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def packed_grids(
    plan: Sequence[PackChunk], h_lat: int, w_lat: int, patch: Tuple[int, int, int]
) -> List[Tuple[int, int, int]]:
    """Per-chunk (F, H, W) token grids (post conv) for a FramePack plan."""
    grids = []
    for ch in plan:
        stride = patch[1] * ch.scale * (4 if ch.double_f else 1)
        grids.append((ch.stop - ch.start, _ceil_div(h_lat, stride), _ceil_div(w_lat, stride)))
    return grids


def packed_token_count(f_hist: int, latent_frame_zero: int, h_lat: int, w_lat: int,
                       patch: Tuple[int, int, int]) -> int:
    """Tokens of the packed sequence: the FramePack history plus the tail
    at full resolution (what MVDT masking draws its keep count from)."""
    grids = packed_grids(framepack_plan(f_hist), h_lat, w_lat, patch)
    grids.append((latent_frame_zero // patch[0], _ceil_div(h_lat, patch[1]),
                  _ceil_div(w_lat, patch[2])))
    return sum(f * h * w for f, h, w in grids)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class WanDiT(nn.Module):
    """Wan diffusion transformer: FramePack-packed and unpacked call modes.

    ``dtype`` is the compute dtype of the matmul paths (bf16 on the card);
    ``param_dtype`` the storage dtype of the parameters. ``remat``
    recomputes each block's activations in the backward pass (per-block
    ``torch.utils.checkpoint``, the reference's ``nn.remat``). With
    ``cfg.mvdt`` the model has the MVDT ``sideblock`` and ``mask_token``.
    """

    def __init__(self, cfg: DiTConfig, dtype: torch.dtype = torch.bfloat16, *,
                 device=None, param_dtype=None, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        kw = dict(device=device, dtype=param_dtype)
        p = cfg.patch_size

        def conv(cin, cout, spatial):
            return nn.Conv3d(cin, cout, kernel_size=(p[0], spatial, spatial),
                             stride=(p[0], spatial, spatial), **kw)

        self.patch_embedding = conv(cfg.in_dim, cfg.dim, p[1])
        if cfg.framepack:
            self.patch_embedding_2x = conv(cfg.in_dim, cfg.dim, 2 * p[1])
            self.patch_embedding_4x = conv(cfg.in_dim, cfg.dim, 4 * p[1])
            self.patch_embedding_8x = conv(cfg.in_dim, cfg.dim, 8 * p[1])
            self.patch_embedding_16x = conv(cfg.in_dim, cfg.dim, 16 * p[1])
            self.patch_embedding_2x_f = conv(cfg.in_dim, cfg.in_dim, 2 * p[1])
        self.text_embedding = nn.Sequential(
            nn.Linear(cfg.text_dim, cfg.dim, **kw), nn.GELU(approximate="tanh"),
            nn.Linear(cfg.dim, cfg.dim, **kw))
        self.time_embedding = nn.Sequential(
            nn.Linear(cfg.freq_dim, cfg.dim, **kw), nn.SiLU(),
            nn.Linear(cfg.dim, cfg.dim, **kw))
        self.time_projection = nn.Sequential(
            nn.SiLU(), nn.Linear(cfg.dim, 6 * cfg.dim, **kw))
        if cfg.image_context_len:
            # MLPProj of the 14B CLIP branch (reference wan/modules/model.py:530-541)
            self.img_emb = nn.Module()
            self.img_emb.proj = nn.Sequential(
                nn.LayerNorm(cfg.image_dim, eps=1e-6, **kw),
                nn.Linear(cfg.image_dim, cfg.image_dim, **kw), nn.GELU(),
                nn.Linear(cfg.image_dim, cfg.dim, **kw), nn.LayerNorm(cfg.dim, eps=1e-6, **kw))
        self.blocks = nn.ModuleList(DiTBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.head = Head(cfg, **kw)
        if cfg.mvdt:
            self.sideblock = DiTBlock(cfg, **kw)
            self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.dim, **kw))

    def _embed_chunk(self, x, scale: int, double_f: bool):
        """Patch-embed a channels-last chunk [B, F, H, W, C] at a spatial
        compression scale; H and W are zero-padded to the stride. Returns
        tokens [B, F·H'·W', dim] and the token grid."""
        c = self.cfg
        p = c.patch_size[1]
        x = x.permute(0, 4, 1, 2, 3)  # [B, C, F, H, W] for Conv3d

        def run(conv, x, stride):
            x = F.pad(x, (0, (-x.shape[4]) % stride, 0, (-x.shape[3]) % stride))
            return F.conv3d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                            stride=conv.stride)

        if double_f:
            x = run(self.patch_embedding_2x_f, x, 4)
        convs = {1: self.patch_embedding}
        if c.framepack:
            convs.update({2: self.patch_embedding_2x, 4: self.patch_embedding_4x,
                          8: self.patch_embedding_8x, 16: self.patch_embedding_16x})
        x = run(convs[scale], x, p * scale)
        b, d, f, h, w = x.shape
        return x.flatten(2).transpose(1, 2), (f, h, w)

    def _time_mod(self, t_values: torch.Tensor, idx: Optional[torch.Tensor]) -> Modulation:
        """Compact modulation tables from distinct timestep values [B, K]."""
        c = self.cfg
        f32 = torch.float32
        emb = sinusoidal_embedding_1d(c.freq_dim, t_values)
        e = F.silu(_dense(emb, self.time_embedding[0], f32))
        e = _dense(e, self.time_embedding[2], f32)
        e0 = _dense(F.silu(e), self.time_projection[1], f32)
        b, k = t_values.shape
        return Modulation(e=e, e0=e0.reshape(b, k, 6, c.dim), idx=idx)

    def _text_embed(self, context: torch.Tensor) -> torch.Tensor:
        h = _gelu(_dense(context, self.text_embedding[0], self.dtype))
        return _dense(h, self.text_embedding[2], self.dtype)

    def _img_embed(self, clip_ctx: torch.Tensor) -> torch.Tensor:
        """The 14B MLPProj of the CLIP tokens: fp32 LayerNorm, Linear, exact
        GELU, Linear in the compute dtype, fp32 LayerNorm, cast back."""
        ln1, fc1, _, fc2, ln2 = self.img_emb.proj
        f32 = torch.float32

        def norm(x, ln):
            return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                                ln.bias.float(), ln.eps)

        h = F.gelu(_dense(norm(clip_ctx, ln1), fc1, self.dtype))
        return norm(_dense(h, fc2, self.dtype).to(f32), ln2).to(self.dtype)

    def _context(self, context: torch.Tensor,
                 clip_context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The embedded text, after the embedded CLIP tokens for the 14B
        i2v model."""
        ctx = self._text_embed(context)
        if self.cfg.image_context_len:
            if clip_context is None:
                raise ValueError("the i2v model needs clip_context")
            ctx = torch.cat([self._img_embed(clip_context), ctx], dim=1)
        return ctx

    def _trunk(self, x, mod: Modulation, context, rope_cos, rope_sin,
               mvdt: Optional[dict] = None, block_cache=None,
               cache_list: Tuple[int, ...] = (), return_cache: bool = False,
               attn_fn=None, kv_len=None):
        """All blocks, with the MVDT side interpolation before block
        ``mid − 1`` (after it the trunk runs on the full token set), and
        TeaCache-style residual caching (reference wan/modules/model.py:
        977-998): blocks listed in ``cache_list`` store their residual
        (x_out − x_in) in bf16 with ``return_cache``, or are skipped with the
        cached residual added back when ``block_cache`` is given.
        ``attn_fn``/``kv_len``: the blocks' self-attention (see
        :class:`SelfAttention`). Returns (x, the modulation after the trunk,
        new_cache)."""
        mid = (self.cfg.num_layers + 1) // 2
        new_cache = []
        for i, block in enumerate(self.blocks):
            if mvdt is not None and i == mid - 1:
                x = self._side_interpolate(x, mvdt, context)
                mod = mvdt["mod_full"]
                rope_cos, rope_sin = mvdt["rope_full"]
            if block_cache is not None and not return_cache and i in cache_list:
                x = x + block_cache[cache_list.index(i)].to(x.dtype)
                continue
            x_in = x
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, mod, context, rope_cos, rope_sin, attn_fn,
                               kv_len, use_reentrant=False)
            else:
                x = block(x, mod, context, rope_cos, rope_sin, attn_fn, kv_len)
            if return_cache and i in cache_list:
                new_cache.append((x - x_in).to(torch.bfloat16))
        return x, mod, new_cache

    def _side_interpolate(self, x, mvdt, context):
        """MVDT mid-network side interpolater (reference
        wan23/modules/model.py:531-545): unshuffle the kept tokens and mask
        tokens to full length, run the side block, masked shortcut."""
        ids_restore, mask = mvdt["ids_restore"], mvdt["mask"]
        b, lk, d = x.shape
        l_full = ids_restore.shape[1]
        pad = self.mask_token.to(x.dtype).expand(b, l_full - lk, d)
        x_full = torch.gather(torch.cat([x, pad], dim=1), 1,
                              ids_restore[:, :, None].expand(-1, -1, d))
        y = self.sideblock(x_full, mvdt["mod_full"], context, *mvdt["rope_full"])
        m = mask[:, :, None].to(y.dtype)
        return y * m + x_full * (1.0 - m)

    def _maybe_mask(self, tokens, mod, cos, sin, mvdt_noise, mvdt_keep):
        """MVDT random masking with a fixed keep count (reference
        random_masking, wan23/modules/model.py:500-528). ``mvdt_noise`` is a
        uniform [B, L] tensor or a ``torch.Generator`` to draw it from.
        Returns (kept tokens, their modulation, the MVDT state or None, and
        the RoPE tables at each sample's kept positions, [B, keep, D/2])."""
        if mvdt_noise is None:
            return tokens, mod, None, cos, sin
        if not self.cfg.mvdt or mvdt_keep is None:
            raise ValueError("MVDT masking needs cfg.mvdt and mvdt_keep")
        b, l, d = tokens.shape
        if isinstance(mvdt_noise, torch.Generator):
            noise = torch.rand((b, l), generator=mvdt_noise, device=mvdt_noise.device)
        else:
            noise = mvdt_noise
        noise = noise.to(tokens.device)
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :mvdt_keep]
        x_masked = torch.gather(tokens, 1, ids_keep[:, :, None].expand(-1, -1, d))
        mask = torch.ones((b, l), dtype=torch.float32, device=tokens.device)
        mask[:, :mvdt_keep] = 0.0
        mask = torch.gather(mask, 1, ids_restore)
        cos_k, sin_k = cos[ids_keep], sin[ids_keep]
        mvdt = dict(ids_restore=ids_restore, ids_keep=ids_keep, mask=mask,
                    mod_full=mod, rope_full=(cos, sin))
        return x_masked, mod.gathered(ids_keep), mvdt, cos_k, sin_k

    def forward(self, x: torch.Tensor, t_frame: torch.Tensor, context: torch.Tensor,
                *, packed: bool = True, latent_frame_zero: int = 8,
                clip_context: Optional[torch.Tensor] = None, mvdt_noise=None,
                mvdt_keep: Optional[int] = None,
                block_cache: Optional[List[torch.Tensor]] = None,
                cache_list: Tuple[int, ...] = (), return_cache: bool = False):
        """Velocity for the trailing ``latent_frame_zero`` frames (packed),
        or for every frame (``packed=False``: all frames at full
        resolution, no FramePack history).

        x: [B, F, H, W, C_in] channels-last latents; t_frame: [B, F]
        per-frame timesteps (0..1000); context: [B, text_len, text_dim];
        clip_context: [B, 257, image_dim] CLIP features (the 14B i2v model).
        Returns [B, latent_frame_zero, H, W, C_out] ([B, F, H, W, C_out]
        unpacked) in fp32, and with
        ``return_cache`` also the residuals of the ``cache_list`` blocks;
        ``block_cache`` skips those blocks (see :meth:`_trunk`).
        ``mvdt_noise`` ([B, L] uniform noise or a ``torch.Generator``) with
        ``mvdt_keep`` runs the MVDT masked pass on ``mvdt_keep`` of the L
        tokens (see :meth:`_maybe_mask`)."""
        emb = (self.embed_packed(x, t_frame, context, latent_frame_zero, clip_context)
               if packed else self.embed_unpacked(x, t_frame, context, clip_context))
        out = self.trunk_head(emb["tokens"], emb["t_values"], emb["idx"], emb["ctx"],
                              emb["cos"], emb["sin"], mvdt_noise=mvdt_noise,
                              mvdt_keep=mvdt_keep, block_cache=block_cache,
                              cache_list=cache_list, return_cache=return_cache)
        out, new_cache = out if return_cache else (out, None)
        out = self._unpatchify(out[:, emb["l_hist"]:], emb["tail_grid"])
        return (out, new_cache) if return_cache else out

    # -- token-level entry points for sequence parallelism --------------------

    def embed_packed(self, x, t_frame, context, latent_frame_zero, clip_context=None):
        """Embedding and conditioning of the packed forward, without the
        blocks: a dict of the packed tokens [B, L, dim], the distinct
        timesteps ``t_values`` [B, 2] (history, tail), the per-token index
        ``idx`` [B, L], the embedded text ``ctx``, the RoPE tables ``cos``
        and ``sin`` [L, D/2], ``l_hist`` and the tail's token grid
        (``clip_context``: see :meth:`forward`). A
        sequence-parallel forward embeds on every rank and shards the token
        axis between this and :meth:`trunk_head` (the reference's
        sp_dit_forward, wan23/distributed/sequence_parallel.py:64-146)."""
        c = self.cfg
        b, f, h_lat, w_lat, _ = x.shape
        f_hist = f - latent_frame_zero
        assert f_hist >= 1, "packed mode requires at least one history frame"
        plan = framepack_plan(f_hist)
        xc = x.to(self.dtype)

        tok_parts, grids = [], []
        for ch in plan:
            toks, grid = self._embed_chunk(xc[:, ch.start:ch.stop], ch.scale, ch.double_f)
            tok_parts.append(toks)
            grids.append(grid)
        tail_toks, tail_grid = self._embed_chunk(xc[:, f_hist:], 1, False)
        tok_parts.append(tail_toks)
        grids.append(tail_grid)
        tokens = torch.cat(tok_parts, dim=1)
        l_hist = tokens.shape[1] - tail_toks.shape[1]
        l = tokens.shape[1]

        # multi-resolution RoPE with cumulative compressed-frame offsets
        cos, sin = rope_lib.framepack_rope(grids, c.head_dim, max_len=c.rope_max_len,
                                           theta=c.rope_theta)
        # two distinct timesteps: history (first frame's) and tail (last frame's)
        t_vals = torch.stack([t_frame[:, 0], t_frame[:, -1]], dim=1).float()
        idx = (torch.arange(l, device=x.device) >= l_hist).to(torch.int32)
        return dict(tokens=tokens, t_values=t_vals,
                    idx=idx[None, :].expand(b, l).contiguous(),
                    ctx=self._context(context, clip_context),
                    cos=torch.from_numpy(cos).to(x.device),
                    sin=torch.from_numpy(sin).to(x.device),
                    l_hist=l_hist, tail_grid=tail_grid)

    def embed_unpacked(self, x, t_frame, context, clip_context=None):
        """Embedding and conditioning of the unpacked forward, with the keys
        of :meth:`embed_packed`: every frame's tokens at full resolution
        [B, L, dim], ``t_values`` = ``t_frame`` [B, F] in fp32 (one table
        row per latent frame, K = F, equal values included), ``idx`` [B, L]
        the latent frame of each token, the grid RoPE tables [L, D/2],
        ``l_hist`` 0 and the token grid as ``tail_grid``."""
        c = self.cfg
        b, f = x.shape[:2]
        tokens, (gf, gh, gw) = self._embed_chunk(x.to(self.dtype), 1, False)
        l = tokens.shape[1]
        idx = torch.arange(f, dtype=torch.int32, device=x.device).repeat_interleave(gh * gw)
        cos, sin = _grid_rope_on((gf, gh, gw), c.head_dim, c.rope_max_len, c.rope_theta,
                                 x.device)
        return dict(tokens=tokens, t_values=t_frame.float(),
                    idx=idx[None, :].expand(b, l).contiguous(),
                    ctx=self._context(context, clip_context), cos=cos, sin=sin,
                    l_hist=0, tail_grid=(gf, gh, gw))

    def trunk_head(self, tokens, t_values, idx, ctx, cos, sin, *, attn_fn=None,
                   kv_len=None, mvdt_noise=None, mvdt_keep=None, block_cache=None,
                   cache_list: Tuple[int, ...] = (), return_cache: bool = False):
        """Blocks and head over embedded tokens [B, L, dim] (any contiguous
        run of the packed sequence, with its ``idx``, ``cos`` and ``sin``
        rows): per-token work apart from the self-attention, which
        ``attn_fn``/``kv_len`` may make sequence-parallel. Returns the head's
        output [B, L, p·C_out] in fp32, and with ``return_cache`` the
        residuals of the ``cache_list`` blocks (:meth:`_trunk`); under
        sequence parallelism they are this rank's rows and stay there
        between TeaCache steps. ``mvdt_noise``/``mvdt_keep``: see
        :meth:`_maybe_mask`."""
        mod = self._time_mod(t_values, idx)
        tokens, mod, mvdt, cos_k, sin_k = self._maybe_mask(tokens, mod, cos, sin,
                                                           mvdt_noise, mvdt_keep)
        out, mod, new_cache = self._trunk(tokens, mod, ctx, cos_k, sin_k, mvdt,
                                          block_cache, cache_list, return_cache,
                                          attn_fn=attn_fn, kv_len=kv_len)
        out = self.head(out, mod)
        return (out, new_cache) if return_cache else out

    def _unpatchify(self, x, grid):
        """Tokens [B, F·H·W, p·C] → video [B, F·pt, H·ph, W·pw, C]."""
        c = self.cfg
        f, h, w = grid
        pt, ph, pw = c.patch_size
        b = x.shape[0]
        x = x.reshape(b, f, h, w, pt, ph, pw, c.out_dim)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)  # b f pt h ph w pw c
        return x.reshape(b, f * pt, h * ph, w * pw, c.out_dim)
