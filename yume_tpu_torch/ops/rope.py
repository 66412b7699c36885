"""3D rotary position embeddings for the Wan DiT (counterpart of
yume_tpu/ops/rope.py).

The cos/sin tables are host-side numpy, computed exactly as the reference
does (fp64 angles, fp32 tables). The head dimension splits into
(frame, height, width) = (D - 4*(D//6), 2*(D//6), 2*(D//6)) and rotation
pairs are adjacent elements (x[..., 2i], x[..., 2i+1]).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def axis_dims(head_dim: int) -> Tuple[int, int, int]:
    """Per-axis rotary sub-dimensions (frame, height, width)."""
    d6 = head_dim // 6
    return head_dim - 4 * d6, 2 * d6, 2 * d6


def _inv_freqs(axis_dim: int, theta: float) -> np.ndarray:
    """theta^(-2j/axis_dim), j = 0 .. axis_dim/2 - 1."""
    half = axis_dim // 2
    return theta ** (-np.arange(half, dtype=np.float64) * 2.0 / axis_dim)


@functools.lru_cache(maxsize=32)
def _axis_tables(max_len: int, axis_dim: int, theta: float):
    """cos/sin tables [max_len, axis_dim/2] for one axis (host-side, cached)."""
    angles = np.outer(np.arange(max_len, dtype=np.float64), _inv_freqs(axis_dim, theta))
    return (np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32))


def grid_rope(
    f_len: int,
    h_len: int,
    w_len: int,
    head_dim: int,
    *,
    f_offset: int = 0,
    max_len: int = 1024,
    theta: float = 10000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables for an (F, H, W) token grid, flattened row-major to
    [F*H*W, head_dim//2]; ``f_offset`` shifts the temporal positions."""
    df, dh, dw = axis_dims(head_dim)
    fc, fs = _axis_tables(max_len, df, theta)
    hc, hs = _axis_tables(max_len, dh, theta)
    wc, ws = _axis_tables(max_len, dw, theta)

    f_idx = np.arange(f_offset, f_offset + f_len)
    shape = (f_len, h_len, w_len)

    def _assemble(tf, th_, tw):
        out = np.concatenate(
            [
                np.broadcast_to(tf[f_idx][:, None, None, :], shape + (df // 2,)),
                np.broadcast_to(th_[:h_len][None, :, None, :], shape + (dh // 2,)),
                np.broadcast_to(tw[:w_len][None, None, :, :], shape + (dw // 2,)),
            ],
            axis=-1,
        )
        return np.ascontiguousarray(out.reshape(f_len * h_len * w_len, head_dim // 2))

    return _assemble(fc, hc, wc), _assemble(fs, hs, ws)


def framepack_rope(
    chunk_grids: Sequence[Tuple[int, int, int]],
    head_dim: int,
    *,
    max_len: int = 1024,
    theta: float = 10000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """RoPE tables for a FramePack packed sequence: temporal offsets
    accumulate across chunks in compressed units."""
    cos_parts, sin_parts = [], []
    f_off = 0
    for (f, h, w) in chunk_grids:
        c, s = grid_rope(f, h, w, head_dim, f_offset=f_off, max_len=max_len, theta=theta)
        cos_parts.append(c)
        sin_parts.append(s)
        f_off += f
    return np.concatenate(cos_parts, axis=0), np.concatenate(sin_parts, axis=0)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [B, L, N, D] by cos/sin tables [L, D//2] or [B, L, D//2].

    Pairs are adjacent elements (2i, 2i+1); the math runs in fp32 and the
    result is cast back to x.dtype.
    """
    b, l, n, d = x.shape
    xf = x.float().reshape(b, l, n, d // 2, 2)
    xe, xo = xf[..., 0], xf[..., 1]
    if cos.dim() == 2:
        c = cos[None, :, None, :]
        s = sin[None, :, None, :]
    else:
        c = cos[:, :, None, :]
        s = sin[:, :, None, :]
    re = xe * c - xo * s
    im = xe * s + xo * c
    return torch.stack([re, im], dim=-1).reshape(b, l, n, d).to(x.dtype)
