"""Width-tiled VAE decoding with blended overlaps (counterpart of
yume_tpu/pipelines/tiled_decode.py; the reference webapp's
``tiled_decode_overlap``): the latent is split into ``n_tiles`` width tiles
with a small latent-space overlap, each tile decodes on its own (bounded
peak activation memory), and the overlapping pixel columns are linearly
cross-faded."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _tile_bounds(latents_w: int, n_tiles: int, latent_overlap: int):
    """(starts, ends, cores) of ``n_tiles`` width tiles: core widths differ
    by at most one, each tile widened by ``latent_overlap`` on its inner
    sides."""
    base = latents_w // n_tiles
    rem = latents_w % n_tiles
    widths = [base + 1 if i < rem else base for i in range(n_tiles)]
    starts, ends, cores = [], [], []
    cur = 0
    for i in range(n_tiles):
        s, e = cur, cur + widths[i]
        cores.append((s, e))
        if i > 0:
            s -= latent_overlap
        if i < n_tiles - 1:
            e += latent_overlap
        starts.append(max(s, 0))
        ends.append(min(e, latents_w))
        cur += widths[i]
    return starts, ends, cores


@torch.no_grad()
def tiled_decode(decode_fn: Callable[[torch.Tensor], torch.Tensor], latents: torch.Tensor, *,
                 n_tiles: int = 5, image_overlap_size: int = 32,
                 scale_factor: int = 16) -> torch.Tensor:
    """``decode_fn`` ([B, F, H, Wt, C] latent tile → [B, T, H', Wt·sf, 3]
    pixels) over width tiles of ``latents`` [B, F, H, W, C]; returns
    [B, T, H', W·sf, 3] in the tiles' dtype. A latent narrower than two
    columns a tile decodes whole."""
    b, f, h, w, c = latents.shape
    lat_overlap = max(1, image_overlap_size // scale_factor)
    if w < n_tiles * 2:
        return decode_fn(latents)
    starts, ends, _ = _tile_bounds(w, n_tiles, lat_overlap)
    ov = lat_overlap * scale_factor
    out = weight = None
    for s, e in zip(starts, ends):
        tile = decode_fn(latents[:, :, :, s:e])
        if out is None:
            out = tile.new_zeros((b, tile.shape[1], tile.shape[2], w * scale_factor, 3))
            weight = torch.zeros((w * scale_factor,), dtype=torch.float32, device=tile.device)
        ps, pe = s * scale_factor, e * scale_factor
        # linear cross-fade ramps on the overlapped edges
        ramp = np.ones((pe - ps,), np.float32)
        if s > 0:
            ramp[:ov] = np.linspace(0.0, 1.0, ov, endpoint=False)
        if e < w:
            ramp[-ov:] = np.linspace(1.0, 0.0, ov, endpoint=False)
        r = torch.from_numpy(ramp).to(tile.device)
        out[:, :, :, ps:pe] += (tile[:, :, :, :pe - ps] * r[:, None]).to(out.dtype)
        weight[ps:pe] += r
        del tile
    return out / torch.clamp_min(weight, 1e-6)[:, None]
