"""Differentiable augmentation for GAN training, DiffAugment (counterpart of
yume_tpu/data/diffaugment.py; the reference vendors it at
ADD/models/DiffAugment.py:35-121): color (brightness, saturation,
contrast), translation and cutout on channels-last [B, H, W, C] images.

The random draws are explicit (:func:`draw_augment` makes them from a
``torch.Generator``), so a test can hand the port the reference's numbers;
translation and cutout keep the reference's shape-static forms (a zero
border and a gather; a computed mask).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _rand_brightness(x, d):
    return x + (d["u"].to(x.dtype) - 0.5)


def _rand_saturation(x, d):
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) * (d["u"].to(x.dtype) * 2.0) + mean


def _rand_contrast(x, d):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (d["u"].to(x.dtype) + 0.5) + mean


def _translation_shift(h: int, w: int, ratio: float = 0.125) -> Tuple[int, int]:
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def _rand_translation(x, d):
    b, h, w, _ = x.shape
    tx, ty = d["tx"].to(x.device), d["ty"].to(x.device)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # a zero border
    gi = (torch.arange(h, device=x.device)[None, :] + tx[:, None] + 1).clamp(0, h + 1)
    gj = (torch.arange(w, device=x.device)[None, :] + ty[:, None] + 1).clamp(0, w + 1)
    bi = torch.arange(b, device=x.device)[:, None, None]
    return xp[bi, gi[:, :, None], gj[:, None, :]]


def _cutout_size(h: int, w: int, ratio: float = 0.5) -> Tuple[int, int]:
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def _rand_cutout(x, d):
    b, h, w, _ = x.shape
    ch, cw = _cutout_size(h, w)
    oy = d["oy"].to(x.device).reshape(b, 1, 1)
    ox = d["ox"].to(x.device).reshape(b, 1, 1)
    gy = torch.arange(h, device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    inside = ((gy >= oy - ch // 2) & (gy < oy + (ch + 1) // 2)
              & (gx >= ox - cw // 2) & (gx < ox + (cw + 1) // 2))
    return x * (1.0 - inside[..., None].to(x.dtype))


_POLICIES = {
    "color": (("brightness", _rand_brightness), ("saturation", _rand_saturation),
              ("contrast", _rand_contrast)),
    "translation": (("translation", _rand_translation),),
    "cutout": (("cutout", _rand_cutout),),
}


def draw_augment(generator: torch.Generator, shape: Tuple[int, ...],
                 policy: str = "color,translation,cutout") -> List[Dict[str, torch.Tensor]]:
    """The draws of :func:`diff_augment` for images of ``shape`` [B, H, W, C],
    one dict a transform in the policy's order: ``u`` U(0, 1) [B, 1, 1, 1]
    for the color transforms, the integer shifts ``tx`` ∈ [−sh, sh] and
    ``ty`` ∈ [−sw, sw] [B] for translation, the centres ``oy`` ∈ [0, H +
    1 − ch mod 2) and ``ox`` [B] for cutout."""
    b, h, w = shape[:3]
    dev = generator.device
    draws = []
    for name, _ in _transforms(policy):
        if name == "translation":
            sh, sw = _translation_shift(h, w)
            draws.append({"tx": torch.randint(-sh, sh + 1, (b,), generator=generator,
                                              device=dev),
                          "ty": torch.randint(-sw, sw + 1, (b,), generator=generator,
                                              device=dev)})
        elif name == "cutout":
            ch, cw = _cutout_size(h, w)
            draws.append({"oy": torch.randint(0, h + (1 - ch % 2), (b,), generator=generator,
                                              device=dev),
                          "ox": torch.randint(0, w + (1 - cw % 2), (b,), generator=generator,
                                              device=dev)})
        else:
            draws.append({"u": torch.rand((b, 1, 1, 1), generator=generator, device=dev)})
    return draws


def _transforms(policy: str):
    return [t for p in policy.split(",") if p.strip() for t in _POLICIES[p.strip()]]


def diff_augment(x: torch.Tensor, draws: List[Dict[str, torch.Tensor]],
                 policy: str = "color,translation,cutout") -> torch.Tensor:
    """Apply the comma-separated augmentation ``policy`` to [B, H, W, C]
    images with ``draws`` (:func:`draw_augment`'s, one a transform)."""
    transforms = _transforms(policy)
    if len(draws) != len(transforms):
        raise ValueError(f"{len(draws)} draws for {len(transforms)} transforms")
    for (_, fn), d in zip(transforms, draws):
        x = fn(x, d)
    return x
