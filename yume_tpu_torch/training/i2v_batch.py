"""The 14B i2v/v2v training batch (counterpart of
yume_tpu/training/i2v_batch.py).

The host draws ``rand_num_img`` and picks the i2v branch (the first tail
frame repeated ``4·s0`` times before the tail) or the v2v branch (the clip's
own pixel history; reference fastvideo/distill_model.py:249-287). The VAE
encodes history and tail separately into the regression target, the
20-channel ``y`` is :meth:`I2VPipeline.make_conditioning` of the history
(wan/image2video.py:300-369), and CLIP embeds the last history frame.

Frame counts are in units of the VAE's temporal stride s0 (4 for Wan2.1,
giving the reference's 16, 33 and 4n+1), so the smoke configs with another
stride train through the same code.
"""

from __future__ import annotations

from typing import Optional

import torch


def trim_s0n1(f: int, s0: int = 4) -> int:
    """The largest s0·n + 1 ≤ f (reference distill_model.py:247-251 for
    s0 = 4)."""
    t = (f // s0) * s0 + 1
    return t - s0 if t > f else t


def takes_i2v_branch(f_px: int, rand_num_img: float, frame_zero: int, s0: int) -> bool:
    """Whether a clip of ``f_px`` frames makes an i2v batch: the host draw
    ``rand_num_img`` < 0.4, or a clip of exactly ``frame_zero`` frames after
    the s0·n + 1 trim, which has no history to split off (reference
    distill_model.py:262-272)."""
    return rand_num_img < 0.4 or trim_s0n1(f_px, s0) == frame_zero


@torch.no_grad()
def build_i2v_train_batch(pipe, video: torch.Tensor, ctx: torch.Tensor, *,
                          rand_num_img: float, frame_zero: Optional[int] = None,
                          first_frame_repeat: Optional[int] = None) -> dict:
    """One 14B training batch from pixel frames.

    pipe: an :class:`..pipelines.i2v.I2VPipeline` with its VAE and CLIP;
    video: [B, F_px, H, W, 3] in [-1, 1], trimmed to s0·n + 1 frames; ctx:
    the captions' umT5 context. ``rand_num_img`` < 0.4 picks the i2v branch;
    a clip of exactly ``frame_zero`` frames forces it and a shorter one
    raises. ``frame_zero`` (the tail in pixel frames) defaults to
    (latent_frame_zero − 1)·s0 + 1, ``first_frame_repeat`` to 4·s0.

    Returns ``latents`` [B, F_lat, h, w, z] (the history's first
    4(m − 1) + 1 of its s0·m frames and the tail, encoded apart, as the
    reference's chunked encoder reads them), ``y`` [B, F_lat, h, w, s0 + z],
    ``context`` and ``clip_context``."""
    s0 = pipe.config.vae.stride[0]
    if frame_zero is None:
        frame_zero = (pipe.config.latent_frame_zero - 1) * s0 + 1
    if first_frame_repeat is None:
        first_frame_repeat = 4 * s0
    video = video[:, : trim_s0n1(video.shape[1], s0)]
    f_px = video.shape[1]
    if f_px < frame_zero:
        raise ValueError(
            f"clip too short for i2v-14B training: {f_px} frames after the s0·n+1 trim "
            f"< frame_zero={frame_zero}; provide clips with at least {frame_zero} pixel "
            "frames")
    if takes_i2v_branch(f_px, rand_num_img, frame_zero, s0):
        tail = video[:, -frame_zero:]
        video = torch.cat([tail[:, :1].expand(-1, first_frame_repeat, -1, -1, -1), tail],
                          dim=1)
        f_px = video.shape[1]
    hist_px, tail_px = video[:, :-frame_zero], video[:, -frame_zero:]
    mh = hist_px.shape[1]
    assert mh % s0 == 0 and tail_px.shape[1] % s0 == 1, (mh, tail_px.shape)

    # the reference's torch.cat([vae.encode(hist), vae.encode(tail)])
    # (wan/image2video.py:287-289) reads only the first 4(m−1)+1 history frames
    latents = torch.cat([pipe.vae.encode(hist_px[:, : mh - (s0 - 1)]),
                         pipe.vae.encode(tail_px)], dim=1)
    pipe._cond_cache = None  # never resume a sampling-time streaming cache
    y = pipe.make_conditioning(hist_px, f_px, history_mode=True)
    batch = {"latents": latents, "y": y, "context": ctx}
    if pipe.clip is not None:
        # CLIP on the last history frame (wan/image2video.py:341-344)
        batch["clip_context"] = pipe.clip_features(hist_px[:, -1])
    return batch


def synthetic_i2v_batch(generator: torch.Generator, *, b: int, f: int, h: int, w: int,
                        z_dim: int, mask_ch: int, text_len: int, text_dim: int,
                        image_context_len: int = 0, image_dim: int = 1280) -> dict:
    """A random batch with the i2v structure (the trainer's synthetic
    mode), drawn from ``generator`` on its device."""
    dev = generator.device

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    batch = {"latents": randn(b, f, h, w, z_dim),
             "y": randn(b, f, h, w, mask_ch + z_dim),
             "context": randn(b, text_len, text_dim) * 0.02}
    if image_context_len:
        batch["clip_context"] = randn(b, image_context_len, image_dim) * 0.02
    return batch
