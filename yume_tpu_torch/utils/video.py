"""Video and image files (the port's copy of yume_tpu/utils/video.py): mp4
export through imageio or OpenCV with retries, an ``.npy`` fallback when
neither writes, and PIL for images."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def to_uint8(video: np.ndarray) -> np.ndarray:
    """[T, H, W, 3] in [-1, 1] → uint8."""
    v = np.clip(np.asarray(video, np.float32), -1.0, 1.0)
    return ((v + 1.0) * 127.5).astype(np.uint8)


def save_video(video: np.ndarray, path: str, fps: int = 16, retry: int = 3) -> str:
    """Write [T, H, W, 3] in [-1, 1] as an mp4 (imageio, else OpenCV). When
    neither can write, the frames go to ``path + '.npy'`` (uint8) so no
    result is lost, and a line says so. Returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = to_uint8(video)

    def _imageio():
        import imageio

        writer = imageio.get_writer(path, fps=fps, codec="libx264", quality=8)
        for f in frames:
            writer.append_data(f)
        writer.close()

    def _cv2():
        import cv2

        h, w = frames.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not vw.isOpened():
            raise IOError("cv2.VideoWriter failed to open")
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()

    last = None
    for _ in range(retry):
        for backend in (_imageio, _cv2):
            try:
                backend()
                return path
            except Exception as e:  # noqa: any writer failure falls through to the next
                last = e
    np.save(path + ".npy", frames)
    print(f"save_video failed ({last}); wrote {path}.npy")
    return path + ".npy"


def save_image(img: np.ndarray, path: str) -> Optional[str]:
    """Write [H, W, 3] in [-1, 1] as an image file (PIL)."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(to_uint8(img[None])[0]).save(path)
    return path


def load_image(path, size=None) -> np.ndarray:
    """An image file (a path or a binary file object) → [H, W, 3] float32 in
    [-1, 1]; ``size`` (H, W) resizes with Lanczos."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.LANCZOS)
    return np.asarray(img, np.float32) / 127.5 - 1.0
