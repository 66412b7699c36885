"""Camera-trajectory metrics appended to captions (the port's copy of the
trajectory functions of yume_tpu/data/camera.py, pinned equal to them by
``tests/test_torch_configs.py``): speed, turn rate and rotation rate of a
c2w sequence (reference fastvideo/sample/sample.py:63-190), and the
per-pixel Plücker ray embedding (reference sample.py:443-487).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def traj_position_change(cam_c2w: np.ndarray, stride: int = 1):
    """(reference sample.py:63-85)"""
    pos = cam_c2w[:, :3, 3]
    coords, angles = [], []
    for i in range(0, len(pos) - 2 * stride):
        v1 = pos[i + stride] - pos[i]
        v2 = pos[i + 2 * stride] - pos[i + stride]
        n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
        if n1 < 1e-6 or n2 < 1e-6:
            continue
        cos = np.clip(np.dot(v1, v2) / (n1 * n2), -1.0, 1.0)
        coords.append(v1)
        angles.append(np.degrees(np.arccos(cos)))
    return coords, angles


def traj_rotation_change(cam_c2w: np.ndarray, stride: int = 1):
    """(reference sample.py:87-105)"""
    rots = cam_c2w[:, :3, :3]
    out = []
    for i in range(0, len(rots) - stride):
        z1, z2 = rots[i][:, 2], rots[i + stride][:, 2]
        n1, n2 = np.linalg.norm(z1), np.linalg.norm(z2)
        if n1 < 1e-6 or n2 < 1e-6:
            continue
        cos = np.clip(np.dot(z1, z2) / (n1 * n2), -1.0, 1.0)
        out.append(np.degrees(np.arccos(cos)))
    return out


def normalize_c2w_matrices(t_list: np.ndarray) -> np.ndarray:
    """Align to frame 0 + OpenGL→Open3D axes (reference sample.py:129-146)."""
    t0_inv = np.linalg.inv(t_list[0])
    conv = np.diag([1.0, -1.0, -1.0, 1.0])
    return np.array([conv @ (t0_inv @ t) for t in t_list])


def metrics_in_range(
    data: np.ndarray, start_frame: int, end_frame: int,
    stride: int = 1, fps: int = 30,
) -> Tuple[float, float, float]:
    """(avg speed m/s, avg direction-change deg, avg rotation deg) over a
    frame window (reference calculate_metrics_in_range, sample.py:148-190)."""
    coords, angles = traj_position_change(data, stride)
    rots = traj_rotation_change(data, stride)
    coords = [v for i, v in enumerate(coords) if start_frame <= i < end_frame - 2 * stride]
    angles = [a for i, a in enumerate(angles) if start_frame <= i < end_frame - 2 * stride]
    rots = [a for i, a in enumerate(rots) if start_frame <= i < end_frame - stride]
    dt = stride / fps
    avg_speed = float(np.mean([np.linalg.norm(v) / dt for v in coords])) if coords else 0.0
    avg_angle = float(np.mean(angles)) if angles else 0.0
    avg_rot = float(np.mean(rots)) if rots else 0.0
    return avg_speed, avg_angle, avg_rot


def metrics_caption(avg_speed: float, avg_angle: float, avg_rot: float) -> str:
    """(reference t2v_datasets.py:428-432)"""
    return (
        f"Actual distance moved:{avg_speed * 100} at 100 meters per second."
        f"Angular change rate (turn speed):{avg_angle}."
        f"View rotation speed:{avg_rot}."
    )


def plucker_rays(K: np.ndarray, c2w: np.ndarray, H: int, W: int,
                 flip_x: np.ndarray | None = None) -> np.ndarray:
    """Per-pixel Plücker ray embedding [B, V, H, W, 6].

    Equivalent of the reference's `ray_condition`
    (fastvideo/sample/sample.py:443-487): pixel centers are unprojected with
    intrinsics K = [B, V, (fx, fy, cx, cy)], rotated into world space by the
    c2w [B, V, 4, 4] poses, and encoded as (o × d, d).

    Args:
        flip_x: optional [V] bool — mirror the x sampling for those views.
    """
    b, v = K.shape[:2]
    j, i = np.meshgrid(np.arange(H, dtype=np.float64),
                       np.arange(W, dtype=np.float64), indexing="ij")
    i = np.broadcast_to(i.reshape(1, 1, H * W), (b, v, H * W)) + 0.5
    j = np.broadcast_to(j.reshape(1, 1, H * W), (b, v, H * W)) + 0.5
    if flip_x is not None and np.any(flip_x):
        i_flip = np.flip(np.arange(W, dtype=np.float64)) + 0.5
        i_flip = np.broadcast_to(
            np.tile(i_flip, H).reshape(1, 1, H * W), (b, 1, H * W))
        i = i.copy()
        i[:, np.asarray(flip_x, bool)] = i_flip
    fx, fy, cx, cy = [K[..., k:k + 1] for k in range(4)]  # [B,V,1]
    zs = np.ones_like(i)
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    d = np.stack([xs, ys, zs], axis=-1)                       # [B,V,HW,3]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays_d = d @ np.swapaxes(c2w[..., :3, :3], -1, -2)        # world dirs
    rays_o = np.broadcast_to(c2w[..., None, :3, 3], rays_d.shape)
    dxo = np.cross(rays_o, rays_d)
    return np.concatenate([dxo, rays_d], axis=-1).reshape(b, v, H, W, 6)
