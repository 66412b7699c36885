"""ctypes bindings for the native host data path (counterpart of
yume_tpu/data/native.py): ``native/yume_host.cpp`` (uint8 → [-1, 1], the
center-crop + bilinear resize) and ``native/yume_decode.cpp`` (the
libavcodec frame decoder, the reference's decord).

Both sources are compiled as they are with ``g++`` at first use, into
``<checkout>/build/yume_tpu_torch/`` under a name that hashes the source
and the flags; the ffmpeg flags come from ``pkg-config``, as
``native/Makefile`` takes them. Where a library cannot be built (no
compiler, or no ffmpeg development libraries for the decoder) its functions
report it: the host helpers compute the same in numpy/OpenCV, and
:func:`decode_frames` returns None so that the reader falls back to OpenCV.
:func:`decoder` says which reader decodes a video.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

from .._build import BUILD_DIR

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
FFMPEG_PACKAGES = ("libavformat", "libavcodec", "libswscale", "libavutil")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
# why a library is not built, by name (shown by :func:`decoder`)
why_not: Dict[str, str] = {}


def _pkg_config(*what: str) -> Optional[list]:
    if shutil.which("pkg-config") is None:
        return None
    r = subprocess.run(["pkg-config", *what, *FFMPEG_PACKAGES], capture_output=True,
                       text=True)
    return r.stdout.split() if r.returncode == 0 else None


def _compile(name: str, cflags=(), libs=()) -> str:
    """``lib<name>.so`` from ``native/<name>.cpp``, built once per source
    and flags; returns its path or raises with the compiler's message."""
    cxx = os.environ.get("CXX", "g++")
    src = os.path.join(NATIVE_DIR, f"{name}.cpp")
    flags = [*CXXFLAGS, *cflags]
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join([cxx, *flags, *libs]).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    if shutil.which(cxx) is None:
        raise RuntimeError(f"{cxx} not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *flags, "-o", tmp, src, *libs], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} failed: {r.stderr.strip()[-400:]}")
    os.replace(tmp, out)     # atomic: a concurrent build sees a whole file or none
    return out


def _load(name: str) -> Optional[ctypes.CDLL]:
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        try:
            if name == "yume_decode":
                cflags, libs = _pkg_config("--cflags"), _pkg_config("--libs")
                if not libs:
                    raise RuntimeError("pkg-config finds no ffmpeg development libraries")
                lib = _bind_decode(ctypes.CDLL(_compile(name, cflags, libs)))
            else:
                lib = _bind_host(ctypes.CDLL(_compile(name)))
        except (OSError, RuntimeError) as e:
            why_not[name] = str(e)
        _libs[name] = lib
        return lib


def _bind_host(lib):
    lib.u8_to_unit_range.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.u8_to_unit_range.restype = None
    lib.center_crop_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
    lib.center_crop_resize_batch.restype = None
    return lib


def _bind_decode(lib):
    lib.yd_open.argtypes = [ctypes.c_char_p]
    lib.yd_open.restype = ctypes.c_void_p
    for name in ("yd_width", "yd_height"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    lib.yd_frame_count.argtypes = [ctypes.c_void_p]
    lib.yd_frame_count.restype = ctypes.c_int64
    lib.yd_read_frames.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    lib.yd_read_frames.restype = ctypes.c_int
    lib.yd_close.argtypes = [ctypes.c_void_p]
    lib.yd_close.restype = None
    return lib


def have_native() -> bool:
    return _load("yume_host") is not None


def have_native_decode() -> bool:
    return _load("yume_decode") is not None


def decoder() -> str:
    """The video reader of this process: 'native' (libavcodec) or 'cv2'
    with the reason the native one is not built."""
    if have_native_decode():
        return "native"
    return f"cv2 ({why_not.get('yume_decode', 'not built')})"


def u8_to_unit_range(frames: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] → float32 in [-1, 1]."""
    lib = _load("yume_host")
    frames = np.ascontiguousarray(frames, np.uint8)
    if lib is None:
        return frames.astype(np.float32) / 127.5 - 1.0
    out = np.empty(frames.shape, np.float32)
    lib.u8_to_unit_range(frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         ctypes.c_int64(frames.size))
    return out


def center_crop_resize(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 [N, H, W, 3] → float32 [N, out_h, out_w, 3] in [-1, 1]
    (center-crop to the target aspect, then bilinear)."""
    lib = _load("yume_host")
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, _ = frames.shape
    if lib is None:
        import cv2

        target_ar = out_w / out_h
        crop_w, crop_h = w, h
        if w / h > target_ar:
            crop_w = round(h * target_ar)
        else:
            crop_h = round(w / target_ar)
        x0, y0 = (w - crop_w) // 2, (h - crop_h) // 2
        out = np.stack([cv2.resize(f[y0:y0 + crop_h, x0:x0 + crop_w], (out_w, out_h),
                                   interpolation=cv2.INTER_LINEAR) for f in frames])
        return out.astype(np.float32) / 127.5 - 1.0
    out = np.empty((n, out_h, out_w, 3), np.float32)
    lib.center_crop_resize_batch(frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 n, h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 out_h, out_w)
    return out


def decode_frames(path: str, indices, size=None) -> Optional[np.ndarray]:
    """Decode the frames ``indices`` (in any order, repeats allowed) →
    uint8 [N, H, W, 3] RGB, or None when the decoder is not built or cannot
    open the file. ``size`` = (height, width) scales during the decode
    (swscale's SWS_AREA, one pass)."""
    lib = _load("yume_decode")
    if lib is None:
        return None
    h = lib.yd_open(path.encode())
    if not h:
        return None
    try:
        want = sorted(set(int(i) for i in indices))
        arr = np.asarray(want, np.int64)
        out_h, out_w = size if size is not None else (lib.yd_height(h), lib.yd_width(h))
        buf = np.empty((len(want), out_h, out_w, 3), np.uint8)
        got = lib.yd_read_frames(h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                 len(want), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 out_h, out_w)
        if got != len(want):
            return None
        lut = {f: i for i, f in enumerate(want)}
        return buf[[lut[int(i)] for i in indices]]
    finally:
        lib.yd_close(h)


def video_frame_count(path: str) -> Optional[int]:
    """The container's recorded frame count, or None when unknown."""
    lib = _load("yume_decode")
    if lib is None:
        return None
    h = lib.yd_open(path.encode())
    if not h:
        return None
    try:
        n = lib.yd_frame_count(h)
        return int(n) if n > 0 else None
    finally:
        lib.yd_close(h)
