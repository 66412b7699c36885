"""Build and load the port's CUDA C++ kernels.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain C
interface, which :func:`library` loads with ``ctypes``. No PyTorch header is
included, so a build takes seconds rather than the minutes
``torch.utils.cpp_extension`` needs. The library lands under
``<checkout>/build/yume_tpu_torch/``, named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is reused.

Nothing is built at import time: the first kernel launch calls
:func:`library`. Pointers and the stream are passed as ``ctypes.c_void_p``;
every C entry point returns ``cudaGetLastError()`` and :func:`check` raises
when it is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "yume_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong
_FLOAT = ctypes.c_float

# C signatures of the entry points in csrc/ (restype int = cudaError_t)
_SIGNATURES = {
    # q, k, v, out, lse, kv_len, B, Lq, Lk, N, D,
    # q strides (b, l, n), k strides, v strides, out strides, scale, stream
    "yume_flash_attention_fwd": [_VOID] * 6 + [_INT] * 5 + [_I64] * 12
                                + [_FLOAT, _VOID],
}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/ if no library for the current sources exists; returns
    the library's path."""
    out = os.path.join(BUILD_DIR, f"libyume_kernels_{_digest()}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.yume_error_string.argtypes = [_INT]
    lib.yume_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().yume_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
