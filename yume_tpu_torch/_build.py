"""Build and load the port's CUDA C++ kernels.

``csrc/*.cu`` (and the header they share, ``csrc/hopper.cuh``) compile
with ``nvcc`` into one shared library with a plain C interface, which
:func:`library` loads with ``ctypes``: one ``nvcc -c`` per source, all
started together, then one link. No PyTorch header is included, so a build
takes seconds rather than the minutes ``torch.utils.cpp_extension`` needs.
The library lands under ``<checkout>/build/yume_tpu_torch/``, named by a
hash of the sources, headers and flags, so an edited source or header
rebuilds and an unchanged one is reused.

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
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

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
    # q, k, v, dout, lse, delta, kv_len, dq, B, Lq, Lk, N, D,
    # q/k/v/dout/dq strides (b, l, n), scale, stream
    "yume_flash_attention_bwd_dq": [_VOID] * 8 + [_INT] * 5 + [_I64] * 15
                                   + [_FLOAT, _VOID],
    # q, k, v, dout, lse, delta, kv_len, dk, dv, B, Lq, Lk, N, D,
    # q/k/v/dout/dk/dv strides (b, l, n), scale, stream
    "yume_flash_attention_bwd_dkv": [_VOID] * 9 + [_INT] * 5 + [_I64] * 18
                                    + [_FLOAT, _VOID],
    # x, qw, w_scale, a_scale, xq (scratch), out, M, N, K, x row stride, stream
    "yume_q8_matmul": [_VOID] * 6 + [_INT] * 3 + [_I64, _VOID],
    # x, a_scale, xq, M, K, x row stride, stream
    "yume_q8_quantize": [_VOID] * 3 + [_INT] * 2 + [_I64, _VOID],
    # x, b (or null), y, n, C, inner, dtype, act, alpha, gain, clamp, stream
    "yume_bias_act": [_VOID] * 3 + [_I64] * 3 + [_INT] * 2 + [_FLOAT] * 3 + [_VOID],
    # x, idx (or null), scale, shift, out, B, L, D, K, table batch stride,
    # x dtype, out dtype, eps, gate, stream
    "yume_adaln_norm": [_VOID] * 5 + [_INT] * 4 + [_I64] + [_INT] * 2 + [_FLOAT] * 2 + [_VOID],
    # q, k, w_q, w_k, cos, sin, oq, ok, B, L, D, half, q strides (b, l),
    # k strides (b, l), table batch stride, dtype, eps, stream
    "yume_qk_norm_rope": [_VOID] * 8 + [_INT] * 4 + [_I64] * 5 + [_INT, _FLOAT, _VOID],
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
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_sources() + glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(procs):
    """Wait for every (cmd, Popen); raise with the output of the first that
    failed. Returns the compiler output of all of them."""
    logs, failed = [], None
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(f"{' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{logs[-1]}"
    if failed:
        raise RuntimeError(failed)
    return "\n".join(logs)


def build() -> str:
    """Compile csrc/ if no library for the current sources exists; returns
    the library's path. The compiler's output (``-Xptxas -v``: registers,
    shared memory and spills of each kernel) is kept beside the library as
    ``<library>.log``."""
    digest = _digest()
    out = os.path.join(BUILD_DIR, f"libyume_kernels_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    nvcc = nvcc_path()
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    log = _run(procs)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", tmp, *objs]
    log += "\n" + _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        os.remove(obj)
    with open(f"{out}.log", "w") as f:
        f.write(log)
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
