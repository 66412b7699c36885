"""PyTorch port ops against the JAX reference on the CPU: RoPE, attention,
and the plain versions of the fused glue kernels; plus the port's
packaging guards (neither the port nor chip_smoke.py imports jax or the
JAX package, no CPU fallback in chip_smoke.py, no library attention or
torch.compile).

Inputs are numpy arrays from a seed, fp32. Tolerances (1e-5 max-abs) cover
the different order of float32 sums in XLA:CPU and ATen; the RoPE tables
are host numpy on both sides and must match exactly.
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close
from yume_tpu.ops import attention as jattn
from yume_tpu.ops import fused_adaln as jfused
from yume_tpu.ops import rope as jrope
from yume_tpu_torch.ops import attention as tattn
from yume_tpu_torch.ops import fused_adaln as tfused
from yume_tpu_torch.ops import rope as trope

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5  # fp32 sum order differs between XLA:CPU and ATen


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid,offset", [((3, 4, 5), 0), ((2, 3, 3), 7)])
def test_grid_rope_tables_equal(grid, offset):
    want = jrope.grid_rope(*grid, 128, f_offset=offset)
    got = trope.grid_rope(*grid, 128, f_offset=offset)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_framepack_rope_tables_equal():
    grids = [(1, 2, 3), (4, 1, 2), (2, 4, 6)]
    for g, w in zip(trope.framepack_rope(grids, 48), jrope.framepack_rope(grids, 48)):
        np.testing.assert_array_equal(g, w)
    assert trope.axis_dims(128) == jrope.axis_dims(128)


@pytest.mark.parametrize("batched_tables", [False, True])
def test_apply_rope_matches_jax(rng_np, batched_tables):
    x = rng_np.standard_normal((2, 12, 3, 16)).astype(np.float32)
    cos, sin = trope.grid_rope(2, 2, 3, 16)
    if batched_tables:
        cos = np.stack([cos, cos[::-1]])
        sin = np.stack([sin, sin[::-1]])
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(cos)),
                           torch.from_numpy(np.ascontiguousarray(sin)))
    assert_close(got, want, TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_len", [None, (5, 9)])
def test_plain_attention_matches_xla(rng_np, kv_len):
    q = rng_np.standard_normal((2, 7, 3, 16)).astype(np.float32)
    k = rng_np.standard_normal((2, 9, 3, 16)).astype(np.float32)
    v = rng_np.standard_normal((2, 9, 3, 16)).astype(np.float32)
    jl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    want = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=jl)
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), kv_len=tl)
    assert_close(got, want, TOL)


def test_plain_attention_lse(rng_np):
    q = torch.from_numpy(rng_np.standard_normal((1, 5, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng_np.standard_normal((1, 6, 2, 8)).astype(np.float32))
    out, lse = tattn.plain_attention(q, k, k, kv_len=torch.tensor([4]), return_lse=True)
    s = torch.einsum("bqnd,bknd->bnqk", q, k)[..., :4] * 8 ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=TOL, rtol=0)
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# fused glue (plain versions on CPU)
# ---------------------------------------------------------------------------


def _glue_inputs(rng_np, b=2, l=10, d=64, k=2):
    x = rng_np.standard_normal((b, l, d)).astype(np.float32) * 2 + 0.5
    y = rng_np.standard_normal((b, l, d)).astype(np.float32)
    s = rng_np.standard_normal((b, k, d)).astype(np.float32) * 0.1
    t = rng_np.standard_normal((b, k, d)).astype(np.float32) * 0.1
    idx = rng_np.integers(0, k, (b, l)).astype(np.int32)
    return x, y, s, t, idx


# tolerance of each K2 mode: fp32 modes TOL; bf16 and fp16 outputs one ulp
# of the largest |out| in their dtype (ULP_REL); the mean-100 rows 1e-4, as
# an x of ~100 carries ~8e-6 of rounding into the fp32 mean, whose order of
# summation differs, while a one-pass E[x^2] - mu^2 would be ~1e-3 off
ADALN_TOL = {"adaln": TOL, "affine": TOL, "fp32_out": TOL, "broadcast": TOL,
             "mean100": 1e-4}


@pytest.mark.parametrize("mode", ["adaln", "affine", "fp32_out", "broadcast", "mean100",
                                  "bf16", "fp16"])
def test_adaln_norm_matches_jax(rng_np, mode):
    """K2's plain version against JAX's adaln_norm: the AdaLN form with
    per-batch tables and idx; norm3's affine LayerNorm (gate 0, no idx,
    K = 1); the Head's bf16 in, fp32 out; a [1, K, D] table broadcast over
    B = 2; rows of mean 100 and unit spread (which pin the two-pass
    variance); bf16 in and out (the headline's dtype); fp16 in and out."""
    x, _, s, t, idx = _glue_inputs(rng_np)
    if mode == "mean100":
        x = x - x.mean(-1, keepdims=True) + 100.0
    if mode == "broadcast":
        s, t = s[:1], t[:1]
    dtype = {"fp32_out": "bfloat16", "bf16": "bfloat16", "fp16": "float16"}.get(mode, "float32")
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    if mode == "affine":  # norm3: gate 0, no idx, K = 1
        s1, t1 = s[:1, :1] + 1.0, t[:1, :1]
        want = jfused.adaln_norm(jx, jnp.asarray(s1), jnp.asarray(t1), None, gate=0.0)
        got = tfused.adaln_norm(tx, torch.from_numpy(s1), torch.from_numpy(t1), None,
                                gate=0.0)
    else:
        od = jnp.float32 if mode == "fp32_out" else None
        tod = torch.float32 if mode == "fp32_out" else None
        want = jfused.adaln_norm(jx, jnp.asarray(s), jnp.asarray(t), jnp.asarray(idx),
                                 out_dtype=od)
        got = tfused.adaln_norm(tx, torch.from_numpy(s), torch.from_numpy(t),
                                torch.from_numpy(idx), out_dtype=tod)
    assert got.dtype == (torch.float32 if mode == "fp32_out" else tx.dtype)
    assert got.shape == tx.shape
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = ADALN_TOL.get(mode) or ULP_REL[dtype] * np.abs(want).max()
    assert_close(got, want, tol)


def test_adaln_residual_matches_jax(rng_np):
    x, y, s, _, idx = _glue_inputs(rng_np)
    want = jfused.adaln_residual(jnp.asarray(x), jnp.asarray(y), jnp.asarray(s),
                                 jnp.asarray(idx))
    got = tfused.adaln_residual(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(s), torch.from_numpy(idx))
    assert_close(got, want, TOL)


def test_rms_norm_matches_jax(rng_np):
    x, _, s, _, _ = _glue_inputs(rng_np)
    w = 1.0 + s[0, 0]
    want = jfused.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-6)
    got = tfused.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6)
    assert_close(got, want, TOL)


# one ulp of the largest |out| in the output dtype: the fp32 sums of XLA
# and ATen differ in order, which may move a rounding by one ulp
ULP_REL = {"float32": TOL, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [33, 64, 3072])
def test_rms_norm_dtypes_and_widths_match_jax(rng_np, dtype, d):
    """K5's contract on the plain path: any D (odd included, as K5's own
    kernel takes it), the output shape and dtype of x, fp32 math."""
    x = rng_np.standard_normal((2, 5, d)).astype(np.float32) * 2 + 0.5
    w = 1.0 + 0.1 * rng_np.standard_normal(d).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = jfused.rms_norm(jx, jnp.asarray(w), eps=1e-6)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tfused.rms_norm(tx, torch.from_numpy(w), eps=1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want = np.asarray(want.astype(jnp.float32))
    tol = ULP_REL[dtype] * (np.abs(want).max() if dtype != "float32" else 1.0)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_rms_norm_tile_wastes_no_lane_at_model_widths():
    """K5's kernel walks D in chunks of at most 1,024 columns with 16-byte
    loads: at the 5B and 14B widths every chunk is full."""
    for d in (3072, 5120):
        chunk, warps = tfused._rms_tile(d)
        assert chunk == 1024 and d % chunk == 0
        assert tfused._RMS_ROWS * chunk == warps * 32 * 8  # 8 bf16 a thread
    assert tfused._rms_tile(33)[0] == 64  # a narrow row: one masked chunk


def test_rms_norm_launch_refuses_host_tensors(rng_np):
    x = torch.from_numpy(rng_np.standard_normal((1, 3, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        tfused._rms_norm_launch(x, torch.ones(64), 1e-6)


def test_adaln_norm_launch_refuses_host_tensors(rng_np):
    """K2's launch path has no CPU fallback: a host tensor raises before
    the library is built."""
    x = torch.from_numpy(rng_np.standard_normal((1, 3, 64)).astype(np.float32))
    tab = torch.zeros((1, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfused._adaln_norm_launch(x, tab, tab, None, 1e-6, 1.0, torch.float32)


@pytest.mark.parametrize("layout", ["contiguous", "qkv_views"])
def test_qk_norm_rope_matches_jax(rng_np, layout):
    """K4's plain version against JAX's qk_norm_rope: contiguous q and k
    with [L, D/2] tables; and q and k as the first two column blocks of a
    fused [B, L, 3·D] qkv projection (the W8A8 block's split views, rows
    strided) with per-sample [B, L, D/2] tables."""
    x, y, s, t, _ = _glue_inputs(rng_np, l=12)
    wq, wk = 1.0 + s[0, 0], 1.0 + t[0, 0]
    cos, sin = trope.grid_rope(2, 2, 3, 16)
    tq, tk = torch.from_numpy(x), torch.from_numpy(y)
    if layout == "qkv_views":
        qkv = rng_np.standard_normal((2, 12, 3 * 64)).astype(np.float32) * 2 + 0.5
        tq, tk, _ = torch.from_numpy(qkv).split(64, -1)
        assert not tq.is_contiguous() and tq.stride(1) == 3 * 64
        x, y = tq.numpy(), tk.numpy()
        shifted = trope.grid_rope(2, 2, 3, 16, f_offset=5)
        cos, sin = np.stack([cos, shifted[0]]), np.stack([sin, shifted[1]])
    want = jfused.qk_norm_rope(jnp.asarray(x), jnp.asarray(y), jnp.asarray(wq),
                               jnp.asarray(wk), jnp.asarray(cos), jnp.asarray(sin), 4,
                               eps=1e-6)
    got = tfused.qk_norm_rope(tq, tk, torch.from_numpy(wq), torch.from_numpy(wk),
                              torch.from_numpy(cos), torch.from_numpy(sin), 4, eps=1e-6)
    for g, w in zip(got, want):
        assert_close(g, w, TOL)


def test_cpu_path_launches_no_kernel(rng_np):
    x, y, s, _, idx = _glue_inputs(rng_np)
    before = tfused.adaln_residual.launches
    tfused.adaln_residual(torch.from_numpy(x), torch.from_numpy(y),
                          torch.from_numpy(s), torch.from_numpy(idx))
    assert tfused.adaln_residual.launches == before


# ---------------------------------------------------------------------------
# packaging guards
# ---------------------------------------------------------------------------


def _port_modules():
    pkg = REPO / "yume_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py"))


def _chip_smoke_imports():
    """Every import statement of chip_smoke.py, at module level or in a
    phase, as source."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    return sorted({ast.unparse(node) for node in ast.walk(tree)
                   if isinstance(node, (ast.Import, ast.ImportFrom))
                   and getattr(node, "module", None) != "__future__"})


def test_port_imports_no_jax():
    mods = _port_modules()
    for m in ("yume_tpu_torch.pipelines.ti2v", "yume_tpu_torch.train",
              "yume_tpu_torch.training.train_step", "yume_tpu_torch.training.optim",
              "yume_tpu_torch.training.lora", "yume_tpu_torch.utils.checkpoint",
              "yume_tpu_torch.sample", "yume_tpu_torch.serving.webapp",
              "yume_tpu_torch.pipelines.tiled_decode", "yume_tpu_torch.utils.offload",
              "yume_tpu_torch.utils.video", "yume_tpu_torch.data.controls",
              "yume_tpu_torch.models.clip", "yume_tpu_torch.pipelines.i2v",
              "yume_tpu_torch.data.camera", "yume_tpu_torch.data.native",
              "yume_tpu_torch.data.dataset", "yume_tpu_torch.data.transforms",
              "yume_tpu_torch.data.loader", "yume_tpu_torch.data.latent_dataset",
              "yume_tpu_torch.data.preprocess", "yume_tpu_torch.models.quantized",
              "yume_tpu_torch.training.i2v_batch", "yume_tpu_torch.training.distill",
              "yume_tpu_torch.diffusion.integrators",
              "yume_tpu_torch.diffusion.distill_schedule", "yume_tpu_torch.utils.stats",
              "yume_tpu_torch.data.diffaugment"):
        assert m in mods, m
    smoke = _chip_smoke_imports()
    assert "from yume_tpu_torch.ops import quant_matmul as qm" in smoke
    assert "from yume_tpu_torch import train" in smoke
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            # the native data path builds from native/*.cpp at first use
            "from yume_tpu_torch.data import native\n"
            "native.have_native(); native.decoder()\n"
            + "".join(f"{stmt}\n" for stmt in smoke) +
            "bad = sorted(k for k in sys.modules\n"
            "             if k.startswith('jax') or k.split('.')[0] == 'yume_tpu')\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_has_no_cpu_fallback(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_port_uses_no_library_attention_or_compile():
    banned = ("scaled_dot_product_attention", "torch.compile")
    for path in (REPO / "yume_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh"):
            text = path.read_text()
            for word in banned:
                assert word not in text, f"{path} names {word}"
