#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. device: the card's name and power limit from nvidia-smi, torch and CUDA
   versions;
2. build: compile the CUDA kernels from yume_tpu_torch/csrc;
3. kernels: every hand-written kernel of the main path (flash attention K1,
   adaln_norm K2, adaln_residual K3, the RMSNorm/RoPE kernel K4+K5) against
   its plain PyTorch version on the same seeded bf16 inputs at the 5B
   segment's shapes: max-abs error against a stated tolerance, and median
   times of both;
4. reference: a 2-layer full-width DiT on the card (kernels, bf16) against
   the same weights on the CPU (plain versions, fp32) at a small input;
5. pipeline: a full-width Yume-5B TI2VPipeline with random bf16 weights,
   two captions through the offline tokenizer and umT5-XXL, then
   ``generate_long`` (Euler, 4 steps) from a seeded 31-frame history at
   the 44×80 latent grid; each tail video must be finite
   [1, 29, 704, 1280, 3]. Every kernel must have launched during this run.

The second-to-last line is a JSON object of per-kernel results; the last is
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a CUDA
device the script exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

# the streaming decode allocates tensors of many sizes; avoid fragmentation
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
L, N, D, DIM = 12095, 24, 128, 3072   # 5B segment: tokens, heads, head dim, width
TEXT_LEN = 512
K1_TOL = 2e-2            # bf16 kernel vs fp32 plain, N(0, 1) inputs
GLUE_REL_TOL = 2.0 ** -7  # one bf16 ulp of the output magnitude
DIT_REL_TOL = 3e-2       # 2 bf16 layers vs fp32, relative L2
CAPTIONS = ["The camera moves forward along a sunlit forest path.",
            "The camera turns left toward a river and keeps walking."]


def log(msg: str):
    print(msg, flush=True)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def require(ok: bool, what: str):
    """Fail the run (exit code 1, no result line) unless ``ok``."""
    if not ok:
        raise SystemExit(f"chip_smoke: {what}")


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return smi


def build_phase():
    from yume_tpu_torch import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {os.path.relpath(_build.build(), REPO)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")


def kernel_phase(results: dict):
    """Each kernel against its plain version at the main path's shapes."""
    from yume_tpu_torch.models import dit as tdit
    from yume_tpu_torch.ops import fused_adaln as fa
    from yume_tpu_torch.ops import rope
    from yume_tpu_torch.ops.flash_attention import flash_attention, plain_attention

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
        return (x * scale).to(dtype)

    def record(kernel, case, err, tol, ms, plain_ms):
        ok = err <= tol
        log(f"  {kernel:<14} {case:<24} max_abs_err {err:.3e}  tol {tol:.3e}  "
            f"kernel {ms:9.3f} ms  plain {plain_ms:9.3f} ms  {'ok' if ok else 'FAIL'}")
        r = results[kernel]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        r.setdefault("ms", ms)          # the first case is the headline shape
        r.setdefault("plain_ms", plain_ms)
        require(ok, f"{kernel} {case}: error {err} exceeds {tol}")

    # K1 flash attention --------------------------------------------------
    q, k, v = randn(1, L, N, D), randn(1, L, N, D), randn(1, L, N, D)
    hs = 4  # the fp32 plain version at L = 12,095 fits only a few heads at a time
    out = flash_attention(q, k, v)
    err = max_err(out[:, :, :hs], plain_attention(q[:, :, :hs], k[:, :, :hs], v[:, :, :hs]))

    def plain_self():
        for h in range(0, N, hs):
            plain_attention(q[:, :, h:h + hs], k[:, :, h:h + hs], v[:, :, h:h + hs])

    record("flash_attention", "self [1,12095,24,128]", err, K1_TOL,
           median_ms(lambda: flash_attention(q, k, v), reps=5), median_ms(plain_self, reps=3))
    kc, vc = randn(1, TEXT_LEN, N, D), randn(1, TEXT_LEN, N, D)
    err = max_err(flash_attention(q, kc, vc), plain_attention(q, kc, vc))
    record("flash_attention", "cross Lk=512", err, K1_TOL,
           median_ms(lambda: flash_attention(q, kc, vc)),
           median_ms(lambda: plain_attention(q, kc, vc)))
    kv_len = torch.tensor([300], dtype=torch.int32, device="cuda")
    err = max_err(flash_attention(q, kc, vc, kv_len=kv_len),
                  plain_attention(q, kc, vc, kv_len=kv_len))
    record("flash_attention", "cross kv_len=300<512", err, K1_TOL,
           median_ms(lambda: flash_attention(q, kc, vc, kv_len=kv_len)),
           median_ms(lambda: plain_attention(q, kc, vc, kv_len=kv_len)))
    del q, k, v, kc, vc, out

    # K2 adaln_norm, K3 adaln_residual -------------------------------------
    x, y = randn(1, L, DIM), randn(1, L, DIM)
    s_tab = randn(1, 2, DIM, dtype=torch.float32, scale=0.1)
    t_tab = randn(1, 2, DIM, dtype=torch.float32, scale=0.1)
    l_hist = 5055
    idx = (torch.arange(L, device="cuda") >= l_hist).to(torch.int32)[None]
    w1 = 1.0 + randn(1, 1, DIM, dtype=torch.float32, scale=0.1)
    b1 = randn(1, 1, DIM, dtype=torch.float32, scale=0.1)
    glue = [
        ("adaln_norm", "AdaLN gate=1 bf16 out",
         lambda: fa.adaln_norm(x, s_tab, t_tab, idx),
         lambda: fa._adaln_norm_ref(x, s_tab, t_tab, idx, 1e-6, 1.0, torch.bfloat16)),
        ("adaln_norm", "norm3 gate=0 K=1",
         lambda: fa.adaln_norm(x, w1, b1, None, gate=0.0),
         lambda: fa._adaln_norm_ref(x, w1, b1, None, 1e-6, 0.0, torch.bfloat16)),
        ("adaln_norm", "head fp32 out",
         lambda: fa.adaln_norm(x, s_tab, t_tab, idx, out_dtype=torch.float32),
         lambda: fa._adaln_norm_ref(x, s_tab, t_tab, idx, 1e-6, 1.0, torch.float32)),
        ("adaln_residual", "residual bf16",
         lambda: fa.adaln_residual(x, y, s_tab, idx),
         lambda: fa._adaln_residual_ref(x, y, s_tab, idx)),
    ]
    plan = tdit.framepack_plan(31)
    grids = tdit.packed_grids(plan, 44, 80, (1, 2, 2)) + [(8, 22, 40)]
    cos, sin = (torch.from_numpy(t).cuda() for t in rope.framepack_rope(grids, D))
    require(cos.shape == (L, D // 2), f"RoPE tables {tuple(cos.shape)}")
    wq = 1.0 + randn(DIM, dtype=torch.float32, scale=0.1)
    wk = 1.0 + randn(DIM, dtype=torch.float32, scale=0.1)
    glue += [
        ("qk_norm_rope", "q and k, RoPE on (K4)",
         lambda: torch.cat(fa.qk_norm_rope(x, y, wq, wk, cos, sin, N, eps=1e-6)),
         lambda: torch.cat(fa._qk_norm_rope_ref(x, y, wq, wk, cos, sin, N, 1e-6))),
        ("rms_norm", "cross q, RoPE off (K5)",
         lambda: fa.rms_norm(x, wq, eps=1e-6),
         lambda: fa._rms_ref(x, wq, 1e-6)),
    ]
    for kernel, case, run, plain in glue:
        want = plain()
        record(kernel, case, max_err(run(), want),
               GLUE_REL_TOL * want.float().abs().max().item(),
               median_ms(run, reps=20), median_ms(plain, reps=20))


def reference_phase():
    """A 2-layer full-width DiT: kernels in bf16 on the card against the
    plain versions in fp32 on the CPU, same weights, small input."""
    from yume_tpu.configs import ti2v_5b
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.pipelines.ti2v import _random_init_
    from yume_tpu_torch.utils.convert import load_state_dict

    cfg = dataclasses.replace(ti2v_5b().dit, num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    card = WanDiT(cfg, torch.bfloat16, device="meta", param_dtype=torch.bfloat16)
    card = card.to_empty(device="cuda")
    _random_init_(card, gen)
    host = WanDiT(cfg, torch.float32, device="meta").to_empty(device="cpu")
    load_state_dict(host, {k: v.float().cpu() for k, v in card.state_dict().items()})

    x = torch.randn((1, 3 + 8, 16, 16, cfg.in_dim), generator=gen, device="cuda")
    x = x.to(torch.bfloat16)
    t = torch.cat([torch.zeros(1, 3), torch.full((1, 8), 700.0)], 1).cuda()
    ctx = torch.randn((1, TEXT_LEN, cfg.text_dim), generator=gen, device="cuda")
    with torch.no_grad():
        got = card(x, t, ctx).float().cpu()
        want = host(x.float().cpu(), t.cpu(), ctx.cpu())
    rel = ((got - want).norm() / want.norm()).item()
    ok = torch.isfinite(got).all().item() and rel <= DIT_REL_TOL
    log(f"reference: 2-layer DiT card(bf16, kernels) vs cpu(fp32, plain): "
        f"relative L2 {rel:.3e}  tol {DIT_REL_TOL:.1e}  {'ok' if ok else 'FAIL'}")
    require(ok, "reference check failed")


def pipeline_phase(counters) -> dict:
    from yume_tpu.configs import ti2v_5b
    from yume_tpu.data.tokenizer import Tokenizer
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline

    cfg = ti2v_5b()
    t0 = time.perf_counter()
    pipe = TI2VPipeline.from_config(cfg, device="cuda", seed=0, init_t5=True)
    torch.cuda.synchronize()
    n_dit = sum(p.numel() for p in pipe.dit.parameters())
    n_t5 = sum(p.numel() for p in pipe.t5.parameters())
    n_vae = sum(p.numel() for p in pipe.vae.parameters())
    log(f"pipeline: ti2v-5B random bf16 init in {time.perf_counter() - t0:.1f} s "
        f"(DiT {n_dit / 1e9:.3f}B, umT5 {n_t5 / 1e9:.3f}B, VAE decoder "
        f"{n_vae / 1e6:.1f}M params; {torch.cuda.memory_allocated() / 2**30:.1f} GiB)")

    times = {"t5": [], "dit_step": [], "segment": [], "decode": []}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            return out
        return wrapper

    pipe.dit.forward = timed("dit_step", pipe.dit.forward)
    pipe.generate_segment = timed("segment", pipe.generate_segment)
    pipe.decode_auto = timed("decode", pipe.decode_auto)
    encode = timed("t5", pipe.encode_text)

    tok = Tokenizer(seq_len=cfg.t5.text_len, vocab_size=cfg.t5.vocab_size,
                    warn_fallback=False)
    ids, mask = tok(CAPTIONS)
    gen = torch.Generator(device="cuda").manual_seed(2)
    history = torch.randn((1, 31, 44, 80, cfg.dit.in_dim), generator=gen, device="cuda")

    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctxs = [encode(ids[i:i + 1], mask[i:i + 1]) for i in range(len(CAPTIONS))]
    latents, videos = pipe.generate_long(ctxs, history, steps=4)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}

    require(latents.shape == (1, 31 + 2 * 8, 44, 80, 48), f"latents {latents.shape}")
    require(torch.isfinite(latents).all().item(), "non-finite latents")
    require(torch.equal(latents[:, :31], history), "history frames changed")
    for i, v in enumerate(videos):
        finite = torch.isfinite(v).all().item()
        log(f"  tail video {i}: shape {list(v.shape)} {v.dtype} finite {finite} "
            f"range [{v.min().item():.3f}, {v.max().item():.3f}]")
        require(tuple(v.shape) == (1, 29, 704, 1280, 3) and finite,
                f"tail video {i}: shape {tuple(v.shape)}, finite {finite}")
    log(f"  requests {len(CAPTIONS)}, wall {total:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, ts in times.items():
        log(f"  stage {name:<9} n={len(ts):2d}  median {statistics.median(ts) * 1e3:10.1f} ms"
            f"  all {[round(t * 1e3, 1) for t in ts]}")
    log(f"  kernel launches in the pipeline run: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    require(not missing, f"kernels not launched on the main path: {missing}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # fp32 results are compared in phases 3 and 4: no TF32 there
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from yume_tpu_torch.ops import fused_adaln as fa
    from yume_tpu_torch.ops.flash_attention import flash_attention

    smi = device_phase()
    build_phase()
    results = {k: {} for k in ("flash_attention", "adaln_norm", "adaln_residual",
                               "qk_norm_rope", "rms_norm")}
    log("kernels vs plain versions at the 5B segment shapes:")
    kernel_phase(results)
    reference_phase()
    torch.cuda.empty_cache()
    # the pipeline runs with PyTorch's default precision settings
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    counters = [flash_attention, fa.adaln_norm, fa.adaln_residual, fa.qk_norm_rope,
                fa.rms_norm]
    launches = pipeline_phase(counters)

    meta = {
        "flash_attention": ("cuda", "yume_tpu_torch/csrc/flash_attention.cu",
                            "yume_tpu/ops/flash_attention.py:57"),
        "adaln_norm": ("triton", "yume_tpu_torch/ops/fused_adaln.py",
                       "yume_tpu/ops/fused_adaln.py:94"),
        "adaln_residual": ("triton", "yume_tpu_torch/ops/fused_adaln.py",
                           "yume_tpu/ops/fused_adaln.py:251"),
        # K4 and K5 are one Triton kernel (rms_rope_kernel), ROPE on and off
        "qk_norm_rope": ("triton", "yume_tpu_torch/ops/fused_adaln.py",
                         "yume_tpu/ops/fused_adaln.py:340"),
        "rms_norm": ("triton", "yume_tpu_torch/ops/fused_adaln.py",
                     "yume_tpu/ops/fused_adaln.py:193"),
    }
    kernels = [{"name": name, "route": route, "source": src, "replaces": rep,
                "launches": launches[name], **results[name]}
               for name, (route, src, rep) in meta.items()]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
