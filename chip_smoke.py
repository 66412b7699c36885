#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. device: the card's name and power limit from nvidia-smi, torch and CUDA
   versions;
2. build: compile the CUDA kernels from yume_tpu_torch/csrc (one nvcc per
   source, in parallel);
3. kernels: every hand-written kernel of the main paths (flash attention
   K1, adaln_norm K2, adaln_residual K3, the RMSNorm/RoPE kernel K4+K5, the
   W8A8 int8 matmul K6) against its plain PyTorch version on the same
   seeded inputs at the 5B segment's shapes: error against a stated
   tolerance, median times of the kernel, of its plain version and of one
   PyTorch library call where one computes the same function, and the
   least time the card could take (bytes over 3.35 TB/s or operations over
   the published peak of their type, whichever is larger);
4. reference: a 2-layer full-width DiT on the card (kernels, bf16) against
   the same weights on the CPU (plain versions, fp32), once in bf16 matmuls
   and once with W8A8, at a small input;
5. quality: the weights-free serving-mode gate (dim 768, 8 layers, a 16×28
   latent grid, 12 steps): latent PSNR of W8A8 and the TeaCache modes
   against the bf16 Euler run, each above its floor and below 80 dB;
6. pipeline: a full-width Yume-5B TI2VPipeline with random bf16 weights, a
   seeded 31-frame history at the 44×80 latent grid, captions through the
   offline tokenizer and umT5-XXL, then two paths, each with the launch
   counts set to 0 just before it and read just after:
   a. bf16 Euler ``generate_long`` (4 steps, one caption): K1–K5 must launch;
   b. the headline: the W8A8 DiT sharing the bf16 weights, 50 steps of
      adaptive TeaCache at threshold 0.1, then ``decode_auto`` of the tail:
      K1–K6 must launch.
   Each tail video must be finite [1, 29, 704, 1280, 3].

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
import torch.nn.functional as F  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
L, N, D, DIM = 12095, 24, 128, 3072   # 5B segment: tokens, heads, head dim, width
FFN = 14336
TEXT_LEN = 512
K1_TOL = 2e-2            # bf16 kernel vs fp32 plain, N(0, 1) inputs
REL_TOL = 2.0 ** -7      # one bf16 ulp of the output magnitude (K2–K6)
DIT_REL_TOL = 3e-2       # 2 bf16 layers vs fp32, relative L2
CAPTIONS = ["The camera moves forward along a sunlit forest path.",
            "The camera turns left toward a river and keeps walking."]
HEADLINE_STEPS, HEADLINE_THRESHOLD = 50, 0.1
# published dense peaks of one H100 SXM at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, ops: float, kind: str):
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the peak rate of their type; and which of the two."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def _randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


def _record(results, kernel, case, err, tol, ms, plain_ms, bound, lib_ms=None, **extra):
    ok = err <= tol
    lib = "n/a" if lib_ms is None else f"{lib_ms:9.3f} ms"
    log(f"  {kernel:<15} {case:<26} max_abs_err {err:.3e}  tol {tol:.3e}  "
        f"kernel {ms:9.3f} ms  plain {plain_ms:9.3f} ms  library {lib}  "
        f"bound {bound[0]:.4f} ms ({bound[1]})  {'ok' if ok else 'FAIL'}"
        + "".join(f"  {k} {v}" for k, v in extra.items()))
    results[kernel]["cases"].append({
        "case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms, **extra})
    require(ok, f"{kernel} {case}: error {err} exceeds {tol}")


def attention_and_glue_kernels(results, gen):
    """K1–K5 against their plain versions at the 5B segment's shapes."""
    from yume_tpu_torch.models import dit as tdit
    from yume_tpu_torch.ops import fused_adaln as fa
    from yume_tpu_torch.ops import rope
    from yume_tpu_torch.ops.flash_attention import flash_attention, plain_attention

    def sdpa(q, k, v):  # the library yardstick of K1, on [B, N, L, D] views
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2))

    def attn_bound(q, kv_rows):
        b, lq, n, d = q.shape
        lse = b * n * lq * 4
        return bound_ms(2 * nbytes(q) + 2 * b * kv_rows * n * d * 2 + lse,
                        4 * b * n * lq * kv_rows * d, "bf16")

    # K1 flash attention --------------------------------------------------
    q, k, v = _randn(gen, 1, L, N, D), _randn(gen, 1, L, N, D), _randn(gen, 1, L, N, D)
    hs = 4  # the fp32 plain version at L = 12,095 fits only a few heads at a time
    out = flash_attention(q, k, v)
    err = max_err(out[:, :, :hs], plain_attention(q[:, :, :hs], k[:, :, :hs], v[:, :, :hs]))

    def plain_self():
        for h in range(0, N, hs):
            plain_attention(q[:, :, h:h + hs], k[:, :, h:h + hs], v[:, :, h:h + hs])

    _record(results, "flash_attention", "self [1,12095,24,128]", err, K1_TOL,
            median_ms(lambda: flash_attention(q, k, v), reps=5),
            median_ms(plain_self, reps=3), attn_bound(q, L),
            median_ms(lambda: sdpa(q, k, v), reps=5))
    kc, vc = _randn(gen, 1, TEXT_LEN, N, D), _randn(gen, 1, TEXT_LEN, N, D)
    err = max_err(flash_attention(q, kc, vc), plain_attention(q, kc, vc))
    _record(results, "flash_attention", "cross Lk=512", err, K1_TOL,
            median_ms(lambda: flash_attention(q, kc, vc)),
            median_ms(lambda: plain_attention(q, kc, vc)), attn_bound(q, TEXT_LEN),
            median_ms(lambda: sdpa(q, kc, vc)))
    kv_len = torch.tensor([300], dtype=torch.int32, device="cuda")
    err = max_err(flash_attention(q, kc, vc, kv_len=kv_len),
                  plain_attention(q, kc, vc, kv_len=kv_len))
    _record(results, "flash_attention", "cross kv_len=300<512", err, K1_TOL,
            median_ms(lambda: flash_attention(q, kc, vc, kv_len=kv_len)),
            median_ms(lambda: plain_attention(q, kc, vc, kv_len=kv_len)),
            attn_bound(q, 300))
    del q, k, v, kc, vc, out

    # K2 adaln_norm, K3 adaln_residual, K4 + K5 ----------------------------
    x, y = _randn(gen, 1, L, DIM), _randn(gen, 1, L, DIM)
    s_tab = _randn(gen, 1, 2, DIM, dtype=torch.float32, scale=0.1)
    t_tab = _randn(gen, 1, 2, DIM, dtype=torch.float32, scale=0.1)
    l_hist = 5055
    idx = (torch.arange(L, device="cuda") >= l_hist).to(torch.int32)[None]
    w1 = 1.0 + _randn(gen, 1, 1, DIM, dtype=torch.float32, scale=0.1)
    b1 = _randn(gen, 1, 1, DIM, dtype=torch.float32, scale=0.1)
    plan = tdit.framepack_plan(31)
    grids = tdit.packed_grids(plan, 44, 80, (1, 2, 2)) + [(8, 22, 40)]
    cos, sin = (torch.from_numpy(t).cuda() for t in rope.framepack_rope(grids, D))
    require(cos.shape == (L, D // 2), f"RoPE tables {tuple(cos.shape)}")
    wq = 1.0 + _randn(gen, DIM, dtype=torch.float32, scale=0.1)
    wk = 1.0 + _randn(gen, DIM, dtype=torch.float32, scale=0.1)
    tabs = nbytes(s_tab, t_tab, idx)
    act = nbytes(x)                       # one [1, 12095, 3072] bf16 pass
    elems = x.numel()
    # (kernel, case, kernel call, plain call, library call, bytes, fp32 ops)
    glue = [
        ("adaln_norm", "AdaLN gate=1 bf16 out",
         lambda: fa.adaln_norm(x, s_tab, t_tab, idx),
         lambda: fa._adaln_norm_ref(x, s_tab, t_tab, idx, 1e-6, 1.0, torch.bfloat16),
         None, 2 * act + tabs, 8 * elems),
        ("adaln_norm", "norm3 gate=0 K=1",
         lambda: fa.adaln_norm(x, w1, b1, None, gate=0.0),
         lambda: fa._adaln_norm_ref(x, w1, b1, None, 1e-6, 0.0, torch.bfloat16),
         None, 2 * act + nbytes(w1, b1), 7 * elems),
        ("adaln_norm", "head fp32 out",
         lambda: fa.adaln_norm(x, s_tab, t_tab, idx, out_dtype=torch.float32),
         lambda: fa._adaln_norm_ref(x, s_tab, t_tab, idx, 1e-6, 1.0, torch.float32),
         None, 3 * act + tabs, 8 * elems),
        ("adaln_residual", "residual bf16",
         lambda: fa.adaln_residual(x, y, s_tab, idx),
         lambda: fa._adaln_residual_ref(x, y, s_tab, idx),
         None, 3 * act + nbytes(s_tab, idx), 2 * elems),
        ("qk_norm_rope", "q and k, RoPE on (K4)",
         lambda: fa.qk_norm_rope(x, y, wq, wk, cos, sin, N, eps=1e-6),
         lambda: fa._qk_norm_rope_ref(x, y, wq, wk, cos, sin, N, 1e-6),
         None, 4 * act + nbytes(wq, wk, cos, sin), 2 * 8 * elems),
        ("rms_norm", "cross q, RoPE off (K5)",
         lambda: fa.rms_norm(x, wq, eps=1e-6),
         lambda: fa._rms_ref(x, wq, 1e-6),
         lambda: F.rms_norm(x, (DIM,), wq.to(x.dtype), eps=1e-6),
         2 * act + nbytes(wq), 4 * elems),
    ]
    def flat(out):  # K4 writes q and k: compare both
        return torch.cat(out) if isinstance(out, tuple) else out

    for kernel, case, run, plain, lib, n_bytes, ops in glue:
        want = flat(plain())
        _record(results, kernel, case, max_err(flat(run()), want),
                REL_TOL * want.float().abs().max().item(),
                median_ms(run, reps=20), median_ms(plain, reps=20),
                bound_ms(n_bytes, ops, "fp32"),
                None if lib is None else median_ms(lib, reps=20))


K6_SHAPES = [  # (case, K, N, launches per layer)
    ("qkv 3072->9216", DIM, 3 * DIM, 1),
    ("o, cross q, cross o 3072->3072", DIM, DIM, 3),
    ("ffn.0 3072->14336", DIM, FFN, 1),
    ("ffn.2 14336->3072", FFN, DIM, 1),
]


def quant_matmul_kernel(results, gen):
    """K6 against its plain version at the four W8A8 projection shapes of
    one 5B block (M = 12,095 tokens), on N(0, 1) bf16 activations and
    weights. The library yardsticks: ``torch._int_mm`` (the s8×s8→s32
    product alone, without the activation quantization and the rescale)
    and the bf16 ``torch.matmul`` of the same projection."""
    from yume_tpu_torch.ops import quant_matmul as qm

    layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "bf16_matmul_ms": 0.0}
    for case, k, n, per_layer in K6_SHAPES:
        x = _randn(gen, L, k)
        w_bf16 = _randn(gen, n, k)
        w = qm.quantize_weight(w_bf16)
        got = qm.q8_dot(x, w)
        want = qm._q8_matmul_ref(x, w.q, w.scale, torch.bfloat16)
        n_diff = int((got != want).sum().item())
        a_scale = qm._absmax_scale(x)
        qa = torch.clamp(torch.round(x.float() / a_scale), -127, 127).to(torch.int8)
        qw_t = w.q.t()
        lib = median_ms(lambda: torch._int_mm(qa, qw_t))
        bf16_ms = median_ms(lambda: torch.matmul(x, w_bf16.t()))
        bound = bound_ms(nbytes(x, w.q, w.scale, got), 2.0 * L * k * n, "int8")
        ms = median_ms(lambda: qm.q8_dot(x, w))
        plain_ms = median_ms(lambda: qm._q8_matmul_ref(x, w.q, w.scale, torch.bfloat16), reps=3)
        _record(results, "quant_matmul", case, max_err(got, want),
                REL_TOL * want.float().abs().max().item(), ms, plain_ms, bound, lib,
                differing=n_diff, bf16_matmul_ms=round(bf16_ms, 4),
                tops=round(2.0 * L * k * n / ms / 1e9, 1))
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound[0]),
                         ("library_ms", lib), ("bf16_matmul_ms", bf16_ms)):
            layer[key] += per_layer * val
        del x, w_bf16, w, got, want, qa, qw_t
    log(f"  quant_matmul per 5B layer (qkv + 3 x 3072^2 + ffn.0 + ffn.2): "
        + ", ".join(f"{k} {v:.3f}" for k, v in layer.items()))
    results["quant_matmul"]["per_layer"] = layer


def reference_phase():
    """A 2-layer full-width DiT: kernels in bf16 on the card against the
    plain versions in fp32 on the CPU, same weights, small input; once with
    bf16 matmuls and once with W8A8 (K6 on the card, the exact plain W8A8
    matmul on the CPU)."""
    from yume_tpu_torch.configs import ti2v_5b
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.pipelines.ti2v import _random_init_
    from yume_tpu_torch.utils.convert import load_state_dict

    for w8a8 in (False, True):
        cfg = dataclasses.replace(ti2v_5b().dit, num_layers=2, w8a8=w8a8)
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
        log(f"reference: 2-layer DiT{' W8A8' if w8a8 else ''} card(bf16, kernels) vs "
            f"cpu(fp32, plain): relative L2 {rel:.3e}  tol {DIT_REL_TOL:.1e}  "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, "reference check failed")
        del card, host


# The serving-mode quality gate, weights-free: latent PSNR of each mode
# against the bf16 Euler run of the same segment. Floors as the JAX
# package's gate (tests_tpu/test_quality_gate.py) sets them; the W8A8 +
# adaptive mode is held to the W8A8 + TeaCache floor, adaptive alone only
# to the 80 dB non-vacuity guard (the gate has no floor for it).
QUALITY_MODES = [  # (mode, w8a8, sampler kwargs, floor)
    ("w8a8", True, {}, 64.0),
    ("teacache@3", False, dict(sampler="teacache", teacache_interval=3), 35.0),
    ("adaptive@0.1", False, dict(sampler="teacache", teacache_threshold=0.1), None),
    ("w8a8+teacache@3", True, dict(sampler="teacache", teacache_interval=3), 35.0),
    ("w8a8+adaptive@0.1", True, dict(sampler="teacache", teacache_threshold=0.1), 35.0),
]


def quality_run(device: str = "cuda") -> dict:
    """Latent PSNR (dB) and full-step count of each serving mode on the
    gate's mid-scale segment: dim 768, 8 layers, 9 history + 4 tail frames
    at a 16×28 latent grid, 12 Euler steps at shift 7, random weights."""
    from yume_tpu_torch.configs import DiTConfig, PipelineConfig, T5Config, VAEConfig
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline

    steps, lfz, f_hist, h, w = 12, 4, 9, 16, 28
    cfg = PipelineConfig(
        name="qgate",
        dit=DiTConfig(model_type="ti2v", in_dim=16, out_dim=16, dim=768, ffn_dim=2048,
                      freq_dim=256, text_dim=32, text_len=64, num_heads=12,
                      num_layers=8, framepack=True),
        vae=VAEConfig(z_dim=16, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                      temporal_downsample=(True, False), stride=(2, 8, 8), patchify=2),
        t5=T5Config(vocab_size=256, dim=32, dim_attn=32, dim_ffn=48, num_heads=2,
                    num_layers=1, text_len=64),
        latent_frame_zero=lfz, sample_shift=7.0)
    pipe = TI2VPipeline.from_config(cfg, device=device, seed=0)
    pipes = {False: pipe, True: pipe.with_w8a8()}
    gen = torch.Generator(device=device).manual_seed(3)
    hist = torch.randn((1, f_hist, h, w, 16), generator=gen, device=device)
    ctx = torch.randn((1, 64, 32), generator=gen, device=device) * 0.2

    def tail(p, **kw):
        return p.generate_segment(hist, ctx, steps=steps, shift=7.0, **kw)[:, -lfz:].float()

    ref = tail(pipe)
    rng_pp = (ref.max() - ref.min()).item()
    out = {}
    for mode, w8a8, kw, _ in QUALITY_MODES:
        p = pipes[w8a8]
        got = tail(p, **kw)
        mse = ((got - ref) ** 2).mean().item()
        n_full = p.last_teacache_n_full if kw else steps
        out[mode] = (10.0 * torch.log10(torch.tensor(rng_pp ** 2 / max(mse, 1e-12))).item(),
                     n_full)
    return out


def quality_phase():
    log(f"quality: latent PSNR vs the bf16 Euler run (12 steps, dim 768, 8 layers)")
    psnr = quality_run("cuda")
    for mode, _, _, floor in QUALITY_MODES:
        p, n_full = psnr[mode]
        ok = p == p and (floor is None or p >= floor) and p <= 80.0
        log(f"  {mode:<18} {p:6.2f} dB  floor {floor}  guard <= 80  full steps "
            f"{n_full}/12  {'ok' if ok else 'FAIL'}")
        require(ok, f"quality {mode}: {p:.2f} dB outside [{floor}, 80]")


def pipeline_phase(counters):
    from yume_tpu_torch.configs import ti2v_5b
    from yume_tpu_torch.data.tokenizer import Tokenizer
    from yume_tpu_torch.ops import quant_matmul as qm
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

    times = {"t5": [], "dit_step": [], "decode": [], "full_step": [],
             "cached_step": [], "headline_decode": []}
    step_launches = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
            return out
        return wrapper

    def timed_dit(fn):
        """A DiT forward timed as a full or a cached TeaCache step, with
        the kernel launches of the first of each kind."""
        def wrapper(*a, **kw):
            kind = "full_step" if kw.get("return_cache") else "cached_step"
            before = {c.__name__: c.launches for c in counters}
            out = timed(kind, fn)(*a, **kw)
            step_launches.setdefault(kind, {
                c.__name__: c.launches - before[c.__name__] for c in counters})
            return out
        return wrapper

    pipe.dit.forward = timed("dit_step", pipe.dit.forward)
    pipe.decode_auto = timed("decode", pipe.decode_auto)
    encode = timed("t5", pipe.encode_text)

    tok = Tokenizer(seq_len=cfg.t5.text_len, vocab_size=cfg.t5.vocab_size,
                    warn_fallback=False)
    ids, mask = tok(CAPTIONS)
    gen = torch.Generator(device="cuda").manual_seed(2)
    history = torch.randn((1, 31, 44, 80, cfg.dit.in_dim), generator=gen, device="cuda")

    def check_tail(name, latents, n_frames, video):
        require(latents.shape == (1, n_frames, 44, 80, 48), f"{name}: latents {latents.shape}")
        require(torch.isfinite(latents).all().item(), f"{name}: non-finite latents")
        require(torch.equal(latents[:, :31], history), f"{name}: history frames changed")
        finite = torch.isfinite(video).all().item()
        log(f"  {name} tail video: shape {list(video.shape)} {video.dtype} finite {finite} "
            f"range [{video.min().item():.3f}, {video.max().item():.3f}]")
        require(tuple(video.shape) == (1, 29, 704, 1280, 3) and finite,
                f"{name}: tail video shape {tuple(video.shape)}, finite {finite}")

    def read_counts(path, needed):
        launches = {c.__name__: c.launches for c in counters}
        log(f"  kernel launches in the {path} run: {launches}")
        missing = [k for k in needed if launches[k] == 0]
        require(not missing, f"kernels not launched on the {path} path: {missing}")
        return launches

    # a. bf16 Euler, one caption (PR 1's path) --------------------------------
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = encode(ids[:1], mask[:1])
    latents, videos = pipe.generate_long([ctx], history, steps=4)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    euler_launches = read_counts("bf16 Euler", [c.__name__ for c in counters
                                                if c is not qm.q8_dot])
    check_tail("euler", latents, 31 + 8, videos[0])
    log(f"  euler: 4 steps, wall {total:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del latents, videos

    # b. the headline: W8A8 + adaptive TeaCache @0.1, 50 steps -----------------
    w8 = pipe.with_w8a8()
    w8.dit.forward = timed_dit(w8.dit.forward)
    w8.decode_auto = timed("headline_decode", w8.decode_auto)
    ctx = encode(ids[1:2], mask[1:2])
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    latents = w8.generate_segment(history, ctx, steps=HEADLINE_STEPS, seed=1,
                                  sampler="teacache", teacache_threshold=HEADLINE_THRESHOLD)
    torch.cuda.synchronize()
    segment_s = time.perf_counter() - t0
    video = w8.decode_auto(latents[:, -cfg.latent_frame_zero:])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_counts("headline", [c.__name__ for c in counters])
    check_tail("headline", latents, 31 + 8, video)
    n_full = w8.last_teacache_n_full
    require(n_full == len(times["full_step"]) and
            HEADLINE_STEPS - n_full == len(times["cached_step"]),
            f"n_full {n_full} disagrees with the timed steps")
    med = {k: statistics.median(v) * 1e3 for k, v in times.items() if v}
    log(f"  headline: W8A8 + adaptive TeaCache @{HEADLINE_THRESHOLD}, {HEADLINE_STEPS} "
        f"steps: n_full {n_full}, full step median {med['full_step']:.1f} ms, cached step "
        f"median {med['cached_step']:.1f} ms, segment {segment_s:.3f} s, decode "
        f"{med['headline_decode']:.1f} ms, segment + decode {total:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  kernel launches per full step {step_launches.get('full_step')}, per cached "
        f"step {step_launches.get('cached_step')}")
    for name, ts in times.items():
        if ts:
            log(f"  stage {name:<11} n={len(ts):2d}  median {statistics.median(ts) * 1e3:10.1f} ms"
                f"  all {[round(t * 1e3, 1) for t in ts]}")
    return launches, euler_launches


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
    from yume_tpu_torch.ops import quant_matmul as qm
    from yume_tpu_torch.ops.flash_attention import flash_attention

    smi = device_phase()
    build_phase()
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
        "quant_matmul": ("cuda", "yume_tpu_torch/csrc/quant_matmul.cu",
                         "yume_tpu/ops/quant_matmul.py:48"),
    }
    results = {k: {"cases": []} for k in meta}
    log("kernels vs plain versions at the 5B segment shapes:")
    gen = torch.Generator(device="cuda").manual_seed(0)
    attention_and_glue_kernels(results, gen)
    quant_matmul_kernel(results, gen)
    torch.cuda.empty_cache()
    reference_phase()
    torch.cuda.empty_cache()
    # the quality gate and the pipeline run with PyTorch's default precision
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    quality_phase()
    torch.cuda.empty_cache()
    counters = [flash_attention, fa.adaln_norm, fa.adaln_residual, fa.qk_norm_rope,
                fa.rms_norm, qm.q8_dot]
    launches, euler_launches = pipeline_phase(counters)
    counter_name = {"quant_matmul": "q8_dot"}

    kernels = []
    for name, (route, src, rep) in meta.items():
        r = results[name]
        # the headline numbers: K6 per 5B layer, the others their first case
        head = r.get("per_layer") or r["cases"][0]
        entry = {"name": name, "route": route, "source": src, "replaces": rep,
                 "launches": launches[counter_name.get(name, name)],
                 "launches_euler_path": euler_launches[counter_name.get(name, name)],
                 "max_abs_err": max(c["max_abs_err"] for c in r["cases"]),
                 "ms": head["ms"], "plain_ms": head["plain_ms"],
                 "bound_ms": head["bound_ms"],
                 "bound_by": r["cases"][0]["bound_by"],
                 "library_ms": head["library_ms"], "cases": r["cases"]}
        if name == "quant_matmul":
            entry["timed_as"] = ("per 5B layer: qkv + 3 x (3072->3072) + ffn.0 + ffn.2; "
                                 "library_ms is torch._int_mm, the s8 x s8 -> s32 "
                                 "product alone")
            entry["bf16_matmul_ms"] = head["bf16_matmul_ms"]
        kernels.append(entry)
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
