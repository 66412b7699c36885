#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. device: the card's name and power limit from nvidia-smi, torch and CUDA
   versions;
2. build: compile the CUDA kernels from yume_tpu_torch/csrc (one nvcc per
   source, in parallel); print the registers, spills, wgmma serialization
   warnings and shared memory of the flash forward, of K6's two kernels, of
   the flash backward's K8 and K9 and of K2 and K4 from the compiler's log;
3. kernels: every hand-written kernel of the main paths (flash attention
   K1, adaln_norm K2, adaln_residual K3, the RMSNorm/RoPE kernel K4, the
   RMSNorm kernel K5, the W8A8 int8 matmul K6, the partial flash attention
   of ring attention K7, the flash-attention backward K8 (dQ) and K9 (dK,
   dV), the fused bias + activation K10) against its plain PyTorch version on the same seeded
   inputs at the 5B segment's shapes (K7 at its ring shapes: sp 4, sp 8,
   USP 2 x 2, a block with no live key; K8/K9 at the trainer's self, cross
   and MVDT shapes, each three times and bit-identical, by events and on
   the device, with the pair against a fused backward's 5-product bound;
   K4 also on the W8A8 block's qkv views, with its batched-table case at
   the trainer's, K2 also at the trainer's 2,805 tokens, both with the
   differing elements and the share of their bound on the device; K10 at
   the ADD
   discriminator's, every activation, bf16, and an NCHW ``dim=1`` call of
   ``filtered_lrelu``, with device times): error against a
   stated tolerance, median times of the kernel, of its plain version and
   of one PyTorch library call where one computes the same function, and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the published peak of their type, whichever is larger), and for
   K1, K6, K7, K8 and K9 the achieved rate and the share of the bound (K6
   equal to its plain version bit for bit, with its pre-pass timed apart; K1
   (self and cross), K5 and K6 also at the unpacked 121-frame stream's
   27,280 tokens, and there K2 (AdaLN and the Head's fp32 out) and K3 with
   its K = 31 tables and K4 on its grid RoPE tables, with the share of their
   bound; and at the 14B segment's shapes (width 5,120, 40 heads, 28,350
   packed tokens): K1 self and cross over the 512 text and the 257 CLIP
   keys beside SDPA, K2 (AdaLN, norm3, the Head's fp32 out; which of its
   two kernels ran), K3, K4 on the 14B FramePack tables, K5, and K6 at the
   14B block's four projection shapes, bit for bit; and at phase 6f's
   packed shapes (the 5B video segments' 11,180 and 11,660 tokens: K1 self
   and cross, K2–K5 on their FramePack tables, K6 at the block's four
   shapes; the data-path trainer's 2,260: K1–K5 and K8/K9, self and cross);
   and at the i2v-14B trainer's 12,060 packed tokens with 40 heads: K1 self
   and cross over 512 and 257 keys, K2–K5, K8/K9 self (held on four heads)
   and cross over 512 and the 257 CLIP keys;
   K1's self cases hold out to two bf16 ulps of the largest |out| and the
   lse to ``K7_LSE_TOL``, on a few heads); then K7's ring invariant
   against K1 and its VJP with an lse cotangent; and for the quantized
   trunk and ``--cfg_parallel`` (phase 6g): K1 self and cross, K2–K5 at
   batch 2 at the 14B's 28,350 tokens and K6 at the batch-2 forward's
   56,700 rows; K6 bit for bit on stored int8 weights and on int8 relayed
   from int4 at the 5B and 14B block shapes, beside ``torch._int_mm``,
   with the relay's time per shape and per layer; the storage quantization
   (int8, int4, the relay) of one full 14B block on the card, bit for bit
   against the CPU's;
4. reference: a 2-layer full-width DiT on the card (kernels, bf16) against
   the same weights on the CPU (plain versions, fp32), once in bf16 matmuls
   and once with W8A8, at a small input; then the gradient of a flow loss
   through the same 2 layers (card: bf16, kernels, remat) against the CPU's
   (fp32, autograd), per parameter group;
5. quality: the weights-free serving-mode gate (dim 768, 8 layers, a 16×28
   latent grid, 12 steps): latent PSNR of W8A8 and the TeaCache modes
   against the bf16 Euler run, each above its floor and below 80 dB;
6. pipeline: a full-width Yume-5B TI2VPipeline with random bf16 weights, a
   seeded 31-frame history at the 44×80 latent grid, captions through the
   offline tokenizer and umT5-XXL, then these paths, each with the launch
   counts set to 0 just before it and read just after:
   a. bf16 Euler ``generate_long`` (4 steps, one caption): K1–K5 must launch;
   b. the headline: the W8A8 DiT sharing the bf16 weights, 50 steps of
      adaptive TeaCache at threshold 0.1, then ``decode_auto`` of the tail:
      K1–K6 must launch; then its first full and cached step once more
      under the profiler (device time and launches by kernel family, copy
      kernels; the trace's K2 and K4 launches must equal the counter's).
   Each tail video must be finite [1, 29, 704, 1280, 3]. Then
   c. the t2v first segment on the same pipeline at ``generate_t2v``'s
      defaults (121 frames of 1280×704: 31 latent frames, 27,280 unpacked
      tokens), each path with the counts set to 0 just before it and read
      just after: 4 bf16 Euler steps (exactly K1 240, K2 364, K3 240, K4
      120, K5 120 and no K6), ``decode_auto`` of all 31 latent frames
      (finite [1, 121, 704, 1280, 3]; its time and peak memory),
      ``generate_long`` continuing those latents with one caption, UniPC
      with CFG 5.0 over 3 steps (6 forwards, K1 360), and one forward of
      the W8A8 DiT (K6 180) with its relative L2 from the bf16 forward
      (at most ``T2V_W8A8_REL_TOL``);
      then a bf16 and a W8A8 forward under the profiler.
   d. (after that pipeline is freed) the serving entry points at full
      width, each with its own random-weight pipeline and the counts set
      to 0 just before it and read just after: ``python -m
      yume_tpu_torch.sample --t2v --steps 4 --sample_num 2 --w8a8
      --teacache`` through ``sample.main`` (the W8A8 t2v first segment,
      its 121-frame decode, the streaming ``encode_auto`` of those frames,
      a W8A8 + adaptive TeaCache continuation and its decode; K1–K6 must
      launch), the image mode (``--jpg_dir`` with a 1280×704 PNG, 16
      repeated frames through ``encode_image_conditioning``), and the
      webapp in a thread with ``--memory_optimization`` (a t2v request of
      2 segments, ``continue_from_last``, an i2v upload; each must end
      ``done`` with its files). Every pipeline call is timed with its peak
      and held device memory and must give finite outputs; the segment
      files must exist (mp4, or the writer's .npy fallback).
   e. (after those pipelines are freed) the Yume-1.0 i2v-14B serving path
      at full width (dim 5,120, 40 layers, umT5-XXL, CLIP ViT-H/14, the
      Wan2.1 VAE; random bf16 weights) at 544×960: ``sample.main --config
      i2v-14B --jpg_dir <a seeded 960×544 PNG> --steps 2 --sample_num 2``
      (an image segment at 28,350 packed tokens and a 32-frame
      continuation at 29,430, CFG: 8 forwards, exactly K1 960, K2 968, K3
      640, K4 320, K5 320, K6 0 launches; umT5, CLIP, the VAE encodes, the
      forwards and the decodes timed with their peak memory; the videos
      finite [1, 81, 544, 960, 3] and [1, 113, 544, 960, 3], both files
      written); then a fresh 14B pipeline's bf16 and W8A8 forward at
      28,350 tokens (K6 240), their relative L2 (at most
      ``T2V_W8A8_REL_TOL``), and one profiled CFG step.
   f. (after those are freed) the video-input mode and the data path on a
      seeded 37-frame 1280×704 clip written with cv2's mp4v writer, with
      its ``.txt`` controls and a camera ``.npy``, each path with the counts
      set to 0 just before it and read just after: which reader decodes
      it (the native decoder built from ``native/*.cpp``, or OpenCV);
      ``sample.main --video_root_dir <tree> --steps 4 --sample_num 2
      --w8a8 --teacache`` (the streaming ``encode_auto`` of 33 frames, two
      segments and their tail decodes; K1–K6 must launch); ``sample.main
      --config i2v-14B --input_video <clip> --width 960 --height 544
      --steps 2 --sample_num 1`` (the first frame 16 times before the 33,
      one ``generate_next`` of 32 frames at 28,350 packed tokens: exactly 4
      forwards, K1 480, K2 484, K3 320, K4 160, K5 160, K6 0); ``train.main
      --data_dir <tree> --lora_rank 16 --remat --max_train_steps 3
      --num_frames 33 --height 352 --width 640`` with random encoders and
      a random head (each step split into the host wait for its batch, the
      device encode and the train step; finite losses, gradient norms
      above 0; K1–K5, K8, K9 launch, K6, K7, K10 do not); and the
      preprocess CLI's ``main --max_samples 1``, whose latents and context
      ``LatentDataset`` reads back bit for bit. The segments' and the
      batches' packed token counts must be the ones phase 3 checks.
   g. (after those are freed) the quantized DiT trunk and batched CFG
      (:func:`quantized_phase`): the 5B CLI with ``--int8 --w8a8
      --teacache`` and with ``--int4 --w8a8`` (the bf16 trunk freed at
      load, no weight quantized while they run), the webapp with ``--quant
      int4``, the 14B CLI with ``--int4 --w8a8 --memory_optimization``
      (the trunk streamed block by block under a stated peak, parked in the
      phase shuttle), full-width 14B forwards on int8 and int4 trunks of
      6e's weights against their dequantized trunks and 6e's bf16 forward,
      and one batched CFG step against two forwards.
7. train (after the pipeline is freed): the 5B trainer at full width and
   its geometry (2,805 packed tokens), random bf16 parameters, remat, each
   path with the counts set to 0 just before it and read just after:
   a. the full fine-tune, clipped AdamW + EMA, 1 warm-up and 3 timed steps;
   b. one MVDT step (mask ratio 0.30) on the same model;
   d. ADD distillation (``make_distill_train_step``) on the same model: an
      fp32 discriminator with random weights on the 8 tail frames, 1
      warm-up and 2 timed steps, the discriminator's share of a step;
   c. LoRA rank 16 through ``yume_tpu_torch.train.main`` (3 steps);
   then ``train.main --smoke`` and ``--smoke --Distil`` on the card.
   Losses and gradient norms must be finite; K1–K5, K8 and K9 must launch
   and K6 must not; K10 launches 60 times a distillation step and nowhere
   else (serving, SP and the other train paths count 0).
   e. (after that model is freed) the i2v-14B trainer, checkpoint I/O and
      the training modules (:func:`train_14b_phase`): ``train.main
      --config i2v-14B --lora_rank 16 --remat --checkpointing_steps 1`` on
      synthetic batches at 12,060 packed tokens (exact launches a step,
      each async save's hold), the same over ``--data_dir`` (an i2v and a
      v2v batch, each step's host wait, encode and train step), the async
      save against a blocking one, a 2-block full-width export round trip
      bit for bit, ``--smoke --config i2v-14B --export_torch_dir`` and
      ``--ckpt_dir``, ``--MVDT --Distil`` (K10 launches),
      ``teacher_rollout``, ``ode_sample`` and ``diff_augment`` on the card.
8. sp (after the train phase is freed): sequence-parallel serving on four
   ranks, four spawned processes that share the one card over a gloo group
   (NCCL refuses two ranks on one device), so their transfers go through
   host memory and their times say nothing of SP speed. Each rank holds the
   same random full-width 5B DiT (checksummed across ranks); Ulysses (sp
   4), ring (sp 4) and USP (2 x 2) forwards at 12,095 tokens against the
   unsharded forward, a 2-step ring Euler segment against the unsharded
   one, and a 12-step ring W8A8 + adaptive TeaCache segment; every rank
   must return the same latents and n_full, and K7 must launch 120 times a
   forward on ring and USP and never on Ulysses.

The second-to-last line is a JSON object of per-kernel results; the last is
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a CUDA
device the script exits non-zero.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib.util
import json
import math
import os
import re
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
# the trainer's geometry (yume_tpu_torch.train defaults): 33 frames at
# 352×640 are 9 history + 8 tail latent frames on a 22×40 grid, 2,805
# packed tokens; MVDT at mask ratio 0.30 keeps 1,963 of them
TRAIN_F_HIST, TRAIN_LFZ, TRAIN_H, TRAIN_W = 9, 8, 22, 40
TRAIN_L, TRAIN_KEEP = 2805, 1963
# the t2v first segment at generate_t2v's defaults: 121 frames of 1280×704
# are 31 latent frames of 44×80, 31×22×40 = 27,280 unpacked tokens
T2V_FRAMES, T2V_SIZE = 121, (1280, 704)
T2V_F, T2V_H, T2V_W = 31, 22, 40
# the 14B i2v segment at 544×960 (phase 6e): 81 frames are 21 latent frames
# of 68×120; FramePack packs the 12 history frames to 9,990 tokens before
# the 9 tail frames' 18,360 (28,350); a 113-frame continuation's 20 history
# frames to 11,070 (29,430)
I2V_SIZE, I2V_FRAMES, I2V_NEXT_FRAMES = (960, 544), 81, 113
I2V_F_HIST, I2V_LFZ, I2V_H, I2V_W = 12, 9, 68, 120
I2V_L, I2V_L_NEXT = 28350, 29430
I2V_DIM, I2V_HEADS, I2V_FFN, CLIP_TOKENS, CLIP_DIM = 5120, 40, 13824, 257, 1280
# phase 6f's packed shapes: the 5B video mode's two segments after a 33-frame
# clip, over 9 and 17 history latent frames at 44×80 (11,180 and 11,660
# packed tokens), and the data-path trainer's batch of 33 frames at 352×640,
# 1 history and 8 tail latent frames at 22×40 (2,260)
VIDEO_5B_HIST, VIDEO_5B_L = (9, 17), (11180, 11660)
VIDEO_TRAIN_HIST, VIDEO_TRAIN_L = 1, 2260
K1_TOL = 2e-2            # bf16 kernel vs fp32 plain, N(0, 1) inputs
BWD_REL_TOL = 2e-2       # K8/K9: share of the largest plain gradient
REL_TOL = 2.0 ** -7      # one bf16 ulp of the output magnitude (K2–K6)
DIT_REL_TOL = 3e-2       # 2 bf16 layers vs fp32, relative L2
GRAD_REL_TOL = 5e-2      # their loss gradient, relative L2 per parameter group
# the 30-layer W8A8 forward at 27,280 tokens against the bf16 one, relative L2
# on this script's seeded random weights and inputs: 3.0672e-2 in each H100
# run; the bound is 30% above that reading
T2V_W8A8_REL_TOL = 4e-2
CAPTIONS = ["The camera moves forward along a sunlit forest path.",
            "The camera turns left toward a river and keeps walking."]
HEADLINE_STEPS, HEADLINE_THRESHOLD = 50, 0.1
# published dense peaks of one H100 SXM at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
# CUPTI loses the kernel records of about 2% of short traces on the H100, in
# bursts: 5 lossy traces of 480 within 2.4 s (scripts/torch_cupti_loss.py).
# A trace that lost records is taken again after this pause.
CUPTI_BURST_S = 3.0
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


def _event_ms(e, total=False) -> float:
    """A profiler event's device time in ms (self, or with its children)."""
    names = (("device_time_total", "cuda_time_total") if total else
             ("self_device_time_total", "self_cuda_time_total"))
    return next((getattr(e, n) for n in names if hasattr(e, n)), 0.0) / 1e3


def device_ms(fn, names=None, reps: int = 10) -> dict:
    """Device time a call of ``fn`` by kernel, from a torch.profiler trace
    of ``reps`` calls after a warm-up: CUPTI's kernel durations, without the
    host's launch path that CUDA events around one call also count. Keys:
    each of ``names`` (the kernels whose name contains it) and "all" (every
    kernel of the call). CUPTI loses kernel records now and then on the
    H100 (about 2 of K3's 20 once, which read as 104% of its bound; three
    traces in a row in another run). A trace that recorded no kernel, or a
    kernel whose record count is not a multiple of ``reps``, is taken
    again after ``CUPTI_BURST_S``, at most three times. If every trace lost
    records, the one that lost fewest is read with each kernel's launches a
    call rounded up (``ceil(count / reps)``) and its lost launches counted
    at the mean of its kept records, and a log line says so. Three traces
    without a kernel fail the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None  # (records lost, [(key, ms, count)])
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.key, _event_ms(e), e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count]
        lost = sum(-count % reps for _, _, count in kernels)
        if kernels and (best is None or lost < best[0]):
            best = (lost, kernels)
        if kernels and not lost:
            break
        log(f"  device_ms: trace {attempt} of 3 lost "
            + (f"{lost} of {sum(c for *_, c in kernels) + lost} kernel records"
               if kernels else "every kernel record"))
        if attempt < 3:
            time.sleep(CUPTI_BURST_S)
    require(best is not None, "device_ms: three profiler traces recorded no kernel")
    lost, kernels = best
    if lost:
        log(f"  device_ms: read from the trace that lost {lost}, each lost launch "
            "counted at its kernel's mean")
    out = dict.fromkeys([*(names or ()), "all"], 0.0)
    for key, ms, count in kernels:
        per_call = ms / count * math.ceil(count / reps)
        out["all"] += per_call
        for n in names or ():
            if n in key:
                out[n] += per_call
    return out


def require(ok: bool, what: str):
    """Fail the run (exit code 1, no result line) unless ``ok``."""
    if not ok:
        raise SystemExit(f"chip_smoke: {what}")


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def two_bf16_ulps(x) -> float:
    """Two bf16 ulps of the largest |x| (bf16 keeps 8 significant bits).
    K1's self cases are held to this, the measure ``K7_TOL`` uses: at N(0, 1)
    inputs their largest |out| lies in [2^-4, 2^-3) at 12,095 keys and in
    [2^-5, 2^-4) at 27,280, so it is 9.8e-4 and 4.9e-4, where the kernel and
    the plain version, each rounded once to bf16, differed by one ulp (4.9e-4
    and 2.4e-4) on the H100. Skipping one 128-key tile moves |out| by
    ~sqrt(128)/L per element and the lse by ~128/L, both past these."""
    return 2.0 ** (math.floor(math.log2(x.float().abs().max().item())) - 6)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, ops: float, kind: str):
    """Least time for the work: the larger of bytes over the memory rate and
    operations over the peak rate of their type; and which of the two."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_bound(q, kv_rows: int):
    """Bound of a flash forward of bf16 q [B, Lq, N, D] over ``kv_rows``
    live keys: q and k/v read once, out (bf16) and the fp32 lse written
    once; 4·B·N·Lq·kv_rows·D operations (the two products). With no live
    key the output is 0 whatever q holds: out and lse written, nothing
    read."""
    b, lq, n, d = q.shape
    lse = b * n * lq * 4
    q_read = nbytes(q) if kv_rows else 0
    return bound_ms(q_read + nbytes(q) + 2 * b * kv_rows * n * d * 2 + lse,
                    4 * b * n * lq * kv_rows * d, "bf16")


def attn_rate(q, kv_rows: int, ms: float, bound) -> dict:
    """Achieved TFLOP/s of a flash forward (the two products over the live
    keys) and the share of its bound it reaches."""
    b, lq, n, d = q.shape
    return {"tflops": round(4 * b * n * lq * kv_rows * d / ms / 1e9, 1),
            "bound_share": round(bound[0] / ms, 4)}


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
    path = _build.build()
    log(f"build: {os.path.relpath(path, REPO)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    # the wgmma kernels' registers, spills and shared memory (ptxas -v
    # reports the register count at entry; the consumers raise theirs with
    # setmaxnreg). Dynamic shared memory from the tile constants of each
    # source: the flash forward's Layout<D>::bytes (Q, STAGES K and V tiles,
    # 1 + 3·STAGES mbarriers, 1 KB for alignment), K6's GEMM's SMEM_BYTES
    # (STAGES xq and qw tiles, two 64 x BN/2 bf16 output buffers, 2·STAGES
    # mbarriers, 1 KB), K8's Dq/K9's DkvLayout<D>::bytes (the held tiles,
    # STAGES streamed tiles, K9's with each q tile's lse and delta,
    # 1 + 2·STAGES mbarriers, 1 KB); K6's pre-pass has none.
    def constants(src, names):
        with open(os.path.join(REPO, "yume_tpu_torch", "csrc", src)) as f:
            found = dict(re.findall(rf"constexpr int ({names}) = (\d+);", f.read()))
        return {k: int(v) for k, v in found.items()}

    fa_c = constants("flash_attention.cu", "BQ|BK|STAGES")
    qm_c = constants("quant_matmul.cu", "BM|BN|BK|STAGES")
    bw_c = constants("flash_attention_bwd.cu", "BQ|BK|BKV|BQT|STAGES")

    with open(f"{path}.log") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                if "spill" in x or "registers" in x]
        if "flash_fwd_kernel" in line:
            d = int(line.split("flash_fwd_kernelILi")[1].split("E")[0])
            name = f"flash_fwd_kernel<{d}>"
            smem = ((fa_c["BQ"] + 2 * fa_c["STAGES"] * fa_c["BK"]) * d * 2
                    + 8 * (1 + 3 * fa_c["STAGES"]) + 1024)
        elif "q8_gemm_kernel" in line:
            name = "q8_gemm_kernel (K6)"
            smem = (qm_c["STAGES"] * (qm_c["BM"] + qm_c["BN"]) * qm_c["BK"]
                    + 2 * 64 * qm_c["BN"] + 16 * qm_c["STAGES"] + 1024)
        elif "quantize_rows_kernel" in line:
            name, smem = "quantize_rows_kernel (K6 pre-pass)", 0
        elif "flash_bwd_dq_kernel" in line:
            d = int(line.split("flash_bwd_dq_kernelILi")[1].split("E")[0])
            name = f"flash_bwd_dq_kernel<{d}> (K8)"
            smem = ((2 * bw_c["BQ"] + 2 * bw_c["STAGES"] * bw_c["BK"]) * d * 2
                    + 8 * (1 + 2 * bw_c["STAGES"]) + 1024)
        elif "flash_bwd_dkv_kernel" in line:
            d = int(line.split("flash_bwd_dkv_kernelILi")[1].split("E")[0])
            name = f"flash_bwd_dkv_kernel<{d}> (K9)"
            smem = ((2 * bw_c["BKV"] + 2 * bw_c["STAGES"] * bw_c["BQT"]) * d * 2
                    + bw_c["STAGES"] * 2 * bw_c["BQT"] * 4 + 8 * (1 + 2 * bw_c["STAGES"]) + 1024)
        else:
            continue
        log(f"build: {name}: {'; '.join(info)}; dynamic shared memory {smem} bytes a CTA")
    # K2 and K4: a staged and a row kernel per dtype (K2: per input and
    # output dtype) and vector width W. K4's staged kernel's dynamic shared
    # memory holds w_q and w_k (8·D bytes) and two row buffers for each of
    # its warps (16 at D = 3,072 bf16); K2's the (gate + scale) and shift
    # rows of its tables (8·K·D bytes) and as many warps' two row buffers as
    # fit (14 at D = 3,072 bf16, K = 2)
    dtypes = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}
    row_kernels = {"K2": {}, "K4": {}}
    for i, line in enumerate(lines):
        m = re.search(r"(adaln_norm|qk_norm_rope)_(staged|rows)I(\w+?)Li(\d+)E", line)
        if m and "Compiling entry function" in line:
            kind = "K2" if m.group(1) == "adaln_norm" else "K4"
            # a repeated type is mangled as a back reference (S<n>_)
            types_ = []
            for t in re.findall(r"13__nv_bfloat16|6__half|S\d*_|f", m.group(3)):
                types_.append(types_[-1] if t.startswith("S") else t)
            block = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.findall(r"(\d+) bytes spill", block)
            row_kernels[kind][f"{m.group(1)}_{m.group(2)}<"
                              f"{', '.join(dtypes[t] for t in types_)}, W {m.group(4)}>"] = (
                int(regs.group(1)) if regs else -1, sum(int(x) for x in spill))
    for kind, found in row_kernels.items():
        require(found, f"build: no {kind} kernel in the compiler's log")
        for name, (regs, spill) in sorted(found.items()):
            log(f"build: {name} ({kind}): {regs} registers, {spill} bytes spilled")
    log(f"build: K4 staged kernel at D = 3,072 bf16: dynamic shared memory "
        f"{8 * DIM + 16 * 2 * DIM * 2} bytes a CTA (16 warps)")
    log(f"build: K2 staged kernel at D = 3,072 bf16, K = 2: dynamic shared memory "
        f"{8 * 2 * DIM + 14 * 2 * DIM * 2} bytes a CTA (14 warps)")
    for kernel in ("flash_fwd_kernel", "q8_gemm_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkv_kernel"):
        serialized = [x for x in lines if "C7515" in x and kernel in x]
        log(f"build: {kernel} wgmma serialization warnings (C7515): {len(serialized)}")


def _randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


def _record(results, kernel, case, err, tol, ms, plain_ms, bound, lib_ms=None, **extra):
    ok = err <= tol
    lib = "n/a" if lib_ms is None else f"{lib_ms:9.3f} ms"
    log(f"  {kernel:<23} {case:<26} max_abs_err {err:.3e}  tol {tol:.3e}  "
        f"kernel {ms:9.3f} ms  plain {plain_ms:9.3f} ms  library {lib}  "
        f"bound {bound[0]:.4f} ms ({bound[1]})  {'ok' if ok else 'FAIL'}"
        + "".join(f"  {k} {v}" for k, v in extra.items()))
    results[kernel]["cases"].append({
        "case": case, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms, **extra})
    require(ok, f"{kernel} {case}: error {err} exceeds {tol}")


def _sdpa(q, k, v):
    """The library yardstick of K1, on [B, N, L, D] views."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2))


def _k1_record(results, case, q, k, v, rows, err, plain_fn, lib_fn=None, kv_len=None,
               reps=10, plain_reps=10, tol=K1_TOL, **extra):
    from yume_tpu_torch.ops.flash_attention import flash_attention

    ms = median_ms(lambda: flash_attention(q, k, v, kv_len=kv_len), reps=reps)
    bound = attn_bound(q, rows)
    _record(results, "flash_attention", case, err, tol, ms,
            median_ms(plain_fn, reps=plain_reps), bound,
            None if lib_fn is None else median_ms(lib_fn, reps=reps),
            **extra, **attn_rate(q, rows, ms, bound))


def _k1_self_check(case, q, k, v, hs):
    """A self case held to the plain version on its first ``hs`` heads:
    out within two bf16 ulps of the largest |out|, lse within
    ``K7_LSE_TOL``. Returns out's error, its tolerance and the lse's
    error."""
    from yume_tpu_torch.ops.flash_attention import flash_attention, plain_attention

    out, lse = flash_attention(q, k, v, return_lse=True)
    want, want_lse = plain_attention(q[:, :, :hs], k[:, :, :hs], v[:, :, :hs],
                                     return_lse=True)
    lse_err = max_err(lse[:, :hs], want_lse)
    log(f"  flash_attention         {case}: lse max_abs_err {lse_err:.3e}  "
        f"tol {K7_LSE_TOL:.1e}  {'ok' if lse_err <= K7_LSE_TOL else 'FAIL'}")
    require(lse_err <= K7_LSE_TOL, f"K1 {case}: lse error {lse_err}")
    return max_err(out[:, :, :hs], want), two_bf16_ulps(want), lse_err


def _k1_plain_by_heads(q, k, v, hs):
    """The fp32 plain version at these lengths fits only a few heads at a
    time."""
    from yume_tpu_torch.ops.flash_attention import plain_attention

    for h in range(0, q.shape[2], hs):
        plain_attention(q[:, :, h:h + hs], k[:, :, h:h + hs], v[:, :, h:h + hs])


def _flat(out):  # K4 writes q and k: compare both
    return torch.cat(out) if isinstance(out, tuple) else out


# K2's two kernels (csrc/adaln_norm.cu), told apart in a profiler trace
K2_KERNELS = ("adaln_norm_staged", "adaln_norm_rows")


def _run_glue(results, cases):
    """K2–K5 cases: (kernel, case, kernel call, plain call, library call,
    bytes, fp32 ops) each against its plain version, with the device time,
    the share of the bound on the device, for K2 and K4 the elements that
    differ from the plain version and for K2 which of its kernels ran."""
    for kernel, case, run, plain, lib, n_bytes, ops in cases:
        want = _flat(plain())
        got = _flat(run())
        bound = bound_ms(n_bytes, ops, "fp32")
        dev = device_ms(run, K2_KERNELS, reps=20)
        extra = {"device_ms": round(dev["all"], 4)}
        if lib is not None:
            extra["library_device_ms"] = round(device_ms(lib, reps=20)["all"], 4)
        extra["bound_share"] = round(bound[0] / extra["device_ms"], 4)
        if kernel in ("adaln_norm", "qk_norm_rope"):
            extra["differing"] = int((got != want).sum().item())
        if kernel == "adaln_norm":
            extra["k2_kernel"] = "+".join(n for n in K2_KERNELS if dev[n] > 0)
        _record(results, kernel, case, max_err(got, want),
                REL_TOL * want.float().abs().max().item(),
                median_ms(run, reps=20), median_ms(plain, reps=20), bound,
                None if lib is None else median_ms(lib, reps=20), **extra)


def attention_and_glue_kernels(results, gen):
    """K1–K5 against their plain versions at the 5B segment's shapes."""
    from yume_tpu_torch.models import dit as tdit
    from yume_tpu_torch.ops import fused_adaln as fa
    from yume_tpu_torch.ops import rope
    from yume_tpu_torch.ops.flash_attention import flash_attention, plain_attention

    def k1_record(*a, **kw):
        _k1_record(results, *a, **kw)

    self_check, plain_by_heads, sdpa = _k1_self_check, _k1_plain_by_heads, _sdpa

    q, k, v = _randn(gen, 1, L, N, D), _randn(gen, 1, L, N, D), _randn(gen, 1, L, N, D)
    hs = 4
    case = "self [1,12095,24,128]"
    err, tol, lse_err = self_check(case, q, k, v, hs)
    k1_record(case, q, k, v, L, err, lambda: plain_by_heads(q, k, v, hs),
              lambda: sdpa(q, k, v), reps=5, plain_reps=3, tol=tol, lse_max_abs_err=lse_err)
    kc, vc = _randn(gen, 1, TEXT_LEN, N, D), _randn(gen, 1, TEXT_LEN, N, D)
    err = max_err(flash_attention(q, kc, vc), plain_attention(q, kc, vc))
    k1_record("cross Lk=512", q, kc, vc, TEXT_LEN, err, lambda: plain_attention(q, kc, vc),
              lambda: sdpa(q, kc, vc))
    kv_len = torch.tensor([300], dtype=torch.int32, device="cuda")
    err = max_err(flash_attention(q, kc, vc, kv_len=kv_len),
                  plain_attention(q, kc, vc, kv_len=kv_len))
    # one library call computes the same function: SDPA on the 300 live keys
    k1_record("cross kv_len=300<512", q, kc, vc, 300, err,
              lambda: plain_attention(q, kc, vc, kv_len=kv_len),
              lambda: sdpa(q, kc[:, :300], vc[:, :300]), kv_len=kv_len)
    del q, k, v, kc, vc
    # the unpacked 121-frame stream: 31 x 22 x 40 = 27,280 tokens (the first
    # segment of a t2v rollout, phase 6c), held to the plain version on two
    # heads
    lu, hs = T2V_F * T2V_H * T2V_W, 2
    q, k, v = _randn(gen, 1, lu, N, D), _randn(gen, 1, lu, N, D), _randn(gen, 1, lu, N, D)
    case = f"self unpacked [1,{lu},24,128]"
    err, tol, lse_err = self_check(case, q, k, v, hs)
    k1_record(case, q, k, v, lu, err, lambda: plain_by_heads(q, k, v, hs),
              lambda: sdpa(q, k, v), reps=5, plain_reps=1, tol=tol, lse_max_abs_err=lse_err)
    del k, v
    # its cross-attention: the 27,280 queries over the 512 text rows
    kc, vc = _randn(gen, 1, TEXT_LEN, N, D), _randn(gen, 1, TEXT_LEN, N, D)
    err = max_err(flash_attention(q, kc, vc), plain_attention(q, kc, vc))
    k1_record(f"cross unpacked [1,{lu},24,128] Lk=512", q, kc, vc, TEXT_LEN, err,
              lambda: plain_attention(q, kc, vc), lambda: sdpa(q, kc, vc), plain_reps=3)
    del q, kc, vc

    # K2 adaln_norm, K3 adaln_residual, K4 qk_norm_rope, K5 rms_norm -------
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
    wq_lib = wq.to(x.dtype)  # F.rms_norm takes the weight in x's dtype
    w1_lib, b1_lib = w1.reshape(DIM).to(x.dtype), b1.reshape(DIM).to(x.dtype)  # F.layer_norm's
    tabs = nbytes(s_tab, t_tab, idx)
    xt = x[:, :TRAIN_L]
    tail_t = TRAIN_LFZ * TRAIN_H * TRAIN_W // 4  # the trainer's tail tokens
    idx_t = (torch.arange(TRAIN_L, device="cuda") >= TRAIN_L - tail_t).to(torch.int32)[None]
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
         lambda: F.layer_norm(x, (DIM,), w1_lib, b1_lib, eps=1e-6),
         2 * act + nbytes(w1, b1), 7 * elems),
        ("adaln_norm", "head fp32 out",
         lambda: fa.adaln_norm(x, s_tab, t_tab, idx, out_dtype=torch.float32),
         lambda: fa._adaln_norm_ref(x, s_tab, t_tab, idx, 1e-6, 1.0, torch.float32),
         None, 3 * act + tabs, 8 * elems),
        # the trainer's 9 history + 8 tail frames, 2,805 packed tokens
        ("adaln_norm", f"trainer [1,{TRAIN_L},3072]",
         lambda: fa.adaln_norm(xt, s_tab, t_tab, idx_t),
         lambda: fa._adaln_norm_ref(xt, s_tab, t_tab, idx_t, 1e-6, 1.0, torch.bfloat16),
         None, 2 * nbytes(xt) + nbytes(s_tab, t_tab, idx_t), 8 * xt.numel()),
        ("adaln_residual", "residual bf16",
         lambda: fa.adaln_residual(x, y, s_tab, idx),
         lambda: fa._adaln_residual_ref(x, y, s_tab, idx),
         None, 3 * act + nbytes(s_tab, idx), 2 * elems),
        ("qk_norm_rope", "q and k, RoPE on (K4)",
         lambda: fa.qk_norm_rope(x, y, wq, wk, cos, sin, N, eps=1e-6),
         lambda: fa._qk_norm_rope_ref(x, y, wq, wk, cos, sin, N, 1e-6),
         None, 4 * act + nbytes(wq, wk, cos, sin), 2 * 8 * elems),
        ("rms_norm", "cross q (K5)",
         lambda: fa.rms_norm(x, wq, eps=1e-6),
         lambda: fa._rms_ref(x, wq, 1e-6),
         lambda: F.rms_norm(x, (DIM,), wq_lib, eps=1e-6),
         2 * act + nbytes(wq), 4 * elems),
    ]
    # K4 on the W8A8 block's q and k: the first two column blocks of its
    # fused [1, L, 9216] qkv output, read in place through the row stride
    qkv = _randn(gen, 1, L, 3 * DIM)
    qv, kv, _ = qkv.split(DIM, -1)
    glue.append(
        ("qk_norm_rope", "q and k as qkv views (K4)",
         lambda: fa.qk_norm_rope(qv, kv, wq, wk, cos, sin, N, eps=1e-6),
         lambda: fa._qk_norm_rope_ref(qv, kv, wq, wk, cos, sin, N, 1e-6),
         None, 4 * act + nbytes(wq, wk, cos, sin), 2 * 8 * elems))
    # K4 with per-sample tables [B, keep, D/2]: the MVDT masked pass of the
    # trainer (1,963 kept of its 2,805 packed tokens, tables gathered)
    keep = TRAIN_KEEP
    qm_, km_ = x[:, :keep], y[:, :keep]
    pos = torch.randperm(L, generator=gen, device="cuda")[:keep]
    bcos, bsin = cos[pos][None].contiguous(), sin[pos][None].contiguous()
    glue.append(
        ("qk_norm_rope", f"batched tables [1,{keep},64]",
         lambda: fa.qk_norm_rope(qm_, km_, wq, wk, bcos, bsin, N, eps=1e-6),
         lambda: fa._qk_norm_rope_ref(qm_, km_, wq, wk, bcos, bsin, N, 1e-6),
         None, 4 * nbytes(qm_) + nbytes(wq, wk, bcos, bsin), 2 * 8 * qm_.numel()))
    def run_glue(cases):
        _run_glue(results, cases)

    run_glue(glue)
    # the unpacked 121-frame stream of the t2v first segment: 27,280 tokens,
    # one table row per latent frame (K = 31: the two fp32 tables, 761,856
    # bytes, do not fit K2's shared memory, so K2 takes its row kernel), the
    # grid RoPE tables one row per token
    lu, k_u = T2V_F * T2V_H * T2V_W, T2V_F
    xu, yu = _randn(gen, 1, lu, DIM), _randn(gen, 1, lu, DIM)
    s_u = _randn(gen, 1, k_u, DIM, dtype=torch.float32, scale=0.1)
    t_u = _randn(gen, 1, k_u, DIM, dtype=torch.float32, scale=0.1)
    idx_u = torch.arange(k_u, dtype=torch.int32, device="cuda").repeat_interleave(
        T2V_H * T2V_W)[None]
    cos_u, sin_u = (torch.from_numpy(t).cuda()
                    for t in rope.grid_rope(T2V_F, T2V_H, T2V_W, D))
    require(cos_u.shape == (lu, D // 2), f"grid RoPE tables {tuple(cos_u.shape)}")
    act_u, elems_u = nbytes(xu), xu.numel()
    tabs_u = nbytes(s_u, t_u, idx_u)
    shape_u = f"[1,{lu},3072]"
    run_glue([
        ("adaln_norm", f"AdaLN unpacked {shape_u} K={k_u}",
         lambda: fa.adaln_norm(xu, s_u, t_u, idx_u),
         lambda: fa._adaln_norm_ref(xu, s_u, t_u, idx_u, 1e-6, 1.0, torch.bfloat16),
         None, 2 * act_u + tabs_u, 8 * elems_u),
        ("adaln_norm", f"head fp32 out unpacked K={k_u}",
         lambda: fa.adaln_norm(xu, s_u, t_u, idx_u, out_dtype=torch.float32),
         lambda: fa._adaln_norm_ref(xu, s_u, t_u, idx_u, 1e-6, 1.0, torch.float32),
         None, 3 * act_u + tabs_u, 8 * elems_u),
        ("adaln_residual", f"residual unpacked K={k_u}",
         lambda: fa.adaln_residual(xu, yu, s_u, idx_u),
         lambda: fa._adaln_residual_ref(xu, yu, s_u, idx_u),
         None, 3 * act_u + nbytes(s_u, idx_u), 2 * elems_u),
        ("qk_norm_rope", f"q and k, grid RoPE [{lu},64]",
         lambda: fa.qk_norm_rope(xu, yu, wq, wk, cos_u, sin_u, N, eps=1e-6),
         lambda: fa._qk_norm_rope_ref(xu, yu, wq, wk, cos_u, sin_u, N, 1e-6),
         None, 4 * act_u + nbytes(wq, wk, cos_u, sin_u), 2 * 8 * elems_u),
        ("rms_norm", f"cross q unpacked {shape_u}",
         lambda: fa.rms_norm(xu, wq, eps=1e-6),
         lambda: fa._rms_ref(xu, wq, 1e-6),
         lambda: F.rms_norm(xu, (DIM,), wq_lib, eps=1e-6),
         2 * act_u + nbytes(wq), 4 * elems_u),
    ])


def i2v_kernels(results, gen):
    """K1–K5 at the 14B segment's shapes (width 5,120, 40 heads of 128,
    28,350 packed tokens: phase 6e's first-segment forward), each against
    its plain version: K1 self (held on two heads), cross over the 512 text
    keys and over the 257 CLIP keys (whose last 128-key tile holds one live
    key), each beside SDPA; K2's AdaLN (K = 2), norm3 and the Head's fp32
    out, with which of its kernels ran; K3; K4 with 40 heads on the 14B
    FramePack RoPE tables; K5 beside ``F.rms_norm``."""
    from yume_tpu_torch.ops.flash_attention import flash_attention, plain_attention

    n, l, dim, hs = I2V_HEADS, I2V_L, I2V_DIM, 2
    q, k, v = (_randn(gen, 1, l, n, D) for _ in range(3))
    case = f"14B self [1,{l},{n},128]"
    err, tol, lse_err = _k1_self_check(case, q, k, v, hs)
    _k1_record(results, case, q, k, v, l, err, lambda: _k1_plain_by_heads(q, k, v, hs),
               lambda: _sdpa(q, k, v), reps=5, plain_reps=1, tol=tol,
               lse_max_abs_err=lse_err)
    del k, v
    for rows, what in ((TEXT_LEN, "text"), (CLIP_TOKENS, "CLIP")):
        kc, vc = _randn(gen, 1, rows, n, D), _randn(gen, 1, rows, n, D)
        err = max_err(flash_attention(q, kc, vc), plain_attention(q, kc, vc))
        _k1_record(results, f"14B cross Lk={rows} ({what})", q, kc, vc, rows, err,
                   lambda: plain_attention(q, kc, vc), lambda: _sdpa(q, kc, vc),
                   plain_reps=3)
        del kc, vc
    del q

    _run_glue(results, _packed_glue(gen, I2V_F_HIST, I2V_LFZ, I2V_H, I2V_W, l, "14B",
                                    dim, n))


# a 14B block's projections as the quantized trunk stores them (self-attention
# q, k and v as one), (name, N, K) in Linear layout
I2V_BLOCK = ([("self_attn.qkv", 3 * I2V_DIM, I2V_DIM), ("self_attn.o", I2V_DIM, I2V_DIM)]
             + [(f"cross_attn.{p}", I2V_DIM, I2V_DIM)
                for p in ("q", "k", "v", "o", "k_img", "v_img")]
             + [("ffn.0", I2V_FFN, I2V_DIM), ("ffn.2", I2V_DIM, I2V_FFN)])


def block_quantization_check(gen) -> dict:
    """The storage quantization of one full-width 14B block on the card
    against the CPU's, bit for bit: ``_quantize_leaf`` (codes and scales),
    ``_quantize_leaf4`` and its relay ``q4_to_q8``, each of the ten N(0,
    0.02) bf16 projections as stored (``I2V_BLOCK``); with the card's time
    for the block."""
    from yume_tpu_torch.models import quantized as tq
    from yume_tpu_torch.ops import quant_matmul as qm

    weights = [_randn(gen, n, k, scale=0.02) for _, n, k in I2V_BLOCK]

    def on_card():
        return [(tq._quantize_leaf(w), tq._quantize_leaf4(w)) for w in weights]

    ms = {"int8": median_ms(lambda: [tq._quantize_leaf(w) for w in weights], reps=3),
          "int4": median_ms(lambda: [tq._quantize_leaf4(w) for w in weights], reps=3)}
    q4s = [tq._quantize_leaf4(w) for w in weights]
    ms["relay"] = median_ms(lambda: [qm.q4_to_q8(q) for q in q4s], reps=3)
    differing = 0
    for (name, _, _), w, (q8, q4) in zip(I2V_BLOCK, weights, on_card()):
        wc = w.cpu()
        c8, c4 = tq._quantize_leaf(wc), tq._quantize_leaf4(wc)
        r, rc = qm.q4_to_q8(q4), qm.q4_to_q8(c4)
        pairs = ((q8.q, c8.q), (q8.scale, c8.scale), (q4.q, c4.q), (q4.scale, c4.scale),
                 (r.q, rc.q), (r.scale, rc.scale))
        bad = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a.cpu(), b)]
        differing += len(bad)
        require(not bad, f"block quantization {name}: card and CPU differ in "
                         f"{[('q8', 's8', 'q4', 's4', 'relay q', 'relay s')[i] for i in bad]}")
    log(f"  14B block quantization on the card equals the CPU's bit for bit "
        f"({len(I2V_BLOCK)} projections, int8, int4 and the relay); card ms for the block: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    del weights, q4s
    return {"card_ms": ms, "differing": differing}


def quantized_storage_kernels(results, gen) -> dict:
    """K6 on the quantized trunk's weights, bit for bit against its plain
    version at the 5B block's four projection shapes (M = 12,095) and the
    14B's (M = 28,350): the stored int8 (``_quantize_leaf``: scales rounded
    in bf16, no 1e-8 floor) and the int8 relayed from int4
    (``q4_to_q8``); each beside ``torch._int_mm`` on the same int8 rows and
    with its bound. The relay's own time per shape and per 14B layer (qkv
    as one relay, o, cross q, cross o, ffn.0, ffn.2) against its bound
    (int4 codes and scales read, int8 codes and scales written)."""
    from yume_tpu_torch.models import quantized as tq
    from yume_tpu_torch.ops import quant_matmul as qm

    relay = {}
    for label, m, shapes in (("5B", L, K6_SHAPES), ("14B", I2V_L, K6_SHAPES_14B)):
        layer_ms = layer_bound = 0.0
        for case, k, n, per_layer in shapes:
            x = _randn(gen, m, k)
            w = _randn(gen, n, k, scale=0.02)
            q8, q4 = tq._quantize_leaf(w), tq._quantize_leaf4(w)
            relayed = qm.q4_to_q8(q4)
            r_ms = median_ms(lambda: qm.q4_to_q8(q4), reps=5)
            r_bound = bound_ms(nbytes(q4.q, q4.scale, relayed.q, relayed.scale), 0.0,
                               "fp32")[0]
            layer_ms += per_layer * r_ms
            layer_bound += per_layer * r_bound
            relay[f"{label} {case}"] = {"ms": round(r_ms, 4), "bound_ms": round(r_bound, 4)}
            xq, _ = qm.q8_quantize(x)
            for kind, wq in (("stored Q8", q8), ("Q8 relayed from Q4", relayed)):
                got = qm.q8_dot(x, wq)
                want = qm._q8_matmul_ref(x, wq.q, wq.scale, torch.bfloat16)
                n_diff = int((got != want).sum().item())
                require(n_diff == 0, f"K6 {label} {case} {kind}: {n_diff} outputs differ")
                qw_t = wq.q.t()
                _record(results, "quant_matmul", f"{label} {case} M={m} {kind}",
                        max_err(got, want), 0.0, median_ms(lambda: qm.q8_dot(x, wq)),
                        median_ms(lambda: qm._q8_matmul_ref(x, wq.q, wq.scale,
                                                            torch.bfloat16), reps=3),
                        bound_ms(nbytes(x, wq.q, wq.scale, got), 2.0 * m * k * n, "int8"),
                        median_ms(lambda: torch._int_mm(xq, qw_t)), differing=n_diff)
                del got, want, qw_t
            del x, w, q8, q4, relayed, xq
        relay[f"{label} per layer"] = {"ms": round(layer_ms, 4),
                                       "bound_ms": round(layer_bound, 4)}
        log(f"  q4_to_q8 per {label} layer (qkv as one, 3 square, ffn.0, ffn.2): "
            f"{layer_ms:.3f} ms, bound {layer_bound:.3f} ms")
    return relay


def batch2_kernels(results, gen):
    """K1–K5 at batch 2 at the 14B segment's 28,350 packed tokens, the
    shapes ``--cfg_parallel`` gives them (cond and uncond as one forward):
    K1 self (held on one head), cross over 512 text and 257 CLIP keys with
    a context per sample, each beside SDPA; K2–K5 as :func:`_packed_glue`
    with per-sample tables. K6 at M = 56,700 is in
    :func:`quant_matmul_kernel`."""
    from yume_tpu_torch.ops.flash_attention import flash_attention, plain_attention

    n, l = I2V_HEADS, I2V_L
    q, k, v = (_randn(gen, 2, l, n, D) for _ in range(3))
    case = f"14B batch 2 self [2,{l},{n},128]"
    err, tol, lse_err = _k1_self_check(case, q, k, v, 1)
    _k1_record(results, case, q, k, v, l, err, lambda: _k1_plain_by_heads(q, k, v, 1),
               lambda: _sdpa(q, k, v), reps=5, plain_reps=1, tol=tol, lse_max_abs_err=lse_err)
    del k, v
    for rows, what in ((TEXT_LEN, "text"), (CLIP_TOKENS, "CLIP")):
        kc, vc = _randn(gen, 2, rows, n, D), _randn(gen, 2, rows, n, D)
        err = max_err(flash_attention(q, kc, vc), plain_attention(q, kc, vc))
        _k1_record(results, f"14B batch 2 cross Lk={rows} ({what})", q, kc, vc, rows, err,
                   lambda: plain_attention(q, kc, vc), lambda: _sdpa(q, kc, vc), plain_reps=3)
        del kc, vc
    del q
    _run_glue(results, _packed_glue(gen, I2V_F_HIST, I2V_LFZ, I2V_H, I2V_W, l,
                                    "14B batch 2", I2V_DIM, n, batch=2))


def _packed_glue(gen, f_hist, lfz, h, w, l, label, dim=DIM, heads=N, batch=1):
    """K2–K5 cases (as :func:`_run_glue` takes them) at the packed shape of
    ``f_hist`` history and ``lfz`` tail latent frames on an h×w latent grid,
    ``l`` tokens, at width ``dim``: the AdaLN tables K = 2 split where the tail begins
    (which of K2's kernels ran is logged), norm3 beside ``F.layer_norm``,
    the Head's fp32 out, K3, K4 with ``heads`` heads on this history's
    FramePack RoPE tables, K5 beside ``F.rms_norm``. With ``batch`` 2 (batched
    CFG) the activations are [2, l, dim], the AdaLN and residual tables one
    per sample [2, 2, dim] over idx [2, l], norm3's one [1, 1, dim] for
    both."""
    from yume_tpu_torch.models import dit as tdit
    from yume_tpu_torch.ops import fused_adaln as fa
    from yume_tpu_torch.ops import rope

    packed = tdit.packed_token_count(f_hist, lfz, h, w, (1, 2, 2))
    require(packed == l, f"{label}: {packed} packed tokens, expected {l}")
    l_hist = l - lfz * (h // 2) * (w // 2)
    x, y = _randn(gen, batch, l, dim), _randn(gen, batch, l, dim)
    s_tab = _randn(gen, batch, 2, dim, dtype=torch.float32, scale=0.1)
    t_tab = _randn(gen, batch, 2, dim, dtype=torch.float32, scale=0.1)
    idx = (torch.arange(l, device="cuda") >= l_hist).to(torch.int32)[None].expand(
        batch, l).contiguous()
    w1 = 1.0 + _randn(gen, 1, 1, dim, dtype=torch.float32, scale=0.1)
    b1 = _randn(gen, 1, 1, dim, dtype=torch.float32, scale=0.1)
    grids = tdit.packed_grids(tdit.framepack_plan(f_hist), h, w, (1, 2, 2))
    grids.append((lfz, h // 2, w // 2))
    cos, sin = (torch.from_numpy(t).cuda() for t in rope.framepack_rope(grids, D))
    require(cos.shape == (l, D // 2), f"{label} RoPE tables {tuple(cos.shape)}")
    wq = 1.0 + _randn(gen, dim, dtype=torch.float32, scale=0.1)
    wk = 1.0 + _randn(gen, dim, dtype=torch.float32, scale=0.1)
    wq_lib = wq.to(x.dtype)
    w1_lib, b1_lib = w1.reshape(dim).to(x.dtype), b1.reshape(dim).to(x.dtype)
    act, elems, tabs = nbytes(x), x.numel(), nbytes(s_tab, t_tab, idx)
    return [
        ("adaln_norm", f"{label} AdaLN [{batch},{l},{dim}] K=2",
         lambda: fa.adaln_norm(x, s_tab, t_tab, idx),
         lambda: fa._adaln_norm_ref(x, s_tab, t_tab, idx, 1e-6, 1.0, torch.bfloat16),
         None, 2 * act + tabs, 8 * elems),
        ("adaln_norm", f"{label} norm3 gate=0 K=1",
         lambda: fa.adaln_norm(x, w1, b1, None, gate=0.0),
         lambda: fa._adaln_norm_ref(x, w1, b1, None, 1e-6, 0.0, torch.bfloat16),
         lambda: F.layer_norm(x, (dim,), w1_lib, b1_lib, eps=1e-6),
         2 * act + nbytes(w1, b1), 7 * elems),
        ("adaln_norm", f"{label} head fp32 out",
         lambda: fa.adaln_norm(x, s_tab, t_tab, idx, out_dtype=torch.float32),
         lambda: fa._adaln_norm_ref(x, s_tab, t_tab, idx, 1e-6, 1.0, torch.float32),
         None, 3 * act + tabs, 8 * elems),
        ("adaln_residual", f"{label} residual [{batch},{l},{dim}]",
         lambda: fa.adaln_residual(x, y, s_tab, idx),
         lambda: fa._adaln_residual_ref(x, y, s_tab, idx),
         None, 3 * act + nbytes(s_tab, idx), 2 * elems),
        ("qk_norm_rope", f"{label} q and k, {heads} heads, FramePack RoPE, "
         f"{f_hist}-frame history",
         lambda: fa.qk_norm_rope(x, y, wq, wk, cos, sin, heads, eps=1e-6),
         lambda: fa._qk_norm_rope_ref(x, y, wq, wk, cos, sin, heads, 1e-6),
         None, 4 * act + nbytes(wq, wk, cos, sin), 2 * 8 * elems),
        ("rms_norm", f"{label} cross q [{batch},{l},{dim}]",
         lambda: fa.rms_norm(x, wq, eps=1e-6),
         lambda: fa._rms_ref(x, wq, 1e-6),
         lambda: F.rms_norm(x, (dim,), wq_lib, eps=1e-6),
         2 * act + nbytes(wq), 4 * elems),
    ]


def video_kernels(results, gen):
    """K1–K5 at phase 6f's packed shapes, each against its plain version:
    the 5B video mode's two segments over 9 and 17 history frames at 44×80
    (11,180 and 11,660 tokens) and the data-path trainer's batch of 1
    history and 8 tail frames at 22×40 (2,260 tokens). K1 self (held on four
    heads, on every head at 2,260) and cross over the 512 text keys, each
    beside SDPA; K2–K5 as :func:`_packed_glue`. K6 at the two segments'
    tokens is in :func:`quant_matmul_kernel`, K8 and K9 at the trainer's in
    :func:`flash_backward_kernels`."""
    from yume_tpu_torch.ops.flash_attention import flash_attention, plain_attention

    geoms = [(f"video seg {i + 1}", f_hist, 44, 80, l, 4)
             for i, (f_hist, l) in enumerate(zip(VIDEO_5B_HIST, VIDEO_5B_L))]
    geoms.append(("data path", VIDEO_TRAIN_HIST, 22, 40, VIDEO_TRAIN_L, N))
    for label, f_hist, h, w, l, hs in geoms:
        q, k, v = (_randn(gen, 1, l, N, D) for _ in range(3))
        case = f"{label} self [1,{l},24,128]"
        err, tol, lse_err = _k1_self_check(case, q, k, v, hs)
        _k1_record(results, case, q, k, v, l, err, lambda: _k1_plain_by_heads(q, k, v, hs),
                   lambda: _sdpa(q, k, v), reps=5, plain_reps=3, tol=tol,
                   lse_max_abs_err=lse_err)
        del k, v
        kc, vc = _randn(gen, 1, TEXT_LEN, N, D), _randn(gen, 1, TEXT_LEN, N, D)
        err = max_err(flash_attention(q, kc, vc), plain_attention(q, kc, vc))
        _k1_record(results, f"{label} cross [1,{l}] Lk=512", q, kc, vc, TEXT_LEN, err,
                   lambda: plain_attention(q, kc, vc), lambda: _sdpa(q, kc, vc))
        del q, kc, vc
        _run_glue(results, _packed_glue(gen, f_hist, 8, h, w, l, label))  # 8 tail frames


def flash_backward_kernels(results, gen):
    """K8 (dQ) and K9 (dK, dV) against ``plain_attention_bwd`` at the 5B
    trainer's shapes: self-attention over its 2,805 packed tokens, cross-
    attention over 512 text rows and MVDT's self-attention over the 1,963
    kept tokens, and phase 6f's data-path batch of 2,260 tokens, self and
    cross (the 14B trainer's cases: :func:`train_14b_kernels`). Tolerance:
    2e-2 of the largest plain gradient (the kernels
    round P and dS to bf16 before their products and write bf16; about 3
    bf16 ulps of the largest entry). Each kernel runs three times on the same
    inputs and must give the same bits (no atomics). Times by CUDA events
    and by the profiler's device time, TFLOP/s and the share of each
    kernel's bound; the pair against the bound of a fused backward's 5
    products. The plain version and the library yardstick
    (``F.scaled_dot_product_attention``'s backward, timed as forward +
    backward less the forward) each compute dQ, dK and dV together, so K8
    and K9 report the same plain and library times (on the device: the
    profiled backward alone)."""
    for case, lq, lk in ((f"self [1,{TRAIN_L},24,128]", TRAIN_L, TRAIN_L),
                         ("cross Lk=512", TRAIN_L, TEXT_LEN),
                         (f"MVDT self [1,{TRAIN_KEEP},24,128]", TRAIN_KEEP, TRAIN_KEEP),
                         (f"data path self [1,{VIDEO_TRAIN_L},24,128]", VIDEO_TRAIN_L,
                          VIDEO_TRAIN_L),
                         (f"data path cross [1,{VIDEO_TRAIN_L}] Lk=512", VIDEO_TRAIN_L,
                          TEXT_LEN)):
        _flash_backward_case(results, gen, case, lq, lk, N)


def _flash_backward_case(results, gen, case, lq, lk, heads, hs=None):
    """One K8/K9 case of :func:`flash_backward_kernels` with ``heads``
    heads; ``hs``: the fp32 plain version fits only that many heads at a
    time, so the kernels are held to it on the first ``hs`` heads and it is
    timed over all of them ``hs`` at a time."""
    from yume_tpu_torch.ops import flash_attention as fl

    hs = hs or heads
    q, do = _randn(gen, 1, lq, heads, D), _randn(gen, 1, lq, heads, D)
    k, v = _randn(gen, 1, lk, heads, D), _randn(gen, 1, lk, heads, D)
    out, lse = fl.flash_attention(q, k, v, return_lse=True)
    delta = fl.attention_delta(out, do)

    def plain(h0=0, h1=hs):
        return fl.plain_attention_bwd(q[:, :, h0:h1], k[:, :, h0:h1], v[:, :, h0:h1],
                                      out[:, :, h0:h1], lse[:, h0:h1], do[:, :, h0:h1])

    want = plain()

    def plain_all():
        for h in range(0, heads, hs):
            plain(h, h + hs)

    plain_ms = median_ms(plain_all, reps=3 if hs == heads else 1,
                         warmup=2 if hs == heads else 1)

    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    do_t = do.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(*leaves)

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, do_t)

    lib_ms = median_ms(sdpa_fwd_bwd, reps=5) - median_ms(sdpa_fwd, reps=5)
    # on the device: the backward alone, on a kept graph (a difference of
    # two profiled calls read 0 at the cross shape on the H100)
    lib_out = F.scaled_dot_product_attention(*leaves)
    lib_dev = device_ms(lambda: torch.autograd.grad(lib_out, leaves, do_t,
                                                    retain_graph=True))["all"]
    del lib_out
    flops = 2.0 * heads * lq * lk * D  # one [Lq, Lk, D] product, all heads
    stats = nbytes(lse, delta)
    pair = {}
    for kernel, ref, run, ops in (
            ("flash_attention_bwd_dq", want[:1],
             lambda: (fl.flash_attention_bwd_dq(q, k, v, do, lse, delta),), 3 * flops),
            ("flash_attention_bwd_dkv", want[1:],
             lambda: fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta), 4 * flops)):
        got = run()
        same = all(torch.equal(a, b) for _ in range(2) for a, b in zip(got, run()))
        require(same, f"{kernel} {case}: a repeat run gave other bits")
        err = max(max_err(g[:, :, :hs], w) for g, w in zip(got, ref))
        tol = BWD_REL_TOL * max(w.float().abs().max().item() for w in ref)
        ms = median_ms(run, reps=10)
        dev = device_ms(run)["all"]
        bound = bound_ms(nbytes(q, k, v, do, *got) + stats, ops, "bf16")
        pair[kernel] = (ms, dev)
        extra = {} if hs == heads else {"held_on_heads": hs}
        _record(results, kernel, case, err, tol, ms, plain_ms, bound, lib_ms,
                device_ms=round(dev, 4), library_device_ms=round(lib_dev, 4),
                tflops=round(ops / ms / 1e9, 1),
                device_tflops=round(ops / dev / 1e9, 1),
                bound_share=round(bound[0] / ms, 4),
                device_bound_share=round(bound[0] / dev, 4), three_runs_identical=same,
                **extra)
        del got
    # a fused backward (FA2/FA3) computes dQ, dK and dV in 5 products
    fused = bound_ms(nbytes(q, k, v, do) + nbytes(q, k, v) + stats, 5 * flops, "bf16")
    ms = sum(t[0] for t in pair.values())
    dev = sum(t[1] for t in pair.values())
    log(f"  K8 + K9 pair              {case:<26} {ms:.3f} ms by events, {dev:.3f} ms on "
        f"the device; 5-product bound {fused[0]:.4f} ms ({fused[1]}), "
        f"{fused[0] / dev:.1%} of it on the device; SDPA backward {lib_ms:.3f} ms, "
        f"{lib_dev:.3f} ms on the device")
    results["flash_attention_bwd_dq"].setdefault("pair", []).append({
        "case": case, "ms": ms, "device_ms": dev, "fused_bound_ms": fused[0],
        "library_ms": lib_ms, "library_device_ms": lib_dev})


# phase 7e: the i2v-14B trainer at the trainer's defaults: 33 frames at
# 352×640 are 9 history and 9 tail latent frames on a 44×80 grid, 12,060
# packed tokens; --data_dir's i2v branch (the first frame 16 times before a
# 33-frame tail) packs 4 + 9 frames (10,120), a v2v batch of a 37-frame read
# 1 + 9 (9,900)
I2V_TRAIN_F_HIST, I2V_TRAIN_H, I2V_TRAIN_W, I2V_TRAIN_L = 9, 44, 80, 12060
I2V_DATA_L = {"i2v": 10120, "v2v": 9900}
I2V_DATA_FRAMES = 37


def train_14b_kernels(results, gen):
    """K1–K5, K8 and K9 at the i2v-14B trainer's shapes (width 5,120, 40
    heads, 12,060 packed tokens over 9 history and 9 tail frames at 44×80),
    each against its plain version: K1 self (held on two heads) and cross
    over the 512 text and the 257 CLIP keys (whose last 128-key tile holds
    one live key) beside SDPA; K2–K5 as :func:`_packed_glue` (which of K2's
    kernels ran is logged); K8 and K9 self (held on four heads), cross over
    512 and over 257 keys, beside SDPA's backward."""
    from yume_tpu_torch.ops.flash_attention import flash_attention, plain_attention

    n, l, hs = I2V_HEADS, I2V_TRAIN_L, 2
    q, k, v = (_randn(gen, 1, l, n, D) for _ in range(3))
    case = f"14B train self [1,{l},{n},128]"
    err, tol, lse_err = _k1_self_check(case, q, k, v, hs)
    _k1_record(results, case, q, k, v, l, err, lambda: _k1_plain_by_heads(q, k, v, hs),
               lambda: _sdpa(q, k, v), reps=5, plain_reps=1, tol=tol,
               lse_max_abs_err=lse_err)
    del k, v
    for rows, what in ((TEXT_LEN, "text"), (CLIP_TOKENS, "CLIP")):
        kc, vc = _randn(gen, 1, rows, n, D), _randn(gen, 1, rows, n, D)
        err = max_err(flash_attention(q, kc, vc), plain_attention(q, kc, vc))
        _k1_record(results, f"14B train cross Lk={rows} ({what})", q, kc, vc, rows, err,
                   lambda: plain_attention(q, kc, vc), lambda: _sdpa(q, kc, vc),
                   plain_reps=3)
        del kc, vc
    del q
    _run_glue(results, _packed_glue(gen, I2V_TRAIN_F_HIST, 9, I2V_TRAIN_H, I2V_TRAIN_W, l,
                                    "14B train", I2V_DIM, n))
    for case, lk, hs_bwd in ((f"14B train self [1,{l},{n},128]", l, 4),
                             ("14B train cross Lk=512", TEXT_LEN, n),
                             ("14B train cross Lk=257 (CLIP)", CLIP_TOKENS, n)):
        _flash_backward_case(results, gen, case, l, lk, n, hs_bwd)
        torch.cuda.empty_cache()


# ring shapes of the 5B segment: 12,095 tokens padded to 12,096, so the
# last shard holds one pad token
L_PAD = 12096
K7_CASES = [  # (case, q rows, kv rows, heads, live keys of the block or None)
    ("ring sp=4 hop [1,3024,24,128]", 3024, 3024, N, None),
    ("ring sp=4 last shard kv_len=3023", 3024, 3024, N, 3023),
    ("ring sp=8 hop [1,1512,24,128]", 1512, 1512, N, None),
    ("ring sp=8 last shard kv_len=1511", 1512, 1512, N, 1511),
    ("USP 2x2 q [1,6048,12,128] x run 3024", 6048, 3024, N // 2, None),
    ("USP 2x2 last run kv_len=3023", 6048, 3024, N // 2, 3023),
    ("block with no live key kv_len=0", 3024, 3024, N, 0),
]
K7_LSE_TOL = 1e-3  # fp32 statistics on both sides; exp2 in the kernel, exp in plain
# K7's bf16 output against the fp32 plain one: the largest |out| of a hop at
# these shapes (N(0, 1) inputs) lies in [0.125, 0.5), where a bf16 ulp is
# 2^-10 to 2^-9; one rounding gave 9.8e-4 to 1.95e-3 on the H100. Two ulps
# at the top, about a tenth of a typical |out| (~0.03 at sp = 4).
K7_TOL = 4e-3
# the ring invariant: four hops merged in fp32 and rounded once, against K1
# rounded once, over 12,095 keys, where the largest |out| is < 0.125 and a
# typical one ~0.015: 4.9e-4 (two ulps) on the H100; 2e-3 is four times it
RING_TOL = 2e-3


def partial_attention_kernel(results, gen):
    """K7 (``flash_attention_partial``) against ``plain_attention_partial``
    at the ring shapes of the 5B segment (``K7_CASES``): out within
    ``K7_TOL``, lse within ``K7_LSE_TOL``; library yardstick
    ``aten._scaled_dot_product_flash_attention`` (it returns the lse too)
    on the block's live keys, wherever one key is live. Then: a block with
    no live key has output 0 and lse <= -1e38 and merges to zero weight;
    the ring invariant (the last shard's q against the four sp=4 kv
    blocks, merged, equals K1 over all 12,095 keys in output and lse); and
    K7's VJP with a cotangent on its lse (K8/K9) against the plain
    version's autograd gradient."""
    from yume_tpu_torch.ops import flash_attention as fl
    from yume_tpu_torch.parallel.ulysses import _INITIAL_LSE, _merge_partials

    for case, lq, lk, n, live in K7_CASES:
        q, k, v = _randn(gen, 1, lq, n, D), _randn(gen, 1, lk, n, D), _randn(gen, 1, lk, n, D)
        kl = None if live is None else torch.tensor([live], dtype=torch.int32, device="cuda")
        out, lse = fl.flash_attention_partial(q, k, v, kv_len=kl)
        want, want_lse = fl.plain_attention_partial(q, k, v, kv_len=kl)
        rows = lk if live is None else live
        lse_err = max_err(lse, want_lse)
        require(lse_err <= K7_LSE_TOL, f"K7 {case}: lse error {lse_err}")
        lib_ms = None
        if rows:  # the library call on the live keys computes the same out and lse
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (t[:, :rows].transpose(1, 2).contiguous() for t in (k, v))
            lib_ms = median_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt))
            del qt, kt, vt
        extra = {"lse_max_abs_err": lse_err}
        if rows == 0:
            # output 0, lse far below any real one, zero weight in a merge
            o_live, lse_live = fl.flash_attention_partial(q, k, v)
            merged, merged_lse = _merge_partials(o_live.float(), lse_live, out.float(), lse)
            require(torch.isfinite(out).all().item() and not out.any().item()
                    and lse.max().item() <= -1e38, f"K7 {case}: output or lse")
            require(torch.equal(merged, o_live.float()) and torch.equal(merged_lse, lse_live),
                    f"K7 {case}: the masked block changed a merge")
            extra["merges_to_zero_weight"] = True
        ms = median_ms(lambda: fl.flash_attention_partial(q, k, v, kv_len=kl))
        bound = attn_bound(q, rows)
        _record(results, "flash_attention_partial", case, max_err(out, want), K7_TOL, ms,
                median_ms(lambda: fl.plain_attention_partial(q, k, v, kv_len=kl), reps=3),
                bound, lib_ms, **extra, **attn_rate(q, rows, ms, bound))
        del q, k, v, out, lse, want, want_lse

    # the ring invariant at sp = 4: the last shard's q (3,023 tokens and a pad)
    q = _randn(gen, 1, L_PAD, N, D)[:, L_PAD - 3024:].contiguous()
    k, v = _randn(gen, 1, L_PAD, N, D), _randn(gen, 1, L_PAD, N, D)
    o = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    lse = torch.full((1, N, 3024), _INITIAL_LSE, device="cuda")
    for hop in range(4):
        blk = slice(hop * 3024, (hop + 1) * 3024)
        kl = torch.tensor([min(L - hop * 3024, 3024)], dtype=torch.int32, device="cuda")
        o_b, lse_b = fl.flash_attention_partial(q, k[:, blk], v[:, blk], kv_len=kl)
        o, lse = _merge_partials(o, lse, o_b.float(), lse_b)
    want, want_lse = fl.flash_attention(q, k[:, :L], v[:, :L], return_lse=True)
    err, lse_err = max_err(o.to(torch.bfloat16), want), max_err(lse, want_lse)
    ok = err <= RING_TOL and lse_err <= K7_LSE_TOL
    log(f"  flash_attention_partial ring invariant: 4 sp=4 hops merged vs K1 over {L} keys: "
        f"max_abs_err {err:.3e}  tol {RING_TOL:.1e}  lse max_abs_err {lse_err:.3e}  "
        f"tol {K7_LSE_TOL:.1e}  {'ok' if ok else 'FAIL'}")
    require(ok, f"K7 ring invariant: error {err}, lse error {lse_err}")
    results["flash_attention_partial"]["ring_invariant_max_abs_err"] = err
    results["flash_attention_partial"]["ring_invariant_lse_max_abs_err"] = lse_err
    del q, k, v, o, lse, want, want_lse

    # the VJP: a cotangent on both outputs, gradients against plain autograd
    q, k, v = (_randn(gen, 1, 3024, N, D) for _ in range(3))
    dout, dlse = _randn(gen, 1, 3024, N, D), torch.randn((1, N, 3024), generator=gen,
                                                         device="cuda")
    kl = torch.tensor([3023], dtype=torch.int32, device="cuda")
    grads, times = [], []
    for fn in (fl.flash_attention_partial, fl.plain_attention_partial):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def fwd_bwd():
            return torch.autograd.grad(fn(*leaves, kv_len=kl), leaves, (dout, dlse))

        grads.append(fwd_bwd())
        times.append(median_ms(fwd_bwd, reps=3))
    err = max(max_err(g, w) for g, w in zip(*grads))
    tol = BWD_REL_TOL * max(w.float().abs().max().item() for w in grads[1])
    log(f"  flash_attention_partial VJP with dlse (K7 + K8 + K9) [1,3024,24,128] "
        f"kv_len=3023: max_abs_err {err:.3e}  tol {tol:.3e}  forward + backward "
        f"{times[0]:.3f} ms, plain autograd {times[1]:.3f} ms  {'ok' if err <= tol else 'FAIL'}")
    require(err <= tol, f"K7 VJP: error {err} exceeds {tol}")
    results["flash_attention_partial"]["vjp"] = {"max_abs_err": err, "tol": tol,
                                                 "ms": times[0], "plain_ms": times[1]}
    del q, k, v, dout, dlse, grads


# K10 (bias_act) against its plain version: both compute in fp32 and round
# once; fp32 to 1e-6 of the largest |output| (CUDA's expf/tanhf/log1pf and
# ATen's may differ by an ulp or two), the half types to one of their ulps
K10_FP32_REL = 1e-6
K10_CLAMP = 256.0            # StyleGAN's conv_clamp
# the discriminator's ConvBlock activation: 5 features x 2 heads x 2 blocks
K10_PER_DISC_PASS = 20
K10_PER_DISTILL_STEP = 3 * K10_PER_DISC_PASS   # D real, D fake, the GAN term


def bias_act_kernel(results, gen):
    """K10 against ``bias_act_plain``: the discriminator's ConvBlock call
    (``[8,196,384]`` fp32, GroupNorm's bias, leaky ReLU 0.2, gain 1; the
    feature-axis heads' ``[196,8,384]`` is the same work), the same
    without a bias (library yardstick ``F.leaky_relu``), every activation at
    that shape with clamp 256 and its default gain, a bf16 case, and
    ``filtered_lrelu``'s NCHW ``dim=1`` call at a size that fills the
    card's bandwidth. Bound: x read once, y written once, the bias read
    once, over 3.35 TB/s; 5 fp32 operations an element (bias, activation,
    gain, two clamps) over the fp32 peak."""
    from yume_tpu_torch.ops import bias_act as ba

    disc = (8, 196, 384)
    cases = [  # (case, x, with bias, kwargs, library call or None)
        ("disc [8,196,384] fp32 lrelu 0.2 gain 1", _randn(gen, *disc, dtype=torch.float32), True,
         dict(act="lrelu", alpha=0.2, gain=1.0), None),
        ("no bias, lrelu 0.2 gain 1", _randn(gen, *disc, dtype=torch.float32), False,
         dict(act="lrelu", alpha=0.2, gain=1.0), lambda x: F.leaky_relu(x, 0.2)),
    ]
    for act in ba.ACTIVATIONS:
        cases.append((f"{act}, clamp 256, default gain", _randn(gen, *disc, dtype=torch.float32),
                      True, dict(act=act, clamp=K10_CLAMP), None))
    cases += [
        ("disc shape bf16 lrelu", _randn(gen, *disc), True, dict(act="lrelu", alpha=0.2, gain=1.0),
         None),
        ("NCHW dim=1 [8,64,256,256] fp32 lrelu", _randn(gen, 8, 64, 256, 256, dtype=torch.float32),
         True, dict(act="lrelu", dim=1, clamp=K10_CLAMP), None),
    ]
    for case, x, with_bias, kw, lib in cases:
        dim = kw.get("dim", -1)
        b = _randn(gen, x.shape[dim], dtype=torch.float32) if with_bias else None
        spec = ba.ACTIVATIONS[kw["act"]]
        full = dict(kw, alpha=kw.get("alpha", spec.def_alpha), gain=kw.get("gain", spec.def_gain))
        got = ba.bias_act(x, b, **kw)
        want = ba.bias_act_plain(x, b, **full)
        top = want.float().abs().max().item()
        tol = (K10_FP32_REL if x.dtype == torch.float32 else REL_TOL) * top
        n_bytes = 2 * nbytes(x) + (nbytes(b) if b is not None else 0)
        ms = median_ms(lambda: ba.bias_act(x, b, **kw), reps=20)
        extra = {"device_ms": round(device_ms(lambda: ba.bias_act(x, b, **kw),
                                              reps=20)["all"], 4)}
        if lib is not None:
            extra["library_device_ms"] = round(device_ms(lambda: lib(x), reps=20)["all"], 4)
        _record(results, "bias_act", case, max_err(got, want), tol, ms,
                median_ms(lambda: ba.bias_act_plain(x, b, **full), reps=10),
                bound_ms(n_bytes, 5 * x.numel(), "fp32"),
                None if lib is None else median_ms(lambda: lib(x), reps=20),
                gb_per_s=round(n_bytes / ms / 1e6, 1), **extra)
        del x, b, got, want


K6_SHAPES = [  # (case, K, N, launches per layer)
    ("qkv 3072->9216", DIM, 3 * DIM, 1),
    ("o, cross q, cross o 3072->3072", DIM, DIM, 3),
    ("ffn.0 3072->14336", DIM, FFN, 1),
    ("ffn.2 14336->3072", FFN, DIM, 1),
]
K6_SHAPES_14B = [  # the 14B block's projections
    ("qkv 5120->15360", I2V_DIM, 3 * I2V_DIM, 1),
    ("o, cross q, cross o 5120->5120", I2V_DIM, I2V_DIM, 3),
    ("ffn.0 5120->13824", I2V_DIM, I2V_FFN, 1),
    ("ffn.2 13824->5120", I2V_FFN, I2V_DIM, 1),
]


def quant_matmul_kernel(results, gen):
    """K6 against its plain version at the four W8A8 projection shapes of
    one 5B block, at the packed segment's M = 12,095 tokens, the unpacked
    t2v stream's 27,280 and the 5B video segments' 11,180 and 11,660 (phase
    6f), and at the 14B block's four at its segment's 28,350 and at the
    batch-2 forward's 56,700 (``--cfg_parallel``), on N(0, 1)
    bf16 activations and weights: the
    output must equal the plain version's bit for bit (``differing`` 0),
    and so must the pre-pass's int8 rows and scales (``q8_quantize``). Per
    shape, and per layer at every M but 27,280: the call's time by CUDA events
    (``ms``) and its kernels' device time from the profiler (``device_ms``:
    the pre-pass and the GEMM apart), TOP/s and the share of the bound, the
    pre-pass against its own bound (x read once, xq and a_scale written
    once). The library yardsticks: ``torch._int_mm`` (the s8×s8→s32 product
    alone, on the pre-pass's int8 rows) and the bf16 ``torch.matmul`` of the
    same projection, by events and on the device."""
    from yume_tpu_torch.ops import quant_matmul as qm

    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bf16_matmul_ms", "device_ms",
            "prepass_ms", "gemm_ms", "prepass_bound_ms", "library_device_ms",
            "bf16_matmul_device_ms")
    kernels = ("quantize_rows_kernel", "q8_gemm_kernel")
    m_t2v = T2V_F * T2V_H * T2V_W
    # (M, shapes, case suffix, the per-layer sum's key or None): the 5B packed
    # segment, the t2v stream, the 14B segment's 28,350 packed tokens
    runs = [(L, K6_SHAPES, "", "per_layer"), (m_t2v, K6_SHAPES, f" M={m_t2v}", None),
            (I2V_L, K6_SHAPES_14B, f" M={I2V_L}", "per_layer_14b"),
            (2 * I2V_L, K6_SHAPES_14B, f" M={2 * I2V_L} (batch 2)", "per_layer_14b_batch2")]
    runs += [(m, K6_SHAPES, f" M={m}", f"per_layer_{m}") for m in VIDEO_5B_L]
    for m, shapes, suffix, layer_key in runs:
        layer = dict.fromkeys(keys, 0.0)
        layer_ops = 0.0
        for case, k, n, per_layer in shapes:
            case = case + suffix
            x = _randn(gen, m, k)
            w_bf16 = _randn(gen, n, k)
            w = qm.quantize_weight(w_bf16)
            got = qm.q8_dot(x, w)
            want = qm._q8_matmul_ref(x, w.q, w.scale, torch.bfloat16)
            n_diff = int((got != want).sum().item())
            require(n_diff == 0, f"K6 {case}: {n_diff} outputs differ from the plain version")
            xq, a_scale = qm.q8_quantize(x)
            want_q, want_s = qm._quantize_act(x)
            require(torch.equal(xq, want_q) and torch.equal(a_scale, want_s),
                    f"K6 {case}: the pre-pass differs from the plain quantization")
            del want_q, want_s
            qw_t = w.q.t()
            ops = 2.0 * m * k * n
            bound = bound_ms(nbytes(x, w.q, w.scale, got), ops, "int8")
            pre_bound = bound_ms(nbytes(x, xq, a_scale), 0.0, "fp32")[0]
            ms = median_ms(lambda: qm.q8_dot(x, w))
            dev = device_ms(lambda: qm.q8_dot(x, w), kernels)
            lib = median_ms(lambda: torch._int_mm(xq, qw_t))
            lib_dev = device_ms(lambda: torch._int_mm(xq, qw_t))["all"]
            bf16_ms = median_ms(lambda: torch.matmul(x, w_bf16.t()))
            bf16_dev = device_ms(lambda: torch.matmul(x, w_bf16.t()))["all"]
            plain_ms = median_ms(lambda: qm._q8_matmul_ref(x, w.q, w.scale, torch.bfloat16),
                                 reps=3)
            vals = (ms, plain_ms, bound[0], lib, bf16_ms, dev["all"], dev[kernels[0]],
                    dev[kernels[1]], pre_bound, lib_dev, bf16_dev)
            _record(results, "quant_matmul", case, max_err(got, want),
                    REL_TOL * want.float().abs().max().item(), ms, plain_ms, bound, lib,
                    differing=n_diff, tops=round(ops / dev["all"] / 1e9, 1),
                    bound_share=round(bound[0] / dev["all"], 4),
                    gemm_tops=round(ops / dev[kernels[1]] / 1e9, 1),
                    int_mm_tops=round(ops / lib_dev / 1e9, 1),
                    **{key: round(v, 4) for key, v in zip(keys[4:], vals[4:])})
            for key, val in zip(keys, vals):
                layer[key] += per_layer * val
            layer_ops += per_layer * ops
            del x, w_bf16, w, got, want, xq, a_scale, qw_t
        if layer_key is None:
            continue
        layer.update(tops=round(layer_ops / layer["device_ms"] / 1e9, 1),
                     bound_share=round(layer["bound_ms"] / layer["device_ms"], 4),
                     gemm_tops=round(layer_ops / layer["gemm_ms"] / 1e9, 1),
                     int_mm_tops=round(layer_ops / layer["library_device_ms"] / 1e9, 1))
        log(f"  quant_matmul per {'14B' if m in (I2V_L, 2 * I2V_L) else '5B'} layer at M = {m} "
            "(qkv + 3 square + ffn.0 + ffn.2): "
            + ", ".join(f"{k} {v:.3f}" for k, v in layer.items()))
        results["quant_matmul"][layer_key] = layer


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


def _param_group(name: str) -> str:
    """blocks.7.self_attn.q.weight → blocks.self_attn; head.head.weight → head."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    return ".".join(parts[:2]) if parts[0] == "blocks" else parts[0]


def gradient_reference_phase():
    """The flow loss of a 2-layer full-width DiT and its gradient: on the
    card (kernels, bf16, remat: K1 forward, K8/K9 backward, K2–K5 through
    their recompute) against the same weights on the CPU (plain versions
    under autograd, fp32), with the same batch and draws. Relative error of
    the loss and relative L2 of each parameter group's gradient."""
    from yume_tpu_torch.configs import ti2v_5b
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.pipelines.ti2v import _random_init_
    from yume_tpu_torch.training.train_step import TrainConfig, draw_step, make_loss_fn
    from yume_tpu_torch.utils.convert import load_state_dict

    cfg = dataclasses.replace(ti2v_5b().dit, num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(4)
    card = WanDiT(cfg, torch.bfloat16, device="meta", param_dtype=torch.bfloat16,
                  remat=True).to_empty(device="cuda")
    _random_init_(card, gen)
    host = WanDiT(cfg, torch.float32, device="meta").to_empty(device="cpu")
    load_state_dict(host, {k: v.float().cpu() for k, v in card.state_dict().items()})
    tc = TrainConfig(latent_frame_zero=8)
    batch = {"latents": torch.randn((1, 3 + 8, 16, 16, cfg.in_dim), generator=gen,
                                    device="cuda"),
             "context": torch.randn((1, TEXT_LEN, cfg.text_dim), generator=gen,
                                    device="cuda")}
    draws = draw_step(batch, tc, torch.Generator().manual_seed(5))
    out = {}
    for name, model, b in (("card", card, batch),
                           ("host", host, {k: v.cpu() for k, v in batch.items()})):
        loss, _ = make_loss_fn(model, tc)(b, draws)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        out[name] = (loss.item(), {n: g.float().cpu() for n, g in zip(names, grads)})
    (loss_c, g_c), (loss_h, g_h) = out["card"], out["host"]
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    ok = loss_rel <= DIT_REL_TOL
    groups = {}
    for n in g_h:
        groups.setdefault(_param_group(n), []).append(n)
    worst = 0.0
    rels = {}
    for group, names in groups.items():
        want = torch.cat([g_h[n].reshape(-1) for n in names])
        got = torch.cat([g_c[n].reshape(-1) for n in names])
        ok &= bool(torch.isfinite(got).all())
        if want.norm() == 0:  # a FramePack scale this input does not use
            ok &= bool(got.norm() == 0)
            continue
        rels[group] = ((got - want).norm() / want.norm()).item()
        worst = max(worst, rels[group])
    ok &= worst <= GRAD_REL_TOL
    log(f"reference: 2-layer DiT flow loss card(bf16, kernels, remat) {loss_c:.6f} vs "
        f"cpu(fp32, plain) {loss_h:.6f}: relative error {loss_rel:.3e}  tol {DIT_REL_TOL:.1e}")
    log("  gradient relative L2 per parameter group (tol "
        f"{GRAD_REL_TOL:.1e}): " + ", ".join(f"{g} {r:.3e}" for g, r in sorted(rels.items()))
        + f"  {'ok' if ok else 'FAIL'}")
    require(ok, "gradient reference check failed")
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
    from yume_tpu_torch.ops import flash_attention as fl
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
             "cached_step": [], "headline_decode": [], "t2v_step": [], "t2v_cfg_forward": []}
    step_launches, step_calls = {}, {}

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
        the kernel launches and the arguments of the first of each kind
        (a cached step's without its block cache: holding that would keep
        an old cache alive and raise the peak memory)."""
        def wrapper(*a, **kw):
            kind = "full_step" if kw.get("return_cache") else "cached_step"
            before = {c.__name__: c.launches for c in counters}
            out = timed(kind, fn)(*a, **kw)
            step_launches.setdefault(kind, {
                c.__name__: c.launches - before[c.__name__] for c in counters})
            step_calls.setdefault(kind, (fn, a, {k: v for k, v in kw.items()
                                                 if k != "block_cache"}))
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

    def check_tail(name, latents, n_frames, video, hist=history):
        require(latents.shape == (1, n_frames, 44, 80, 48), f"{name}: latents {latents.shape}")
        require(torch.isfinite(latents).all().item(), f"{name}: non-finite latents")
        require(torch.equal(latents[:, :31], hist), f"{name}: history frames changed")
        finite = torch.isfinite(video).all().item()
        log(f"  {name} tail video: shape {list(video.shape)} {video.dtype} finite {finite} "
            f"range [{video.min().item():.3f}, {video.max().item():.3f}]")
        require(tuple(video.shape) == (1, 29, 704, 1280, 3) and finite,
                f"{name}: tail video shape {tuple(video.shape)}, finite {finite}")

    # the flash backward (K8, K9) runs only under autograd, K10 only in the
    # ADD discriminator, K7 only in SP: one-card serving never launches them
    backward = {fl.flash_attention_bwd_dq.__name__, fl.flash_attention_bwd_dkv.__name__}
    not_serving = backward | {"bias_act", "flash_attention_partial"}

    def read_counts(path, needed):
        launches = {c.__name__: c.launches for c in counters}
        log(f"  kernel launches in the {path} run: {launches}")
        missing = [k for k in needed if launches[k] == 0]
        require(not missing, f"kernels not launched on the {path} path: {missing}")
        stray = [k for k in not_serving if launches[k]]
        require(not stray, f"kernels of other paths launched on the {path} path: {stray}")
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
    euler_launches = read_counts("bf16 Euler", [c.__name__ for c in counters if c
                                                is not qm.q8_dot and c.__name__ not in not_serving])
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
    launches = read_counts("headline", [c.__name__ for c in counters
                                        if c.__name__ not in not_serving])
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
    # the first full and cached step once more, under the profiler: device
    # time by kernel family and the longest kernels; the cached step reads
    # the cache the profiled full step returns. The traces must show every
    # K2 and K4 launch of the step (K4 reads q and k out of the qkv output
    # in place, so no copy kernel precedes it)
    with torch.no_grad():
        fn, a, kw = step_calls["full_step"]
        held = {}
        checked_trace("headline full step", lambda: held.update(out=fn(*a, **kw)),
                      _glue_launches(step_launches["full_step"]))
        cache = held.pop("out")[1]
        fn, a, kw = step_calls["cached_step"]
        checked_trace("headline cached step", lambda: fn(*a, **kw, block_cache=cache),
                      _glue_launches(step_launches["cached_step"]))
        del cache
    del w8.dit.forward, w8.decode_auto, pipe.dit.forward, pipe.decode_auto
    t2v_launches = t2v_phase(pipe, w8, encode, tok, counters, timed, times, read_counts,
                             check_tail)
    return launches, euler_launches, t2v_launches


def t2v_phase(pipe, w8, encode, tok, counters, timed, times, read_counts, check_tail):
    """Phase 6c: the t2v first segment on the resident 5B pipeline at
    ``generate_t2v``'s defaults (121 frames of 1280×704: 31 latent frames,
    27,280 unpacked tokens), each path with the launch counts set to 0 just
    before it and read just after. Returns each path's launches."""
    cfg = pipe.config
    n = cfg.dit.num_layers
    # a bf16 forward: 30 x (self + cross) K1, 3 x 30 + 1 K2, 2 x 30 K3, 30 K4
    # and 30 K5, no K6; the W8A8 one adds 6 x 30 K6
    per_forward = {"flash_attention": 2 * n, "adaln_norm": 3 * n + 1,
                   "adaln_residual": 2 * n, "qk_norm_rope": n, "rms_norm": n,
                   "q8_dot": 0}

    def expect(path, launches, forwards, **extra):
        want = {k: v * forwards for k, v in {**per_forward, **extra}.items()}
        wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
        require(not wrong, f"{path}: launches (counted, expected) {wrong}")

    def zero_counts():
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30

    pipe.dit.forward = timed("t2v_step", pipe.dit.forward)
    ctx = encode(*tok(CAPTIONS[:1]))
    (w, h), s = T2V_SIZE, cfg.vae.stride
    f_lat = (T2V_FRAMES - 1) // s[0] + 1
    lat_shape = (1, f_lat, h // s[1], w // s[2], cfg.vae.z_dim)
    require(f_lat * (lat_shape[2] // 2) * (lat_shape[3] // 2) == T2V_F * T2V_H * T2V_W,
            f"t2v token count for latents {lat_shape}")
    stages, out = {}, {}

    # 1. bf16 Euler, 4 steps
    zero_counts()
    t0 = time.perf_counter()
    latents = pipe.generate_t2v(ctx, steps=4, solver="euler", return_latents=True)
    torch.cuda.synchronize()
    stages["euler 4 steps"] = time.perf_counter() - t0
    out["t2v euler"] = read_counts("t2v euler", [])
    expect("t2v euler", out["t2v euler"], 4)
    require(tuple(latents.shape) == lat_shape and latents.dtype == torch.float32
            and torch.isfinite(latents).all().item(),
            f"t2v latents {tuple(latents.shape)} {latents.dtype}")
    log(f"  t2v euler: 4 steps at {T2V_F * T2V_H * T2V_W} tokens, wall "
        f"{stages['euler 4 steps']:.3f} s, DiT step median "
        f"{statistics.median(times['t2v_step']) * 1e3:.1f} ms, all "
        f"{[round(t * 1e3, 1) for t in times['t2v_step']]}, peak device memory "
        f"{peak():.2f} GiB")
    del pipe.dit.forward

    # 2. decode_auto of all 31 latent frames (untiled, 2-frame chunks)
    zero_counts()
    t0 = time.perf_counter()
    video = pipe.decode_auto(latents)
    torch.cuda.synchronize()
    stages["decode 31 frames"] = time.perf_counter() - t0
    finite = torch.isfinite(video).all().item()
    decode_peak = peak()
    log(f"  t2v decode: shape {list(video.shape)} {video.dtype} finite {finite}, wall "
        f"{stages['decode 31 frames']:.3f} s, peak device memory {decode_peak:.2f} GiB "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB held after)")
    require(tuple(video.shape) == (1, T2V_FRAMES, h, w, 3) and finite,
            f"t2v video shape {tuple(video.shape)}, finite {finite}")
    del video

    # 3. the webapp's rollout: one caption continued from the t2v latents
    zero_counts()
    t0 = time.perf_counter()
    grown, videos = pipe.generate_long([ctx], latents, steps=4)
    torch.cuda.synchronize()
    stages["generate_long 1 segment"] = time.perf_counter() - t0
    out["t2v rollout"] = read_counts("t2v rollout", [c.__name__ for c in counters
                                                     if c.__name__ in per_forward
                                                     and c.__name__ != "q8_dot"])
    check_tail("t2v rollout", grown, f_lat + cfg.latent_frame_zero, videos[0], latents)
    log(f"  t2v rollout: generate_long, 4 steps, wall "
        f"{stages['generate_long 1 segment']:.3f} s, peak device memory {peak():.2f} GiB")
    del grown, videos

    # 4. UniPC with CFG: 3 steps of a cond and an uncond forward
    ctx_null = encode(*tok([""]))
    pipe.dit.forward = timed("t2v_cfg_forward", pipe.dit.forward)
    zero_counts()
    t0 = time.perf_counter()
    cfg_latents = pipe.generate_t2v(ctx, steps=3, solver="unipc", ctx_null=ctx_null,
                                    guide_scale=5.0, return_latents=True)
    torch.cuda.synchronize()
    stages["unipc cfg 3 steps"] = time.perf_counter() - t0
    out["t2v unipc cfg"] = read_counts("t2v unipc cfg", [])
    expect("t2v unipc cfg", out["t2v unipc cfg"], 6)
    require(tuple(cfg_latents.shape) == lat_shape and torch.isfinite(cfg_latents).all().item(),
            "t2v unipc cfg: latents not finite")
    log(f"  t2v unipc + CFG 5.0: 3 steps, {len(times['t2v_cfg_forward'])} forwards, wall "
        f"{stages['unipc cfg 3 steps']:.3f} s, forward median "
        f"{statistics.median(times['t2v_cfg_forward']) * 1e3:.1f} ms, peak device memory "
        f"{peak():.2f} GiB")
    del cfg_latents
    del pipe.dit.forward

    # 5. one W8A8 forward at 27,280 tokens against the bf16 one
    x = latents.to(torch.bfloat16)
    t_frame = torch.full((1, f_lat), 500.0, device=x.device)
    with torch.no_grad():
        ref = pipe.dit(x, t_frame, ctx, packed=False)
        w8.dit(x, t_frame, ctx, packed=False)  # warm-up
        zero_counts()
        t0 = time.perf_counter()
        got = w8.dit(x, t_frame, ctx, packed=False)
        torch.cuda.synchronize()
    stages["w8a8 forward"] = time.perf_counter() - t0
    out["t2v w8a8 forward"] = read_counts("t2v w8a8 forward", [])
    expect("t2v w8a8 forward", out["t2v w8a8 forward"], 1, q8_dot=6 * n)
    rel = ((got - ref).norm() / ref.norm()).item()
    require(math.isfinite(rel) and torch.isfinite(got).all().item(),
            "t2v w8a8 forward: not finite")
    log(f"  t2v w8a8 forward: {stages['w8a8 forward'] * 1e3:.1f} ms, relative L2 from the "
        f"bf16 forward {rel:.4e}  tol {T2V_W8A8_REL_TOL:.0e}, peak device memory "
        f"{peak():.2f} GiB")
    require(rel <= T2V_W8A8_REL_TOL,
            f"t2v w8a8 forward: relative L2 {rel} from bf16 exceeds {T2V_W8A8_REL_TOL}")
    # one bf16 and one W8A8 forward under the profiler: device time by kernel
    # family; the traces must show the counted K2 and K4 launches
    with torch.no_grad():
        for what, dit in (("t2v bf16 step", pipe.dit), ("t2v w8a8 forward", w8.dit)):
            checked_trace(what, lambda: dit(x, t_frame, ctx, packed=False),
                          _glue_launches({"adaln_norm": 3 * n + 1, "qk_norm_rope": n}))
    for name, t in stages.items():
        log(f"  t2v stage {name:<24} {t:8.3f} s")
    del x, t_frame, ref, got, latents
    return out


# the serving entry points (phase 6d): the CLI's t2v run, the image mode and
# the webapp's three requests
SERVING_STEPS = 4
SERVING_KERNELS = ("flash_attention", "adaln_norm", "adaln_residual", "qk_norm_rope",
                   "rms_norm")


class _Recorder:
    """Wraps pipeline methods on the class (the entry points build their own
    pipelines) for the time, the peak device memory and the device memory
    held at entry of each call, and the output's shape and finiteness, which
    every call must pass. :meth:`restore` puts the methods back."""

    def __init__(self, cls, names):
        self.cls, self.calls, self.saved = cls, [], {n: getattr(cls, n) for n in names}
        # the running peak of each call in progress (calls nest: decode_tiled
        # calls decode_auto), folded into the caller's when a call ends
        self.peaks = []
        for name, fn in self.saved.items():
            setattr(cls, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            if self.peaks:
                self.peaks[-1] = max(self.peaks[-1], torch.cuda.max_memory_allocated())
            self.peaks.append(held)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            peak = max(self.peaks.pop(), torch.cuda.max_memory_allocated())
            if self.peaks:
                self.peaks[-1] = max(self.peaks[-1], peak)
            first = out[0] if isinstance(out, tuple) else out
            finite = torch.isfinite(first).all().item()
            self.calls.append({"call": name, "s": dt, "held_gib": held / 2**30,
                               "peak_gib": peak / 2**30,
                               "shape": list(first.shape), "finite": finite})
            require(finite, f"{name}: non-finite output {list(first.shape)}")
            return out
        return wrapper

    def take(self, quiet=False):
        calls, self.calls = self.calls, []
        for c in () if quiet else calls:
            log(f"    {c['call']:<28} {c['s']:8.3f} s  held {c['held_gib']:6.2f} GiB  peak "
                f"{c['peak_gib']:6.2f} GiB  out {c['shape']}")
        return calls

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)


def _video_files(out_dir, names):
    """The written file of each segment: the mp4, or the .npy the writer
    falls back to; returns {name: (path, bytes)}."""
    found = {}
    for name in names:
        path = os.path.join(out_dir, name)
        path = path if os.path.exists(path) else path + ".npy"
        require(os.path.exists(path), f"no file written for {name} in {out_dir}")
        found[name] = (os.path.relpath(path, REPO), os.path.getsize(path))
    return found


def serving_phase(counters):
    """Phase 6d: the serving entry points at full width (Yume-5B, random
    bf16 weights, 1280×704, 121 frames), after phase 6's pipeline is freed;
    each path with the launch counts set to 0 just before it and read just
    after:
    a. ``python -m yume_tpu_torch.sample --t2v --steps 4 --sample_num 2
       --w8a8 --teacache`` through ``sample.main``: the W8A8 t2v first
       segment at 27,280 tokens, its 121-frame decode, ``encode_auto`` of
       those frames (streaming), one W8A8 + adaptive TeaCache continuation
       at 12,095 packed tokens and its tail decode: K1–K6 must launch;
    b. the image mode, ``--jpg_dir`` with a 1280×704 PNG: 16 repeated
       frames through ``encode_image_conditioning``, a 4-step segment, the
       ``decode_auto`` of its 31 latent frames;
    c. the webapp in a thread on port 0 with ``--memory_optimization``: a
       t2v request of 2 segments, ``continue_from_last``, an i2v upload,
       each ending ``done`` with its files; the device memory held while
       the DiT runs (umT5 and the VAE parked) and the tiled decode's peak.
    Every pipeline call is timed and must give finite outputs. Returns each
    path's launches."""
    import base64
    import io
    import shutil
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    from yume_tpu_torch import sample
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
    from yume_tpu_torch.serving import webapp

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"serving: {left:.2f} GiB left allocated after the pipeline phase")
    require(left < 1.0, "the pipeline phase left memory allocated")
    root = os.path.join(REPO, "build", "serving")
    shutil.rmtree(root, ignore_errors=True)
    writer = ("imageio" if importlib.util.find_spec("imageio") else
              "cv2" if importlib.util.find_spec("cv2") else "none (.npy)")
    log(f"  video writers: imageio {importlib.util.find_spec('imageio') is not None}, "
        f"cv2 {importlib.util.find_spec('cv2') is not None}; first tried: {writer}")
    out = {"launches": {}, "paths": {}}
    rec = _Recorder(TI2VPipeline, ("generate_t2v", "encode_auto", "encode_image_conditioning",
                                   "generate_segment", "decode_auto", "decode_tiled",
                                   "encode_text"))
    steps = _Recorder(WanDiT, ("forward",))

    def dit_steps(path):
        """Each DiT forward's time, by its token stream (unpacked t2v,
        packed segment)."""
        calls = steps.take(quiet=True)
        by_kind = {}
        for c in calls:
            kind = "unpacked" if len(c["shape"]) == 5 and c["shape"][1] == T2V_F else "packed"
            by_kind.setdefault(kind, []).append(round(c["s"] * 1e3, 1))
        log(f"  {path}: DiT forwards (ms) {by_kind}")
        return by_kind

    def zero_counts():
        for c in counters:
            c.launches = 0

    def read_counts(path, needed):
        launches = {c.__name__: c.launches for c in counters}
        log(f"  kernel launches in the {path} run: {launches}")
        missing = [k for k in needed if launches[k] == 0]
        require(not missing, f"kernels not launched on the {path} path: {missing}")
        stray = [k for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "bias_act",
                             "flash_attention_partial") if launches[k]]
        require(not stray, f"kernels of other paths launched on the {path} path: {stray}")
        out["launches"][path] = launches

    def cli(path, argv, files):
        out_dir = os.path.join(root, path)
        zero_counts()
        t0 = time.perf_counter()
        rc = sample.main(argv + ["--output_dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(rc == 0, f"{path}: sample.main returned {rc}")
        read_counts(path, needed=SERVING_KERNELS + (("q8_dot",) if "--w8a8" in argv else ()))
        calls = rec.take()
        written = _video_files(out_dir, files)
        log(f"  {path}: sample.main wall {wall:.3f} s, files {written}")
        out["paths"][path] = {"wall_s": wall, "calls": calls, "files": written,
                              "dit_forward_ms": dit_steps(path)}
        gc.collect()
        torch.cuda.empty_cache()
        require(torch.cuda.memory_allocated() < 2**30, f"{path}: the CLI left memory allocated")

    try:
        # a. the CLI's t2v run: W8A8, adaptive TeaCache, two segments
        log("serving a: python -m yume_tpu_torch.sample --t2v --steps 4 --sample_num 2 "
            "--w8a8 --teacache")
        cli("cli t2v", ["--t2v", "--steps", str(SERVING_STEPS), "--sample_num", "2", "--w8a8",
                        "--teacache"], ["segment_000.mp4", "segment_001.mp4"])
        enc = [c for c in out["paths"]["cli t2v"]["calls"] if c["call"] == "encode_auto"]
        require(len(enc) == 1 and enc[0]["shape"] == [1, T2V_F, 44, 80, 48],
                f"cli t2v: encode_auto calls {enc}")
        log(f"  cli t2v: encode_auto of {T2V_FRAMES} frames (streaming, bf16) "
            f"{enc[0]['s']:.3f} s, peak {enc[0]['peak_gib']:.2f} GiB "
            f"({enc[0]['held_gib']:.2f} GiB held at entry)")

        # b. the image mode: a 1280×704 PNG through --jpg_dir
        jpg = os.path.join(root, "jpg")
        os.makedirs(jpg)
        yy, xx = np.mgrid[0:T2V_SIZE[1], 0:T2V_SIZE[0]]
        img = np.stack([xx * 255 // T2V_SIZE[0], yy * 255 // T2V_SIZE[1],
                        (xx + yy) % 256], -1).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(jpg, "frame.png"))
        log("serving b: python -m yume_tpu_torch.sample --jpg_dir <1280x704 png> --steps 4")
        cli("cli image", ["--jpg_dir", jpg, "--steps", str(SERVING_STEPS)], ["segment_000.mp4"])

        # c. the webapp
        log("serving c: python -m yume_tpu_torch.serving.webapp --memory_optimization")
        args = webapp.build_argparser().parse_args(
            ["--memory_optimization", "--port", "0", "--output_dir", os.path.join(root, "web")])
        app = webapp.WebApp(args)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), app.handler())
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        port = srv.server_address[1]

        def post(path, obj):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         data=json.dumps(obj).encode(), method="POST",
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read())

        def status():
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/status",
                                        timeout=60) as r:
                return json.loads(r.read())

        try:
            t0 = time.perf_counter()
            require(post("/api/load", {})["status"] == "loaded", "webapp: load failed")
            torch.cuda.synchronize()
            log(f"  webapp load: {time.perf_counter() - t0:.3f} s, "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the device with umT5 "
                f"and the VAE parked")
            buf = io.BytesIO()
            Image.fromarray(img[::2, ::2]).save(buf, format="PNG")
            upload = base64.b64encode(buf.getvalue()).decode()
            requests = [("webapp t2v", {"mode": "t2v", "segments": 2, "steps": SERVING_STEPS,
                                        "seed": 0}, 2),
                        ("webapp continue", {"mode": "continue_from_last", "keys": "D",
                                             "mouse": "→", "steps": SERVING_STEPS,
                                             "seed": 1}, 1),
                        ("webapp i2v", {"mode": "i2v", "image_b64": upload,
                                        "steps": SERVING_STEPS, "seed": 2}, 1)]
            for path, req, n_videos in requests:
                n_before = len(app.outputs)
                zero_counts()
                t0 = time.perf_counter()
                require(post("/api/generate_long", req)["status"] == "started",
                        f"{path}: not started")
                while (st := status())["status"] == "generating":
                    time.sleep(0.05)
                wall = time.perf_counter() - t0
                require(st["status"] == "done", f"{path}: {st['status']}: {st['progress']}")
                read_counts(path, needed=SERVING_KERNELS)
                calls = rec.take()
                files = st["outputs"][n_before:]
                require(len(files) == n_videos and all(os.path.exists(f) for f in files),
                        f"{path}: files {files}")
                dit_held = [c["held_gib"] for c in calls
                            if c["call"] in ("generate_t2v", "generate_segment")]
                tiled_peak = [c["peak_gib"] for c in calls if c["call"] == "decode_tiled"]
                log(f"  {path}: request wall {wall:.3f} s, files "
                    f"{[(os.path.relpath(f, REPO), os.path.getsize(f)) for f in files]}, device "
                    f"memory held while the DiT runs {dit_held} GiB, tiled decode peak "
                    f"{tiled_peak} GiB")
                files = [os.path.relpath(f, REPO) for f in files]
                out["paths"][path] = {"wall_s": wall, "calls": calls, "files": files,
                                      "dit_forward_ms": dit_steps(path),
                                      "dit_held_gib": dit_held, "tiled_decode_peak_gib":
                                      tiled_peak}
        finally:
            srv.shutdown()
            srv.server_close()
            app.close()
            thread.join(timeout=60)
        require(not thread.is_alive(), "webapp: the server thread did not stop")
        del app, srv
    finally:
        rec.restore()
        steps.restore()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 6e: the 14B's kernel launches a forward (40 layers): K1 self and
# cross over the text and the CLIP keys, K2 3 a block and the Head's, K3 2 a
# block, K4 and K5 1 a block; K6 6 a block with W8A8
I2V_STEPS = 2
I2V_PER_FORWARD = {"flash_attention": 3 * 40, "adaln_norm": 3 * 40 + 1,
                   "adaln_residual": 2 * 40, "qk_norm_rope": 40, "rms_norm": 40, "q8_dot": 0}
I2V_W8A8_PER_FORWARD = 6 * 40
# the 40-layer W8A8 forward at 28,350 tokens is held to the 30-layer 5B's
# bound, T2V_W8A8_REL_TOL: 3.583e-2 to 3.660e-2 on an H100 at this
# script's seeds


def _i2v_forward_inputs(cfg):
    """The seeded inputs of a 14B forward at 28,350 packed tokens (phases 6e
    and 6g): bf16 latents [1, 21, 68, 120, 36], every frame at t = 500, two
    text contexts and CLIP features."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    f_lat = I2V_F_HIST + I2V_LFZ
    x = torch.randn((1, f_lat, I2V_H, I2V_W, cfg.dit.in_dim), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t_frame = torch.full((1, f_lat), 500.0, device="cuda")
    ctx, ctx_null = (0.1 * torch.randn((1, cfg.dit.text_len, cfg.dit.text_dim), generator=gen,
                                       device="cuda") for _ in range(2))
    clip_ctx = torch.randn((1, CLIP_TOKENS, CLIP_DIM), generator=gen,
                           device="cuda").to(torch.bfloat16)
    return x, t_frame, ctx, ctx_null, clip_ctx


def i2v_phase(counters):
    """Phase 6e: the Yume-1.0 i2v-14B serving path at full width (dim 5,120,
    40 layers, umT5-XXL, CLIP ViT-H/14, the Wan2.1 VAE; random bf16 weights)
    at 544×960, after phase 6d's pipelines are freed, each path with the
    launch counts set to 0 just before it and read just after:
    a. ``python -m yume_tpu_torch.sample --config i2v-14B --jpg_dir <a seeded
       960×544 PNG> --steps 2 --sample_num 2`` through ``sample.main``: an
       image segment of 81 frames (28,350 packed tokens) and a
       ``generate_next`` of 32 frames (113 frames, 29,430 tokens), two CFG
       Euler steps each, 8 forwards: exactly the launches of
       ``I2V_PER_FORWARD`` times 8; umT5, CLIP, the VAE encodes, the DiT
       forwards and the decodes timed with their peak memory; the decoded
       videos finite [1, 81, 544, 960, 3] and [1, 113, 544, 960, 3], both
       segment files written;
    b. a new random-weight pipeline without umT5 and CLIP, and its W8A8 twin
       on the same bf16 weights: one bf16 and one W8A8 forward at 28,350
       tokens (K6 240 launches), their relative L2 (at most
       ``T2V_W8A8_REL_TOL``), and one CFG step (the cond and the uncond bf16
       forward) under the profiler.
    Returns each path's launches and figures."""
    import shutil

    import numpy as np
    from PIL import Image

    from yume_tpu_torch import sample
    from yume_tpu_torch.configs import i2v_14b
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.pipelines.i2v import I2VPipeline

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"i2v: {left:.2f} GiB left allocated after the serving phase")
    require(left < 1.0, "the serving phase left memory allocated")
    root = os.path.join(REPO, "build", "i2v")
    shutil.rmtree(root, ignore_errors=True)
    jpg, out_dir = os.path.join(root, "jpg"), os.path.join(root, "cli")
    os.makedirs(jpg)
    (w, h) = I2V_SIZE
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (h, w, 3), dtype=np.uint8)) \
        .save(os.path.join(jpg, "frame.png"))
    out = {"launches": {}}
    others = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "bias_act",
              "flash_attention_partial")

    def zero_counts():
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()

    def check_counts(path, forwards, **extra):
        launches = {c.__name__: c.launches for c in counters}
        log(f"  kernel launches in the {path} run: {launches}")
        want = {k: v * forwards for k, v in I2V_PER_FORWARD.items()}
        want.update(extra, **dict.fromkeys(others, 0))
        wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
        require(not wrong, f"{path}: launches (counted, expected) {wrong}")
        out["launches"][path] = launches

    rec = _Recorder(I2VPipeline, ("encode_text", "clip_features", "make_conditioning",
                                  "generate", "generate_next", "decode_auto"))
    steps = _Recorder(WanDiT, ("forward",))
    try:
        # a. the CLI: an image segment and one continuation
        argv = ["--config", "i2v-14B", "--jpg_dir", jpg, "--width", str(w), "--height", str(h),
                "--steps", str(I2V_STEPS), "--sample_num", "2", "--output_dir", out_dir]
        log("i2v a: python -m yume_tpu_torch.sample " + " ".join(argv[:-2]))
        zero_counts()
        t0 = time.perf_counter()
        rc = sample.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(rc == 0, f"i2v cli: sample.main returned {rc}")
        check_counts("i2v cli", 2 * 2 * I2V_STEPS)
        calls = rec.take()
        forwards = steps.take(quiet=True)
        by_call = {}
        for c in calls:
            by_call.setdefault(c["call"], []).append(c)
        videos = [c["shape"] for c in by_call["decode_auto"]]
        require(videos == [[1, I2V_FRAMES, h, w, 3], [1, I2V_NEXT_FRAMES, h, w, 3]],
                f"i2v cli: decoded videos {videos}")
        fwd_ms = [round(c["s"] * 1e3, 1) for c in forwards]
        require(len(fwd_ms) == 2 * 2 * I2V_STEPS and
                all(c["shape"] == [1, I2V_LFZ, I2V_H, I2V_W, 16] for c in forwards),
                f"i2v cli: DiT forwards {[c['shape'] for c in forwards]}")
        files = _video_files(out_dir, ["segment_000.mp4", "segment_001.mp4"])
        summary = {k: [round(c["s"], 3) for c in v] for k, v in by_call.items()}
        peak = max(c["peak_gib"] for c in calls)
        log(f"  i2v cli: sample.main wall {wall:.3f} s; DiT forwards (ms), 4 at {I2V_L} "
            f"tokens then 4 at {I2V_L_NEXT}: {fwd_ms}; calls (s) {summary}; peak device "
            f"memory {peak:.2f} GiB; files {files}")
        out["cli"] = {"wall_s": wall, "dit_forward_ms": fwd_ms, "calls_s": summary,
                      "peak_gib": peak, "files": files,
                      "decode_peak_gib": [round(c["peak_gib"], 2)
                                          for c in by_call["decode_auto"]]}
    finally:
        rec.restore()
        steps.restore()
    gc.collect()
    torch.cuda.empty_cache()
    require(torch.cuda.memory_allocated() < 2**30, "i2v cli: the CLI left memory allocated")

    # b. one bf16 and one W8A8 forward at 28,350 tokens; a profiled CFG step
    cfg = i2v_14b()
    t0 = time.perf_counter()
    pipe = I2VPipeline.from_config(cfg, device="cuda", seed=0, init_t5=False, init_clip=False)
    torch.cuda.synchronize()
    log(f"i2v b: random bf16 14B DiT and VAE in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in pipe.dit.parameters()) / 1e9:.3f}B DiT params; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    w8 = pipe.with_w8a8()
    x, t_frame, ctx, ctx_null, clip_ctx = _i2v_forward_inputs(cfg)

    def forward(dit, context=ctx):
        return dit(x, t_frame, context, latent_frame_zero=I2V_LFZ, clip_context=clip_ctx)

    res = {}
    with torch.no_grad():
        for name, dit, extra in (("bf16", pipe.dit, {}),
                                 ("w8a8", w8.dit, {"q8_dot": I2V_W8A8_PER_FORWARD})):
            forward(dit)    # warm-up (the W8A8 one quantizes the weights)
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res[name] = forward(dit)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check_counts(f"i2v {name} forward", 1, **extra)
            require(torch.isfinite(res[name]).all().item(), f"i2v {name} forward: not finite")
            out[f"{name}_forward_ms"] = ms
            log(f"  i2v {name} forward at {I2V_L} tokens: {ms:.1f} ms, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        rel = ((res["w8a8"].float() - res["bf16"].float()).norm()
               / res["bf16"].float().norm()).item()
        out["w8a8_rel_l2"] = rel
        # phase 6g's quantized trunks hold these weights (seed 0, the DiT drawn first)
        out["_bf16_forward"] = res["bf16"].float().cpu()
        log(f"  i2v w8a8 forward: relative L2 from the bf16 forward {rel:.4e}  tol "
            f"{T2V_W8A8_REL_TOL:.0e}")
        require(rel <= T2V_W8A8_REL_TOL,
                f"i2v w8a8 forward: relative L2 {rel} from bf16 exceeds {T2V_W8A8_REL_TOL}")
        del res
        out["cfg_step_trace"] = checked_trace(
            "14B CFG step (bf16 cond + uncond forwards)",
            lambda: (forward(pipe.dit), forward(pipe.dit, ctx_null)),
            _glue_launches({"adaln_norm": 2 * I2V_PER_FORWARD["adaln_norm"],
                            "qk_norm_rope": 2 * I2V_PER_FORWARD["qk_norm_rope"]}))
    del pipe, w8, x, ctx, ctx_null, clip_ctx
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 6f: the video-input mode and the data path, on a seeded clip of
# 37 frames of 1280×704 written with cv2's mp4v writer (the sample CLI reads
# its first 33; the trainer a random window of 33 at 352×640)
VIDEO_FRAMES, VIDEO_SIZE, VIDEO_READ = 37, (1280, 704), 33
# 33 frames are 9 latent frames: at 704×1280 the 5B's history, at 352×640
# the trainer's batch (1 history and 8 tail frames, 22×40)
VIDEO_LATENT_F = 9
# the 14B's history: the first frame 16 times, then the 33 frames (49 ≡ 1
# mod 4), and generate_next of 32 frames: 81 frames, 28,350 packed tokens
VIDEO_I2V_HISTORY = 49
OTHER_PATHS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "bias_act",
               "flash_attention_partial")


def _zero_counts(counters):
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0


def _read_counts(counters, out, path, needed=(), absent=(), exact=None):
    """The launch counts of ``path`` into ``out["launches"]``; fails when a
    kernel of ``needed`` did not launch, one of ``absent`` did, or one of
    ``exact`` launched another number of times."""
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    log(f"  kernel launches in the {path} run: {launches}")
    missing = [k for k in needed if launches[k] == 0]
    stray = [k for k in absent if launches[k]]
    wrong = {k: (launches[k], v) for k, v in (exact or {}).items() if launches[k] != v}
    require(not (missing or stray or wrong), f"{path}: kernels not launched {missing}, "
            f"launched {stray}, counted/expected {wrong}")
    out["launches"][path] = launches


def _random_head_init(train):
    """An ``init_params_`` for ``train.main`` that gives the DiT a random
    head: ``main`` starts from a zero head, which gives LoRA adapters a zero
    gradient; a random one (as phase 7's LoRA step) makes K8 and K9 run on a
    real upstream gradient and each step's grad norm positive."""
    real_init = train.init_params_

    def init(model, generator):
        real_init(model, generator)
        with torch.no_grad():
            head = model.head.head
            head.weight.normal_(0.0, head.weight.shape[1] ** -0.5, generator=generator)

    return init


def _write_clip(path, n_frames, size, seed):
    """A seeded moving pattern, [n_frames, H, W, 3] uint8, through cv2's
    mp4v writer (the card's host has no imageio)."""
    import cv2
    import numpy as np

    (w, h), rng = size, np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 16, (w, h))
    require(vw.isOpened(), f"cv2 cannot write {path}")
    for i in range(n_frames):
        f = np.stack([(xx // 4 + 5 * i) % 256, (yy // 3 + 3 * i) % 256,
                      ((xx + yy) // 8 + 7 * i) % 256], -1) + rng.integers(0, 8, (h, w, 3))
        vw.write(np.clip(f, 0, 255).astype(np.uint8))
    vw.release()


def video_phase(counters):
    """Phase 6f: the video-input mode and the data path at full width,
    after phase 6e's pipelines are freed, each path with the launch counts
    set to 0 just before it and read just after:
    a. the test tree ``<root>/Keys_W_Mouse_·/walk_frames_0-37.mp4`` (a
       seeded 37-frame 1280×704 clip, cv2's mp4v writer), its ``.txt``
       controls and a camera ``.npy``; which reader decodes it (the native
       libavcodec decoder built from ``native/*.cpp``, or OpenCV) and the
       decode time of 33 frames;
    b. ``sample.main --video_root_dir <root> --steps 4 --sample_num 2 --w8a8
       --teacache`` (Yume-5B, random bf16 weights): the streaming
       ``encode_auto`` of the 33 frames, two W8A8 + adaptive TeaCache
       segments and their tail decodes; K1–K6 must launch;
    c. ``sample.main --config i2v-14B --input_video <clip> --width 960
       --height 544 --steps 2 --sample_num 1``: the first frame 16 times
       before the 33 frames, one ``generate_next`` of 32 frames (81 frames,
       28,350 packed tokens) with CFG, exactly 4 forwards and
       ``I2V_PER_FORWARD`` launches each; the history encode, the forwards
       and the decode with the peak;
    d. ``train.main --data_dir <root> --lora_rank 16 --remat
       --max_train_steps 3 --num_frames 33 --height 352 --width 640``
       (random encoders, and a random head so that the adapters get a
       gradient): each step's host wait for its batch, the batch's device
       encode and the train step; finite losses, gradient norms finite and
       above 0; K1–K5, K8 and K9 launch, K6, K7 and K10 do not;
    e. ``python -m yume_tpu_torch.data.preprocess --data_dir <root>
       --max_samples 1`` (its ``main``): ``LatentDataset`` reads back the
       latents, the context and the mask it wrote, bit for bit.
    Returns each path's launches and figures."""
    import shutil

    import numpy as np

    from yume_tpu_torch import sample, train
    from yume_tpu_torch.data import dataset, native, preprocess
    from yume_tpu_torch.data.latent_dataset import LatentDataset
    from yume_tpu_torch.models.dit import WanDiT, packed_token_count
    from yume_tpu_torch.models.vae import WanVAE
    from yume_tpu_torch.pipelines.i2v import I2VPipeline
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"video: {left:.2f} GiB left allocated after the i2v phase")
    require(left < 1.0, "the i2v phase left memory allocated")
    root = os.path.join(REPO, "build", "video")
    shutil.rmtree(root, ignore_errors=True)
    clips = os.path.join(root, "clips")
    base = os.path.join(clips, "Keys_W_Mouse_·", f"walk_frames_0-{VIDEO_FRAMES}")
    os.makedirs(os.path.dirname(base))
    out = {"launches": {}}

    def zero_counts():
        _zero_counts(counters)

    def read_counts(path, needed=(), absent=OTHER_PATHS, exact=None):
        _read_counts(counters, out, path, needed, absent, exact)

    # a. the tree and its reader
    t0 = time.perf_counter()
    _write_clip(base + ".mp4", VIDEO_FRAMES, VIDEO_SIZE, seed=7)
    with open(base + ".txt", "w", encoding="utf-8") as f:
        f.write(f"Start Frame: 0\nEnd Frame: {VIDEO_FRAMES}\nKeys: W\nMouse: ·\n")
    c2w = np.tile(np.eye(4), (VIDEO_FRAMES, 1, 1))
    c2w[:, 2, 3] = 0.05 * np.arange(VIDEO_FRAMES)
    np.save(base + ".npy", c2w)
    write_s = time.perf_counter() - t0
    decoder = native.decoder()
    t0 = time.perf_counter()
    frames = dataset.read_video_frames(base + ".mp4", list(range(VIDEO_READ)),
                                       size=VIDEO_SIZE[::-1])
    decode_s = time.perf_counter() - t0
    require(frames.shape == (VIDEO_READ, VIDEO_SIZE[1], VIDEO_SIZE[0], 3)
            and np.isfinite(frames).all() and np.abs(frames).max() <= 1.0,
            f"video a: read {frames.shape}")
    out["tree"] = {"reader": dataset.last_reader, "decoder": decoder, "write_s": write_s,
                   "decode_s": decode_s, "mp4_bytes": os.path.getsize(base + ".mp4"),
                   "video_length": dataset.video_length(base + ".mp4")}
    log(f"video a: a {VIDEO_FRAMES}-frame {VIDEO_SIZE[0]}x{VIDEO_SIZE[1]} clip written by "
        f"cv2 (mp4v) in {write_s:.3f} s; decoder: {decoder}; {VIDEO_READ} frames read by "
        f"{dataset.last_reader} in {decode_s:.3f} s; video_length "
        f"{out['tree']['video_length']}")
    require(out["tree"]["video_length"] == VIDEO_FRAMES, "video a: video_length")
    del frames

    # b. the 5B video mode
    rec = _Recorder(TI2VPipeline, ("encode_auto", "generate_segment", "decode_auto",
                                   "encode_text"))
    steps = _Recorder(WanDiT, ("forward",))
    out5 = os.path.join(root, "cli5b")
    argv = ["--video_root_dir", clips, "--steps", str(SERVING_STEPS), "--sample_num", "2",
            "--w8a8", "--teacache", "--output_dir", out5]
    log("video b: python -m yume_tpu_torch.sample " + " ".join(argv[:-2]))
    try:
        zero_counts()
        t0 = time.perf_counter()
        rc = sample.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(rc == 0, f"video 5b: sample.main returned {rc}")
        read_counts("video 5b", needed=SERVING_KERNELS + ("q8_dot",))
        calls = rec.take()
        fwd_ms = [round(c["s"] * 1e3, 1) for c in steps.take(quiet=True)]
    finally:
        rec.restore()
        steps.restore()
    enc = [c for c in calls if c["call"] == "encode_auto"]
    require(len(enc) == 1 and enc[0]["shape"] == [1, VIDEO_LATENT_F, 44, 80, 48],
            f"video 5b: encode_auto calls {enc}")
    segs = [c for c in calls if c["call"] == "generate_segment"]
    decs = [c for c in calls if c["call"] == "decode_auto"]
    require([c["shape"][1] for c in segs] == [VIDEO_LATENT_F + 8, VIDEO_LATENT_F + 16]
            and [c["shape"][1] for c in decs] == [29, 29], "video 5b: segments or decodes")
    # the packed shapes phase 3 holds K1–K6 at
    seg_l = tuple(packed_token_count(c["shape"][1] - 8, 8, 44, 80, (1, 2, 2)) for c in segs)
    require(seg_l == VIDEO_5B_L, f"video 5b: segments at {seg_l} packed tokens, phase 3 "
            f"checks {VIDEO_5B_L}")
    files = _video_files(out5, ["video000_seg000.mp4", "video000_seg001.mp4"])
    out["5b"] = {"wall_s": wall, "encode_s": enc[0]["s"], "encode_peak_gib": enc[0]["peak_gib"],
                 "segment_s": [c["s"] for c in segs], "decode_s": [c["s"] for c in decs],
                 "peak_gib": max(c["peak_gib"] for c in calls), "dit_forward_ms": fwd_ms,
                 "files": files}
    log(f"  video 5b: sample.main wall {wall:.3f} s; encode_auto of {VIDEO_READ} frames "
        f"(streaming) {enc[0]['s']:.3f} s, peak {enc[0]['peak_gib']:.2f} GiB; segments "
        f"{[round(c['s'], 3) for c in segs]} s; tail decodes "
        f"{[round(c['s'], 3) for c in decs]} s; DiT forwards (ms) {fwd_ms}; files {files}")
    gc.collect()
    torch.cuda.empty_cache()
    require(torch.cuda.memory_allocated() < 2**30, "video 5b: the CLI left memory allocated")

    # c. the 14B video mode
    (w, h) = I2V_SIZE
    rec = _Recorder(I2VPipeline, ("encode_text", "clip_features", "make_conditioning",
                                  "generate", "decode_auto"))
    steps = _Recorder(WanDiT, ("forward",))
    out14 = os.path.join(root, "cli14b")
    argv = ["--config", "i2v-14B", "--input_video", base + ".mp4", "--width", str(w),
            "--height", str(h), "--steps", str(I2V_STEPS), "--sample_num", "1",
            "--output_dir", out14]
    log("video c: python -m yume_tpu_torch.sample " + " ".join(argv[:-2]))
    n_fwd = 2 * I2V_STEPS
    try:
        zero_counts()
        t0 = time.perf_counter()
        rc = sample.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(rc == 0, f"video 14b: sample.main returned {rc}")
        read_counts("video 14b", exact={k: v * n_fwd for k, v in I2V_PER_FORWARD.items()})
        calls = rec.take()
        forwards = steps.take(quiet=True)
    finally:
        rec.restore()
        steps.restore()
    by_call = {}
    for c in calls:
        by_call.setdefault(c["call"], []).append(c)
    require(len(forwards) == n_fwd and all(c["shape"] == [1, I2V_LFZ, I2V_H, I2V_W, 16]
                                           for c in forwards),
            f"video 14b: DiT forwards {[c['shape'] for c in forwards]}")
    require([c["shape"] for c in by_call["decode_auto"]] == [[1, I2V_FRAMES, h, w, 3]],
            f"video 14b: decoded {[c['shape'] for c in by_call['decode_auto']]}")
    cond = by_call["make_conditioning"][0]
    files = _video_files(out14, ["video000_seg000.mp4"])
    fwd_ms = [round(c["s"] * 1e3, 1) for c in forwards]
    out["14b"] = {"wall_s": wall, "history_frames": VIDEO_I2V_HISTORY, "packed_tokens": I2V_L,
                  "dit_forward_ms": fwd_ms, "history_encode_s": cond["s"],
                  "history_encode_peak_gib": cond["peak_gib"],
                  "decode_s": by_call["decode_auto"][0]["s"],
                  "decode_peak_gib": by_call["decode_auto"][0]["peak_gib"],
                  "peak_gib": max(c["peak_gib"] for c in calls), "files": files,
                  "calls_s": {k: [round(c["s"], 3) for c in v] for k, v in by_call.items()}}
    log(f"  video 14b: sample.main wall {wall:.3f} s; history of {VIDEO_I2V_HISTORY} frames "
        f"(the first 16 times, then {VIDEO_READ}); {n_fwd} forwards at {I2V_L} packed tokens "
        f"(ms) {fwd_ms}; history encode {cond['s']:.3f} s (peak {cond['peak_gib']:.2f} GiB); "
        f"decode of {I2V_FRAMES} frames {out['14b']['decode_s']:.3f} s (peak "
        f"{out['14b']['decode_peak_gib']:.2f} GiB); peak {out['14b']['peak_gib']:.2f} GiB; "
        f"calls (s) {out['14b']['calls_s']}; files {files}")
    gc.collect()
    torch.cuda.empty_cache()
    require(torch.cuda.memory_allocated() < 2**30, "video 14b: the CLI left memory allocated")

    # d. the trainer on the tree: LoRA rank 16, random encoders
    tw, th = 640, 352
    argv = ["--data_dir", clips, "--lora_rank", "16", "--remat", "--max_train_steps", "3",
            "--num_frames", str(VIDEO_READ), "--height", str(th), "--width", str(tw),
            "--checkpointing_steps", "0", "--output_dir", os.path.join(root, "train")]
    log("video d: python -m yume_tpu_torch.train " + " ".join(argv[:-2]))
    real_init, init_random_head = train.init_params_, _random_head_init(train)
    real_encode, batches = WanVAE.encode, []

    def encode(self, video):
        z = real_encode(self, video)
        batches.append(tuple(z.shape))
        return z

    train.init_params_, WanVAE.encode = init_random_head, encode
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train.main(argv)
        wall = time.perf_counter() - t0
        read_counts("video train", needed=("flash_attention", "adaln_norm", "adaln_residual",
                                           "qk_norm_rope", "rms_norm",
                                           "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
                    absent=("q8_dot", "flash_attention_partial", "bias_act"))
    finally:
        train.init_params_, WanVAE.encode = real_init, real_encode
    run = train.main.last_run
    require(all(map(math.isfinite, run["losses"])) and len(run["grad_norms"]) == 3
            and all(math.isfinite(g) and g > 0 for g in run["grad_norms"]),
            f"video train: losses {run['losses']}, grad norms {run['grad_norms']}")
    # the packed shape phase 3 holds K1–K5, K8 and K9 at
    train_l = {packed_token_count(s[1] - 8, 8, s[2], s[3], (1, 2, 2)) for s in batches}
    require(len(batches) == 3 and train_l == {VIDEO_TRAIN_L},
            f"video train: batches {batches}, {train_l} packed tokens, phase 3 checks "
            f"{VIDEO_TRAIN_L}")
    split = [round(s - a - b, 4) for s, a, b in zip(run["step_times"], run["batch_wait_s"],
                                                     run["encode_s"])]
    out["train"] = {k: run[k] for k in ("losses", "grad_norms", "step_times", "batch_wait_s",
                                        "encode_s")}
    out["train"].update(train_step_s=split, wall_s=wall,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"  video train: step times {[round(t, 4) for t in run['step_times']]} s = host wait "
        f"{[round(t, 4) for t in run['batch_wait_s']]} + device encode "
        f"{[round(t, 4) for t in run['encode_s']]} + train step {split}; losses "
        f"{[round(x, 5) for x in run['losses']]}; grad norms {run['grad_norms']}; peak "
        f"{out['train']['peak_gib']:.2f} GiB; wall {wall:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # e. the preprocess CLI and LatentDataset
    made = {}
    real_encode, real_text = WanVAE.encode, TI2VPipeline.encode_text
    WanVAE.encode = lambda self, v: made.setdefault("latents", real_encode(self, v))
    TI2VPipeline.encode_text = lambda self, ids, mask: made.setdefault(
        "context", real_text(self, ids, mask))
    pre = os.path.join(root, "latents")
    argv = ["--data_dir", clips, "--output_dir", pre, "--max_samples", "1"]
    log("video e: python -m yume_tpu_torch.data.preprocess " + " ".join(argv))
    try:
        zero_counts()
        t0 = time.perf_counter()
        preprocess.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        WanVAE.encode, TI2VPipeline.encode_text = real_encode, real_text
    read_counts("video preprocess")
    item = LatentDataset(os.path.join(pre, "videos2caption.json"))[0]
    same = {k: bool(np.array_equal(item[k], made[k][0].float().cpu().numpy()))
            for k in ("latents", "context")}
    require(all(same.values()) and item["latents"].shape == (VIDEO_LATENT_F, 22, 40, 48),
            f"video preprocess: read back {same}, latents {item['latents'].shape}")
    out["preprocess"] = {"wall_s": wall, "latents": list(item["latents"].shape),
                         "context": list(item["context"].shape),
                         "mask_tokens": int(item["context_mask"].sum()), "bit_equal": same}
    log(f"  video preprocess: main wall {wall:.3f} s; LatentDataset read back latents "
        f"{list(item['latents'].shape)} and context {list(item['context'].shape)} bit for bit "
        f"({same})")
    del made, item
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 6g: the quantized DiT trunk and batched CFG
Q_STEPS = 4
# a W8A8 forward of a quantized trunk against the same trunk dequantized
# (the exact bf16 product), relative L2: W8A8's activation rounding alone,
# 3.58e-2 to 3.66e-2 against the bf16 trunk on the 14B (phase 6e)
Q_REL_TOL = 5e-2


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def quantized_phase(counters, bf16_ref):
    """Phase 6g: the quantized DiT trunk (``models/quantized.py``) and
    batched CFG at full width, after phase 6f's paths are freed, each path
    with the launch counts set to 0 just before it and read just after:
    a. ``sample.main --t2v --steps 4 --sample_num 2 --int8 --w8a8
       --teacache`` (Yume-5B, random bf16 weights): the trunk quantized at
       load (the drop in allocated memory, the stored bytes from
       ``quantized_bytes``), the t2v first segment and a TeaCache
       continuation on it (full and cached forward times), the peak; K1–K6
       launch and no weight is quantized while it runs;
    b. ``sample.main --jpg_dir <1280×704 PNG> --steps 4 --int4 --w8a8``: the
       same records for the int4 trunk (K6 on int8 relayed on each call);
    c. the webapp with ``--quant int4 --w8a8``: an i2v upload request
       quantizes the trunk and runs on it;
    d. ``sample.main --config i2v-14B --jpg_dir <960×544 PNG> --width 960
       --height 544 --steps 2 --int4 --w8a8 --memory_optimization``: the 14B
       trunk streamed block by block into int4 (the load's peak under the
       int4 trunk's bytes + two bf16 blocks + the non-block parameters + 1
       GiB), parked in the phase shuttle as ``dit_q``; the peak by phase,
       the 4 CFG forwards at 28,350 tokens, exactly ``I2V_PER_FORWARD`` and
       240 K6 launches each;
    e. the 14B trunk in int8 and in int4 (seed 0: the weights of phase 6e's
       bf16 DiT), one W8A8 forward each against the same trunk dequantized
       (at most ``Q_REL_TOL``) and against phase 6e's bf16 forward
       (reported); the int4 relay's and the context-side dequantization's
       share of a forward;
    f. one CFG Euler step on the int4 W8A8 trunk with ``cfg_parallel`` (one
       batch-2 forward) against two forwards, on d's umT5 contexts of the
       prompt and the negative prompt: both times; the batch-2 forward and
       the guided update equal to the two forwards' bit for bit, each
       operation of the forward batch-invariant (:func:`batch2_cause`), and
       what the exact products over the whole batch at once (as they ran
       before) make of both.
    Returns each path's launches and figures."""
    import base64
    import shutil

    import numpy as np
    from PIL import Image

    from yume_tpu_torch import sample
    from yume_tpu_torch.configs import i2v_14b
    from yume_tpu_torch.models import quantized as tq
    from yume_tpu_torch.models.dit import DiTBlock, WanDiT
    from yume_tpu_torch.ops import quant_matmul as qm
    from yume_tpu_torch.pipelines.i2v import I2VPipeline
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
    from yume_tpu_torch.serving import webapp
    from yume_tpu_torch.utils.offload import OffloadSlot

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"quantized: {left:.2f} GiB left allocated after the video phase")
    require(left < 1.0, "the video phase left memory allocated")
    root = os.path.join(REPO, "build", "quantized")
    shutil.rmtree(root, ignore_errors=True)
    pngs = {}
    for name, (w, h) in (("5b", T2V_SIZE), ("14b", I2V_SIZE)):
        os.makedirs(os.path.join(root, f"jpg{name}"))
        img = np.random.default_rng(9).integers(0, 256, (h, w, 3), dtype=np.uint8)
        pngs[name] = os.path.join(root, f"jpg{name}", "frame.png")
        Image.fromarray(img).save(pngs[name])
    out = {"launches": {}, "paths": {}}
    others = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "bias_act",
              "flash_attention_partial")

    def zero_counts():
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        return qm.quantize_weight.calls

    def read_counts(path, calls0, need=SERVING_KERNELS + ("q8_dot",)):
        launches = {c.__name__: c.launches for c in counters}
        log(f"  kernel launches in the {path} run: {launches}")
        missing = [k for k in need if launches[k] == 0]
        require(not missing, f"{path}: kernels not launched: {missing}")
        stray = [k for k in others if launches[k]]
        require(not stray, f"{path}: kernels of other paths launched: {stray}")
        quantized = qm.quantize_weight.calls - calls0
        require(quantized == 0, f"{path}: {quantized} weights quantized while it ran")
        out["launches"][path] = launches
        return launches

    def freed(path):
        gc.collect()
        torch.cuda.empty_cache()
        require(torch.cuda.memory_allocated() < 2**30, f"{path}: memory left allocated")

    # every DiT forward on a quantized trunk, timed, by kind
    dit_calls = []
    real_forward = WanDiT.forward

    def timed_forward(dit, x, *a, **kw):
        if not tq.is_quantized(dit):
            return real_forward(dit, x, *a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = real_forward(dit, x, *a, **kw)
        torch.cuda.synchronize()
        kind = ("cached" if kw.get("block_cache") is not None else
                "full" if kw.get("return_cache") else
                "unpacked" if kw.get("packed") is False else "packed")
        dit_calls.append((kind, x.shape[0], (time.perf_counter() - t0) * 1e3))
        return r

    def forward_ms():
        by_kind = {}
        for kind, b, ms in dit_calls:
            by_kind.setdefault(f"{kind} batch {b}", []).append(round(ms, 1))
        dit_calls.clear()
        return by_kind

    quant_events = []
    real_quantize = TI2VPipeline.quantize_int8

    def quantize_spy(self, bits=8):
        torch.cuda.synchronize()
        before, t0 = torch.cuda.memory_allocated(), time.perf_counter()
        real_quantize(self, bits)
        torch.cuda.synchronize()
        stored, bf16 = tq.quantized_bytes(self.dit)
        quant_events.append({"bits": bits, "s": time.perf_counter() - t0,
                             "freed_gib": (before - torch.cuda.memory_allocated()) / 2**30,
                             "stored_gib": stored / 2**30, "bf16_gib": bf16 / 2**30})

    real_host_blocks = tq.quantize_host_blocks
    loads = []

    def host_blocks_spy(*a, **kw):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dit = real_host_blocks(*a, **kw)
        torch.cuda.synchronize()
        loads.append({"s": time.perf_counter() - t0, "held_gib": held / 2**30,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "stored_gib": tq.quantized_bytes(dit)[0] / 2**30})
        return dit

    phase_peaks, phase_now = {}, ["load"]
    real_use = OffloadSlot.use

    def use_spy(slot, name):
        phase_peaks[phase_now[0]] = max(phase_peaks.get(phase_now[0], 0.0),
                                        torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        phase_now[0] = name
        return real_use(slot, name)

    # the 14B CLI run's text contexts, the prompt's and the negative prompt's
    contexts = []
    real_sample_cfg = I2VPipeline._sample_cfg

    def sample_cfg_spy(self, noise, y, ctx, ctx_null, *a, **kw):
        contexts.append((ctx.cpu(), ctx_null.cpu()))
        return real_sample_cfg(self, noise, y, ctx, ctx_null, *a, **kw)

    WanDiT.forward = timed_forward
    I2VPipeline._sample_cfg = sample_cfg_spy
    TI2VPipeline.quantize_int8 = quantize_spy
    tq.quantize_host_blocks = host_blocks_spy
    OffloadSlot.use = use_spy
    try:
        # a, b: the 5B CLI on an int8 and an int4 trunk
        for path, argv, files in (
                ("5b int8 w8a8 teacache",
                 ["--t2v", "--steps", str(Q_STEPS), "--sample_num", "2", "--int8", "--w8a8",
                  "--teacache"], ["segment_000.mp4", "segment_001.mp4"]),
                ("5b int4 w8a8", ["--jpg_dir", os.path.dirname(pngs["5b"]), "--steps",
                                  str(Q_STEPS), "--int4", "--w8a8"], ["segment_000.mp4"])):
            log(f"quantized {path}: python -m yume_tpu_torch.sample " + " ".join(argv))
            out_dir = os.path.join(root, path.replace(" ", "_"))
            quant_events.clear()
            calls0 = zero_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = sample.main(argv + ["--output_dir", out_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            require(rc == 0, f"{path}: sample.main returned {rc}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            read_counts(path, calls0)
            require(len(quant_events) == 1, f"{path}: quantize_int8 calls {quant_events}")
            ev = quant_events[0]
            # the projections' bf16 bytes less their codes and scales leave the device
            want_freed = ev["bf16_gib"] - ev["stored_gib"]
            require(ev["freed_gib"] >= 0.98 * want_freed,
                    f"{path}: quantize_int8 freed {ev['freed_gib']:.2f} GiB, the bf16 trunk "
                    f"less the stored one is {want_freed:.2f} GiB")
            fwd = forward_ms()
            written = _video_files(out_dir, files)
            log(f"  {path}: wall {wall:.3f} s; quantize_int8 {ev['s']:.3f} s freed "
                f"{ev['freed_gib']:.2f} GiB (bf16 {ev['bf16_gib']:.2f} GiB, stored "
                f"{ev['stored_gib']:.2f} GiB); DiT forwards (ms) {fwd}; peak {peak:.2f} GiB; "
                f"files {written}")
            out["paths"][path] = {"wall_s": wall, "quantize": ev, "dit_forward_ms": fwd,
                                  "peak_gib": peak, "files": written}
            freed(path)

        # c: the webapp, --quant int4 --w8a8, one i2v upload
        log("quantized c: python -m yume_tpu_torch.serving.webapp --quant int4 --w8a8")
        args = webapp.build_argparser().parse_args(
            ["--quant", "int4", "--w8a8", "--output_dir", os.path.join(root, "web")])
        app = webapp.WebApp(args)
        try:
            app.load_models()
            with open(pngs["5b"], "rb") as f:
                upload = base64.b64encode(f.read()).decode()
            quant_events.clear()
            calls0 = zero_counts()
            t0 = time.perf_counter()
            app._generate({"mode": "i2v", "image_b64": upload, "steps": Q_STEPS, "seed": 2})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            require(app.status == "done", f"webapp --quant int4: {app.status} {app.progress}")
            read_counts("webapp quant int4", calls0)
            require(app.pipe.dit.quant_bits == 4 and len(quant_events) == 1,
                    f"webapp --quant int4: {quant_events}")
            files = [(os.path.relpath(f, REPO), os.path.getsize(f)) for f in app.outputs]
            require(len(files) == 1 and files[0][1] > 0, f"webapp --quant int4: {files}")
            fwd = forward_ms()
            log(f"  webapp --quant int4: request wall {wall:.3f} s (quantize "
                f"{quant_events[0]['s']:.3f} s), DiT forwards (ms) {fwd}, files {files}")
            out["paths"]["webapp quant int4"] = {"wall_s": wall, "quantize": quant_events[0],
                                                 "dit_forward_ms": fwd, "files": files}
        finally:
            app.close()
        del app
        freed("webapp quant int4")

        # d: the 14B CLI, int4 trunk streamed in, the phase shuttle
        cfg = i2v_14b()
        meta = WanDiT(cfg.dit, torch.bfloat16, device="meta")
        block_gib = sum(p.numel() for p in DiTBlock(cfg.dit, device="meta").parameters())
        block_gib *= 2 / 2**30
        other_gib = sum(p.numel() for n, p in meta.named_parameters()
                        if not n.startswith("blocks.")) * 2 / 2**30
        del meta
        (w, h) = I2V_SIZE
        argv = ["--config", "i2v-14B", "--jpg_dir", os.path.dirname(pngs["14b"]), "--width",
                str(w), "--height", str(h), "--steps", str(I2V_STEPS), "--int4", "--w8a8",
                "--memory_optimization"]
        path = "14b int4 w8a8 memory_optimization"
        log(f"quantized d: python -m yume_tpu_torch.sample " + " ".join(argv))
        out_dir = os.path.join(root, "14b")
        loads.clear()
        phase_peaks.clear()
        phase_now[0] = "load"
        calls0 = zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = sample.main(argv + ["--output_dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(rc == 0, f"{path}: sample.main returned {rc}")
        phase_peaks[phase_now[0]] = max(phase_peaks.get(phase_now[0], 0.0),
                                        torch.cuda.max_memory_allocated() / 2**30)
        launches = read_counts(path, calls0)
        want = {k: v * 2 * I2V_STEPS for k, v in I2V_PER_FORWARD.items()}
        want["q8_dot"] = I2V_W8A8_PER_FORWARD * 2 * I2V_STEPS
        wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
        require(not wrong, f"{path}: launches (counted, expected) {wrong}")
        require(len(loads) == 1, f"{path}: quantize_host_blocks calls {loads}")
        load = loads[0]
        bound = load["stored_gib"] + 2 * block_gib + other_gib + 1.0
        require(load["peak_gib"] <= bound,
                f"{path}: the streamed load peaked at {load['peak_gib']:.2f} GiB, over the "
                f"int4 trunk + two bf16 blocks + the rest + 1 GiB = {bound:.2f} GiB")
        fwd = forward_ms()
        n_fwd = sum(len(v) for v in fwd.values())
        require(n_fwd == 2 * I2V_STEPS, f"{path}: DiT forwards {fwd}")
        written = _video_files(out_dir, ["segment_000.mp4"])
        log(f"  {path}: wall {wall:.3f} s; load {load['s']:.3f} s, peak "
            f"{load['peak_gib']:.2f} GiB (bound {bound:.2f}: int4 trunk "
            f"{load['stored_gib']:.2f} + 2 bf16 blocks {2 * block_gib:.2f} + the rest "
            f"{other_gib:.2f} + 1); peaks by phase (GiB) "
            f"{ {k: round(v, 2) for k, v in phase_peaks.items()} }; DiT forwards (ms) {fwd}; "
            f"files {written}")
        out["paths"][path] = {"wall_s": wall, "load": load, "load_bound_gib": bound,
                              "block_bf16_gib": block_gib, "non_block_gib": other_gib,
                              "phase_peak_gib": dict(phase_peaks), "dit_forward_ms": fwd,
                              "files": written}
        freed(path)
    finally:
        WanDiT.forward = real_forward
        I2VPipeline._sample_cfg = real_sample_cfg
        TI2VPipeline.quantize_int8 = real_quantize
        tq.quantize_host_blocks = real_host_blocks
        OffloadSlot.use = real_use
    require(contexts, "the 14B CLI run made no CFG segment")
    out["forwards"] = quantized_forwards(counters, bf16_ref, contexts[0])
    return out


def _batch_ops() -> dict:
    """The operations of a DiT forward that reduce across elements, and so
    could round otherwise at batch 2 than at batch 1, each as (module,
    attribute) where the forward looks it up: kernels K1–K6, the exact
    products (cuBLAS) and the patch embedding (cuDNN). The rest of a
    forward is elementwise or row-wise PyTorch."""
    from yume_tpu_torch.models import dit as dit_mod
    from yume_tpu_torch.ops import fused_adaln as fa
    from yume_tpu_torch.ops import quant_matmul as qm

    return {"K1 attention": (dit_mod, "attention"), "K2 adaln_norm": (fa, "adaln_norm"),
            "K3 adaln_residual": (fa, "adaln_residual"),
            "K4 qk_norm_rope": (fa, "qk_norm_rope"), "K5 rms_norm": (fa, "rms_norm"),
            "K6 q8_dot": (qm, "q8_dot"), "exact products (_dense)": (dit_mod, "_dense"),
            "patch embedding (F.conv3d)": (F, "conv3d")}


def _one_at_a_time(fn):
    """``fn`` called once a sample and the results joined along the batch:
    the batch is the leading dim of its first argument of three or more
    dims, and every tensor argument of two or more dims that leads with it
    is sliced. The wrapper carries ``fn``'s launch count, so that the
    kernel's own count is left as it was."""
    @functools.wraps(fn)
    def run(*a, **kw):
        big = [t for t in a if torch.is_tensor(t) and t.dim() >= 3]
        b = big[0].shape[0] if big else 1
        if b == 1:
            return fn(*a, **kw)

        def pick(t, i):
            return t[i:i + 1] if torch.is_tensor(t) and t.dim() >= 2 and t.shape[0] == b else t

        outs = [fn(*(pick(t, i) for t in a), **{k: pick(v, i) for k, v in kw.items()})
                for i in range(b)]
        return tuple(map(torch.cat, zip(*outs))) if isinstance(outs[0], tuple) else torch.cat(outs)
    return run


def _whole_batch(dense):
    """``models/dit.py::_dense`` as it ran before it went one sample at a
    time: one ``F.linear`` over the batch as it comes."""
    from yume_tpu_torch.models.dit import QLinear

    def run(x, layer, dtype):
        w = layer.dequant(dtype) if isinstance(layer, QLinear) else layer.weight.to(dtype)
        return F.linear(x.to(dtype), w, None if layer.bias is None else layer.bias.to(dtype))
    return run


def _patched(ops: dict, wrap: dict, fn):
    """``fn()`` with each operation ``name`` of ``ops`` (:func:`_batch_ops`)
    replaced by ``wrap[name](operation)``."""
    saved = {n: getattr(*ops[n]) for n in wrap}
    for n, f in saved.items():
        setattr(*ops[n], wrap[n](f))
    try:
        return fn()
    finally:
        for n, f in saved.items():
            setattr(*ops[n], f)


def batch2_cause(trunk, x2, t2, ctx2, clip2) -> dict:
    """Whether a batch-2 forward of ``trunk`` gives each sample the bits of
    its own batch-1 forward, and which operation broke that before. The
    forward cut to block 0 (the embeddings, one block and the head, each
    operation at its full shape) with every operation of
    :func:`_batch_ops` but one run one sample at a time: the one left
    batched must not change the bits. Then the cut and the whole forward as
    they run, and with the exact products over the whole batch at once.
    Returns the max abs gaps from the batch-1 forwards."""
    ops, blocks = _batch_ops(), trunk.blocks
    apart = dict.fromkeys(ops, _one_at_a_time)

    def forward(n=slice(None)):
        return trunk(x2[n], t2[n], ctx2[n], latent_frame_zero=I2V_LFZ, clip_context=clip2[n])

    def gaps(n_blocks, runs):
        trunk.blocks = blocks[:n_blocks]
        try:
            want = torch.cat([forward(slice(0, 1)), forward(slice(1, 2))]).float()
            return {k: (_patched(ops, wrap, forward).float() - want).abs().max().item()
                    for k, wrap in runs.items()}
        finally:
            trunk.blocks = blocks

    alone = gaps(1, {n: {o: w for o, w in apart.items() if o != n} for n in ops})
    runs = {"batched": {}, "products over the whole batch":
            {"exact products (_dense)": _whole_batch}}
    return {"one_batched": alone, "block 0": gaps(1, runs), "forward": gaps(len(blocks), runs)}


def quantized_forwards(counters, bf16_ref, contexts) -> dict:
    """Phase 6g e and f (see :func:`quantized_phase`): full-width 14B
    forwards on int8 and int4 trunks of phase 6e's weights, the relay's
    share, and one batched CFG step against two forwards on ``contexts``,
    the 14B CLI run's umT5 contexts of its prompt and negative prompt."""
    from yume_tpu_torch.configs import i2v_14b
    from yume_tpu_torch.models import quantized as tq
    from yume_tpu_torch.ops import quant_matmul as qm
    from yume_tpu_torch.pipelines.i2v import I2VPipeline

    def zero_counts():
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()

    cfg = i2v_14b()
    cfg_w8 = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, w8a8=True))
    x, t_frame, ctx, ctx_null, clip_ctx = _i2v_forward_inputs(cfg)
    ref = bf16_ref.cuda()

    @torch.no_grad()
    def forward(dit):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = dit(x, t_frame, ctx, latent_frame_zero=I2V_LFZ, clip_context=clip_ctx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        require(torch.isfinite(r).all().item(), "quantized forward: not finite")
        return r, ms, {c.__name__: c.launches for c in counters}

    fwd_out = {}
    for bits in (8, 4):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trunk = tq.quantize_host_blocks(cfg_w8.dit, bits, seed=0, device="cuda",
                                        dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s, load_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
        stored = tq.quantized_bytes(trunk)[0] / 2**30
        # the same bits without W8A8: every projection dequantized, exact
        plain = tq.quantize_host_blocks(cfg.dit, bits, seed=0, device="cuda",
                                        dtype=torch.bfloat16)
        forward(trunk)   # warm-up
        res = {}
        for name, dit, k6 in (("w8a8", trunk, I2V_W8A8_PER_FORWARD), ("dequantized", plain, 0)):
            r, ms, launches = forward(dit)
            want = dict(I2V_PER_FORWARD, q8_dot=k6)
            wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
            require(not wrong, f"int{bits} {name} forward: launches {wrong}")
            res[name] = (r, ms)
        del dit, r    # the loop's last trunk
        rel = _rel_l2(res["w8a8"][0], res["dequantized"][0])
        rel_bf16 = {k: _rel_l2(v[0], ref) for k, v in res.items()}
        entry = {"load_s": load_s, "load_peak_gib": load_peak, "stored_gib": stored,
                 "forward_ms": {k: v[1] for k, v in res.items()},
                 "w8a8_vs_dequantized_rel_l2": rel, "vs_bf16_rel_l2": rel_bf16}
        log(f"  int{bits} 14B trunk: streamed in {load_s:.2f} s (peak {load_peak:.2f} GiB, "
            f"stored {stored:.2f} GiB); W8A8 forward {res['w8a8'][1]:.1f} ms, dequantized "
            f"{res['dequantized'][1]:.1f} ms; relative L2 W8A8 vs dequantized {rel:.4e} "
            f"(tol {Q_REL_TOL:.0e}), vs phase 6e's bf16 forward {rel_bf16}")
        require(rel <= Q_REL_TOL, f"int{bits} W8A8 forward: relative L2 {rel} from its "
                                  f"dequantized trunk exceeds {Q_REL_TOL}")
        del res, plain
        if bits == 4:
            entry.update(_relay_share(trunk, entry["forward_ms"]["w8a8"]))
            entry["cfg_parallel_step"] = _cfg_parallel_step(
                counters, I2VPipeline(cfg_w8, trunk, None), clip_ctx, contexts)
        fwd_out[f"int{bits}"] = entry
        del trunk
        gc.collect()
        torch.cuda.empty_cache()
    del x, ctx, ctx_null, clip_ctx, ref
    gc.collect()
    torch.cuda.empty_cache()
    return fwd_out


def _relay_share(trunk, forward_ms: float) -> dict:
    """The int4 relay and the context-side dequantization of one 14B layer,
    and their share of a W8A8 forward of ``forward_ms``."""
    from yume_tpu_torch.ops import quant_matmul as qm

    b = trunk.blocks[0]
    relayed = (b.self_attn.qkv, b.self_attn.o, b.cross_attn.q, b.cross_attn.o, b.ffn[0],
               b.ffn[2])
    exact = (b.cross_attn.k, b.cross_attn.v, b.cross_attn.k_img, b.cross_attn.v_img)
    relay_ms = median_ms(lambda: [qm.q4_to_q8(l.stored) for l in relayed], reps=5)
    deq_ms = median_ms(lambda: [l.dequant(torch.bfloat16) for l in exact], reps=5)
    out = {"relay_ms_per_layer": relay_ms, "dequant_ms_per_layer": deq_ms,
           "relay_share": 40 * relay_ms / forward_ms, "dequant_share": 40 * deq_ms / forward_ms}
    log(f"  int4 relay a layer {relay_ms:.3f} ms ({out['relay_share']:.1%} of a W8A8 "
        f"forward), context-side dequantization {deq_ms:.3f} ms ({out['dequant_share']:.1%})")
    return out


@torch.no_grad()
def _cfg_parallel_step(counters, pipe, clip_ctx, contexts) -> dict:
    """Phase 6g f: one CFG Euler step on ``pipe``'s trunk, batched against
    two forwards, on the CLI's umT5 contexts of the prompt and the negative
    prompt: the forwards' and the guided update's bits (:func:`batch2_cause`
    for the forwards, with the exact products over the whole batch too),
    and both times."""
    ops = _batch_ops()
    gen = torch.Generator(device="cuda").manual_seed(7)
    f_lat = I2V_F_HIST + I2V_LFZ
    noise = torch.randn((1, f_lat, I2V_H, I2V_W, 16), generator=gen, device="cuda")
    y = torch.randn((1, f_lat, I2V_H, I2V_W, 20), generator=gen, device="cuda")
    cond, null = (c.cuda() for c in contexts)
    lat0 = pipe._latent0(y, noise)
    x2 = torch.cat([lat0, y], dim=-1).to(torch.bfloat16).repeat(2, 1, 1, 1, 1)
    t2 = torch.full((2, f_lat), 1000.0, device="cuda")
    cause = batch2_cause(pipe.dit, x2, t2, torch.cat([cond, null]), clip_ctx.repeat(2, 1, 1))
    del x2
    step = {}
    for kind, batched, wrap in (("two forwards", False, {}), ("batched", True, {}),
                                ("batched, products over the whole batch", True,
                                 {"exact products (_dense)": _whole_batch})):
        pipe.cfg_parallel = batched
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = _patched(ops, wrap, lambda: pipe._sample_cfg(noise, y, cond, null, clip_ctx, 1,
                                                           3.0, 5.0))
        torch.cuda.synchronize()
        step[kind] = (lat[:, -I2V_LFZ:] - lat0[:, -I2V_LFZ:],
                      (time.perf_counter() - t0) * 1e3, counters[0].launches)
    upd = step["two forwards"][0]
    update = {k: {"max_abs": (v[0] - upd).abs().max().item(), "rel_l2": _rel_l2(v[0], upd)}
              for k, v in step.items() if k != "two forwards"}
    # K1 launches a forward whatever its batch: one forward, or two
    k1 = {k: v[2] for k, v in step.items()}
    n_k1 = I2V_PER_FORWARD["flash_attention"]
    log(f"  batch 2 against batch 1, max abs gap of the forward cut to block 0 with only "
        f"this operation batched {cause['one_batched']}; cut to block 0 {cause['block 0']}; "
        f"the whole forward {cause['forward']}")
    log(f"  14B CFG Euler step on the int4 W8A8 trunk, the CLI's prompt against its "
        f"negative prompt: two forwards {step['two forwards'][1]:.1f} ms, one batch-2 "
        f"forward {step['batched'][1]:.1f} ms; the guided update from the two forwards' "
        f"{update}")
    require(k1 == {"two forwards": 2 * n_k1, "batched": n_k1,
                   "batched, products over the whole batch": n_k1},
            f"cfg_parallel step: K1 launches {k1}")
    require(not any(cause["one_batched"].values()) and cause["block 0"]["batched"] == 0
            and cause["forward"]["batched"] == 0,
            f"cfg_parallel: a batch-2 forward is not two batch-1 forwards bit for bit: {cause}")
    require(update["batched"]["max_abs"] == 0,
            f"cfg_parallel: the guided update is not two forwards' bit for bit: {update}")
    return {"two_forwards_ms": step["two forwards"][1], "batched_ms": step["batched"][1],
            "whole_batch_products_ms": step["batched, products over the whole batch"][1],
            "update": update, "batch2": cause}


# kernel families of a device trace, by kernel name (first match wins)
KERNEL_FAMILIES = [
    ("K1 flash fwd", ("flash_fwd_kernel",)),
    ("K8 dQ", ("flash_bwd_dq_kernel",)),
    ("K9 dK dV", ("flash_bwd_dkv_kernel",)),
    ("K2 adaln_norm", ("adaln_norm_staged", "adaln_norm_rows")),
    ("K3 K5 Triton glue", ("adaln_residual_kernel", "rms_norm_kernel")),
    ("K4 qk_norm_rope", ("qk_norm_rope_",)),
    ("K6 W8A8", ("q8_gemm_kernel", "quantize_rows_kernel")),
    ("K10 bias_act", ("bias_act_kernel",)),
    ("conv", ("conv", "cudnn")),
    ("GEMM", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
]


TRAIN_RANGES = ("loss_and_grads", "optimizer", "ema")  # training/train_step.py
# training/distill.py; every backward runs on autograd's own thread
DISTILL_RANGES = ("generator_forward", "discriminator_update", "generator_gan_term",
                  "generator_backward", "optimizer", "ema", "backward passes")


def device_breakdown(what: str, fn, ranges_named=TRAIN_RANGES,
                     rest: str = "loss_and_grads") -> dict:
    """Run ``fn`` once under torch.profiler and log its device time by
    kernel family, by the step's named ranges and its ten longest
    kernels. Per range: the kernels launched inside it (the backward runs
    on autograd's own thread, so ``rest``, the loss and gradient part of a
    train step, is what the other ranges leave) and the span on the device
    from its first to its last kernel, idle gaps included. Times in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    families = dict.fromkeys([name for name, _ in KERNEL_FAMILIES] + ["other"], 0.0)
    launched = dict.fromkeys(families, 0)
    copies = [0, 0.0]  # copy kernels (counted in "other"): launches, ms
    ranges, spans, kernels = {}, {}, []
    for e in prof.key_averages():
        if e.key in ranges_named:
            if e.device_type == DeviceType.CUDA:
                spans[e.key] = _event_ms(e)
            elif e.key != rest:
                ranges[e.key] = _event_ms(e, total=True)
        elif e.device_type == DeviceType.CUDA:
            fam = next((n for n, keys in KERNEL_FAMILIES if any(k in e.key for k in keys)),
                       "other")
            families[fam] += _event_ms(e)
            launched[fam] += e.count
            if "copy" in e.key.lower():
                copies[0] += e.count
                copies[1] += _event_ms(e)
            kernels.append((_event_ms(e), e.count, e.key[:90]))
        elif e.key in ("optimizer", "ema"):
            ranges[e.key] = _event_ms(e, total=True)
    busy = sum(families.values())
    log(f"  trace of one {what}: wall {wall:.1f} ms under the profiler, device busy "
        f"{busy:.1f} ms ({100 * busy / wall:.1f}%)")
    log("    by family: " + ", ".join(f"{k} {v:.1f} ms ({100 * v / busy:.1f}%) x{launched[k]}"
                                      for k, v in families.items()))
    log(f"    copy kernels (in other): x{copies[0]}, {copies[1]:.2f} ms")
    ranges[rest] = busy - sum(ranges.values())
    log("    kernels by range: " + ", ".join(f"{k} {v:.1f} ms" for k, v in ranges.items()))
    log("    device span by range: " + ", ".join(f"{k} {v:.1f} ms" for k, v in spans.items()))
    for ms, count, name in sorted(kernels, reverse=True)[:10]:
        log(f"    {ms:9.2f} ms  x{count:<6d} {name}")
    return {"wall_ms": wall, "busy_ms": busy, "families_ms": families, "ranges_ms": ranges,
            "spans_ms": spans, "launches": launched, "copy_kernels": copies[0],
            "copy_ms": copies[1]}


def _glue_launches(counted: dict) -> dict:
    """The K2 and K4 launches a trace must show: the counters'."""
    return {"K2 adaln_norm": counted["adaln_norm"], "K4 qk_norm_rope": counted["qk_norm_rope"]}


def checked_trace(what: str, fn, want: dict) -> dict:
    """:func:`device_breakdown` of one DiT forward whose kernel families
    must show ``want`` launches ({family: n}, the counters': a trace that
    shows them all proves the counters count every kernel the forward
    runs). CUPTI can lose kernel records: in one H100 run a traced t2v step
    read 47% busy, half its K1 time and one K2 missing while the counters
    were right. So a trace that disagrees is logged and taken again after
    ``CUPTI_BURST_S``, at most three times in all; three disagreeing traces
    fail the run."""
    for attempt in range(1, 4):
        trace = device_breakdown(what, fn, ranges_named=(), rest="dit_forward")
        wrong = {f: (trace["launches"][f], n) for f, n in want.items()
                 if trace["launches"][f] != n}
        if not wrong:
            return trace
        log(f"  {what}: trace {attempt} of 3 shows (traced, counted) {wrong}")
        if attempt < 3:
            time.sleep(CUPTI_BURST_S)
    require(False, f"{what}: three traces disagree with the counters: {wrong}")


def count_syncs(fn) -> int:
    """Run ``fn`` once with CUDA sync debugging on and count the calls that
    synchronised the host with the card (torch.cuda.set_sync_debug_mode)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def train_phase(counters):
    """The 5B trainer at full width and its geometry (2,805 packed tokens),
    random bf16 parameters, per-block remat. Three paths, each with the
    launch counts set to 0 just before it and read just after:
    a. the full fine-tune: ``make_train_step`` with clipped AdamW and EMA,
       1 warm-up and 3 timed steps (the model carries the MVDT side block,
       whose parameters get zero gradients here);
    b. one MVDT step on the same model and state at mask ratio 0.30;
    d. ADD distillation on the same model and state (:func:`distill_path`),
       then one LoRA rank-16 step on that model (``make_lora_train_step``),
       whose random head gives the adapters a gradient that is not zero;
    c. LoRA rank 16 through the entry point ``train.main`` (its own fp32
       parameters, 3 steps), after the model of a., b. and d. is freed;
    then ``train.main --smoke`` and ``--smoke --Distil`` on the card. Every
    loss and gradient norm must be finite; K1–K5, K8 and K9 must launch,
    K6 must not, and K10 only in d. (60 times a step)."""
    from yume_tpu_torch import train
    from yume_tpu_torch.configs import ti2v_5b
    from yume_tpu_torch.models.dit import WanDiT, packed_token_count
    from yume_tpu_torch.ops import bias_act as ba
    from yume_tpu_torch.ops import quant_matmul as qm
    from yume_tpu_torch.ops.flash_attention import flash_attention_partial as fl_partial
    from yume_tpu_torch.pipelines.ti2v import _random_init_
    from yume_tpu_torch.training.lora import LoRAModel, init_lora, make_lora_train_step
    from yume_tpu_torch.training.train_step import (TrainConfig, draw_step, init_train_state,
                                                    make_train_step, trainable_params)

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"train: {left:.2f} GiB left allocated after the pipeline phase")
    require(left < 1.0, "the pipeline phase left memory allocated")
    cfg = dataclasses.replace(ti2v_5b().dit, mvdt=True)
    require(packed_token_count(TRAIN_F_HIST, TRAIN_LFZ, TRAIN_H, TRAIN_W, cfg.patch_size)
            == TRAIN_L, "trainer token count")
    gen = torch.Generator(device="cuda").manual_seed(6)
    t0 = time.perf_counter()
    model = WanDiT(cfg, torch.bfloat16, device="meta", param_dtype=torch.bfloat16,
                   remat=True).to_empty(device="cuda")
    _random_init_(model, gen)
    tc = TrainConfig(latent_frame_zero=TRAIN_LFZ)
    state = init_train_state(trainable_params(model), tc)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  5B DiT (+ MVDT side block) {n_params / 1e9:.3f}B bf16 params, AdamW state and "
        f"EMA in {time.perf_counter() - t0:.1f} s: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    f = TRAIN_F_HIST + TRAIN_LFZ

    def batch(step):
        g = torch.Generator(device="cuda").manual_seed(100 + step)
        return {"latents": torch.randn((1, f, TRAIN_H, TRAIN_W, cfg.in_dim), generator=g,
                                       device="cuda"),
                "context": torch.randn((1, TEXT_LEN, cfg.text_dim), generator=g,
                                       device="cuda") * 0.02}

    def run(path, step_fn, st, n_steps, masked=False, k10_per_step=0):
        """``n_steps`` steps with the counts set to 0 just before and read
        just after; K10 must launch ``k10_per_step`` times a step."""
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times, losses, norms = [], [], []
        extra = {"gan_loss": [], "d_loss": []}
        for i in range(n_steps):
            b = batch(i)
            draws = draw_step(b, tc, torch.Generator(device="cuda").manual_seed(200 + i),
                              masked=masked)
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, metrics = step_fn(st, b, draws)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            for k in extra:
                if k in metrics:
                    extra[k].append(metrics[k].item())
            times.append(time.perf_counter() - t)
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        extra = {k + "es": v for k, v in extra.items() if v}
        log(f"  {path}: step times {[round(t, 4) for t in times]} s, losses "
            f"{[round(x, 5) for x in losses]}, grad norms {[round(x, 4) for x in norms]}, "
            + "".join(f"{k} {[round(x, 5) for x in v]}, " for k, v in extra.items())
            + f"peak device memory {peak:.2f} GiB")
        log(f"  kernel launches in the {path} run: {launches}")
        finite = losses + norms + [x for v in extra.values() for x in v]
        require(all(map(math.isfinite, finite)), f"{path}: non-finite loss or norm")
        missing = [c.__name__ for c in counters if c not in (qm.q8_dot, ba.bias_act, fl_partial)
                   and not c.launches]
        require(not missing, f"kernels not launched on the {path} path: {missing}")
        require(qm.q8_dot.launches == 0 and fl_partial.launches == 0,
                f"{path}: the W8A8 kernel or K7 launched in training")
        require(ba.bias_act.launches == k10_per_step * n_steps,
                f"{path}: K10 launched {ba.bias_act.launches} times in {n_steps} steps, "
                f"not {k10_per_step} a step")
        return {"step_s": times, "losses": losses, "grad_norms": norms, "peak_gib": peak,
                "launches": launches, **extra}

    runs = {}
    full_step = make_train_step(model, tc)
    runs["full"] = run("5B AdamW full fine-tune (remat)", full_step, state, 4)
    runs["full"]["median_step_s"] = statistics.median(runs["full"]["step_s"][1:])
    log(f"  full fine-tune: median step {runs['full']['median_step_s']:.4f} s (steps 2-4)")
    b = batch(4)
    draws = draw_step(b, tc, torch.Generator(device="cuda").manual_seed(204))
    trace = device_breakdown("full fine-tune step", lambda: full_step(state, b, draws))
    # the kernels' time hardly changes under the profiler, the host's does:
    # the unprofiled step's idle share is its median wall less that busy time
    trace["idle_share_unprofiled"] = 1.0 - trace["busy_ms"] / (
        runs["full"]["median_step_s"] * 1e3)
    trace["syncs_per_step"] = count_syncs(lambda: full_step(state, b, draws))
    log(f"  unprofiled idle share {trace['idle_share_unprofiled']:.3f} (median step less "
        f"{trace['busy_ms']:.1f} ms of kernels); host-device synchronisations in one "
        f"step: {trace['syncs_per_step']}")
    runs["full"]["trace"] = trace
    tc_m = dataclasses.replace(tc, mvdt=True)
    runs["mvdt"] = run(f"5B MVDT step (keep {TRAIN_KEEP} of {TRAIN_L})",
                       make_train_step(model, tc_m, mvdt_keep=TRAIN_KEEP), state, 1,
                       masked=True)
    runs["distill"] = distill_path(model, tc, state, run, batch)
    # one LoRA step on this model: its head is random, so the adapters'
    # gradient is not zero (train.main below starts from a zero head)
    del state, full_step
    gc.collect()
    torch.cuda.empty_cache()
    lora_model = LoRAModel(model, init_lora(model, rank=16, generator=gen))
    runs["lora_random_head"] = run(
        "LoRA rank 16 step on the random-head model", make_lora_train_step(lora_model, tc),
        init_train_state(lora_model.adapters, tc), 1)
    require(runs["lora_random_head"]["grad_norms"][0] > 0, "LoRA: zero adapter gradient")
    del model, lora_model, b, draws
    gc.collect()
    torch.cuda.empty_cache()

    out_dir = os.path.join(REPO, "build", "train_smoke")
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train.main(["--lora_rank", "16", "--remat", "--max_train_steps", "3",
                "--checkpointing_steps", "0", "--output_dir", os.path.join(out_dir, "lora")])
    lora = dict(train.main.last_run, launches={c.__name__: c.launches for c in counters},
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                wall_s=time.perf_counter() - t0)
    lora["median_step_s"] = statistics.median(lora["step_times"][1:])
    log(f"  LoRA rank 16 through train.main (fp32 base, bf16 compute, remat): "
        f"{lora['trainable']:,} trainable params, step times "
        f"{[round(t, 4) for t in lora['step_times']]} s, losses "
        f"{[round(x, 5) for x in lora['losses']]}, grad norms {lora['grad_norms']}, "
        f"peak device memory {lora['peak_gib']:.2f} GiB, wall {lora['wall_s']:.1f} s")
    log(f"  kernel launches in the LoRA run: {lora['launches']}")
    require(all(map(math.isfinite, lora["losses"] + lora["grad_norms"])),
            "LoRA: non-finite loss or norm")
    others = ("q8_dot", "bias_act", "flash_attention_partial")
    missing = [k for k, n in lora["launches"].items() if k not in others and not n]
    require(not missing and not any(lora["launches"][k] for k in others),
            f"LoRA: kernels not launched {missing}, or one of {others} launched")
    runs["lora"] = lora
    gc.collect()
    torch.cuda.empty_cache()

    for flags in ([], ["--Distil"]):
        train.main(["--smoke", "--max_train_steps", "2", "--checkpointing_steps", "0",
                    "--output_dir", os.path.join(out_dir, "smoke"), *flags])
        smoke = train.main.last_run
        gan = {k: smoke[k] for k in ("gan_losses", "d_losses") if k in smoke}
        log(f"  train.main --smoke {' '.join(flags)} on the card: losses {smoke['losses']}, "
            f"grad norms {smoke['grad_norms']}" + "".join(f", {k} {v}" for k, v in gan.items()))
        values = smoke["losses"] + smoke["grad_norms"] + [x for v in gan.values() for x in v]
        require(all(map(math.isfinite, values)) and len(gan) == (2 if flags else 0),
                f"smoke {flags}: non-finite loss or norm")
    return runs


def distill_path(model, tc, state, run, batch) -> dict:
    """Phase 7d: ADD distillation (``make_distill_train_step``) on the
    trainer's 5B model and state, an fp32 discriminator with random weights
    (DINO frozen) over the 8 tail latent frames at 22×40: 1 warm-up and 2
    timed steps with the counts set to 0 just before and read just after
    (K10 60 times a step); DINO must not change. Then the discriminator's
    share of a step: one profiled step by range and kernel family, and its
    two parts alone (the hinge update: two passes forward and back and
    AdamW; the GAN term: a pass forward and its input gradient), timed by
    CUDA events."""
    from yume_tpu_torch.training.distill import (_disc_hinge_update, _frames, disc_optimizer,
                                                 generator_gan_term, init_disc_state,
                                                 make_distill_train_step)
    from yume_tpu_torch.training.train_step import draw_step

    d_opt = disc_optimizer()
    disc, disc_state = init_disc_state(d_opt, z_dim=model.cfg.out_dim, device="cuda",
                                       generator=torch.Generator(device="cuda").manual_seed(7))
    n_disc = sum(p.numel() for p in disc.parameters())
    dino0 = [p.detach().clone() for p in disc.dino.parameters()]
    step = make_distill_train_step(model, tc, disc, d_opt)

    def distill(st, b, draws):
        st, _, metrics = step(st, disc_state, b, draws)
        return st, metrics

    out = run(f"5B ADD distillation step ({n_disc / 1e6:.1f}M-param fp32 discriminator, "
              f"{TRAIN_LFZ} tail frames)", distill, state, 3,
              k10_per_step=K10_PER_DISTILL_STEP)
    out["median_step_s"] = statistics.median(out["step_s"][1:])
    require(all(torch.equal(p, q) for p, q in zip(disc.dino.parameters(), dino0)),
            "distill: the frozen DINO weights changed")
    b = batch(5)
    draws = draw_step(b, tc, torch.Generator(device="cuda").manual_seed(205))
    out["trace"] = device_breakdown("ADD distillation step", lambda: distill(state, b, draws),
                                    DISTILL_RANGES, "backward passes")
    out["syncs_per_step"] = count_syncs(lambda: distill(state, b, draws))
    real = _frames(b["latents"][:, -TRAIN_LFZ:].float())
    fake = real + 0.5 * torch.randn(real.shape, generator=torch.Generator(device="cuda")
                                    .manual_seed(8), device="cuda")

    def gan_term():
        dt = fake.detach().requires_grad_()
        torch.autograd.grad(generator_gan_term(disc, dt), dt)

    parts = {"d_update_ms": median_ms(lambda: _disc_hinge_update(disc, d_opt, disc_state,
                                                                  real, fake), reps=5),
             "gan_term_ms": median_ms(gan_term, reps=5)}
    parts["share_of_step"] = (parts["d_update_ms"] + parts["gan_term_ms"]) / (
        out["median_step_s"] * 1e3)
    out["discriminator"] = parts
    log(f"  distill: median step {out['median_step_s']:.4f} s (steps 2-3); discriminator alone: "
        f"hinge update {parts['d_update_ms']:.2f} ms, GAN term {parts['gan_term_ms']:.2f} ms, "
        f"{100 * parts['share_of_step']:.1f}% of the median step; host-device synchronisations "
        f"in one step: {out['syncs_per_step']}; DINO unchanged")
    del disc, disc_state, step, dino0, real, fake
    return out


# ---------------------------------------------------------------------------
# phase 7e: the i2v-14B trainer, checkpoint I/O, the training modules
# ---------------------------------------------------------------------------

# kernel launches of one 14B LoRA step under remat (40 blocks): the forward
# (K1 self + text + CLIP cross, K2 3 a block and the Head's, K3 2, K4 and K5
# 1 a block), remat's recompute of every block, and the backward of each
# attention (K8, K9); the glue kernels' gradients are plain PyTorch
I2V_TRAIN_PER_STEP = {"flash_attention": 240, "adaln_norm": 241, "adaln_residual": 160,
                      "qk_norm_rope": 80, "rms_norm": 80, "flash_attention_bwd_dq": 120,
                      "flash_attention_bwd_dkv": 120}
# the 14B LoRA rank-16 trainable count: 10 projections (q, k, v, o of both
# attentions, k_img, v_img) x 40 blocks x 16 x (5,120 + 5,120)
I2V_LORA_TRAINABLE = 10 * 40 * 16 * (5120 + 5120)


def train_14b_phase(counters) -> dict:
    """Phase 7e, after phase 7's trainer is freed; each path with the launch
    counts set to 0 just before it and read just after:
    a. ``train.main --config i2v-14B --lora_rank 16 --remat
       --max_train_steps 3 --checkpointing_steps 1`` on synthetic batches at
       12,060 packed tokens (a bf16 base, fp32 adapters, a random head so
       that the adapters get a gradient): step times, peak memory, the
       trainable count, finite losses, gradient norms above 0, exactly
       ``I2V_TRAIN_PER_STEP`` launches a step (K6, K7, K10 none), how long
       each async save held the loop, the three checkpoints left; then one
       more step of main's under the profiler (device time by kernel
       family and range, the unprofiled idle share);
    b. the same with ``--data_dir`` over a seeded 37-frame clip (phase 6f's,
       read as 37 frames of 352×640) and random encoders (umT5-XXL, CLIP
       ViT-H, the Wan2.1 VAE), 2 steps: each step's branch (i2v, then v2v
       at seed 42), packed tokens (10,120, 9,900) and host wait / encode /
       train step split;
    c. checkpoint I/O: an async ``Checkpointer`` against the blocking save on
       the 14B's rank-16 LoRA train state (parameters, EMA, two moments;
       four saves a simulated 2 s step apart; the newest three kept); a
       full-width 14B DiT cut to 2 blocks through ``export_dit_state_dict``,
       ``save_sharded_safetensors`` (its GB/s) and the strict ``--ckpt_dir``
       loader, bit for bit; ``train.main --smoke --config i2v-14B
       --export_torch_dir``, then ``--ckpt_dir`` from that export;
    d. ``train.main --smoke --config i2v-14B --MVDT --Distil`` (K10
       launches), ``teacher_rollout`` and ``ode_sample`` over the trainer's
       smoke 5B DiT, ``diff_augment`` on CUDA tensors (equal to the CPU's on the
       same draws)."""
    import shutil

    import numpy as np

    from yume_tpu_torch import train
    from yume_tpu_torch.configs import i2v_14b
    from yume_tpu_torch.data import diffaugment
    from yume_tpu_torch.diffusion.integrators import ode_sample
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
    from yume_tpu_torch.training import lora as lora_mod
    from yume_tpu_torch.training.distill import teacher_rollout
    from yume_tpu_torch.training.train_step import TrainConfig, init_train_state
    from yume_tpu_torch.utils.checkpoint import (Checkpointer, checkpoints,
                                                 export_dit_state_dict,
                                                 load_safetensors_state_dict, save_checkpoint,
                                                 save_sharded_safetensors)

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"train 14B: {left:.2f} GiB left allocated after the 5B train phase")
    require(left < 1.0, "the train phase left memory allocated")
    root = os.path.join(REPO, "build", "train_14b")
    shutil.rmtree(root, ignore_errors=True)
    out = {"launches": {}}

    def zero_counts():
        _zero_counts(counters)

    def read_counts(path, needed=(), absent=(), exact=None):
        _read_counts(counters, out, path, needed, absent, exact)

    def check_run(path, run, n_steps):
        require(len(run["losses"]) == n_steps
                and all(map(math.isfinite, run["losses"]))
                and all(math.isfinite(g) and g > 0 for g in run["grad_norms"]),
                f"{path}: losses {run['losses']}, grad norms {run['grad_norms']}")

    others = ("q8_dot", "flash_attention_partial", "bias_act")
    real_init = train.init_params_
    train.init_params_ = _random_head_init(train)
    try:
        # a. synthetic batches at 12,060 tokens
        a_dir = os.path.join(root, "a")
        argv = ["--config", "i2v-14B", "--lora_rank", "16", "--remat", "--max_train_steps",
                "3", "--checkpointing_steps", "1", "--output_dir", a_dir]
        log("train 14B a: python -m yume_tpu_torch.train " + " ".join(argv[:-2]))
        # keep main's step and its last arguments, for one profiled step after
        captured = {}

        def make_lora_step(lora_model, tc, **kw):
            step = real_make_lora_step(lora_model, tc, **kw)

            def recorded(*args):
                captured["args"] = args
                return step(*args)

            captured["step"] = recorded
            return recorded

        real_make_lora_step = lora_mod.make_lora_train_step
        lora_mod.make_lora_train_step = make_lora_step
        try:
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train.main(argv)
            wall = time.perf_counter() - t0
        finally:
            lora_mod.make_lora_train_step = real_make_lora_step
        read_counts("train 14B lora", exact={k: 3 * v for k, v in I2V_TRAIN_PER_STEP.items()},
                    absent=others)
        run = train.main.last_run
        check_run("train 14B a", run, 3)
        require(run["trainable"] == I2V_LORA_TRAINABLE,
                f"train 14B a: {run['trainable']} trainable, not {I2V_LORA_TRAINABLE}")
        kept = [os.path.basename(f) for f in checkpoints(a_dir)]
        require(kept == [f"checkpoint-{i}.pt" for i in (1, 2, 3)], f"train 14B a: kept {kept}")
        out["lora"] = {k: run[k] for k in ("losses", "grad_norms", "step_times", "trainable",
                                           "save_hold_s")}
        out["lora"].update(wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           median_step_s=statistics.median(run["step_times"][1:]),
                           checkpoint_bytes=os.path.getsize(checkpoints(a_dir)[-1]))
        log(f"  train 14B a (LoRA rank 16, bf16 base, remat, {I2V_TRAIN_L} tokens): "
            f"{run['trainable']:,} trainable params; step times "
            f"{[round(t, 4) for t in run['step_times']]} s (median of steps 2-3 "
            f"{out['lora']['median_step_s']:.4f} s); losses "
            f"{[round(x, 5) for x in run['losses']]}; grad norms {run['grad_norms']}; async "
            f"saves held the loop {[round(t, 4) for t in run['save_hold_s']]} s "
            f"({out['lora']['checkpoint_bytes'] / 1e9:.3f} GB a checkpoint; kept {kept}); "
            f"peak {out['lora']['peak_gib']:.2f} GiB; wall {wall:.1f} s")
        trace = device_breakdown(f"14B LoRA step (remat, {I2V_TRAIN_L} tokens)",
                                 lambda: captured["step"](*captured["args"]))
        # the kernels' time hardly changes under the profiler, the host's does
        trace["idle_share_unprofiled"] = 1.0 - trace["busy_ms"] / (
            out["lora"]["median_step_s"] * 1e3)
        log(f"  unprofiled idle share {trace['idle_share_unprofiled']:.3f} (median step less "
            f"{trace['busy_ms']:.1f} ms of kernels)")
        out["lora"]["trace"] = trace
        captured.clear()
        shutil.rmtree(a_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        # b. --data_dir over phase 6f's clip
        clips = os.path.join(REPO, "build", "video", "clips")
        base = os.path.join(clips, "Keys_W_Mouse_·", f"walk_frames_0-{VIDEO_FRAMES}")
        if not os.path.exists(base + ".mp4"):
            os.makedirs(os.path.dirname(base), exist_ok=True)
            _write_clip(base + ".mp4", VIDEO_FRAMES, VIDEO_SIZE, seed=7)
            with open(base + ".txt", "w", encoding="utf-8") as f:
                f.write(f"Start Frame: 0\nEnd Frame: {VIDEO_FRAMES}\nKeys: W\nMouse: ·\n")
        argv = ["--config", "i2v-14B", "--data_dir", clips, "--lora_rank", "16", "--remat",
                "--max_train_steps", "2", "--num_frames", str(I2V_DATA_FRAMES), "--height",
                "352", "--width", "640", "--checkpointing_steps", "0", "--output_dir",
                os.path.join(root, "b")]
        log("train 14B b: python -m yume_tpu_torch.train " + " ".join(argv[:-2]))
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train.main(argv)
        wall = time.perf_counter() - t0
        read_counts("train 14B data_dir", needed=tuple(I2V_TRAIN_PER_STEP), absent=others)
        run = train.main.last_run
        check_run("train 14B b", run, 2)
        require(run["branch"] == ["i2v", "v2v"] and run["packed_tokens"] == [
            I2V_DATA_L[b] for b in run["branch"]],
            f"train 14B b: branches {run['branch']}, packed tokens {run['packed_tokens']}")
        split = [round(s - a - b, 4) for s, a, b in zip(run["step_times"], run["batch_wait_s"],
                                                         run["encode_s"])]
        out["data_dir"] = {k: run[k] for k in ("losses", "grad_norms", "step_times",
                                               "batch_wait_s", "encode_s", "branch",
                                               "packed_tokens")}
        out["data_dir"].update(train_step_s=split, wall_s=wall,
                               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"  train 14B b: branches {run['branch']} at {run['packed_tokens']} packed tokens; "
            f"step times {[round(t, 4) for t in run['step_times']]} s = host wait "
            f"{[round(t, 4) for t in run['batch_wait_s']]} + device encode "
            f"{[round(t, 4) for t in run['encode_s']]} + train step {split}; losses "
            f"{[round(x, 5) for x in run['losses']]}; grad norms {run['grad_norms']}; peak "
            f"{out['data_dir']['peak_gib']:.2f} GiB; wall {wall:.1f} s")
    finally:
        train.init_params_ = real_init
    gc.collect()
    torch.cuda.empty_cache()
    require(torch.cuda.memory_allocated() < 2**30, "train 14B: the trainer left memory allocated")

    # c. checkpoint I/O: the save's hold, the export round trip
    gen = torch.Generator(device="cuda").manual_seed(16)
    adapters = {}
    for i in range(40):
        for name in ("self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
                     "cross_attn.q", "cross_attn.k", "cross_attn.v", "cross_attn.o",
                     "cross_attn.k_img", "cross_attn.v_img"):
            adapters[f"blocks.{i}.{name}.lora_a"] = _randn(gen, 16, I2V_DIM, dtype=torch.float32)
            adapters[f"blocks.{i}.{name}.lora_b"] = _randn(gen, I2V_DIM, 16, dtype=torch.float32)
    state = init_train_state(adapters, TrainConfig())
    state_bytes = 4 * nbytes(*adapters.values())
    ck, block = Checkpointer(os.path.join(root, "async")), []
    for step in range(1, 5):
        state.step = step
        torch.cuda.synchronize()
        ck.save(state)
        time.sleep(2.0)  # a 14B LoRA step, while the write runs
    t0 = time.perf_counter()
    ck.close()
    drain_s = time.perf_counter() - t0
    hold = ck.hold_s
    kept = [os.path.basename(f) for f in checkpoints(os.path.join(root, "async"))]
    require(kept == [f"checkpoint-{i}.pt" for i in (2, 3, 4)], f"train 14B c: kept {kept}")
    saved = torch.load(os.path.join(root, "async", "checkpoint-4.pt"), weights_only=True)
    require(all(torch.equal(saved["params"][k], t.cpu()) for k, t in adapters.items()),
            "train 14B c: the async checkpoint differs from the state")
    del saved
    for step in range(5, 7):
        state.step = step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(root, "blocking"), state)
        block.append(time.perf_counter() - t0)
    out["save"] = {"state_gb": state_bytes / 1e9, "async_hold_s": hold, "drain_s": drain_s,
                   "blocking_s": block, "kept": kept}
    log(f"train 14B c: the 14B LoRA rank-16 train state ({state_bytes / 1e9:.3f} GB on the "
        f"card): async saves held the caller {[round(t, 4) for t in hold]} s (a simulated "
        f"2 s step between them; the last write drained in {drain_s:.3f} s), blocking saves "
        f"{[round(t, 4) for t in block]} s; kept {kept}")
    del state, adapters, ck
    shutil.rmtree(os.path.join(root, "async"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "blocking"), ignore_errors=True)

    cfg2 = dataclasses.replace(i2v_14b().dit, num_layers=2)
    model = WanDiT(cfg2, torch.bfloat16, device="meta",
                   param_dtype=torch.float32).to_empty(device="cuda")
    train.init_params_(model, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = export_dit_state_dict(model.state_dict())
    export_s = time.perf_counter() - t0
    del model
    exp = os.path.join(root, "export2")
    t0 = time.perf_counter()
    n_bytes = save_sharded_safetensors(sd, exp)
    write_s = time.perf_counter() - t0
    fresh = WanDiT(cfg2, torch.bfloat16, device="meta",
                   param_dtype=torch.float32).to_empty(device="cuda")
    t0 = time.perf_counter()
    train.load_dit_checkpoint(fresh, exp)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    back = fresh.state_dict()
    same = set(back) == set(sd) and all(torch.equal(back[k].cpu(), v) for k, v in sd.items())
    require(same, "train 14B c: the 2-block export did not come back bit for bit")
    out["export"] = {"tensors": len(sd), "bytes": n_bytes, "export_s": export_s,
                     "write_s": write_s, "write_gb_s": n_bytes / write_s / 1e9,
                     "load_s": load_s, "bit_equal": same}
    log(f"  2-block full-width 14B DiT: {len(sd)} tensors, {n_bytes / 1e9:.3f} GB of fp32; "
        f"export to the host {export_s:.3f} s, the writer {write_s:.3f} s "
        f"({out['export']['write_gb_s']:.3f} GB/s), the strict --ckpt_dir load "
        f"{load_s:.3f} s; every tensor back bit for bit")
    del fresh, back, sd
    shutil.rmtree(exp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    smoke = ["--smoke", "--config", "i2v-14B", "--max_train_steps", "2",
             "--checkpointing_steps", "0"]
    first, second = os.path.join(root, "smoke_export"), os.path.join(root, "smoke_export2")
    train.main(smoke + ["--output_dir", os.path.join(root, "s1"), "--export_torch_dir", first])
    train.main(smoke + ["--output_dir", os.path.join(root, "s2"), "--ckpt_dir", first,
                        "--export_torch_dir", second])
    run = train.main.last_run
    names = [set(load_safetensors_state_dict(d)) for d in (first, second)]
    require(all(map(math.isfinite, run["losses"])) and names[0] == names[1]
            and run["export"]["tensors"] == len(names[0]),
            "train 14B c: --smoke --ckpt_dir --export_torch_dir")
    log(f"  train.main --smoke --config i2v-14B --export_torch_dir, then --ckpt_dir from it "
        f"and --export_torch_dir again on the card: losses {run['losses']}, "
        f"{run['export']['tensors']} tensors exported")

    # d. the other training modules at smoke size on the card
    zero_counts()
    train.main(smoke + ["--MVDT", "--Distil", "--output_dir", os.path.join(root, "s3")])
    read_counts("train 14B smoke distil", needed=("bias_act", "flash_attention_bwd_dq"))
    run = train.main.last_run
    require(all(map(math.isfinite, run["losses"] + run["gan_losses"] + run["d_losses"])),
            "train 14B d: --MVDT --Distil")
    # the trainer's smoke 5B (head dim 16; the sampler's smoke config has 32,
    # which K1 does not take)
    cfg = train.smoke_config(False)
    pipe = TI2VPipeline.from_config(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    ctx = _randn(gen, 1, cfg.dit.text_len, cfg.dit.text_dim, dtype=torch.float32)
    zero_counts()
    lat = teacher_rollout(pipe, ctx, pipe.dit, size=(64, 64), frame_num=5, steps=3)
    read_counts("teacher rollout", needed=("flash_attention",))
    f_lat = lat.shape[1]

    def velocity(x, sigma):
        t = (sigma[:, None] * 1000.0).expand(-1, f_lat)
        with torch.no_grad():
            return pipe.dit(x.to(torch.bfloat16), t, ctx, packed=False).float()

    noise = _randn(gen, *lat.shape, dtype=torch.float32)
    zero_counts()
    ode = ode_sample(velocity, noise, method="euler", steps=4)
    read_counts("ode_sample", needed=("flash_attention",))
    ode5 = ode_sample(lambda x, s: -x * s.reshape(-1, 1, 1, 1, 1), noise, method="dopri5")
    x = torch.rand((4, 64, 64, 3), generator=gen, device="cuda")
    draws = diffaugment.draw_augment(gen, tuple(x.shape))
    aug = diffaugment.diff_augment(x, draws)
    aug_cpu = diffaugment.diff_augment(x.cpu(), [{k: v.cpu() for k, v in d.items()}
                                                 for d in draws])
    aug_err = max_err(aug.cpu(), aug_cpu)
    finite = all(torch.isfinite(t).all().item() for t in (lat, ode, ode5, aug))
    require(finite and lat.shape == (1, 3, 8, 8, cfg.vae.z_dim) and aug_err <= 1e-6,
            f"train 14B d: rollout {tuple(lat.shape)}, finite {finite}, "
            f"diff_augment card vs CPU {aug_err}")
    out["modules"] = {"teacher_rollout": list(lat.shape), "ode_sample": list(ode.shape),
                      "diff_augment_max_abs_err_vs_cpu": aug_err}
    log(f"  train 14B d: --smoke --MVDT --Distil losses {run['losses']}; teacher_rollout "
        f"{list(lat.shape)}, ode_sample (Euler over the smoke DiT, dopri5 on a toy field) "
        f"finite; diff_augment on the card within {aug_err:.1e} of the CPU on the same draws")
    del pipe, lat, ode, ode5, x, aug
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# sequence-parallel serving: four ranks on the one card
# ---------------------------------------------------------------------------

SP_WORLD = 4
SP_KINDS = ("ulysses", "ring", "usp")
# relative L2 of a sharded 30-layer bf16 forward (or 2-step Euler segment)
# against the unsharded one: the same arithmetic but for the attention
# (all-to-all and K1 over the whole sequence, or K7 blocks merged in fp32),
# whose last-bit differences then propagate through 30 bf16 layers; as the
# 2-layer bf16-vs-fp32 reference (3e-2)
SP_REL_TOL = 3e-2
SP_EULER_STEPS, SP_TEACACHE_STEPS = 2, 12
SP_TIMEOUT_S = 600
# K7 launches per rank in one forward: 30 layers x 4 hops (ring sp 4) or
# x 2 hops x 2 runs (USP 2 x 2); a cached TeaCache step runs 14 layers
K7_PER_LAYER = {"ulysses": 0, "ring": SP_WORLD, "usp": SP_WORLD}


def _sp_rank_run(rank: int, world: int, init_file: str) -> dict:
    """One rank of the SP phase; see :func:`sp_phase`."""
    import datetime
    import hashlib

    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from yume_tpu_torch.configs import ti2v_5b
    from yume_tpu_torch.models.dit import WanDiT
    from yume_tpu_torch.ops import bias_act as ba
    from yume_tpu_torch.ops import fused_adaln as fa
    from yume_tpu_torch.ops import flash_attention as fl
    from yume_tpu_torch.ops import quant_matmul as qm
    from yume_tpu_torch.parallel.mesh import make_sp_groups, make_usp_groups
    from yume_tpu_torch.parallel.sp_forward import sp_dit_forward
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline, _random_init_

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=SP_TIMEOUT_S))
    sp = make_sp_groups(world)
    groups = {"ulysses": sp, "ring": sp, "usp": make_usp_groups(2, world // 2)}
    counters = [fl.flash_attention, fl.flash_attention_partial, fa.adaln_norm,
                fa.adaln_residual, fa.qk_norm_rope, fa.rms_norm, qm.q8_dot,
                fl.flash_attention_bwd_dq, fl.flash_attention_bwd_dkv, ba.bias_act]
    out = {"rank": rank, "times_s": {}, "launches": {}, "rel_l2": {}}

    def same_on_every_rank(what, value) -> bool:
        every = [None] * world
        dist.all_gather_object(every, value)
        same = all(x == every[0] for x in every)
        require(same, f"SP rank {rank}: {what} differs between ranks: {every}")
        return same

    def digest(t):
        return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()

    def run(path, fn, every_rank=True):
        """``fn()`` with the counts set to 0 just before and read just
        after, and its wall time; a path of every rank starts on all of
        them together."""
        if every_rank:
            dist.barrier()
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["times_s"][path] = time.perf_counter() - t0
        out["launches"][path] = {c.__name__: c.launches for c in counters}
        return res

    def rel_l2(got, want):
        return ((got.float() - want.float()).norm() / want.float().norm()).item()

    cfg = ti2v_5b()
    t0 = time.perf_counter()
    dit = WanDiT(cfg.dit, torch.bfloat16, device="meta", param_dtype=torch.bfloat16)
    dit = dit.to_empty(device="cuda")
    _random_init_(dit, torch.Generator(device="cuda").manual_seed(0))
    dit.eval()
    checksum = sum(p.float().sum(dtype=torch.float64).item() for p in dit.parameters())
    out["weights_checksum"] = checksum
    same_on_every_rank("the weights' checksum", checksum)
    out["times_s"]["init"] = time.perf_counter() - t0

    g = torch.Generator(device="cuda").manual_seed(2)
    history = torch.randn((1, 31, 44, 80, cfg.dit.in_dim), generator=g, device="cuda")
    tail = torch.randn((1, 8, 44, 80, cfg.dit.in_dim), generator=g, device="cuda")
    ctx = 0.1 * torch.randn((1, TEXT_LEN, cfg.dit.text_dim), generator=g, device="cuda")
    x = torch.cat([history, tail], 1).to(torch.bfloat16)
    t = torch.cat([torch.zeros(1, 31), torch.full((1, 8), 700.0)], 1).cuda()
    with torch.no_grad():
        ref = run("unsharded forward", lambda: dit(x, t, ctx), False) if rank == 0 else None
        for kind in SP_KINDS:
            v = run(f"{kind} forward", lambda: sp_dit_forward(dit, groups[kind], x, t, ctx,
                                                               latent_frame_zero=8, kind=kind))
            require(v.shape == (1, 8, 44, 80, cfg.dit.out_dim) and torch.isfinite(v).all().item(),
                    f"SP {kind} forward: shape {tuple(v.shape)} or non-finite")
            same_on_every_rank(f"the {kind} forward", digest(v))
            if rank == 0:
                out["rel_l2"][f"{kind} forward"] = rel_l2(v, ref)
        del ref, v

    pipe = TI2VPipeline(cfg, dit, None, sp_groups=groups["ring"], sp_kind="ring")
    seg = dict(seed=1, shift=7.0)
    lat = run("ring euler", lambda: pipe.generate_segment(history, ctx, steps=SP_EULER_STEPS,
                                                          **seg))
    require(torch.isfinite(lat).all().item() and torch.equal(lat[:, :31], history),
            "SP ring Euler: non-finite latents or history changed")
    same_on_every_rank("the ring Euler latents", digest(lat))
    if rank == 0:
        want = run("unsharded euler", lambda: dataclasses.replace(pipe, sp_groups=None)
                   .generate_segment(history, ctx, steps=SP_EULER_STEPS, **seg), False)
        out["rel_l2"]["ring euler"] = rel_l2(lat[:, 31:], want[:, 31:])
        del want
    del lat
    w8 = pipe.with_w8a8()
    lat = run("ring w8a8 adaptive teacache", lambda: w8.generate_segment(
        history, ctx, steps=SP_TEACACHE_STEPS, sampler="teacache",
        teacache_threshold=HEADLINE_THRESHOLD, **seg))
    require(torch.isfinite(lat).all().item(), "SP ring TeaCache: non-finite latents")
    out["n_full"] = w8.last_teacache_n_full
    same_on_every_rank("the ring TeaCache latents", digest(lat))
    same_on_every_rank("n_full", out["n_full"])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    dist.barrier()
    dist.destroy_process_group()
    return out


def sp_rank(rank: int, world: int, init_file: str, results):
    """Entry point of a spawned SP rank: its results, or its traceback,
    go to the parent through ``results``."""
    import traceback

    try:
        results.put((rank, "ok", _sp_rank_run(rank, world, init_file)))
    except BaseException:  # the parent reports it and fails the run
        results.put((rank, "error", traceback.format_exc()))
        raise


def sp_phase() -> dict:
    """Sequence-parallel serving at full 5B width on four ranks, four
    processes that time-share the one card and join a gloo group (NCCL
    refuses two ranks on one device), so their transfers go through host
    memory: the card checks the SP path's numerics and kernels, not its
    speed. Each rank builds the same random bf16 5B DiT (a checksum across
    ranks proves it), then, with the launch counts set to 0 before and read
    after each path:
    a. ``sp_dit_forward`` with Ulysses (sp 4), ring (sp 4) and USP (2 x 2)
       on 31 history + 8 tail frames at 44x80 (12,095 tokens), each within
       ``SP_REL_TOL`` of the unsharded forward on rank 0;
    b. ``generate_segment`` with ``sp_kind="ring"``: a 2-step Euler segment
       (against the unsharded one on rank 0), then W8A8 + adaptive TeaCache
       @0.1 over 12 steps.
    Every rank must return the same velocity and latents, bit for bit, and
    the same n_full. K7 must launch 120 times a forward on ring and USP,
    never on Ulysses."""
    import multiprocessing
    import queue

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"sp: {left:.2f} GiB left allocated in the parent; {SP_WORLD} ranks on one card "
        "over gloo (transfers through host memory; times are not SP speed)")
    require(left < 1.0, "the train phase left memory allocated")
    init_file = os.path.join(REPO, "build", f"sp_rendezvous_{os.getpid()}")
    os.makedirs(os.path.dirname(init_file), exist_ok=True)
    if os.path.exists(init_file):
        os.remove(init_file)
    ctx = multiprocessing.get_context("spawn")
    inbox = ctx.Queue()
    procs = [ctx.Process(target=sp_rank, args=(r, SP_WORLD, init_file, inbox))
             for r in range(SP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    ranks = {}
    try:
        while len(ranks) < SP_WORLD:
            left_s = SP_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                rank, status, payload = inbox.get(timeout=max(left_s, 1.0))
            except queue.Empty:
                require(False, f"SP ranks timed out after {SP_TIMEOUT_S} s")
            require(status == "ok", f"SP rank {rank} failed:\n{payload}")
            ranks[rank] = payload
        for p in procs:
            p.join(timeout=60)
        require(all(p.exitcode == 0 for p in procs),
                f"SP ranks exited {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(init_file):
            os.remove(init_file)
    wall = time.perf_counter() - t0

    r0 = ranks[0]
    log(f"  weights checksum {r0['weights_checksum']!r} on every rank; phase wall {wall:.1f} s")
    for kind in SP_KINDS:
        path = f"{kind} forward"
        rel = r0["rel_l2"][path]
        per_rank = [ranks[r]["launches"][path] for r in range(SP_WORLD)]
        k7 = {c["flash_attention_partial"] for c in per_rank}
        log(f"  {path}: relative L2 vs the unsharded forward {rel:.3e}  tol {SP_REL_TOL:.0e}  "
            f"{'ok' if rel <= SP_REL_TOL else 'FAIL'}; K7 launches per rank {sorted(k7)}, "
            f"rank 0 {per_rank[0]}")
        require(rel <= SP_REL_TOL, f"SP {path}: relative L2 {rel} exceeds {SP_REL_TOL}")
        require(k7 == {30 * K7_PER_LAYER[kind]}, f"SP {path}: K7 launches {k7}")
        require(all(c["flash_attention"] > 0 and c["q8_dot"] == 0 and c["bias_act"] == 0
                    for c in per_rank), f"SP {path}: K1 did not launch, or K6 or K10 did")
    rel = r0["rel_l2"]["ring euler"]
    log(f"  ring euler ({SP_EULER_STEPS} steps): tail relative L2 vs the unsharded segment "
        f"{rel:.3e}  tol {SP_REL_TOL:.0e}  {'ok' if rel <= SP_REL_TOL else 'FAIL'}; latents "
        f"identical on every rank")
    require(rel <= SP_REL_TOL, f"SP ring Euler: relative L2 {rel}")
    require(r0["launches"]["ring euler"]["flash_attention_partial"]
            == SP_EULER_STEPS * 30 * SP_WORLD, "SP ring Euler: K7 launches")
    n_full = r0["n_full"]
    tc = r0["launches"]["ring w8a8 adaptive teacache"]
    want_k7 = (n_full * 30 + (SP_TEACACHE_STEPS - n_full) * 14) * SP_WORLD
    log(f"  ring W8A8 + adaptive TeaCache @{HEADLINE_THRESHOLD}, {SP_TEACACHE_STEPS} steps: "
        f"n_full {n_full} on every rank, latents identical on every rank; launches {tc}")
    require(tc["flash_attention_partial"] == want_k7 and tc["q8_dot"] > 0
            and tc["bias_act"] == 0,
            f"SP ring TeaCache: K7 launches {tc['flash_attention_partial']} != {want_k7}, "
            f"or K6 did not launch, or K10 did")
    log("  per-rank wall times (s; four ranks time-share one card, transfers through host "
        "memory over gloo):")
    for r in range(SP_WORLD):
        log(f"    rank {r}: " + ", ".join(f"{k} {v:.3f}" for k, v in ranks[r]["times_s"].items())
            + f"; peak device memory {ranks[r]['peak_gib']:.2f} GiB")
    return {"wall_s": wall, "ranks": [ranks[r] for r in range(SP_WORLD)]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)
    # fp32 results are compared in phases 3 and 4: no TF32 there
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from yume_tpu_torch.ops import bias_act as ba
    from yume_tpu_torch.ops import fused_adaln as fa
    from yume_tpu_torch.ops import quant_matmul as qm
    from yume_tpu_torch.ops import flash_attention as fl
    from yume_tpu_torch.ops.flash_attention import flash_attention

    smi = device_phase()
    build_phase()
    meta = {
        "flash_attention": ("cuda", "yume_tpu_torch/csrc/flash_attention.cu",
                            "yume_tpu/ops/flash_attention.py:57"),
        "adaln_norm": ("cuda", "yume_tpu_torch/csrc/adaln_norm.cu",
                       "yume_tpu/ops/fused_adaln.py:94"),
        "adaln_residual": ("triton", "yume_tpu_torch/ops/fused_adaln.py",
                           "yume_tpu/ops/fused_adaln.py:251"),
        "qk_norm_rope": ("cuda", "yume_tpu_torch/csrc/qk_norm_rope.cu",
                         "yume_tpu/ops/fused_adaln.py:340"),
        "rms_norm": ("triton", "yume_tpu_torch/ops/fused_adaln.py",
                     "yume_tpu/ops/fused_adaln.py:193"),
        "quant_matmul": ("cuda", "yume_tpu_torch/csrc/quant_matmul.cu",
                         "yume_tpu/ops/quant_matmul.py:48"),
        "flash_attention_bwd_dq": ("cuda", "yume_tpu_torch/csrc/flash_attention_bwd.cu",
                                   "yume_tpu/ops/flash_attention.py:151"),
        "flash_attention_bwd_dkv": ("cuda", "yume_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "yume_tpu/ops/flash_attention.py:183"),
        # K7: K1's kernel launched per kv block by ring attention
        "flash_attention_partial": ("cuda", "yume_tpu_torch/csrc/flash_attention.cu",
                                    "yume_tpu/ops/flash_attention.py:393"),
        # K10: launched by _forward_pallas (:100, pl.pallas_call at :113)
        "bias_act": ("cuda", "yume_tpu_torch/csrc/bias_act.cu", "yume_tpu/ops/bias_act.py:88"),
    }
    results = {k: {"cases": []} for k in meta}
    log("kernels vs plain versions at the 5B segment shapes:")
    gen = torch.Generator(device="cuda").manual_seed(0)
    attention_and_glue_kernels(results, gen)
    i2v_kernels(results, gen)
    batch2_kernels(results, gen)
    video_kernels(results, gen)
    train_14b_kernels(results, gen)
    quant_matmul_kernel(results, gen)
    storage = {"block": block_quantization_check(gen),
               "relay": quantized_storage_kernels(results, gen)}
    flash_backward_kernels(results, gen)
    partial_attention_kernel(results, gen)
    bias_act_kernel(results, gen)
    torch.cuda.empty_cache()
    reference_phase()
    gradient_reference_phase()
    torch.cuda.empty_cache()
    # the quality gate and the pipeline run with PyTorch's default precision
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    quality_phase()
    torch.cuda.empty_cache()
    counters = [flash_attention, fa.adaln_norm, fa.adaln_residual, fa.qk_norm_rope,
                fa.rms_norm, qm.q8_dot, fl.flash_attention_bwd_dq, fl.flash_attention_bwd_dkv,
                fl.flash_attention_partial, ba.bias_act]
    launches, euler_launches, t2v_launches = pipeline_phase(counters)
    serving = serving_phase(counters)
    i2v = i2v_phase(counters)
    video = video_phase(counters)
    quantized = quantized_phase(counters, i2v.pop("_bf16_forward"))
    train_runs = train_phase(counters)
    train_launches = train_runs["full"]["launches"]
    train_14b = train_14b_phase(counters)
    sp = sp_phase()
    sp_launches = sp["ranks"][0]["launches"]
    counter_name = {"quant_matmul": "q8_dot"}

    kernels = []
    for name, (route, src, rep) in meta.items():
        r = results[name]
        # the headline numbers: K6 per 5B layer, the others their first case
        head = r.get("per_layer") or r["cases"][0]
        key = counter_name.get(name, name)
        backward = name.startswith("flash_attention_bwd")
        entry = {"name": name, "route": route, "source": src, "replaces": rep,
                 "max_abs_err": max(c["max_abs_err"] for c in r["cases"]),
                 "ms": head["ms"], "plain_ms": head["plain_ms"],
                 "bound_ms": head["bound_ms"],
                 "bound_by": r["cases"][0]["bound_by"],
                 "library_ms": head["library_ms"], "cases": r["cases"],
                 "launches_train_distill": train_runs["distill"]["launches"][key],
                 # phase 6c: the t2v first segment (4 Euler steps at 27,280
                 # tokens), its rollout, UniPC with CFG, one W8A8 forward
                 "launches_t2v_path": t2v_launches["t2v euler"][key],
                 **{f"launches_{p.replace(' ', '_')}": t2v_launches[p][key]
                    for p in ("t2v rollout", "t2v unipc cfg", "t2v w8a8 forward")},
                 # phase 6d: the serving entry points (the CLI's t2v run and
                 # image mode, the webapp's three requests)
                 **{f"launches_serving_{p.replace(' ', '_')}": n[key]
                    for p, n in serving["launches"].items()},
                 # phase 6e: the 14B CLI run (8 forwards), one bf16 and one
                 # W8A8 forward at 28,350 tokens
                 **{f"launches_{p.replace(' ', '_')}": n[key]
                    for p, n in i2v["launches"].items()},
                 # phase 6f: the 5B and 14B video modes, the trainer on the
                 # tree, the preprocess CLI
                 **{f"launches_{p.replace(' ', '_')}": n[key]
                    for p, n in video["launches"].items()},
                 # phase 6g: the quantized trunk's CLI runs and webapp request
                 **{f"launches_{p.replace(' ', '_')}": n[key]
                    for p, n in quantized["launches"].items()},
                 # phase 7e: the 14B trainer (3 LoRA steps; 2 on the data
                 # path), the smoke distillation and the training modules
                 **{f"launches_{p.replace(' ', '_')}": n[key]
                    for p, n in train_14b["launches"].items()}}
        if name == "flash_attention_partial":
            # K7's main path is the SP phase's ring forward (rank 0)
            entry.update(launches=sp_launches["ring forward"][key],
                         **{f"launches_sp_{p.replace(' ', '_')}": sp_launches[p][key]
                            for p in sp_launches if p != "unsharded forward"},
                         ring_invariant_max_abs_err=r["ring_invariant_max_abs_err"],
                         ring_invariant_lse_max_abs_err=r["ring_invariant_lse_max_abs_err"],
                         vjp=r["vjp"],
                         library="aten._scaled_dot_product_flash_attention, [B, N, L, D]")
            kernels.append(entry)
            continue
        # the backward kernels' main path is the train phase's, K10's the
        # distillation path's (3 steps); the others' the headline
        main_path = (train_runs["distill"]["launches"] if name == "bias_act" else
                     train_launches if backward else launches)
        entry.update({
            "launches": main_path[key],
            "launches_euler_path": euler_launches[key],
            "launches_train": train_launches[key],
            "launches_train_mvdt": train_runs["mvdt"]["launches"][key],
            "launches_train_lora": train_runs["lora"]["launches"][key],
            "launches_sp_ring_forward": sp_launches["ring forward"][key]})
        if name == "quant_matmul":
            entry["timed_as"] = ("per 5B layer: qkv + 3 x (3072->3072) + ffn.0 + ffn.2; "
                                 "ms by CUDA events around each call, device_ms from the "
                                 "profiler (pre-pass prepass_ms + GEMM gemm_ms); "
                                 "library_ms is torch._int_mm, the s8 x s8 -> s32 "
                                 "product alone")
            for key in ("device_ms", "prepass_ms", "gemm_ms", "prepass_bound_ms",
                        "library_device_ms", "bf16_matmul_ms", "bf16_matmul_device_ms",
                        "tops", "gemm_tops", "int_mm_tops", "bound_share"):
                entry[key] = head[key]
        if backward:
            entry["timed_as"] = ("plain_ms and library_ms (the backward of "
                                 "F.scaled_dot_product_attention) compute dq, dk and dv "
                                 "together; pair: K8 + K9 against a fused backward's "
                                 "5-product bound")
            entry["pair"] = results["flash_attention_bwd_dq"]["pair"]
        if name == "bias_act":
            entry["launches_per_distill_step"] = K10_PER_DISTILL_STEP
            # at the discriminator's size the events time the host's launch path;
            # the profiled distillation step gives the kernel's own device time
            entry["device_ms_per_launch_in_distill_trace"] = (
                train_runs["distill"]["trace"]["families_ms"]["K10 bias_act"]
                / K10_PER_DISTILL_STEP)
            entry["timed_as"] = ("the discriminator's call with a bias, which no single "
                                 "PyTorch call computes; F.leaky_relu(x, 0.2) times the "
                                 "no-bias case")
        kernels.append(entry)
    train = {k: {f: v for f, v in r.items() if f != "launches"} for k, r in train_runs.items()}
    log("serving: " + json.dumps(serving["paths"]))
    log("i2v: " + json.dumps({k: v for k, v in i2v.items() if k != "launches"}))
    log("video: " + json.dumps({k: v for k, v in video.items() if k != "launches"}))
    log("quantized storage (phase 3): " + json.dumps(storage))
    log("quantized: " + json.dumps({k: v for k, v in quantized.items() if k != "launches"}))
    log("train: " + json.dumps(train))
    log("train 14B: " + json.dumps({k: v for k, v in train_14b.items() if k != "launches"}))
    log("sp: " + json.dumps(sp))
    log(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
