"""Time K2 (``adaln_norm``), K4 (``qk_norm_rope``) and the headline's W8A8
DiT steps on one GPU, for the package of a given checkout:

    python3 scripts/torch_glue_step_time.py [--root DIR] [--steps N] [--label L]

``--root`` is the checkout whose ``yume_tpu_torch`` is imported (default:
this one), so two commits compare on one card by running this script once
per checkout, alternating (A, B, B, A). Measured, as chip_smoke.py phases 3
and 6b do:

* K2 at the 5B segment's shape, ``[1, 12095, 3072]`` bf16: the profiler's
  device time of the AdaLN call (two fp32 table rows, history and tail,
  picked by idx) and of the norm3 call (gate 0, one row, no idx) beside
  ``F.layer_norm`` on the same input, weight and bias;
* K4 at the 5B segment's shape, ``[1, 12095, 3072]`` bf16 q and k with the
  packed FramePack RoPE tables: the profiler's device time of the call on
  contiguous q and k, and of the W8A8 block's q/k path on a ``[1, 12095,
  9216]`` qkv output: its split views handed to K4, or, where the
  checkout's K4 refuses strided rows, copied out first as that checkout's
  DiT does (``qkv_path_copies``); and, as the practical floor of that
  traffic, a copy of the same bytes (q and k cloned: 297 MB read and
  written);
* the full-width Yume-5B DiT in W8A8 (random bf16 weights N(0, 0.02) from
  seed 0), a 31-frame history and 8 tail frames on the 44×80 latent grid
  (12,095 packed tokens), a random 512-token context: TeaCache's full
  step (blocks 7–22 stored) and cached step, two warm-ups and ``--steps``
  timed calls of each on the host's clock between two synchronisations;
  then one full and one cached step under the profiler: device busy, K2's
  and K4's kernels and the copy kernels (launches and ms).

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

L, N, D, DIM = 12095, 24, 128, 3072
TEXT_LEN = 512
# kernel names by family: the CUDA kernels, then the Triton ones before them
FAMILIES = {"k2": ("adaln_norm_staged", "adaln_norm_rows", "adaln_norm_kernel"),
            "k4": ("qk_norm_rope_", "rms_rope_kernel")}


def _trace(fn, reps: int = 1) -> dict:
    """Device time of ``reps`` calls of ``fn`` by kernel group (ms a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"busy_ms": 0.0}
    for group in (*FAMILIES, "copy"):
        out[f"{group}_ms"], out[f"{group}_launches"] = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = next(getattr(e, n) for n in ("self_device_time_total", "self_cuda_time_total")
                  if hasattr(e, n)) / 1e3 / reps
        out["busy_ms"] += ms
        group = next((g for g, names in FAMILIES.items() if any(k in e.key for k in names)),
                     "copy" if "copy" in e.key.lower() else None)
        if group:
            out[f"{group}_ms"] += ms
            out[f"{group}_launches"] += e.count // reps
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_glue_step_time: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import yume_tpu_torch
    from yume_tpu_torch.configs import ti2v_5b
    from yume_tpu_torch.models import dit as tdit
    from yume_tpu_torch.ops import fused_adaln as fa
    from yume_tpu_torch.ops import rope
    from yume_tpu_torch.pipelines.ti2v import _random_init_

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    res = {"label": args.label, "package": yume_tpu_torch.__file__, "card": smi}

    gen = torch.Generator(device="cuda").manual_seed(0)
    # K2 at the headline shape --------------------------------------------------
    x = torch.randn((1, L, DIM), generator=gen, device="cuda").to(torch.bfloat16)
    s_tab = 0.1 * torch.randn((1, 2, DIM), generator=gen, device="cuda")
    t_tab = 0.1 * torch.randn((1, 2, DIM), generator=gen, device="cuda")
    idx = (torch.arange(L, device="cuda") >= 5055).to(torch.int32)[None]  # 31 history frames
    w1 = 1.0 + 0.1 * torch.randn((1, 1, DIM), generator=gen, device="cuda")
    b1 = 0.1 * torch.randn((1, 1, DIM), generator=gen, device="cuda")
    w1_lib, b1_lib = w1.reshape(DIM).to(x.dtype), b1.reshape(DIM).to(x.dtype)
    res["k2_adaln"] = _trace(lambda: fa.adaln_norm(x, s_tab, t_tab, idx), reps=20)
    res["k2_norm3"] = _trace(lambda: fa.adaln_norm(x, w1, b1, None, gate=0.0), reps=20)
    res["layer_norm"] = _trace(lambda: F.layer_norm(x, (DIM,), w1_lib, b1_lib, eps=1e-6),
                               reps=20)
    del x

    # K4 at the headline shape --------------------------------------------------
    q = torch.randn((1, L, DIM), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((1, L, DIM), generator=gen, device="cuda").to(torch.bfloat16)
    qkv = torch.randn((1, L, 3 * DIM), generator=gen, device="cuda").to(torch.bfloat16)
    wq = 1.0 + 0.1 * torch.randn(DIM, generator=gen, device="cuda")
    wk = 1.0 + 0.1 * torch.randn(DIM, generator=gen, device="cuda")
    grids = tdit.packed_grids(tdit.framepack_plan(31), 44, 80, (1, 2, 2)) + [(8, 22, 40)]
    cos, sin = (torch.from_numpy(t).cuda() for t in rope.framepack_rope(grids, D))
    qv, kv, _ = qkv.split(DIM, -1)
    try:
        fa.qk_norm_rope(qv, kv, wq, wk, cos, sin, N, eps=1e-6)
        copies = False
    except ValueError:  # a K4 that takes contiguous rows only
        copies = True

    def qkv_path():
        a, b = (qv.contiguous(), kv.contiguous()) if copies else (qv, kv)
        return fa.qk_norm_rope(a, b, wq, wk, cos, sin, N, eps=1e-6)

    res["k4_contiguous"] = _trace(lambda: fa.qk_norm_rope(q, k, wq, wk, cos, sin, N, eps=1e-6),
                                  reps=20)
    res["k4_qkv_path"] = _trace(qkv_path, reps=20)
    res["qkv_path_copies"] = copies
    res["clone_q_k"] = _trace(lambda: (q.clone(), k.clone()), reps=20)
    del q, k, qkv, qv, kv

    # the headline's W8A8 DiT: a full and a cached TeaCache step ------------------
    cfg = dataclasses.replace(ti2v_5b().dit, w8a8=True)
    model = tdit.WanDiT(cfg, torch.bfloat16, device="meta",
                        param_dtype=torch.bfloat16).to_empty(device="cuda").eval()
    _random_init_(model, torch.Generator(device="cuda").manual_seed(0))
    x = torch.randn((1, 39, 44, 80, cfg.in_dim), generator=gen, device="cuda").to(torch.bfloat16)
    t_frame = torch.cat([torch.zeros((1, 31), device="cuda"),
                         torch.full((1, 8), 500.0, device="cuda")], dim=1)
    ctx = torch.randn((1, TEXT_LEN, cfg.text_dim), generator=gen, device="cuda") * 0.02
    edge = cfg.num_layers // 4
    cache_list = tuple(range(edge, cfg.num_layers - edge))
    kw = dict(latent_frame_zero=8, cache_list=cache_list)
    times = {"full_step_ms": [], "cached_step_ms": []}
    with torch.no_grad():
        cache = model(x, t_frame, ctx, return_cache=True, **kw)[1]
        steps = {"full_step_ms": lambda: model(x, t_frame, ctx, return_cache=True, **kw),
                 "cached_step_ms": lambda: model(x, t_frame, ctx, block_cache=cache, **kw)}
        for name, fn in steps.items():
            for i in range(2 + args.steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 2:
                    times[name].append((time.perf_counter() - t) * 1e3)
        for name, fn in steps.items():
            res[name] = times[name]
            res[f"median_{name}"] = statistics.median(times[name])
            res[f"trace_{name.removesuffix('_ms')}"] = _trace(fn)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
