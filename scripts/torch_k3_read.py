"""Read K3 (``adaln_residual``) at the 14B segment's shape several times in
one process, each reading by three clocks, to tell the kernel's speed from
the clock's artefacts:

    python3 scripts/torch_k3_read.py [--readings N] [--reps R] [--out FILE]

The case is chip_smoke.py phase 3's: x and y ``[1, 28350, 5120]`` bf16
N(0, 1), a ``[1, 2, 5120]`` fp32 gate table, idx 0 over the 9,990 history
tokens and 1 over the tail. Its bytes, each input read once and the output
written once, are 3 x 290.3 MB (the table and idx add 0.15 MB). Each reading
takes, for K3 and for ``torch.add(x, y, out=o)`` (the same bytes, no gate):

* ``prof``: the profiler's device time a launch over ``R`` launches, with the
  number of kernel records it holds (``records``; ``R`` when none was lost)
  and their shortest and longest;
* ``loop``: CUDA events around ``R`` back-to-back launches, over ``R``;
* ``cold``: CUDA events around one launch, the median of ``R``, each launch
  after a 512 MB read that leaves the 50 MB L2 holding clean, unrelated
  lines, with the card held busy meanwhile (``torch.cuda._sleep``) so that
  the host's launch path is not timed; the launch ends with its last output
  lines still dirty in L2;
* ``drained``: as ``cold``, but the events also enclose a second 512 MB read
  after the launch, which writes those dirty lines back to memory; the same
  events around the second read alone are subtracted.

Each time is also given as a rate, bytes over time, beside the 3.35 TB/s of
the H100 SXM data sheet that chip_smoke.py's bounds use. Prints one JSON
line with the card's name and power limit, and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

L, L_HIST, DIM = 28350, 9990, 5120
HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 512 << 20


def _prof(fn, reps: int, name: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and name in e.name:
            durs.append(next(getattr(e, n) for n in ("self_device_time_total",
                                                     "self_cuda_time_total")
                             if hasattr(e, n)) / 1e3)
    return {"ms": sum(durs) / reps, "records": len(durs),
            "min_ms": min(durs, default=0.0), "max_ms": max(durs, default=0.0)}


def _loop(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _enclosed(fn, flush, reps: int) -> float:
    """Median of events around ``fn`` alone, each after ``flush``, with the
    card kept busy while the host enqueues."""
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--readings", type=int, default=5)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", default="chiprun_out/k3_read.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k3_read: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from yume_tpu_torch.ops import fused_adaln as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    x, y = randn(1, L, DIM), randn(1, L, DIM)
    s_tab = randn(1, 2, DIM, dtype=torch.float32, scale=0.1)
    idx = (torch.arange(L, device="cuda") >= L_HIST).to(torch.int32)[None]
    o = torch.empty_like(x)
    n_bytes = 3 * x.numel() * x.element_size() + s_tab.numel() * 4 + idx.numel() * 4
    flush_buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")

    def flush():
        torch.sum(flush_buf, dim=0, out=sink)

    def k3():
        fa.adaln_residual(x, y, s_tab, idx)

    def add():
        torch.add(x, y, out=o)

    def rate(ms):
        return round(n_bytes / (ms * 1e-3) / 1e12, 3)

    want = fa._adaln_residual_ref(x, y, s_tab, idx)
    err = (fa.adaln_residual(x, y, s_tab, idx).float() - want.float()).abs().max().item()
    readings = []
    for _ in range(args.readings):
        for what, fn, kname in (("k3", k3, "adaln_residual_kernel"), ("add", add, "")):
            prof = _prof(fn, args.reps, kname)
            loop = _loop(fn, args.reps)
            cold = _enclosed(fn, flush, args.reps)

            def fn_then_flush():
                fn()
                flush()
            drained = _enclosed(fn_then_flush, flush, args.reps) - _enclosed(
                flush, flush, args.reps)
            r = {"what": what, "prof_ms": round(prof["ms"], 4), "records": prof["records"],
                 "record_min_ms": round(prof["min_ms"], 4),
                 "record_max_ms": round(prof["max_ms"], 4),
                 "loop_ms": round(loop, 4), "cold_ms": round(cold, 4),
                 "drained_ms": round(drained, 4)}
            r.update({f"{k[:-3]}_tb_s": rate(r[k]) for k in
                      ("prof_ms", "loop_ms", "cold_ms", "drained_ms")})
            readings.append(r)
            print(json.dumps(r), flush=True)
    out = {"card": smi.stdout.strip(), "shape": [1, L, DIM], "bytes": n_bytes,
           "bound_ms": round(n_bytes / HBM_BYTES_PER_S * 1e3, 4), "reps": args.reps,
           "max_abs_err": err, "readings": readings}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "readings"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
