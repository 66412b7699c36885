"""Count the kernel records that torch.profiler's CUDA traces lose, and where
in a trace they are lost, on one card in one process:

    python3 scripts/torch_cupti_loss.py [--rounds N] [--out FILE]

Each trace runs ``reps`` calls of a function that launches two kernels,
``torch.add`` then ``torch.mul`` on 4M-element bf16 tensors, exactly as
chip_smoke.py's ``device_ms`` traces a kernel: one call to warm up, the
calls under ``profile(activities=[CUDA])``, a synchronisation, the end of
the trace. The records a trace holds, sorted by their start on the device,
are matched against the launched order (add, mul, add, mul, ...), so each
lost record has a position: the launch it was, from 0 to 2 x reps - 1.
Four ways to run a trace are compared, interleaved round by round:

* ``plain``: as ``device_ms``;
* ``sleep``: the host sleeps 20 ms after the synchronisation, before the
  trace ends;
* ``tail``: 16 more launches of a third kernel (``fill_``) and a second
  synchronisation before the trace ends; their records are not counted;
* ``lead``: one launch of a fourth kernel (``torch.cuda._sleep``, the
  ``spin_kernel``) before the calls; its record is not counted.

and two trace lengths, 20 and 500 calls (40 and 1,000 records). Prints one
JSON line a (mode, reps) pair: traces, traces that lost records (their
numbers in the run and seconds from its start), records lost and the
positions lost as [first, last] runs, with the card's name and power limit, and
writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

MODES = ("plain", "sleep", "tail", "lead")
TRACE_REPS = (20, 500)


def _trace(fn, reps: int, mode: str, pad) -> list:
    """The kinds ('add', 'mul', other) of the kernel records of one trace of
    ``reps`` calls, in the order they started on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if mode == "lead":
            torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        if mode == "sleep":
            time.sleep(0.02)
        elif mode == "tail":
            for _ in range(16):
                pad()
            torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    return ["mul" if "MulFunctor" in n else "add" if "add" in n else "other"
            for _, n in kernels]


def _lost_positions(kinds: list, reps: int) -> list:
    """Launch positions (0 .. 2 reps - 1) missing from ``kinds``."""
    seq = [k for k in kinds if k != "other"]
    missing, j = [], 0
    for i in range(2 * reps):
        want = "add" if i % 2 == 0 else "mul"
        if j < len(seq) and seq[j] == want:
            j += 1
        else:
            missing.append(i)
    return missing


def _runs(positions: list) -> list:
    """``positions`` (sorted) as [first, last] runs of consecutive ones."""
    runs = []
    for i in positions:
        if runs and runs[-1][1] == i - 1:
            runs[-1][1] = i
        else:
            runs.append([i, i])
    return runs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=60)
    p.add_argument("--out", default="chiprun_out/cupti_loss.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_cupti_loss: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    a = torch.randn(1 << 22, device="cuda").to(torch.bfloat16)
    b, c, d = torch.randn_like(a), torch.empty_like(a), torch.empty_like(a)
    f = torch.empty(1 << 20, device="cuda")

    def fn():
        torch.add(a, b, out=c)
        torch.mul(a, b, out=d)

    stats = {(m, r): {"mode": m, "reps": r, "traces": 0, "lossy_traces": 0, "lost": 0,
                      "lossy_trace_numbers": [], "lossy_trace_seconds": [],
                      "lost_runs": []}
             for m in MODES for r in TRACE_REPS}
    n = 0
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        for reps in TRACE_REPS:
            for mode in MODES:
                missing = _lost_positions(_trace(fn, reps, mode, lambda: f.fill_(1.0)), reps)
                s = stats[(mode, reps)]
                s["traces"] += 1
                if missing:
                    s["lossy_traces"] += 1
                    s["lost"] += len(missing)
                    s["lossy_trace_numbers"].append(n)
                    s["lossy_trace_seconds"].append(round(time.perf_counter() - t0, 2))
                    s["lost_runs"].append(_runs(missing))
                n += 1
    out = {"card": smi.stdout.strip(), "traces": n,
           "seconds": round(time.perf_counter() - t0, 1), "by_mode": list(stats.values())}
    for s in out["by_mode"]:
        print(json.dumps(s), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "by_mode"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
