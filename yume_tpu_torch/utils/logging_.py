"""Per-phase wall-clock timing (the ``phase`` / ``phase_summary`` part of
yume_tpu/utils/logging_.py): named phases accumulate host time into a
table printed at the end of a run, and show as named ranges in a
``torch.profiler`` trace."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple

import torch


class PhaseTimer:
    """Accumulates (total seconds, count) per phase name. A phase ends with
    a synchronisation of ``device`` when it is a CUDA device, so its time
    covers the device work it queued."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.phases: Dict[str, Tuple[float, int]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        tot, cnt = self.phases.get(name, (0.0, 0))
        self.phases[name] = (tot + time.perf_counter() - t0, cnt + 1)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{name: {"total_s", "n", "mean_s"}}, longest first; prints an
        aligned table."""
        out = {n: {"total_s": t, "n": c, "mean_s": t / max(c, 1)}
               for n, (t, c) in sorted(self.phases.items(), key=lambda kv: -kv[1][0])}
        if out:
            w = max(len(n) for n in out)
            print(f"{'phase'.ljust(w)}  {'total_s':>9}  {'n':>5}  {'mean_s':>9}")
            for n, r in out.items():
                print(f"{n.ljust(w)}  {r['total_s']:9.3f}  {r['n']:5d}  {r['mean_s']:9.4f}")
        return out
