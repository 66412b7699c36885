"""Training-stats collector (counterpart of yume_tpu/utils/stats.py, the
reference's StyleGAN ``training_stats``, ADD/th_utils/training_stats.py):
named scalars accumulated on the host as (sum, count, min, max), reduced
across processes only when a summary asks for it."""

from __future__ import annotations

from typing import Dict

import torch


class Collector:
    def __init__(self):
        self._sum: Dict[str, float] = {}
        self._cnt: Dict[str, int] = {}
        self._min: Dict[str, float] = {}
        self._max: Dict[str, float] = {}

    def report(self, **scalars):
        """Accumulate named scalars (Python numbers or 0-d tensors; a tensor
        on the card is read once here)."""
        for name, v in scalars.items():
            v = float(v)
            self._sum[name] = self._sum.get(name, 0.0) + v
            self._cnt[name] = self._cnt.get(name, 0) + 1
            self._min[name] = min(self._min.get(name, v), v)
            self._max[name] = max(self._max.get(name, v), v)

    def mean(self, name: str) -> float:
        return self._sum[name] / max(self._cnt[name], 1)

    def summary(self, cross_host: bool = False) -> Dict[str, Dict[str, float]]:
        """{name: {mean, min, max, n}}; with ``cross_host`` in a
        ``torch.distributed`` group of more than one process, the sums and
        counts are summed over the processes (one all-reduce of 2 numbers a
        name; min and max stay this process's, as the reference's)."""
        names = sorted(self._sum)
        if cross_host and torch.distributed.is_available() and \
                torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
            vec = torch.tensor([[self._sum[n], self._cnt[n]] for n in names],
                               dtype=torch.float64)
            if torch.distributed.get_backend() == "nccl":
                vec = vec.cuda()
            torch.distributed.all_reduce(vec)
            vec = vec.cpu()
            return {n: {"mean": vec[i, 0].item() / max(vec[i, 1].item(), 1),
                        "min": self._min[n], "max": self._max[n], "n": int(vec[i, 1])}
                    for i, n in enumerate(names)}
        return {n: {"mean": self.mean(n), "min": self._min[n], "max": self._max[n],
                    "n": self._cnt[n]} for n in names}

    def reset(self):
        for d in (self._sum, self._cnt, self._min, self._max):
            d.clear()
