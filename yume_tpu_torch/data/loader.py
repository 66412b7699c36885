"""Background-prefetch batch loader (counterpart of yume_tpu/data/loader.py;
the reference's DataLoader workers, fastvideo/distill_model.py:644-654).

Worker threads decode and preprocess ahead of the training step. They do
host work only (decode, numpy); the consumer moves each batch to the
device. Threads suffice because the decoders release the GIL.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np


def process_rank() -> tuple:
    """(rank, world size) of ``torch.distributed`` when it is initialised,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class PrefetchLoader:
    """Prefetching, index-driven loader with disjoint per-process streams.

    Every process must consume different samples (the reference's
    DistributedSampler, fastvideo/distill_model.py:642-643; inference
    stride ``(step-1)*world_size+rank``, fastvideo/sample/sample.py:667):
    process p draws the indices ``p, p+P, p+2P, …`` of the global stream
    (P processes), so the processes cover it without overlap.
    ``process_index`` and ``process_count`` default to the rank and world
    size of :func:`process_rank`. A worker's exception is raised by the
    ``next`` that reaches its batch.
    """

    def __init__(self, sample_fn: Callable[[int], Dict], batch_size: int = 1, *,
                 num_workers: int = 2, prefetch: int = 4,
                 collate: Optional[Callable[[List[Dict]], Dict]] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        if process_index is None or process_count is None:
            process_index, process_count = process_rank()
        assert 0 <= process_index < process_count, (process_index, process_count)
        self.sample_fn = sample_fn
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.collate = collate or _default_collate
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._idx = 0
        self._idx_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_workers)]
        for t in self._threads:
            t.start()

    def _next_indices(self) -> List[int]:
        with self._idx_lock:
            start = self._idx
            self._idx += self.batch_size
        # global stream position → this process's disjoint stride
        return [(start + j) * self.process_count + self.process_index
                for j in range(self.batch_size)]

    def _worker(self):
        while not self._stop.is_set():
            idx = self._next_indices()
            try:
                batch = self.collate([self.sample_fn(i) for i in idx])
            except Exception as e:      # noqa: raised on the consumer's side
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)


def _default_collate(samples: List[Dict]) -> Dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out
