"""Host offload of whole models (counterpart of yume_tpu/utils/offload.py,
the reference webapp's CPU⇄GPU shuttle under ``memory_optimization``):
models wait in host memory and visit the device one at a time."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class OffloadSlot:
    """Keep at most one of the registered modules on ``device``.

    Modules move in place (``nn.Module.to``), so whoever holds them, a
    pipeline's ``t5`` or ``vae``, finds them where the last :meth:`use` or
    :meth:`park` put them; a module moved to the host frees its device
    tensors."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._modules: Dict[str, nn.Module] = {}

    def register(self, name: str, module: nn.Module):
        """Park ``module`` on the host under ``name``."""
        self._modules[name] = module.to("cpu")

    def __contains__(self, name: str) -> bool:
        return name in self._modules

    def use(self, name: str) -> nn.Module:
        """Move every other registered module to the host, then ``name``'s
        to the device; returns it."""
        self.park(keep=name)
        return self._modules[name].to(self.device)

    def park(self, keep: str = None):
        """Move every registered module but ``keep`` to the host."""
        for other, module in self._modules.items():
            if other != keep:
                module.to("cpu")
