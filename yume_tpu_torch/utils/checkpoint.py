"""Train-state checkpoints as torch files (the save/restore part of
yume_tpu/utils/checkpoint.py; Orbax is not ported), and the reader of
torch state dicts (:func:`load_torch_state_dict`).

``<output_dir>/checkpoint-<step>.pt`` holds the step, the trained tensors,
the optimizer state and the EMA. :func:`restore_checkpoint` copies the
newest one into an existing state in place, so a full fine-tune's
parameters stay the model's own tensors.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import torch

from ..training.train_step import TrainState

_NAME = re.compile(r"checkpoint-(\d+)\.pt$")


def save_checkpoint(output_dir: str, state: TrainState) -> str:
    """Write ``state`` as ``checkpoint-<step>.pt`` (atomically); returns the
    path."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"checkpoint-{state.step}.pt")
    tmp = f"{path}.tmp"
    torch.save({"step": state.step, "params": state.params,
                "opt_state": state.opt_state, "ema_params": state.ema_params}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    found = [(int(m.group(1)), p) for p in glob.glob(os.path.join(output_dir, "checkpoint-*.pt"))
             if (m := _NAME.search(p))]
    return max(found)[1] if found else None


def _copy_into(dst, src, where: str):
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise KeyError(f"checkpoint {where}: keys differ from the state's")
        for k in dst:
            if isinstance(dst[k], (dict, torch.Tensor)):
                _copy_into(dst[k], src[k], f"{where}.{k}")
            else:
                dst[k] = src[k]
    else:
        if dst.shape != src.shape:
            raise ValueError(f"checkpoint {where}: shape {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)


def load_torch_state_dict(path: str) -> dict:
    """A torch ``.pth``/``.pt`` state dict as fp32 CPU tensors, unwrapped
    from a ``state_dict`` or ``model`` entry where the file has one."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return {k: v.float() for k, v in sd.items() if torch.is_tensor(v)}


def restore_checkpoint(output_dir: str, state: TrainState) -> TrainState:
    """Copy the newest checkpoint of ``output_dir`` into ``state`` (in
    place) and return it; raises FileNotFoundError when there is none."""
    path = latest_checkpoint(output_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint-*.pt in {output_dir}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    _copy_into(state.params, ckpt["params"], "params")
    _copy_into(state.opt_state, ckpt["opt_state"], "opt_state")
    _copy_into(state.ema_params, ckpt["ema_params"], "ema_params")
    state.step = int(ckpt["step"])
    return state
