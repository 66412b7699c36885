"""Train-state checkpoints as torch files (the save/restore part of
yume_tpu/utils/checkpoint.py; Orbax is not ported), and the readers of
released weights: torch state dicts (:func:`load_torch_state_dict`) and
safetensors files, single or sharded with an index
(:func:`load_safetensors_state_dict`, a reader of the format written here
by hand, so it needs no ``safetensors`` package).

``<output_dir>/checkpoint-<step>.pt`` holds the step, the trained tensors,
the optimizer state and the EMA. :func:`restore_checkpoint` copies the
newest one into an existing state in place, so a full fine-tune's
parameters stay the model's own tensors.
"""

from __future__ import annotations

import glob
import json
import os
import re
import struct
from typing import Any, Dict, Mapping, Optional

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


_WRAPPER_SEGMENTS = frozenset(
    ("module", "_fsdp_wrapped_module", "_checkpoint_wrapped_module", "_orig_mod"))


def normalize_torch_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop FSDP/compile wrapper segments anywhere in the key path (whole
    segments, not substrings: ``module`` is a substring of
    ``_fsdp_wrapped_module``), as checkpoints saved through those wrappers
    carry them."""
    return {".".join(s for s in k.split(".") if s not in _WRAPPER_SEGMENTS): v
            for k, v in sd.items()}


_CLIP_BLOCK = re.compile(r"transformer\.(\d+)\.")
_CLIP_VISUAL_HEAD = ("patch_embedding.", "cls_embedding", "pos_embedding", "pre_norm.")


def clip_visual_from_released(sd: Mapping[str, Any], num_layers: int = 32) -> Dict[str, Any]:
    """The tensors ``CLIPVisual`` loads from the released CLIP checkpoint
    (``models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``): the
    ``visual.`` ones without the prefix, up to the 31st of its
    ``num_layers`` blocks (the ``use_31_block`` output never uses the last
    block, the post-norm or the head; the text tower is not needed). A
    tensor the tower needs and the file lacks raises when it loads."""
    out = {}
    for k, v in sd.items():
        if not k.startswith("visual."):
            continue
        k = k[len("visual."):]
        block = _CLIP_BLOCK.match(k)
        if (block and int(block.group(1)) < num_layers - 1) or k.startswith(_CLIP_VISUAL_HEAD):
            out[k] = v
    return out


# safetensors dtype names → torch dtypes (little-endian raw data)
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_INDEX = "diffusion_pytorch_model.safetensors.index.json"


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file → {name: CPU tensor} in the file's dtypes.

    The format: an unsigned little-endian 8-byte header length N, N bytes
    of JSON ({name: {"dtype", "shape", "data_offsets": [begin, end]}} and an
    optional ``__metadata__``), then the raw little-endian data, offsets
    counted from its start."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size < 8:
            raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
        (n,) = struct.unpack("<Q", f.read(8))
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes in a {size}-byte file")
        header = json.loads(f.read(n))
        base = 8 + n
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            shape = [int(d) for d in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
            numel = 1
            for d in shape:
                numel *= d
            if not 0 <= begin <= end <= size - base or \
                    end - begin != numel * torch.empty((), dtype=dtype).element_size():
                raise ValueError(f"{path}: {name} has data offsets {begin}..{end} for "
                                 f"{info['dtype']} {shape}")
            f.seek(base + begin)
            raw = bytearray(f.read(end - begin))
            out[name] = torch.frombuffer(raw, dtype=torch.uint8).view(dtype).reshape(shape) \
                if raw else torch.empty(shape, dtype=dtype)
    return out


def load_safetensors_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors checkpoint → one flat state dict of CPU tensors in the
    files' dtypes. ``path`` is a file, a directory of ``*.safetensors``, or
    a sharded directory whose ``diffusion_pytorch_model.safetensors.index.json``
    names the shards in its ``weight_map`` (every name it maps must be in
    its shard)."""
    weight_map = None
    if os.path.isdir(path):
        index = os.path.join(path, _INDEX)
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted({os.path.join(path, v) for v in weight_map.values()})
        else:
            files = sorted(os.path.join(path, f) for f in os.listdir(path)
                           if f.endswith(".safetensors"))
    else:
        files = [path]
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(f))
    if weight_map is not None:
        missing = sorted(set(weight_map) - set(sd))
        if missing:
            raise KeyError(f"{path}: the index maps {len(missing)} tensors no shard holds, "
                           f"e.g. {missing[:5]}")
    return sd


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
