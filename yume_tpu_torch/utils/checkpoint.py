"""Train-state checkpoints as torch files (the save/restore part of
yume_tpu/utils/checkpoint.py; Orbax is not ported), the readers of released
weights: torch state dicts (:func:`load_torch_state_dict`) and safetensors
files, single or sharded with an index (:func:`load_safetensors_state_dict`),
and the export of a trained DiT in the released layout
(:func:`export_dit_state_dict`, :func:`save_sharded_safetensors`). The
safetensors format is read and written here by hand, so neither needs the
``safetensors`` package.

``<output_dir>/checkpoint-<step>.pt`` holds the step, the trained tensors,
the optimizer state and the EMA. :class:`Checkpointer` writes them in a
background thread from a host snapshot and keeps the newest three;
:func:`restore_checkpoint` copies the newest one into an existing state in
place, so a full fine-tune's parameters stay the model's own tensors.
"""

from __future__ import annotations

import glob
import json
import os
import re
import struct
import threading
import time
from typing import Any, Dict, List, Mapping, Optional

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


def checkpoints(output_dir: str) -> List[str]:
    """The ``checkpoint-<step>.pt`` files of ``output_dir``, oldest step
    first."""
    found = [(int(m.group(1)), p) for p in glob.glob(os.path.join(output_dir, "checkpoint-*.pt"))
             if (m := _NAME.search(p))]
    return [p for _, p in sorted(found)]


def latest_checkpoint(output_dir: str) -> Optional[str]:
    found = checkpoints(output_dir)
    return found[-1] if found else None


class Checkpointer:
    """Train-state saves that overlap the next steps (the reference's
    ``Checkpointer``, yume_tpu/utils/checkpoint.py:686-713, without Orbax).

    :meth:`save` takes a host snapshot of the state, one device-to-host
    copy of each tensor enqueued on the current stream into pinned buffers
    kept from one save to the next, and returns; a background thread waits
    for the copies, writes ``checkpoint-<step>.pt`` as
    :func:`save_checkpoint` does (``torch.save`` then ``os.replace``) and
    deletes all but the newest ``max_to_keep``. The copies are ordered
    before any later kernel of the stream, so the next step may update the
    state in place at once. A save waits for the one before it; call
    :meth:`close` (or :meth:`wait`) before reading checkpoints back.
    ``hold_s`` lists how long each :meth:`save` held its caller."""

    def __init__(self, output_dir: str, max_to_keep: int = 3):
        self.output_dir, self.max_to_keep = output_dir, max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self.hold_s: List[float] = []

    def _snapshot(self, tree, path=()):
        if isinstance(tree, dict):
            return {k: self._snapshot(v, path + (k,)) for k, v in tree.items()}
        if not torch.is_tensor(tree):
            return tree
        t = tree.detach()
        if t.device.type == "cpu":
            return t.clone()
        buf = self._buffers.get(path)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._buffers[path] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t, non_blocking=True)

    def save(self, state: TrainState):
        t0 = time.perf_counter()
        self.wait()
        snap = TrainState(step=state.step, **{
            k: self._snapshot(getattr(state, k), (k,))
            for k in ("params", "opt_state", "ema_params")})
        done = None
        if torch.cuda.is_available() and any(
                t.is_cuda for t in state.params.values()):
            done = torch.cuda.Event()
            done.record()

        def write():
            try:
                if done is not None:
                    done.synchronize()
                save_checkpoint(self.output_dir, snap)
                for old in checkpoints(self.output_dir)[: -self.max_to_keep]:
                    os.remove(old)
            except BaseException as e:  # raised in the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="checkpointer", daemon=True)
        self._thread.start()
        self.hold_s.append(time.perf_counter() - t0)

    def wait(self):
        """Block until the save in flight is written; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()
        self._buffers.clear()


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


# the torch dtypes written to safetensors, by their format name
_SAFETENSORS_NAMES = {v: k for k, v in _SAFETENSORS_DTYPES.items()}


def save_sharded_safetensors(sd: Mapping[str, Any], out_dir: str, n_shards: int = 3,
                             base: str = "diffusion_pytorch_model") -> int:
    """Write a flat state dict in the released checkpoint's layout (the
    reference's ``save_sharded_safetensors``,
    yume_tpu/utils/checkpoint.py:649-683): the sorted keys dealt round-robin
    into ``<base>-0000i-of-0000n.safetensors`` and an index
    ``<base>.safetensors.index.json`` with ``metadata.total_size`` and the
    ``weight_map``. Every tensor is written as F32, as the reference's
    export casts to float32. Each file: an 8-byte little-endian header
    length, the JSON header (``dtype``, ``shape``, ``data_offsets`` per
    tensor, padded with spaces to 8 bytes), then the raw little-endian data
    in key order. Returns the bytes of tensor data written."""
    keys = sorted(sd)
    n_shards = max(1, min(n_shards, len(keys)))
    os.makedirs(out_dir, exist_ok=True)
    names = [f"{base}-{s + 1:05d}-of-{n_shards:05d}.safetensors" for s in range(n_shards)]
    weight_map, total = {}, 0
    for s, fname in enumerate(names):
        tensors = {k: torch.as_tensor(sd[k]).detach().to("cpu", torch.float32).contiguous()
                   for k in keys[s::n_shards]}
        header, offset = {}, 0
        for k, t in tensors.items():
            n = t.numel() * t.element_size()
            header[k] = {"dtype": _SAFETENSORS_NAMES[t.dtype], "shape": list(t.shape),
                         "data_offsets": [offset, offset + n]}
            offset += n
            weight_map[k] = fname
        raw = json.dumps(header, separators=(",", ":")).encode()
        raw += b" " * (-len(raw) % 8)
        path = os.path.join(out_dir, fname)
        with open(f"{path}.tmp", "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for t in tensors.values():
                if t.numel():
                    f.write(t.view(-1).view(torch.uint8).numpy().data)
        os.replace(f"{path}.tmp", path)
        total += offset
    with open(os.path.join(out_dir, f"{base}.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return total


def export_dit_state_dict(state_dict: Mapping[str, torch.Tensor],
                          lora: Optional[Mapping[str, torch.Tensor]] = None
                          ) -> Dict[str, torch.Tensor]:
    """A DiT's tensors in the reference ``WanModel`` layout as fp32 host
    tensors (the reference's ``export_dit_state_dict``,
    yume_tpu/utils/checkpoint.py:558-646). The port's parameter names are
    the reference's, so ``state_dict`` (a ``WanDiT.state_dict()`` with the
    EMA tensors in place of the trained ones; see
    :func:`..training.lora.base_state_dict` for a model that carries LoRA)
    is the export but for the dtype; with ``lora`` (adapters by
    ``<layer>.lora_a``/``.lora_b``) they are merged into their weights first
    (:func:`..training.lora.merge_lora`), one layer at a time: the 14B's
    merged fp32 weights would not fit on the card beside its bf16 base."""
    from ..training.lora import merge_lora

    out = {}
    for k, v in state_dict.items():
        layer = k[: -len(".weight")]
        if lora and f"{layer}.lora_a" in lora:
            v = merge_lora({k: v}, {f"{layer}.lora_{s}": lora[f"{layer}.lora_{s}"]
                                    for s in "ab"})[k]
        out[k] = v.detach().to("cpu", torch.float32)
    return out


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
