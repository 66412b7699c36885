"""The control-annotated video dataset (counterpart of
yume_tpu/data/dataset.py; reference StableVideoAnimationDataset,
fastvideo/dataset/t2v_datasets.py:254-471): scans
``root_dir/<Keys_X_Mouse_Y>/*.mp4`` with sibling ``.txt`` control files and
``.npy`` camera trajectories, caps the files of a category, samples a random
window, optionally prepends long history from the full source mp4
(FramePack training), builds the control caption (with the camera-metrics
string at ``metrics_prob``), and yields channels-last float32 video in
[-1, 1] as host numpy.

Every draw comes from one ``random.Random(seed)`` in the reference's order
(the category cap, the shuffle, then per sample the window start, the
history length and the metrics draw), so a seed gives the samples JAX's
dataset gives. A failed sample rerolls a random index (reference
:445-453). Frames come from the native libavcodec decoder where it builds,
else from OpenCV.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .camera import metrics_caption, metrics_in_range
from .controls import control_caption, parse_control_txt

# the reader of the last read_video_frames call: 'native' or 'cv2'
last_reader: Optional[str] = None


def read_video_frames(path: str, indices: List[int],
                      size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Decode the frames ``indices`` → [N, H, W, 3] float32 in [-1, 1];
    ``size`` = (height, width) resizes (SWS_AREA natively, INTER_AREA in
    OpenCV). The native decoder reads when it builds and opens the file,
    else OpenCV; ``last_reader`` records which."""
    from .native import decode_frames

    global last_reader
    frames = decode_frames(path, indices, size)
    if frames is not None:
        last_reader = "native"
        return frames.astype(np.float32) / 127.5 - 1.0

    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    want = set(int(i) for i in indices)
    max_idx = max(want)
    grabbed, pos = {}, 0
    while pos <= max_idx:
        ok, frame = cap.read()
        if not ok:
            break
        if pos in want:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if size is not None:
                frame = cv2.resize(frame, (size[1], size[0]), interpolation=cv2.INTER_AREA)
            grabbed[pos] = frame
        pos += 1
    cap.release()
    missing = [i for i in indices if i not in grabbed]
    if missing:
        raise IOError(f"missing frames {missing[:3]}... in {path}")
    last_reader = "cv2"
    return np.stack([grabbed[i] for i in indices]).astype(np.float32) / 127.5 - 1.0


def video_length(path: str) -> int:
    """The video's frame count: the container's, else OpenCV's."""
    from .native import video_frame_count

    n = video_frame_count(path)
    if n is not None:
        return n

    import cv2

    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


@dataclasses.dataclass
class ClipMeta:
    mp4_path: str
    video_id: str
    keys: str
    mouse: str
    npy_path: Optional[str]
    start_frame: int
    end_frame: int
    full_mp4: Optional[str]


class ControlVideoDataset:
    """Directory-scanning dataset of control-annotated clips."""

    def __init__(self, root_dir: str, *, full_mp4_dir: Optional[str] = None,
                 n_sample_frames: int = 33, height: int = 352, width: int = 640,
                 max_files_per_category: int = 4000, history_prob: float = 0.5,
                 metrics_prob: float = 0.65, seed: int = 0):
        self.n_sample_frames = n_sample_frames
        self.size = (height, width)
        self.history_prob = history_prob
        self.metrics_prob = metrics_prob
        self.rng = random.Random(seed)
        self.meta: List[ClipMeta] = []

        for subdir in sorted(glob.glob(os.path.join(root_dir, "*/"))):
            mp4s = sorted(glob.glob(os.path.join(subdir, "*.mp4")))
            if len(mp4s) > max_files_per_category:
                mp4s = self.rng.sample(mp4s, max_files_per_category)
            for mp4 in mp4s:
                base = os.path.splitext(os.path.basename(mp4))[0]
                txt = os.path.join(subdir, base + ".txt")
                npy = os.path.join(subdir, base + ".npy")
                if not os.path.exists(txt):
                    continue
                keys, mouse, start, end = parse_control_txt(txt)
                if keys is None or mouse is None:
                    continue
                vid = base.split("_frames_")[0]
                full = None
                if full_mp4_dir:
                    parts = vid.split("_")
                    full = os.path.join(full_mp4_dir, "_".join(parts[:-2]), vid + ".mp4")
                self.meta.append(ClipMeta(mp4, vid, keys, mouse,
                                          npy if os.path.exists(npy) else None,
                                          start, end, full))
        self.rng.shuffle(self.meta)

    def __len__(self) -> int:
        return len(self.meta)

    def get_sample(self, index: int) -> Dict:
        m = self.meta[index % max(len(self.meta), 1)]
        vlen = video_length(m.mp4_path)
        n = min(self.n_sample_frames, vlen)
        start = self.rng.randint(0, max(vlen - n, 0))
        idx = list(range(start, start + n))
        video = read_video_frames(m.mp4_path, idx, self.size)

        # history prepend from the full source video (reference :350-381)
        history = None
        abs_start = m.start_frame + start
        if m.full_mp4 and os.path.exists(m.full_mp4) and abs_start > 0:
            len_cat = 400 if self.rng.random() < 0.4 else 1000
            hi = (self.rng.randint(min(10, abs_start), min(len_cat, abs_start))
                  if abs_start > 10 else self.rng.randint(0, abs_start))
            if hi > 0:
                try:
                    history = read_video_frames(m.full_mp4, list(range(abs_start - hi,
                                                                       abs_start)), self.size)
                except Exception:       # noqa: a clip without its history still trains
                    history = None

        caption = control_caption(m.keys, m.mouse)
        if m.npy_path and self.rng.random() < self.metrics_prob:
            try:
                data = np.load(m.npy_path)
                if hasattr(data, "keys") and "extrinsic" in getattr(data, "files", []):
                    data = data["extrinsic"]
                sp, an, ro = metrics_in_range(np.asarray(data), idx[0], idx[-1])
                caption += metrics_caption(sp, an, ro)
            except Exception:           # noqa: an unreadable trajectory drops the metrics
                pass

        return {"video": video,          # [N, H, W, 3] in [-1, 1]
                "history": history,      # [Nh, H, W, 3] or None
                "caption": caption, "keys": m.keys, "mouse": m.mouse,
                "video_id": m.video_id}

    def __getitem__(self, index: int) -> Dict:
        # a failed sample rerolls (reference t2v_datasets.py:445-453)
        for _ in range(8):
            try:
                return self.get_sample(index)
            except Exception:           # noqa: any decode failure rerolls
                index = self.rng.randint(0, max(len(self.meta) - 1, 0))
        raise RuntimeError("dataset: too many failed samples")

    def iter_batches(self, batch_size: int = 1) -> Iterator[List[Dict]]:
        i = 0
        while True:
            yield [self[i + j] for j in range(batch_size)]
            i += batch_size


def trim_to_4n_plus_1(video: np.ndarray) -> np.ndarray:
    """Trim the frame count to 4n+1 (reference distill_model.py:249-253)."""
    keep = ((video.shape[0] - 1) // 4) * 4 + 1
    return video[:keep]
