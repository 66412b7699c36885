"""Keyboard/mouse control vocabulary → caption text. The port's own copy
of yume_tpu/data/controls.py (pinned equal to it by
``tests/test_torch_configs.py``).

The Yume "action space": WASD keys + mouse arrows embedded into the text
prompt (reference fastvideo/dataset/t2v_datasets.py:393-418,
webapp_single_gpu.py:648-677).
"""

from __future__ import annotations

from typing import Optional

BASE_CAPTION = "This video depicts a city walk scene with a first-person view (FPV)."

KEY_VOCAB = {
    "W": "Person moves forward (W).",
    "A": "Person moves left (A).",
    "S": "Person moves backward (S).",
    "D": "Person moves right (D).",
    "W+A": "Person moves forward and left (W+A).",
    "W+D": "Person moves forward and right (W+D).",
    "S+D": "Person moves backward and right (S+D).",
    "S+A": "Person moves backward and left (S+A).",
    "A+W": "Person moves forward and left (W+A).",
    "D+W": "Person moves forward and right (W+D).",
    "D+S": "Person moves backward and right (S+D).",
    "A+S": "Person moves backward and left (S+A).",
    "None": "Person stands still (·).",
    "·": "Person stands still (·).",
}

MOUSE_VOCAB = {
    "→": "Camera turns right (→).",
    "←": "Camera turns left (←).",
    "↑": "Camera tilts up (↑).",
    "↓": "Camera tilts down (↓).",
    "↑→": "Camera tilts up and turns right (↑→).",
    "↑←": "Camera tilts up and turns left (↑←).",
    "↓→": "Camera tilts down and turns right (↓→).",
    "↓←": "Camera tilts down and turns left (↓←).",
    "·": "Camera remains still (·).",
}


def control_caption(
    keys: str,
    mouse: str,
    *,
    base: str = BASE_CAPTION,
    metrics: Optional[str] = None,
) -> str:
    """Full per-segment caption (reference t2v_datasets.py:388-432)."""
    cap = base + KEY_VOCAB.get(keys, KEY_VOCAB["None"]) + \
        MOUSE_VOCAB.get(mouse, MOUSE_VOCAB["·"])
    if metrics:
        cap = cap + metrics
    return cap


def parse_control_txt(path: str):
    """Parse a test_video control .txt fixture (reference
    t2v_datasets.py:218-250):
        Start Frame: 1381 / End Frame: 1431 / Keys: W+A / Mouse: →
    Returns (keys, mouse, start_frame, end_frame)."""
    keys = mouse = None
    start = end = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line.startswith("Keys:"):
                keys = line.split(":", 1)[1].strip()
            elif line.startswith("Mouse:"):
                mouse = line.split(":", 1)[1].strip()
            elif line.startswith("Start Frame:"):
                start = int(line.split(":", 1)[1])
            elif line.startswith("End Frame:"):
                end = int(line.split(":", 1)[1])
    return keys, mouse, start, end
