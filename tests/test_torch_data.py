"""The port's data path (``yume_tpu_torch/data``) against the JAX package's
on the same files and seeds: the native host helpers and the frame reader
(the libavcodec decoder the port builds from ``native/*.cpp``, and OpenCV),
``ControlVideoDataset`` (clips, windows, history, captions and frames),
the transforms, and ``PrefetchLoader`` (disjoint strides, errors raised on
the consumer's side, the rank read from ``torch.distributed``).

Everything here is host numpy computed by the same code or the same C++
sources, so every comparison is exact. The test videos are small mp4s that
the tests write with OpenCV's mp4v writer, as the card's host writes them.
"""

import os
import time

import numpy as np
import pytest

from yume_tpu.data import dataset as jdataset
from yume_tpu.data import native as jnative
from yume_tpu.data import transforms as jtransforms
from yume_tpu.data.loader import PrefetchLoader as JaxLoader
from yume_tpu_torch.data import dataset as tdataset
from yume_tpu_torch.data import native as tnative
from yume_tpu_torch.data import transforms as ttransforms
from yume_tpu_torch.data.loader import PrefetchLoader, process_rank

READERS = ("native", "cv2")


def write_clip(path, n_frames, h=40, w=56, seed=0):
    """A moving gradient with noise: [n_frames, h, w, 3] uint8 through
    cv2's mp4v writer; returns the frames written."""
    import cv2

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.stack([np.stack([(xx * 4 + 9 * i) % 256, (yy * 5 + 3 * i) % 256,
                                 (xx + yy + 17 * i) % 256], -1)
                       + rng.integers(0, 6, (h, w, 3)) for i in range(n_frames)])
    frames = np.clip(frames, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 16, (w, h))
    for f in frames:
        vw.write(f[..., ::-1].copy())
    vw.release()
    return frames


def write_tree(root, full_root=None):
    """``<root>/<Keys_X_Mouse_Y>/<vid>_frames_<a>-<b>.mp4`` with control
    ``.txt`` files, camera ``.npy`` files for some, one clip without its
    ``.txt`` and one whose ``.txt`` names no keys; with ``full_root`` the
    full source videos the history is read from."""
    clips = [("Keys_W_Mouse_·", "cityA_seg_01", 30, 20, "W", "·", True),
             ("Keys_W_Mouse_·", "cityA_seg_02", 4, 18, "W", "·", False),
             ("Keys_A_Mouse_→", "cityB_seg_07", 120, 22, "A", "→", True),
             ("Keys_S+D_Mouse_↑", "cityC_seg_03", 0, 16, "S+D", "↑", False)]
    for i, (cat, vid, start, n, keys, mouse, npy) in enumerate(clips):
        base = os.path.join(root, cat, f"{vid}_frames_{start}-{start + n}")
        write_clip(base + ".mp4", n, seed=i)
        with open(base + ".txt", "w", encoding="utf-8") as f:
            f.write(f"Start Frame: {start}\nEnd Frame: {start + n}\nKeys: {keys}\n"
                    f"Mouse: {mouse}\n")
        if npy:
            t = np.tile(np.eye(4), (start + n + 4, 1, 1))
            t[:, 2, 3] = 0.03 * np.arange(len(t))
            t[:, 0, 3] = 0.01 * np.arange(len(t)) ** 1.5
            np.save(base + ".npy", t)
        if full_root:
            parts = vid.split("_")
            write_clip(os.path.join(full_root, "_".join(parts[:-2]), vid + ".mp4"),
                       start + n, seed=10 + i)
    write_clip(os.path.join(root, "Keys_W_Mouse_·", "no_txt.mp4"), 8, seed=20)
    bad = os.path.join(root, "Keys_Q_Mouse_·", "odd_frames_0-8")
    write_clip(bad + ".mp4", 8, seed=21)
    with open(bad + ".txt", "w", encoding="utf-8") as f:
        f.write("Start Frame: 0\nEnd Frame: 8\nMouse: ·\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_tree(str(root / "clips"), str(root / "full"))
    return str(root / "clips"), str(root / "full")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "c.mp4")
    return path, write_clip(path, 24, h=48, w=64, seed=3)


@pytest.fixture
def reader(request, monkeypatch):
    """Both packages on one reader: 'cv2' makes both native decoders
    report that they cannot decode."""
    if request.param == "native":
        assert tnative.have_native_decode() and jnative.have_native_decode()
    else:
        monkeypatch.setattr(tnative, "decode_frames", lambda *a, **k: None)
        monkeypatch.setattr(tnative, "video_frame_count", lambda *a, **k: None)
        monkeypatch.setattr(jnative, "decode_frames", lambda *a, **k: None)
        monkeypatch.setattr(jnative, "video_frame_count", lambda *a, **k: None)
    return request.param


def test_native_libraries_build_from_the_sources():
    """The port builds ``native/*.cpp`` into ``build/yume_tpu_torch/`` (never
    into ``native/``) and says which reader decodes."""
    assert tnative.have_native() and tnative.have_native_decode()
    assert tnative.decoder() == "native"
    for lib in tnative._libs.values():
        assert os.path.dirname(lib._name) == os.path.abspath(tnative.BUILD_DIR)
        assert os.path.basename(lib._name).startswith(("libyume_host-", "libyume_decode-"))


@pytest.mark.parametrize("reader", READERS, indirect=True)
@pytest.mark.parametrize("size", [None, (24, 32)])
def test_read_video_frames_equal(clip, reader, size):
    path, _ = clip
    idx = [0, 7, 3, 3, 23, 11]          # unordered and repeated: the reader's contract
    got = tdataset.read_video_frames(path, idx, size)
    want = jdataset.read_video_frames(path, idx, size)
    assert tdataset.last_reader == reader
    assert got.dtype == np.float32 and got.shape == (6,) + (size or (48, 64)) + (3,)
    np.testing.assert_array_equal(got, want)
    assert -1.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("reader", READERS, indirect=True)
def test_video_length_equal(clip, reader):
    path, frames = clip
    assert tdataset.video_length(path) == jdataset.video_length(path) == len(frames)


def test_readers_agree_with_the_frames_written(clip):
    """The native reader decodes the mp4v stream close to the frames written
    (a lossy codec), and reports a frame past the end as not decoded."""
    path, frames = clip
    native = tdataset.read_video_frames(path, list(range(24)))
    assert tdataset.last_reader == "native"
    written = frames.astype(np.float32) / 127.5 - 1.0
    assert np.abs(native - written).mean() < 0.05
    assert tnative.decode_frames(path, [99]) is None            # past the end


def test_reader_refuses_missing_files(tmp_path):
    with pytest.raises(IOError):
        tdataset.read_video_frames(str(tmp_path / "none.mp4"), [0])


@pytest.mark.parametrize("native_lib", [True, False], ids=["native", "fallback"])
def test_host_helpers_equal(native_lib, monkeypatch):
    """``u8_to_unit_range`` and ``center_crop_resize`` exactly as JAX's, on
    the C++ library and on the numpy/OpenCV fallback, cropping either side."""
    if not native_lib:
        monkeypatch.setitem(tnative._libs, "yume_host", None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    rng = np.random.default_rng(1)
    for shape, out in (((3, 40, 60, 3), (20, 30)), ((2, 50, 40, 3), (16, 24)),
                       ((1, 33, 71, 3), (32, 32))):
        x = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(tnative.u8_to_unit_range(x), jnative.u8_to_unit_range(x))
        got = tnative.center_crop_resize(x, *out)
        np.testing.assert_array_equal(got, jnative.center_crop_resize(x, *out))
        np.testing.assert_array_equal(ttransforms.CenterCropResizeVideo(out)(x), got)
        assert got.shape == (shape[0],) + out + (3,)


@pytest.mark.parametrize("reader", READERS, indirect=True)
@pytest.mark.parametrize("seed,cap,history", [(0, 4000, True), (5, 1, True), (9, 4000, False)])
def test_control_dataset_equal(tree, reader, seed, cap, history):
    """Same files and seed: the same clips in the same order, and sample by
    sample the same window, history, caption (with the metrics draw) and
    frames, through the category cap, the full-mp4 history and the clips
    the scan skips."""
    root, full = tree
    kw = dict(full_mp4_dir=full if history else None, n_sample_frames=9, height=24,
              width=32, max_files_per_category=cap, seed=seed)
    tds, jds = tdataset.ControlVideoDataset(root, **kw), jdataset.ControlVideoDataset(root, **kw)
    assert len(tds) == len(jds) > 1
    for a, b in zip(tds.meta, jds.meta):
        assert a.__dict__ == b.__dict__
    n_history = n_metrics = 0
    for i in range(8):
        got, want = tds[i], jds[i]
        assert set(got) == set(want)
        for k in ("caption", "keys", "mouse", "video_id"):
            assert got[k] == want[k], k
        np.testing.assert_array_equal(got["video"], want["video"])
        assert (got["history"] is None) == (want["history"] is None)
        if got["history"] is not None:
            np.testing.assert_array_equal(got["history"], want["history"])
            n_history += 1
        n_metrics += "Actual distance moved" in got["caption"]
    assert tds.rng.getstate() == jds.rng.getstate()
    assert (n_history > 0) == history and n_metrics > 0
    assert tdataset.last_reader == reader


def test_dataset_rerolls_a_failed_sample(tmp_path):
    """A clip that cannot be decoded rerolls a random index, in the same
    draw order as JAX's."""
    root = str(tmp_path / "clips")
    write_tree(root)
    broken = os.path.join(root, "Keys_A_Mouse_→", "cityB_seg_07_frames_120-142.mp4")
    with open(broken, "wb") as f:
        f.write(b"not a video")
    tds = tdataset.ControlVideoDataset(root, n_sample_frames=5, height=16, width=16, seed=3)
    jds = jdataset.ControlVideoDataset(root, n_sample_frames=5, height=16, width=16, seed=3)
    bad = [m.mp4_path for m in tds.meta].index(broken)
    got, want = tds[bad], jds[bad]
    assert got["video_id"] == want["video_id"] != "cityB_seg_07"
    np.testing.assert_array_equal(got["video"], want["video"])


def test_trim_to_4n_plus_1():
    for n in (1, 4, 5, 8, 9, 33, 34):
        v = np.arange(n)
        np.testing.assert_array_equal(tdataset.trim_to_4n_plus_1(v),
                                      jdataset.trim_to_4n_plus_1(v))


def test_transforms_equal():
    import random

    tcrop = ttransforms.TemporalRandomCrop(9, random.Random(4))
    jcrop = jtransforms.TemporalRandomCrop(9, random.Random(4))
    assert [tcrop(n) for n in (5, 9, 30, 100)] == [jcrop(n) for n in (5, 9, 30, 100)]
    lengths = [5, 9, 9, 3, 17, 5, 9, 1, 12]
    for drop_last in (True, False):
        got = list(ttransforms.LengthGroupedSampler(lengths, 2, seed=7, drop_last=drop_last))
        assert got == list(jtransforms.LengthGroupedSampler(lengths, 2, seed=7,
                                                             drop_last=drop_last))
        assert all(len(b) == 2 for b in got) or not drop_last
    rng = np.random.default_rng(2)
    samples = [{"video": rng.standard_normal((t, 2, 2, 3)).astype(np.float32),
                "caption": f"c{t}", "id": t} for t in (3, 5, 4)]
    got, want = ttransforms.collate(samples), jtransforms.collate(samples)
    assert got.keys() == want.keys() and got["caption"] == want["caption"]
    np.testing.assert_array_equal(got["video"], want["video"])
    assert got["video"].shape == (3, 5, 2, 2, 3) and not got["video"][0, 3:].any()


# -- the loader (as tests/test_data.py:105-165) ----------------------------------------


def test_prefetch_loader():
    def sample(i):
        time.sleep(0.01)
        return {"x": np.full((2, 2), i, np.float32), "id": i}

    loader = PrefetchLoader(sample, batch_size=2, num_workers=2, prefetch=3)
    seen = set()
    for _ in range(4):
        b = next(loader)
        assert b["x"].shape == (2, 2, 2)
        assert all((b["x"][j] == i).all() for j, i in enumerate(b["id"]))
        seen.update(b["id"])
    loader.close()
    assert seen == set(range(8))


@pytest.mark.parametrize("cls", [PrefetchLoader, JaxLoader], ids=["port", "jax"])
def test_prefetch_loader_disjoint_strides(cls):
    """Each process draws its own stride of the global stream; together
    they cover it without overlap (the port and JAX alike)."""
    n_proc, per_proc = 4, []
    for p in range(n_proc):
        loader = cls(lambda i: {"id": i}, batch_size=2, num_workers=1, process_index=p,
                     process_count=n_proc)
        got = set()
        for _ in range(3):
            got.update(next(loader)["id"])
        loader.close()
        assert all(i % n_proc == p for i in got), (p, got)
        per_proc.append(got)
    union = set()
    for s in per_proc:
        assert union.isdisjoint(s)
        union |= s
    assert union == set(range(n_proc * 2 * 3))


def test_prefetch_loader_stress_many_workers():
    """16 workers (more than the cores) on a 50 µs switch interval draw
    disjoint, contiguous indices: the shared stream position loses no
    update."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(5e-5)
    loader = PrefetchLoader(lambda i: {"id": i}, batch_size=3, num_workers=16, prefetch=8)
    try:
        ids = [i for _ in range(200) for i in next(loader)["id"]]
    finally:
        loader.close()
        sys.setswitchinterval(old)
    assert all(not t.is_alive() for t in loader._threads)
    assert len(ids) == len(set(ids)) == 600
    assert set(ids) <= set(range(600 + 16 * 3 + 8 * 3))


def test_prefetch_loader_propagates_errors():
    def bad(i):
        raise ValueError(f"boom {i}")

    loader = PrefetchLoader(bad, batch_size=1, num_workers=1)
    try:
        with pytest.raises(ValueError, match="boom"):
            next(loader)
    finally:
        loader.close()


def test_loader_reads_the_rank_of_torch_distributed(monkeypatch):
    """Without arguments the loader takes the rank and world size of an
    initialised ``torch.distributed`` group, else (0, 1)."""
    import torch.distributed as dist

    assert process_rank() == (0, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    assert process_rank() == (2, 3)
    loader = PrefetchLoader(lambda i: {"id": i}, batch_size=2, num_workers=1)
    try:
        assert (loader.process_index, loader.process_count) == (2, 3)
        assert next(loader)["id"] == [2, 5]
    finally:
        loader.close()
