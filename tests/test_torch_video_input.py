"""The port's video-input serving mode and the rest of its data path on the
CPU, against the JAX package: ``iter_video_samples`` (arrays, captions and
tags, strided by rank), ``_run_video``'s pipeline calls on JAX's noise
draws (the 5B's ``encode_auto``, segments and tail decodes; the 14B's
repeated-first-frame history and growing ``generate_next``), ``main`` in
both video modes at the reference's smoke configs, the preprocess CLI and
``LatentDataset``, and ``train.main --smoke --data_dir`` (its first batch
against JAX's, its MVDT keep counts).

The pipelines hold the released-layout checkpoints of
``test_torch_sample_cli.py`` (perturbed JAX weights, loaded by both).
Tolerances as there: context 1e-5, latents 1e-4, video 1e-3 (fp32; XLA:CPU
and ATen sum in another order, and the decoder amplifies the last bits);
a second 14B continuation's latents as ``test_torch_i2v.py`` holds
``generate_next``'s, 2e-3 (both pipelines round the DiT input to bf16).
The clips are small mp4s written with OpenCV's mp4v writer.
"""

import argparse
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import write_clip, write_tree
from test_torch_sample_cli import released, released_14b  # noqa: F401 (fixtures)
from torch_parity import assert_close, torch_threads
from yume_tpu_torch import sample
from yume_tpu_torch.pipelines.i2v import I2VPipeline
from yume_tpu_torch.pipelines.ti2v import TI2VPipeline

CTX_TOL, LATENT_TOL, VIDEO_TOL = 1e-5, 1e-4, 1e-3
# test_torch_i2v.py's bound on a generate_next's latents: one bf16 step of a
# DiT input carried to the output
BF16_STEP_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three categories of control-annotated clips (``test_torch_data``'s
    tree) and a lone clip."""
    root = tmp_path_factory.mktemp("videos")
    write_tree(str(root / "clips"))
    write_clip(str(root / "clip.mp4"), 12, seed=30)
    return str(root / "clips"), str(root / "clip.mp4")


def _sample_args(pkg, argv):
    return pkg.build_argparser().parse_args(["--smoke"] + argv)


# -- iter_video_samples -------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
def test_iter_video_samples_equal(tree, smoke):
    from yume_tpu import sample as jsample

    root, clip = tree
    args = argparse.Namespace(input_video=clip, video_root_dir=root, smoke=smoke,
                              video_frames=7, prompt="fallback")
    size = (32, 32) if smoke else (40, 24)
    got = list(sample.iter_video_samples(args, size))
    want = list(jsample.iter_video_samples(args, size))
    # the lone clip, then every mp4 of the scan (those without a .txt too)
    assert len(got) == len(want) == 7
    for (v, cap, tag), (jv, jcap, jtag) in zip(got, want):
        assert (cap, tag) == (jcap, jtag)
        assert v.shape == (1, 5 if smoke else 7, size[1], size[0], 3)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert [c for _, c, _ in got].count("fallback") == 2   # the lone clip, the one without .txt
    from yume_tpu_torch.data.controls import control_caption

    assert got[1][1] == control_caption("A", "→")


def test_iter_video_samples_strides_by_rank(tree, monkeypatch):
    """Two ranks serve disjoint clips of the scan, tagged by global index,
    as JAX's two processes do."""
    from yume_tpu import sample as jsample
    from yume_tpu_torch.data import loader

    root, _ = tree
    args = argparse.Namespace(input_video=None, video_root_dir=root, smoke=True,
                              video_frames=5, prompt="p")
    tags = []
    for rank in (0, 1):
        monkeypatch.setattr(loader, "process_rank", lambda r=rank: (r, 2))
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        got = [(c, t) for _, c, t in sample.iter_video_samples(args, (32, 32))]
        assert got == [(c, t) for _, c, t in jsample.iter_video_samples(args, (32, 32))]
        tags += [t for _, t in got]
    assert sorted(tags) == [f"video{i:03d}" for i in range(6)]


# -- _run_video's pipeline calls ------------------------------------------------------


class Calls:
    """Records the outputs of pipeline methods and the arrays handed to
    ``save_video``; the port's sampling calls get JAX's noise draws."""

    def __init__(self, monkeypatch, cls, names, video_module, inject=None):
        self.out = {n: [] for n in names}
        self.saved = []
        for name in names:
            real = getattr(cls, name)

            def spy(self_, *a, _real=real, _name=name, **kw):
                if inject is not None:
                    kw = inject(_name, self_, a, kw)
                r = _real(self_, *a, **kw)
                self.out[_name].append(r)
                return r
            monkeypatch.setattr(cls, name, spy)
        monkeypatch.setattr(video_module, "save_video",
                            lambda v, path, fps=16: self.saved.append((os.path.basename(path),
                                                                       np.asarray(v))) or path)


def _jax_normal(seed, shape):
    return torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                                         jnp.float32)))


def _inject_segment_noise(name, pipe, a, kw):
    if name == "generate_segment":
        b, _, h, w, c = a[0].shape
        kw["noise"] = _jax_normal(kw["seed"], (b, pipe.config.latent_frame_zero, h, w, c))
    return kw


def _inject_i2v_noise(name, pipe, a, kw):
    if name == "generate":
        b, _, h, w, _ = a[0].shape
        s = pipe.config.vae.stride
        f_lat = (kw["frame_num"] - 1) // s[0] + 1
        kw["noise"] = _jax_normal(kw["seed"], (b, f_lat, h // s[1], w // s[2],
                                               pipe.config.vae.z_dim))
    return kw


def _encoders(jpipe, tpipe):
    from yume_tpu_torch.data.tokenizer import Tokenizer

    tok = Tokenizer(seq_len=32, vocab_size=4096, warn_fallback=False)
    return (lambda text: jpipe.encode_text(*map(jnp.asarray, tok([text]))),
            lambda text: tpipe.encode_text(*tok([text])))


def test_run_video_5b_matches_jax(released, tree, tmp_path, monkeypatch):  # noqa: F811
    """The 5B video mode on the lone clip, 2 samples: ``encode_auto`` of its
    5 frames, two segments continuing it and their tail decodes."""
    from yume_tpu import sample as jsample
    from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxPipeline
    from yume_tpu.utils import video as jvideo
    from yume_tpu_torch.utils import video as tvideo
    from yume_tpu_torch.utils.logging_ import PhaseTimer

    _, _, jpipe, tpipe = released
    _, clip = tree
    names = ("encode_auto", "generate_segment", "decode_auto")
    jcalls = Calls(monkeypatch, JaxPipeline, names, jvideo)
    tcalls = Calls(monkeypatch, TI2VPipeline, names, tvideo, _inject_segment_noise)
    argv = ["--input_video", clip, "--sample_num", "2", "--output_dir", str(tmp_path)]
    jenc, tenc = _encoders(jpipe, tpipe)
    jsample._run_video(_sample_args(jsample, argv), jpipe.config, jpipe, jenc, "euler",
                       (32, 32), 2)
    sample._run_video(_sample_args(sample, argv), tpipe.config, tpipe, tenc, "euler",
                      (3, None), (32, 32), 2, None, PhaseTimer())
    for name, tol in zip(names, (LATENT_TOL, LATENT_TOL, VIDEO_TOL)):
        assert len(tcalls.out[name]) == len(jcalls.out[name]) == (1 if name == names[0] else 2)
        for got, want in zip(tcalls.out[name], jcalls.out[name]):
            assert_close(got, want, tol)
    assert tcalls.out["generate_segment"][1].shape == (1, 7, 4, 4, 8)
    assert [n for n, _ in tcalls.saved] == ["video000_seg000.mp4", "video000_seg001.mp4"]
    for (_, got), (_, want) in zip(tcalls.saved, jcalls.saved):
        assert got.shape == want.shape == (3, 32, 32, 3)     # 2 latent frames
        np.testing.assert_allclose(got, want, atol=VIDEO_TOL, rtol=0)


@pytest.mark.parametrize("distilled", [False, True], ids=["cfg", "distilled"])
def test_run_video_14b_matches_jax(released_14b, tree, tmp_path, monkeypatch,  # noqa: F811
                                   distilled):
    """The 14B video mode on the lone clip, 2 samples: the first frame
    repeated 8 times in front of its 5 frames (13 ≡ 1 mod the stride 2),
    then two ``generate_next`` of 2 frames, the second on the first's whole
    decoded video; with CFG or cond-only (``--distilled``). As in
    ``test_torch_i2v.py``, the port's second continuation starts from JAX's
    video, so that each continuation is held alone (the videos differ by up
    to ``VIDEO_TOL``)."""
    from yume_tpu import sample as jsample
    from yume_tpu.pipelines.i2v import I2VPipeline as JaxPipeline
    from yume_tpu.utils import video as jvideo
    from yume_tpu_torch.utils import video as tvideo
    from yume_tpu_torch.utils.logging_ import PhaseTimer

    _, _, jpipe, tpipe = released_14b
    _, clip = tree
    jhist, thist = [], []
    real_j, real_t = JaxPipeline.generate_next, I2VPipeline.generate_next

    def jax_next(self, history, ctx, ctx_null, **kw):
        jhist.append((np.asarray(history), ctx_null is None))
        return real_j(self, history, ctx, ctx_null, **kw)

    def port_next(self, history, ctx, ctx_null, **kw):
        thist.append((history, ctx_null is None))
        return real_t(self, torch.from_numpy(jhist[len(thist) - 1][0]), ctx, ctx_null, **kw)

    monkeypatch.setattr(JaxPipeline, "generate_next", jax_next)
    monkeypatch.setattr(I2VPipeline, "generate_next", port_next)
    jcalls = Calls(monkeypatch, JaxPipeline, ("generate",), jvideo)
    tcalls = Calls(monkeypatch, I2VPipeline, ("generate",), tvideo, _inject_i2v_noise)
    argv = ["--config", "i2v-14B", "--input_video", clip, "--sample_num", "2",
            "--output_dir", str(tmp_path)] + (["--distilled"] if distilled else [])
    jenc, tenc = _encoders(jpipe, tpipe)
    jsample._run_video(_sample_args(jsample, argv), jpipe.config, jpipe, jenc, "euler",
                       (32, 32), 2)
    sample._run_video(_sample_args(sample, argv), tpipe.config, tpipe, tenc, "euler",
                      (3, None), (32, 32), 2, None, PhaseTimer())
    assert [(h.shape, null) for h, null in thist] == [((1, 13, 32, 32, 3), distilled),
                                                      ((1, 15, 32, 32, 3), distilled)]
    assert [null for _, null in jhist] == [distilled] * 2
    # the repeated first frame and the clip exactly; the grown history to VIDEO_TOL
    np.testing.assert_array_equal(thist[0][0].numpy(), jhist[0][0])
    assert_close(thist[1][0], jhist[1][0], VIDEO_TOL)
    # the first continuation's latents to 1e-4; the second's, on the same
    # input, to test_torch_i2v.py's generate_next bound: 20 of its 4,608
    # latents differ by up to 5.6e-4, one bf16 rounding of a DiT input apart
    for got, want, tol in zip(tcalls.out["generate"], jcalls.out["generate"],
                              (LATENT_TOL, BF16_STEP_TOL)):
        assert_close(got[0], want[0], tol)
        assert_close(got[1], want[1], VIDEO_TOL)
    assert tcalls.out["generate"][1][1].shape == (1, 17, 32, 32, 3)
    assert [n for n, _ in tcalls.saved] == ["video000_seg000.mp4", "video000_seg001.mp4"]
    for (_, got), (_, want) in zip(tcalls.saved, jcalls.saved):
        assert got.shape == want.shape == (2, 32, 32, 3)
        np.testing.assert_allclose(got, want, atol=VIDEO_TOL, rtol=0)


# -- main in the video modes ----------------------------------------------------------


MODES = {"5b": [], "5b_teacache_w8a8": ["--teacache", "--w8a8"],
         "5b_memory_optimization": ["--memory_optimization"],
         "14b": ["--config", "i2v-14B"], "14b_teacache": ["--config", "i2v-14B", "--teacache"],
         "14b_distilled": ["--config", "i2v-14B", "--distilled"],
         "14b_memory_optimization": ["--config", "i2v-14B", "--memory_optimization"]}
CASES = [("5b", "video_root_dir"), ("5b", "input_video"),
         ("5b_teacache_w8a8", "video_root_dir"), ("5b_memory_optimization", "video_root_dir"),
         ("14b", "video_root_dir"), ("14b", "input_video"), ("14b_teacache", "input_video"),
         ("14b_distilled", "input_video"), ("14b_memory_optimization", "input_video")]


@pytest.mark.parametrize("mode,source", CASES)
def test_main_writes_video_segments(mode, source, tree, tmp_path, monkeypatch):
    """``main`` in the video mode: one file per clip and sample; the 5B
    encodes each clip once and continues it, the 14B passes the sampler and
    the cond-only choice to every ``generate_next`` of a growing history."""
    root, clip = tree
    seen = []
    for cls, name in ((TI2VPipeline, "generate_segment"), (I2VPipeline, "generate_next")):
        real = getattr(cls, name)

        def spy(self, x, ctx, *a, _real=real, **kw):
            seen.append((tuple(x.shape), kw.get("sampler"), a[0] is None if a else None))
            return _real(self, x, ctx, *a, **kw)
        monkeypatch.setattr(cls, name, spy)
    src = ["--video_root_dir", root] if source == "video_root_dir" else ["--input_video", clip]
    assert sample.main(["--smoke", "--device", "cpu", "--sample_num", "2", "--output_dir",
                        str(tmp_path)] + src + MODES[mode]) == 0
    n_clips = 6 if source == "video_root_dir" else 1
    want = [f"video{i:03d}_seg{s:03d}.mp4" for i in range(n_clips) for s in range(2)]
    assert sorted(os.listdir(tmp_path)) == want
    assert all(os.path.getsize(tmp_path / f) > 0 for f in want)
    sampler = "teacache" if "--teacache" in MODES[mode] else "euler"
    if mode.startswith("14b"):
        assert seen == [((1, 13, 32, 32, 3), sampler, "--distilled" in MODES[mode]),
                        ((1, 15, 32, 32, 3), sampler, "--distilled" in MODES[mode])] * n_clips
    else:
        assert seen == [((1, 3, 4, 4, 8), sampler, None), ((1, 5, 4, 4, 8), sampler,
                                                           None)] * n_clips


def test_video_mode_without_clips_raises(tmp_path):
    os.makedirs(tmp_path / "empty" / "Keys_W_Mouse_·")
    for config in ("ti2v-5B", "i2v-14B"):
        with pytest.raises(FileNotFoundError, match="no input videos"):
            sample.main(["--smoke", "--device", "cpu", "--config", config,
                         "--video_root_dir", str(tmp_path / "empty"),
                         "--output_dir", str(tmp_path / "out")])


# -- the preprocess CLI and LatentDataset ---------------------------------------------


def test_preprocess_matches_jax(released, tree, tmp_path, monkeypatch):  # noqa: F811
    """Both preprocess CLIs over the same tree through the same released
    weights: the same manifest, latents at 1e-4, embeddings at 1e-5 and
    masks exactly; then ``LatentDataset`` reads back what the port wrote,
    bit for bit, as JAX's reads it (with CFG dropout to
    ``uncond_embed.npy``)."""
    from yume_tpu import sample as jsample
    from yume_tpu.data import preprocess as jpre
    from yume_tpu.data.latent_dataset import LatentDataset as JaxLatentDataset
    from yume_tpu_torch.data import preprocess as tpre
    from yume_tpu_torch.data.latent_dataset import LatentDataset

    _, _, jpipe, tpipe = released
    root, _ = tree
    monkeypatch.setattr(jsample, "load_pipeline", lambda a: (jpipe.config, jpipe))
    monkeypatch.setattr(sample, "load_pipeline", lambda a: (tpipe.config, tpipe))
    argv = ["--data_dir", root, "--num_frames", "5", "--height", "32", "--width", "32",
            "--max_samples", "3"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jpre.main(argv + ["--output_dir", jout]) == 0
    assert tpre.main(argv + ["--output_dir", tout, "--device", "cpu"]) == 0
    with open(os.path.join(tout, "videos2caption.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(jout, "videos2caption.json")) as f:
        assert manifest == json.load(f)
    assert len(manifest) == 3 and manifest[0]["length"] == 3
    for a in manifest:
        for sub, tol in (("latent", LATENT_TOL), ("prompt_embed", CTX_TOL),
                         ("prompt_attention_mask", 0)):
            got = np.load(os.path.join(tout, sub, a["latent_path"]))
            np.testing.assert_allclose(got, np.load(os.path.join(jout, sub, a["latent_path"])),
                                       atol=tol, rtol=0)
    np.save(os.path.join(tout, "uncond_embed.npy"),
            np.full((32, 32), 0.5, np.float32))
    for cfg_rate in (0.0, 0.5):
        tds = LatentDataset(os.path.join(tout, "videos2caption.json"), cfg_rate=cfg_rate, seed=3)
        jds = JaxLatentDataset(os.path.join(tout, "videos2caption.json"), cfg_rate=cfg_rate,
                               seed=3)
        assert len(tds) == len(jds) == 3
        for i in list(range(3)) * 2:
            got, want = tds[i], jds[i]
            assert got.keys() == want.keys() and got["caption"] == want["caption"]
            for k in ("latents", "context", "context_mask"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        a = manifest[0]
        np.testing.assert_array_equal(tds[0]["latents"],
                                      np.load(os.path.join(tout, "latent", a["latent_path"])))


def test_preprocess_smoke_cli(tmp_path):
    """``python -m yume_tpu_torch.data.preprocess --smoke --device cpu``:
    two synthetic clips through the smoke config, read back."""
    from yume_tpu_torch.data import preprocess
    from yume_tpu_torch.data.latent_dataset import LatentDataset

    assert preprocess.main(["--smoke", "--device", "cpu", "--output_dir", str(tmp_path)]) == 0
    ds = LatentDataset(str(tmp_path / "videos2caption.json"))
    assert len(ds) == 2 and ds[1]["caption"] == "smoke sample 1"
    assert ds[0]["latents"].shape == (3, 4, 4, 8) and ds[0]["context"].shape == (32, 32)
    assert preprocess.build_argparser().parse_args(["--output_dir", "x"]).device == "cuda"


# -- train --data_dir -----------------------------------------------------------------


@pytest.fixture(scope="module")
def encoders(released, tmp_path_factory):  # noqa: F811
    """``--encoders_dir`` for the trainer's smoke config: the released
    VAE (the same smoke VAE) and a perturbed umT5 of the trainer's smoke
    size (vocab 256, dim 16, 16 tokens)."""
    from test_torch_pipeline import _params
    from yume_tpu.configs import T5Config
    from yume_tpu.models.t5 import T5Encoder
    from yume_tpu_torch.utils import convert

    d, _, _, _ = released
    out = tmp_path_factory.mktemp("encoders")
    os.symlink(d / sample.VAE_FILE, out / sample.VAE_FILE)
    c = T5Config(vocab_size=256, dim=16, dim_attn=16, dim_ffn=24, num_heads=2, num_layers=1,
                 text_len=16)
    ids = jnp.zeros((1, 16), jnp.int32)
    t5 = convert.t5_state_dict(_params(T5Encoder(c, dtype=jnp.float32), 81, ids,
                                       jnp.ones_like(ids)), c.num_layers)
    torch.save({k: torch.from_numpy(v) for k, v in t5.items()}, str(out / sample.T5_FILE))
    return str(out)


@pytest.fixture(scope="module")
def one_clip(tmp_path_factory):
    """One 9-frame clip (the smoke run's 9 frames): every sample is the
    whole clip, whichever of the loader's two threads draws it first."""
    root = tmp_path_factory.mktemp("train")
    base = str(root / "Keys_W_Mouse_·" / "walk_frames_0-9")
    write_clip(base + ".mp4", 9, seed=40)
    with open(base + ".txt", "w", encoding="utf-8") as f:
        f.write("Start Frame: 0\nEnd Frame: 9\nKeys: W\nMouse: ·\n")
    return str(root)


def test_train_data_dir_first_batch_matches_jax(encoders, one_clip, tmp_path, monkeypatch):
    """``train.main --smoke --data_dir --encoders_dir``: the first batch
    (the umT5 context of the clip's caption, the full-clip VAE encode of
    its 9 frames at 64×64) against JAX's trainer's. JAX's encoder pipeline
    is built here in fp32 (its default is bf16), to match the port's fp32 on
    the CPU, and without the random parameters that the loaded weights
    replace. JAX stops once its batch is made."""
    from yume_tpu import train as jtrain
    from yume_tpu.data import loader as jloader
    from yume_tpu.models.dit import WanDiT
    from yume_tpu.models.t5 import T5Encoder
    from yume_tpu.models.vae import WanVAE as JaxVAE
    from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxPipeline
    from yume_tpu.utils import logging_ as jlogging
    from yume_tpu_torch import train
    from yume_tpu_torch.models.vae import WanVAE

    class Stop(Exception):
        pass

    def unset_pipeline(cls, cfg, *a, **kw):
        # fp32 modules without parameters: --encoders_dir loads the VAE and umT5
        return cls(cfg, WanDiT(cfg.dit, dtype=jnp.float32), None, JaxVAE(cfg.vae), None,
                   T5Encoder(cfg.t5, dtype=jnp.float32), None)

    got, want, loaders = {}, {}, []
    real_loader_init = jloader.PrefetchLoader.__init__
    monkeypatch.setattr(JaxPipeline, "from_config", classmethod(unset_pipeline))
    monkeypatch.setattr(jloader.PrefetchLoader, "__init__",
                        lambda self, *a, **kw: loaders.append(self) or real_loader_init(
                            self, *a, **kw))
    for cls, name, into, key in ((JaxPipeline, "_encode", want, "latents"),
                                 (JaxPipeline, "encode_text", want, "context"),
                                 (WanVAE, "encode", got, "latents"),
                                 (TI2VPipeline, "encode_text", got, "context")):
        real = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda self, *a, _r=real, _d=into, _k=key:
                            _d.setdefault(_k, _r(self, *a)))

    @contextlib.contextmanager
    def phase(name):
        yield
        if name == "get_batch":
            raise Stop

    monkeypatch.setattr(jlogging, "phase", phase)
    argv = ["--smoke", "--data_dir", one_clip, "--encoders_dir", encoders,
            "--max_train_steps", "2", "--checkpointing_steps", "0"]
    try:
        with pytest.raises(Stop):
            jtrain.main(argv + ["--output_dir", str(tmp_path / "jax")])
    finally:
        for loader in loaders:
            loader.close()
    assert train.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")]) == 0
    assert got["latents"].shape == (1, 5, 8, 8, 8) and got["context"].shape == (1, 16, 16)
    assert_close(got["context"], want["context"], CTX_TOL)
    assert_close(got["latents"], want["latents"], LATENT_TOL)
    run = train.main.last_run
    assert np.isfinite(run["losses"]).all() and all(g > 0 for g in run["grad_norms"])
    assert len(run["batch_wait_s"]) == len(run["encode_s"]) == 2


def test_train_data_dir_mvdt_keeps_follow_the_batch(one_clip, tmp_path, monkeypatch):
    """``--MVDT --data_dir`` outside the smoke run (the 5B config replaced by
    the trainer's smoke config, 9 frames of 64×64): the geometry counts 5 +
    2 latent frames (76 packed tokens), the batch holds 5 (68), and every
    keep count is a share of the batch's own. Without ``--encoders_dir`` the
    encoders are random and a warning says so."""
    from yume_tpu_torch import configs, train
    from yume_tpu_torch.models.dit import WanDiT, packed_token_count

    monkeypatch.setitem(configs.CONFIGS, "ti2v-5B", lambda: train.smoke_config(False))
    seen = []
    real = WanDiT._maybe_mask
    monkeypatch.setattr(WanDiT, "_maybe_mask", lambda self, tokens, *a: seen.append(
        (tokens.shape[1], a[-1])) or real(self, tokens, *a))
    out = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: out.append(" ".join(map(str, a))))
    assert train.main(["--device", "cpu", "--MVDT", "--data_dir", one_clip, "--num_frames", "9",
                       "--height", "64", "--width", "64", "--max_train_steps", "3",
                       "--checkpointing_steps", "0", "--output_dir", str(tmp_path)]) == 0
    n_tok = packed_token_count(3, 2, 8, 8, (1, 2, 2))
    assert n_tok == 68 and packed_token_count(5, 2, 8, 8, (1, 2, 2)) == 76
    keeps = [int(n_tok * (1.0 - (0.30 + 0.025 * i))) for i in range(9)]
    masked = [(n, k) for n, k in seen if k is not None]     # the plain pass masks nothing
    assert all(n == n_tok for n, _ in seen) and len(masked) == 3, seen
    assert all(k in keeps for _, k in masked), (masked, keeps)
    assert any("encoders are randomly initialised" in line for line in out)
    assert np.isfinite(train.main.last_run["losses"]).all()
