"""The port's sampling CLI (``python -m yume_tpu_torch.sample``) on the CPU:
the hand-written safetensors reader against the ``safetensors`` package
(bit for bit, fp32, fp16, bf16 and integers, sharded with an index),
``load_pipeline`` on a checkpoint directory in the released layout against
JAX's ``load_torch_weights`` pipeline (``generate_t2v`` and a continuation
segment on injected noise), ``main`` in every 5B mode at the reference's
smoke config, the refusals of what is not ported, and the defaults.

Tolerances, as ``test_torch_pipeline.py``: context 1e-5, latents 1e-4,
video 1e-3 (fp32; XLA:CPU and ATen sum float32 in another order, both
pipelines round the latent to bf16 before the DiT, and the decoder
amplifies the last bits). The reader is exact.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_checkpoint_roundtrip import _save_sharded_safetensors
from torch_parity import assert_close, port_config, torch_threads
from yume_tpu_torch import sample
from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
from yume_tpu_torch.serving import webapp
from yume_tpu_torch.utils import convert
from yume_tpu_torch.utils.checkpoint import load_safetensors_state_dict, read_safetensors

CTX_TOL, LATENT_TOL, VIDEO_TOL = 1e-5, 1e-4, 1e-3


# -- the safetensors reader ------------------------------------------------------


def _tensors(dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = [(3, 5), (7,), (2, 3, 4), (), (1, 1)]
    out = {}
    for i, shape in enumerate(shapes):
        a = torch.from_numpy(np.array(rng.standard_normal(shape) * 100, np.float32))
        out[f"blocks.{i}.w"] = a.to(dtype) if dtype.is_floating_point else \
            a.round().clamp(-127, 127).abs().to(dtype)
    return out


def _bits_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_safetensors_reader_sharded_fp32(tmp_path):
    """The released layout as ``test_checkpoint_roundtrip.py`` writes it:
    three fp32 shards and ``diffusion_pytorch_model.safetensors.index.json``."""
    sd = _tensors(torch.float32, 51)
    _save_sharded_safetensors(sd, str(tmp_path))
    assert os.path.exists(tmp_path / "diffusion_pytorch_model.safetensors.index.json")
    _bits_equal(load_safetensors_state_dict(str(tmp_path)), sd)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.int64, torch.int32,
                                   torch.int8, torch.uint8])
def test_safetensors_reader_dtypes(tmp_path, dtype):
    """Each dtype against the package's own reader, as a sharded directory
    with an index, a directory without one, and a single file."""
    from safetensors.torch import load_file, save_file

    sd = _tensors(dtype, 52)
    names = sorted(sd)
    shards = {"a.safetensors": names[:2], "b.safetensors": names[2:]}
    for fname, keys in shards.items():
        save_file({k: sd[k] for k in keys}, str(tmp_path / fname), metadata={"format": "pt"})
        _bits_equal(read_safetensors(str(tmp_path / fname)), load_file(str(tmp_path / fname)))
    _bits_equal(load_safetensors_state_dict(str(tmp_path)), sd)
    with open(tmp_path / "diffusion_pytorch_model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: fn for fn, ks in shards.items() for k in ks}}, f)
    _bits_equal(load_safetensors_state_dict(str(tmp_path)), sd)


def test_safetensors_reader_refuses_bad_files(tmp_path):
    from safetensors.torch import save_file

    save_file({"w": torch.ones(4)}, str(tmp_path / "a.safetensors"))
    raw = (tmp_path / "a.safetensors").read_bytes()
    (tmp_path / "short.safetensors").write_bytes(raw[:-4])        # data cut short
    with pytest.raises(ValueError, match="data offsets"):
        read_safetensors(str(tmp_path / "short.safetensors"))
    (tmp_path / "header.safetensors").write_bytes((10 ** 9).to_bytes(8, "little") + raw[8:])
    with pytest.raises(ValueError, match="header"):
        read_safetensors(str(tmp_path / "header.safetensors"))
    os.remove(tmp_path / "short.safetensors")
    os.remove(tmp_path / "header.safetensors")
    with open(tmp_path / "diffusion_pytorch_model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {"w": "a.safetensors", "v": "a.safetensors"}}, f)
    with pytest.raises(KeyError, match="no shard holds"):
        load_safetensors_state_dict(str(tmp_path))


# -- a checkpoint directory in the released layout ----------------------------------


def _jax_smoke_config():
    """The JAX CLI's 5B smoke config (yume_tpu/sample.py:165-178)."""
    import dataclasses

    from yume_tpu.configs import CONFIGS, DiTConfig, T5Config, VAEConfig

    return dataclasses.replace(
        CONFIGS["ti2v-5B"](),
        dit=DiTConfig(model_type="ti2v", in_dim=8, out_dim=8, dim=128, ffn_dim=256,
                      freq_dim=64, text_dim=32, text_len=32, num_heads=4, num_layers=2,
                      framepack=True),
        vae=VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                      temporal_downsample=(True, False), stride=(2, 8, 8), patchify=2),
        t5=T5Config(vocab_size=4096, dim=32, dim_attn=32, dim_ffn=48, num_heads=2,
                    num_layers=1, text_len=32),
        latent_frame_zero=2)


def test_smoke_config_is_the_references():
    from yume_tpu_torch.configs import ti2v_5b

    assert sample.smoke_config(ti2v_5b()) == port_config(_jax_smoke_config())


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """The JAX smoke pipeline's modules with perturbed parameters (from
    their shapes, as ``test_torch_pipeline.py``), written as the released
    files: the DiT through the reference's exporter as sharded safetensors
    with an index, the VAE and umT5 as ``.pth`` state dicts. Then JAX's
    ``load_torch_weights`` into a pipeline without parameters, and the
    port's ``load_pipeline``."""
    from test_torch_pipeline import _params
    from yume_tpu.models.dit import WanDiT
    from yume_tpu.models.t5 import T5Encoder
    from yume_tpu.models.vae import WanVAE
    from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxPipeline
    from yume_tpu.sample import load_torch_weights
    from yume_tpu.utils.checkpoint import export_dit_state_dict, save_sharded_safetensors

    d = tmp_path_factory.mktemp("ckpt")
    c = _jax_smoke_config()
    dit, vae, t5 = WanDiT(c.dit, dtype=jnp.float32), WanVAE(c.vae), T5Encoder(c.t5,
                                                                              dtype=jnp.float32)
    ids = jnp.zeros((1, 32), jnp.int32)
    src = JaxPipeline(c, dit, _params(dit, 61, jnp.zeros((1, 3, 4, 4, 8)), jnp.zeros((1, 3)),
                                      jnp.zeros((1, 32, 32)), packed=False),
                      vae, _params(vae, 62, jnp.zeros((1, 5, 32, 32, 3))),
                      t5, _params(t5, 63, ids, jnp.ones_like(ids)))
    sds = convert.pipeline_state_dicts(src)
    save_sharded_safetensors(export_dit_state_dict(src.dit_params, c.dit.num_layers), str(d))
    for name, key in ((sample.VAE_FILE, "vae"), (sample.T5_FILE, "t5")):
        torch.save({k: torch.from_numpy(v) for k, v in sds[key].items()}, str(d / name))
    jpipe = JaxPipeline(c, dit, None, vae, None, t5, None)
    load_torch_weights(jpipe, str(d))
    with torch_threads(2):
        args = sample.build_argparser().parse_args(
            ["--smoke", "--device", "cpu", "--ckpt_dir", str(d)])
        cfg, tpipe = sample.load_pipeline(args)
        yield d, sds, jpipe, tpipe


def test_released_layout_loads_whole(released):
    d, sds, _, tpipe = released
    for name, module in (("dit", tpipe.dit), ("vae", tpipe.vae), ("t5", tpipe.t5)):
        got = module.state_dict()
        assert set(got) == set(sds[name]), name
        for k, v in sds[name].items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert tpipe.device.type == "cpu" and next(tpipe.dit.parameters()).dtype == torch.float32


def test_released_layout_rollout_matches_jax(released):
    """The umT5 context, ``generate_t2v`` (5 frames of 32×32, 2 Euler
    steps) and its decode, and a continuation segment, on injected noise."""
    from yume_tpu_torch.data.tokenizer import Tokenizer

    _, _, jpipe, tpipe = released
    tok = Tokenizer(seq_len=32, vocab_size=4096, warn_fallback=False)
    ids, mask = tok(["Person moves forward (W).Camera remains still (·)."])
    jctx = jpipe.encode_text(jnp.asarray(ids), jnp.asarray(mask))
    tctx = tpipe.encode_text(ids, mask)
    assert_close(tctx, jctx, CTX_TOL)
    rng = np.random.default_rng(64)
    noise = rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32)
    tail = rng.standard_normal((1, 2, 4, 4, 8)).astype(np.float32)
    kw = dict(size=(32, 32), frame_num=5, steps=2)
    want = jpipe.generate_t2v(jctx, noise=jnp.asarray(noise), return_latents=True, **kw)
    got = tpipe.generate_t2v(tctx, noise=torch.from_numpy(noise), return_latents=True, **kw)
    assert np.abs(np.asarray(want) - noise).max() > 1e-2     # the DiT moved the latents
    assert_close(got, want, LATENT_TOL)
    assert_close(tpipe.decode_auto(got), jpipe.decode_auto(want), VIDEO_TOL)
    want = jpipe.generate_segment(want, jctx, steps=2, noise=jnp.asarray(tail))
    got = tpipe.generate_segment(got, tctx, steps=2, noise=torch.from_numpy(tail))
    assert_close(got, want, LATENT_TOL)


def test_released_layout_is_strict(released, tmp_path):
    d, sds, _, tpipe = released
    os.symlink(d / sample.T5_FILE, tmp_path / sample.T5_FILE)
    with pytest.raises(RuntimeError, match="missing: DiT .*Wan2.2_VAE.pth"):
        sample.load_torch_weights(tpipe.config, str(tmp_path), device="cpu")
    vae = dict(sds["vae"])
    vae.pop("encoder.conv1.weight")
    with pytest.raises(KeyError, match="lacks 1 keys"):
        TI2VPipeline.from_state_dicts(tpipe.config, sds["dit"], vae, device="cpu",
                                      dtype=torch.float32)


# -- main at the smoke config --------------------------------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("inputs")
    os.makedirs(d / "jpg")
    Image.fromarray((np.random.default_rng(65).random((48, 40, 3)) * 255).astype(np.uint8)) \
        .save(str(d / "jpg" / "frame.png"))
    (d / "captions.txt").write_text("Person moves forward (W).\n\nCamera turns left (←).\n")
    return d


MODES = {
    "t2v": ["--t2v", "--sample_num", "2"],
    "jpg": ["--jpg_dir", "{jpg}", "--sample_num", "2"],
    "sde": ["--t2v", "--sde", "--sample_num", "2"],
    "time_travel": ["--t2v", "--time_travel", "--sample_num", "2"],
    "sde_time_travel": ["--jpg_dir", "{jpg}", "--sde", "--time_travel", "--sample_num", "2"],
    "teacache": ["--t2v", "--teacache", "--sample_num", "2"],
    "teacache_interval": ["--t2v", "--teacache", "--teacache_interval", "2",
                          "--sample_num", "2"],
    "refine_captions": ["--t2v", "--refine_prompt", "--caption_file", "{captions}",
                        "--sample_num", "3"],
    "memory_optimization": ["--t2v", "--memory_optimization", "--w8a8", "--sample_num", "2"],
    "unipc_profile": ["--t2v", "--sample_solver", "unipc", "--profile_dir", "{out}/trace"],
}
# (sampler, teacache_interval, teacache_threshold) of each mode's continuation
SEGMENT_KW = {"t2v": ("euler", 3, None), "jpg": ("euler", 3, None), "sde": ("sde", 3, None),
              "time_travel": ("time_travel", 3, None), "sde_time_travel": ("tts", 3, None),
              "teacache": ("teacache", 3, 0.1), "teacache_interval": ("teacache", 2, None),
              "refine_captions": ("euler", 3, None), "memory_optimization": ("euler", 3, None)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_main_writes_segments(mode, inputs, tmp_path, monkeypatch):
    seen = []
    real = TI2VPipeline.generate_segment

    def spy(self, *a, **kw):
        seen.append((kw["sampler"], kw["teacache_interval"], kw["teacache_threshold"]))
        return real(self, *a, **kw)

    encoded = []
    real_encode = TI2VPipeline.encode_text
    monkeypatch.setattr(TI2VPipeline, "generate_segment", spy)
    monkeypatch.setattr(TI2VPipeline, "encode_text",
                        lambda self, ids, mask: encoded.append(ids) or real_encode(self, ids,
                                                                                   mask))
    fill = dict(jpg=str(inputs / "jpg"), captions=str(inputs / "captions.txt"), out=tmp_path)
    argv = [a.format(**fill) for a in MODES[mode]]
    with torch_threads(2):
        assert sample.main(["--smoke", "--device", "cpu", "--output_dir", str(tmp_path)]
                           + argv) == 0
    n = int(argv[argv.index("--sample_num") + 1]) if "--sample_num" in argv else 1
    for s in range(n):
        assert os.path.getsize(tmp_path / f"segment_{s:03d}.mp4") > 0, s
    assert not os.path.exists(tmp_path / f"segment_{n:03d}.mp4")
    image_mode = "--jpg_dir" in argv
    assert len(seen) == n - 1 + image_mode
    assert all(s == SEGMENT_KW[mode] for s in seen) if seen else mode == "unipc_profile"
    if mode == "refine_captions":      # one refined caption a segment, the last one repeated
        from yume_tpu_torch.data.prompt_refine import TemplateRefiner
        from yume_tpu_torch.data.tokenizer import Tokenizer

        tok = Tokenizer(seq_len=32, vocab_size=4096, warn_fallback=False)
        want = [tok([TemplateRefiner()(c)])[0] for c in
                ("Person moves forward (W).", "Camera turns left (←).")]
        assert len(encoded) == 3
        for got, w in zip(encoded, want + want[1:]):
            np.testing.assert_array_equal(got, w)
    if mode == "unipc_profile":
        assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_teacache_flags():
    parse = sample.build_argparser().parse_args
    assert sample.teacache_settings(parse(["--teacache"])) == (3, sample.TEACACHE_THRESHOLD)
    assert sample.teacache_settings(parse(["--teacache", "--teacache_threshold", "0.2"])) \
        == (3, 0.2)
    assert sample.teacache_settings(parse(["--teacache", "--teacache_interval", "4"])) \
        == (4, None)
    for bad in (["--teacache_interval", "0"], ["--teacache_interval", "2",
                                                "--teacache_threshold", "0.1"]):
        with pytest.raises(SystemExit):
            sample.teacache_settings(parse(["--teacache"] + bad))
    assert "fixed interval" in sample.build_argparser().format_help()


def test_entry_points_default_to_cuda():
    assert sample.build_argparser().parse_args([]).device == "cuda"
    assert webapp.build_argparser().parse_args([]).device == "cuda"


# -- refusals -------------------------------------------------------------------------


SAMPLE_REFUSED = {
    "config_14b": (["--config", "i2v-14B"], "item 6"),
    "distilled": (["--distilled"], "item 6"),
    "cfg_parallel": (["--cfg_parallel"], "item 6"),
    "int8": (["--int8"], "item 6"),
    "int4": (["--int4"], "item 6"),
    "pp": (["--pp", "2"], "item 8"),
    "sp": (["--sp", "2"], "item 4"),
    "input_video": (["--input_video", "clip.mp4"], "item 3"),
    "video_root_dir": (["--video_root_dir", "videos"], "item 3"),
}
WEBAPP_REFUSED = {
    "config_14b": (["--config", "i2v-14B"], "item 6"),
    "quant_int8": (["--quant", "int8"], "item 6"),
    "quant_int4": (["--quant", "int4"], "item 6"),
    "pp": (["--pp", "2"], "item 8"),
    "sp": (["--sp", "2"], "item 4"),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_REFUSED))
def test_sample_refuses_unported(case, tmp_path):
    argv, item = SAMPLE_REFUSED[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        sample.main(["--smoke", "--device", "cpu", "--output_dir", str(tmp_path)] + argv)


@pytest.mark.parametrize("case", sorted(WEBAPP_REFUSED))
def test_webapp_refuses_unported(case, tmp_path):
    argv, item = WEBAPP_REFUSED[case]
    args = webapp.build_argparser().parse_args(
        ["--smoke", "--device", "cpu", "--output_dir", str(tmp_path)] + argv)
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        webapp.WebApp(args)


def test_model_refiners_refused(tmp_path):
    from yume_tpu_torch.data.prompt_refine import TemplateRefiner, get_refiner

    assert isinstance(get_refiner(None), TemplateRefiner)
    for model in ("remote", "/models/InternVL3-2B"):
        with pytest.raises(NotImplementedError, match="not queued"):
            get_refiner(model)
    with pytest.raises(NotImplementedError, match="not queued"):
        sample.main(["--smoke", "--device", "cpu", "--output_dir", str(tmp_path),
                     "--refine_prompt", "--refiner_model", "remote"])
    args = webapp.build_argparser().parse_args(
        ["--smoke", "--device", "cpu", "--output_dir", str(tmp_path), "--refiner_model", "x"])
    with pytest.raises(NotImplementedError, match="not queued"):
        webapp.WebApp(args)


def test_save_video_falls_back_to_npy(tmp_path, monkeypatch, capsys):
    """With neither imageio nor cv2 the frames go to ``<path>.npy`` as
    uint8, a line says so, and the path written comes back."""
    import sys

    from yume_tpu_torch.utils.video import save_video, to_uint8

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    video = np.random.default_rng(66).uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    path = str(tmp_path / "clip.mp4")
    assert save_video(video, path, retry=1) == path + ".npy"
    assert not os.path.exists(path)
    np.testing.assert_array_equal(np.load(path + ".npy"), to_uint8(video))
    assert f"wrote {path}.npy" in capsys.readouterr().out
