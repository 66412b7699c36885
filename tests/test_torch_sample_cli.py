"""The port's sampling CLI (``python -m yume_tpu_torch.sample``) on the CPU:
the hand-written safetensors reader against the ``safetensors`` package
(bit for bit, fp32, fp16, bf16 and integers, sharded with an index),
``load_pipeline`` on a checkpoint directory in the released layout against
JAX's ``load_torch_weights`` pipeline (``generate_t2v`` and a continuation
segment on injected noise), the same for the 14B's released layout
(``Wan2.1_VAE.pth`` and the CLIP file too; ``generate`` on injected noise),
``main`` in every 5B and 14B mode at the reference's smoke configs, the
refusals of what is not ported, and the defaults.

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


def test_released_layout_loads_a_pipeline_stage(released):
    """A ``--pp`` rank other than 0: no VAE nor umT5, and of the DiT's blocks
    only its stage's (the other stage's stay on the meta device, the load
    strict all the same)."""
    from yume_tpu_torch.parallel.pipeline import stage_keep

    d, sds, _, _ = released
    cfg = sample.run_config(sample.build_argparser().parse_args(["--smoke"]))
    pipe = sample.load_torch_weights(cfg, str(d), device="cpu", dtype=torch.float32,
                                     encoders=False, dit_keep=stage_keep(2, 2, 1))
    assert pipe.vae is None and pipe.t5 is None
    for k, t in pipe.dit.state_dict().items():
        assert t.is_meta == k.startswith("blocks.0."), k
        if not t.is_meta:
            np.testing.assert_array_equal(t.numpy(), sds["dit"][k], err_msg=k)


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


def _tokens(texts):
    from yume_tpu_torch.data.tokenizer import Tokenizer

    tok = Tokenizer(seq_len=32, vocab_size=4096, warn_fallback=False)
    return [tok([t]) for t in texts]


def _as_stored(sd, num_layers):
    """A quantized state dict of reference names with each block's
    self-attention q, k and v joined into ``qkv``, as the port's trunk
    stores them."""
    sd = dict(sd)
    for i in range(num_layers):
        p = f"blocks.{i}.self_attn."
        for leaf in ("q", "scale", "bias"):
            sd[f"{p}qkv.{leaf}"] = np.concatenate([sd.pop(f"{p}{a}.{leaf}") for a in "qkv"])
    return sd


def _quantized_5b(released, argv):
    """JAX's CLI path (``load_torch_weights``, then ``quantize_int8`` in
    ``main``) and the port's (``load_pipeline``, ``quantize_trunk``) on the
    released layout; the same bits on both sides."""
    from yume_tpu.sample import build_argparser as jax_argparser, load_pipeline
    from yume_tpu_torch.models.quantized import is_quantized

    d = released[0]
    jargs = jax_argparser().parse_args(["--smoke", "--ckpt_dir", str(d)] + argv)
    _, jpipe = load_pipeline(jargs)
    args = sample.build_argparser().parse_args(
        ["--smoke", "--device", "cpu", "--ckpt_dir", str(d)] + argv)
    cfg, tpipe = sample.load_pipeline(args)
    sample.quantize_trunk(args, cfg, tpipe)
    return jargs, jpipe, tpipe, is_quantized


@pytest.mark.parametrize("flag", ["--int8", "--int4"])
def test_released_layout_quantized_matches_jax(released, flag):
    """``--smoke --int8``/``--int4`` on the 5B: the trunk quantized at load
    (the same int8 or int4 bits as JAX's), then ``generate_t2v`` (Euler on
    the quantized trunk) and a continuation segment, on injected noise."""
    _, jpipe, tpipe, is_quantized = _quantized_5b(released, [flag])
    bits = 4 if flag == "--int4" else 8
    jpipe.quantize_int8(bits=bits)
    assert is_quantized(tpipe.dit) and tpipe.dit.quant_bits == bits
    want_sd = _as_stored(convert.quantized_dit_state_dict(*jpipe.dit_params, 2), 2)
    got_sd = tpipe.dit.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got_sd[k].numpy(), v, err_msg=k)
    (ids, mask), = _tokens(["Person moves forward (W)."])
    jctx, tctx = jpipe.encode_text(jnp.asarray(ids), jnp.asarray(mask)), tpipe.encode_text(ids,
                                                                                           mask)
    rng = np.random.default_rng(66)
    noise = rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32)
    tail = rng.standard_normal((1, 2, 4, 4, 8)).astype(np.float32)
    kw = dict(size=(32, 32), frame_num=5, steps=2)
    want = jpipe.generate_t2v(jctx, noise=jnp.asarray(noise), return_latents=True, **kw)
    got = tpipe.generate_t2v(tctx, noise=torch.from_numpy(noise), return_latents=True, **kw)
    assert np.abs(np.asarray(want) - noise).max() > 1e-2
    assert_close(got, want, LATENT_TOL)
    want = jpipe.generate_segment(want, jctx, steps=2, noise=jnp.asarray(tail))
    got = tpipe.generate_segment(got, tctx, steps=2, noise=torch.from_numpy(tail))
    assert_close(got, want, LATENT_TOL)


def test_released_layout_unipc_int8_matches_jax(released):
    """``--t2v --sample_solver unipc --int8``: UniPC with CFG on the bf16
    trunk, then the trunk quantized for the continuation, as both CLIs do."""
    _, jpipe, tpipe, is_quantized = _quantized_5b(
        released, ["--t2v", "--sample_solver", "unipc", "--int8"])
    assert not is_quantized(tpipe.dit)
    (ids, mask), (nids, nmask) = _tokens(["Person moves forward (W).", ""])
    jctx, tctx = jpipe.encode_text(jnp.asarray(ids), jnp.asarray(mask)), tpipe.encode_text(ids,
                                                                                           mask)
    jnull = jpipe.encode_text(jnp.asarray(nids), jnp.asarray(nmask))
    tnull = tpipe.encode_text(nids, nmask)
    rng = np.random.default_rng(67)
    noise = rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32)
    tail = rng.standard_normal((1, 2, 4, 4, 8)).astype(np.float32)
    kw = dict(size=(32, 32), frame_num=5, steps=2, solver="unipc", guide_scale=5.0)
    want = jpipe.generate_t2v(jctx, ctx_null=jnull, noise=jnp.asarray(noise),
                              return_latents=True, **kw)
    got = tpipe.generate_t2v(tctx, ctx_null=tnull, noise=torch.from_numpy(noise),
                             return_latents=True, **kw)
    assert_close(got, want, LATENT_TOL)
    jpipe.quantize_int8(bits=8)
    tpipe.quantize_int8(8)
    want = jpipe.generate_segment(want, jctx, steps=2, noise=jnp.asarray(tail))
    got = tpipe.generate_segment(got, tctx, steps=2, noise=torch.from_numpy(tail))
    assert tpipe.dit.quant_bits == 8
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
    "int8": ["--t2v", "--int8", "--sample_num", "2"],
    "int4_w8a8_teacache": ["--jpg_dir", "{jpg}", "--int4", "--w8a8", "--teacache",
                           "--sample_num", "2"],
    "unipc_int8": ["--t2v", "--sample_solver", "unipc", "--int8", "--sample_num", "2"],
}
# (sampler, teacache_interval, teacache_threshold) of each mode's continuation
SEGMENT_KW = {"t2v": ("euler", 3, None), "jpg": ("euler", 3, None), "sde": ("sde", 3, None),
              "time_travel": ("time_travel", 3, None), "sde_time_travel": ("tts", 3, None),
              "teacache": ("teacache", 3, 0.1), "teacache_interval": ("teacache", 2, None),
              "refine_captions": ("euler", 3, None), "memory_optimization": ("euler", 3, None),
              "int8": ("euler", 3, None), "int4_w8a8_teacache": ("teacache", 3, 0.1),
              "unipc_int8": ("euler", 3, None)}
# the trunk's storage bits while the first segment and the continuations run
# (the multistep t2v solver quantizes after its first segment)
QUANT_BITS = {"int8": (8, 8), "int4_w8a8_teacache": (4, 4), "unipc_int8": (None, 8)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_main_writes_segments(mode, inputs, tmp_path, monkeypatch):
    seen, bits = [], []
    real, real_t2v = TI2VPipeline.generate_segment, TI2VPipeline.generate_t2v

    def spy(self, *a, **kw):
        seen.append((kw["sampler"], kw["teacache_interval"], kw["teacache_threshold"]))
        bits.append(getattr(self.dit, "quant_bits", None))
        return real(self, *a, **kw)

    def spy_t2v(self, *a, **kw):
        bits.append(getattr(self.dit, "quant_bits", None))
        return real_t2v(self, *a, **kw)

    encoded = []
    real_encode = TI2VPipeline.encode_text
    monkeypatch.setattr(TI2VPipeline, "generate_segment", spy)
    monkeypatch.setattr(TI2VPipeline, "generate_t2v", spy_t2v)
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
    first, rest = QUANT_BITS.get(mode, (None, None))
    assert bits == [first] + [rest] * (n - 1)


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


# argv and what the refusal must name: a ROADMAP queue 1 item, or for a flag
# that means nothing for the model asked for, the model it is for (a 14B run
# without an image or a video: JAX's message)
SAMPLE_REFUSED = {
    "config_14b": (["--config", "i2v-14B"], "pipeline needs --jpg_dir .image mode., "
                                            "--input_video, or --video_root_dir"),
    "distilled": (["--distilled"], "i2v-14B"),
    "cfg_parallel": (["--cfg_parallel"], "i2v-14B"),
}
WEBAPP_REFUSED = {
    "config_14b": (["--config", "i2v-14B"], "the webapp serves the 5B"),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_REFUSED))
def test_sample_refuses_unported(case, tmp_path):
    argv, item = SAMPLE_REFUSED[case]
    match = f"ROADMAP queue 1, {item}" if item.startswith("item") else item
    with pytest.raises((NotImplementedError, SystemExit), match=match) as refused:
        sample.main(["--smoke", "--device", "cpu", "--output_dir", str(tmp_path)] + argv)
    assert refused.type is (NotImplementedError if item.startswith("item") else SystemExit)


@pytest.mark.parametrize("case", sorted(WEBAPP_REFUSED))
def test_webapp_refuses_unported(case, tmp_path):
    argv, item = WEBAPP_REFUSED[case]
    args = webapp.build_argparser().parse_args(
        ["--smoke", "--device", "cpu", "--output_dir", str(tmp_path)] + argv)
    match = f"ROADMAP queue 1, {item}" if item.startswith("item") else item
    with pytest.raises(NotImplementedError, match=match):
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



# -- the 14B ---------------------------------------------------------------------------


def _jax_smoke_config_14b():
    """The JAX CLI's 14B smoke config (yume_tpu/sample.py:143-163)."""
    import dataclasses

    from yume_tpu.configs import CONFIGS, CLIPConfig, DiTConfig, T5Config, VAEConfig

    return dataclasses.replace(
        CONFIGS["i2v-14B"](),
        dit=DiTConfig(model_type="i2v", in_dim=18, out_dim=8, dim=128, ffn_dim=256,
                      freq_dim=64, text_dim=32, text_len=32, num_heads=4, num_layers=2,
                      framepack=True, image_context_len=5, image_dim=12),
        vae=VAEConfig(z_dim=8, base_dim=8, dim_mult=(1, 2, 2), num_res_blocks=1,
                      temporal_downsample=(True, False), stride=(2, 4, 4), patchify=1,
                      arch="wan21"),
        t5=T5Config(vocab_size=4096, dim=32, dim_attn=32, dim_ffn=48, num_heads=2,
                    num_layers=1, text_len=32),
        clip=CLIPConfig(image_size=16, patch_size=8, dim=12, num_heads=2, num_layers=1,
                        out_tokens=5),
        latent_frame_zero=2).check_i2v_channels()


@pytest.fixture(scope="module")
def released_14b(tmp_path_factory):
    """The JAX 14B smoke pipeline's modules with perturbed parameters, written
    as the released files: the DiT through the reference's exporter as
    sharded safetensors, ``Wan2.1_VAE.pth``, umT5, and the CLIP file (the
    visual tower's tensors under ``visual.``, with a last block and a text
    tensor the tower does not use). Then JAX's ``load_torch_weights`` into a
    pipeline without parameters, and the port's ``load_pipeline``. JAX's
    loader converts a Wan2.1 VAE as the released file's four stages
    (``convert_vae21_state_dict``'s ``n_stages`` default); the smoke VAE has
    three, so the fixture passes that count to it."""
    import functools

    from test_torch_pipeline import _params
    from yume_tpu.utils import checkpoint as jcheckpoint
    from yume_tpu.models.clip import CLIPVisual
    from yume_tpu.models.dit import WanDiT
    from yume_tpu.models.t5 import T5Encoder
    from yume_tpu.models.vae import WanVAE
    from yume_tpu.pipelines.i2v import I2VPipeline as JaxPipeline
    from yume_tpu.sample import load_torch_weights
    from yume_tpu.utils.checkpoint import export_dit_state_dict, save_sharded_safetensors

    d = tmp_path_factory.mktemp("ckpt14b")
    c = _jax_smoke_config_14b()
    dit, vae = WanDiT(c.dit, dtype=jnp.float32), WanVAE(c.vae)
    t5, clip = T5Encoder(c.t5, dtype=jnp.float32), CLIPVisual(c.clip)
    ids = jnp.zeros((1, 32), jnp.int32)
    src = JaxPipeline(
        c, dit, _params(dit, 71, jnp.zeros((1, 3, 8, 8, 18)), jnp.zeros((1, 3)),
                        jnp.zeros((1, 32, 32)), packed=False,
                        clip_context=jnp.zeros((1, 5, 12))),
        vae, _params(vae, 72, jnp.zeros((1, 5, 32, 32, 3))),
        t5, _params(t5, 73, ids, jnp.ones_like(ids)),
        clip, _params(clip, 74, jnp.zeros((1, 16, 16, 3))))
    sds = convert.pipeline_state_dicts(src)
    save_sharded_safetensors(export_dit_state_dict(src.dit_params, c.dit.num_layers), str(d))
    released_clip = {f"visual.{k}": torch.from_numpy(v) for k, v in sds["clip"].items()}
    released_clip["visual.transformer.1.norm1.weight"] = torch.ones(12)
    released_clip["textual.token_embedding.weight"] = torch.zeros(4, 12)
    torch.save(released_clip, str(d / sample.CLIP_FILE))
    for name, key in ((sample.VAE21_FILE, "vae"), (sample.T5_FILE, "t5")):
        torch.save({k: torch.from_numpy(v) for k, v in sds[key].items()}, str(d / name))
    jpipe = JaxPipeline(c, dit, None, vae, None, t5, None, clip, None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcheckpoint, "convert_vae21_state_dict",
                   functools.partial(jcheckpoint.convert_vae21_state_dict,
                                     n_stages=len(c.vae.dim_mult)))
        load_torch_weights(jpipe, str(d))
    with torch_threads(2):
        args = sample.build_argparser().parse_args(
            ["--config", "i2v-14B", "--smoke", "--device", "cpu", "--ckpt_dir", str(d)])
        cfg, tpipe = sample.load_pipeline(args)
        yield d, sds, jpipe, tpipe


def test_smoke_config_14b_is_the_references():
    from yume_tpu_torch.configs import i2v_14b

    assert sample.smoke_config(i2v_14b()) == port_config(_jax_smoke_config_14b())


def test_released_layout_14b_loads_whole(released_14b):
    d, sds, _, tpipe = released_14b
    from yume_tpu_torch.pipelines.i2v import I2VPipeline

    assert isinstance(tpipe, I2VPipeline)
    for name, module in (("dit", tpipe.dit), ("vae", tpipe.vae), ("t5", tpipe.t5),
                         ("clip", tpipe.clip)):
        got = module.state_dict()
        assert set(got) == set(sds[name]), name
        for k, v in sds[name].items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_released_layout_14b_generate_matches_jax(released_14b):
    """The umT5 context and ``generate`` (an image segment, 5 frames of
    32×32, 2 CFG Euler steps) on JAX's noise: latents and video."""
    import jax

    from yume_tpu_torch.data.tokenizer import Tokenizer

    _, _, jpipe, tpipe = released_14b
    tok = Tokenizer(seq_len=32, vocab_size=4096, warn_fallback=False)
    ctxs = []
    for text in ("Person moves forward (W).", ""):
        ids, mask = tok([text])
        jctx = jpipe.encode_text(jnp.asarray(ids), jnp.asarray(mask))
        tctx = tpipe.encode_text(ids, mask)
        assert_close(tctx, jctx, CTX_TOL)
        ctxs.append((jctx, tctx))
    img = np.random.default_rng(75).uniform(-1, 1, (1, 1, 32, 32, 3)).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 3, 8, 8, 8), jnp.float32))
    want_lat, want_video = jpipe.generate(jnp.asarray(img), ctxs[0][0], ctxs[1][0],
                                          frame_num=5, steps=2)
    got_lat, got_video = tpipe.generate(torch.from_numpy(img), ctxs[0][1], ctxs[1][1],
                                        frame_num=5, steps=2, noise=torch.from_numpy(noise))
    assert np.abs(np.asarray(want_lat)[:, -2:] - noise[:, -2:]).max() > 1e-2
    assert_close(got_lat, want_lat, LATENT_TOL)
    assert_close(got_video, want_video, VIDEO_TOL)


@pytest.mark.parametrize("case", ["int4_memory_optimization", "cfg_parallel"])
def test_released_layout_14b_quantized_and_cfg_parallel_match_jax(released_14b, case):
    """``--config i2v-14B --int4 --memory_optimization``: JAX's CLI streams
    the DiT from the released safetensors into int4 storage
    (``_host_dit_tree``, ``quantize_host_blocks``); the port's
    ``quantize_trunk`` makes the same bits without a bf16 trunk and parks
    it in the phase shuttle as ``dit_q``. ``--cfg_parallel``: both
    pipelines batch cond and uncond. Then ``generate`` on JAX's noise."""
    import dataclasses

    import jax

    from yume_tpu.models.quantized import quantize_host_blocks
    from yume_tpu.sample import _host_dit_tree, build_argparser as jax_argparser

    d, _, jbase, _ = released_14b
    argv = ["--int4", "--memory_optimization"] if case.startswith("int4") else ["--cfg_parallel"]
    args = sample.build_argparser().parse_args(
        ["--config", "i2v-14B", "--smoke", "--device", "cpu", "--ckpt_dir", str(d),
         "--jpg_dir", "jpg"] + argv)
    cfg, tpipe = sample.load_pipeline(args)
    if case.startswith("int4"):
        jargs = jax_argparser().parse_args(["--config", "i2v-14B", "--smoke", "--ckpt_dir",
                                            str(d), "--int4"])
        jpipe = dataclasses.replace(jbase, dit_params=quantize_host_blocks(
            _host_dit_tree(jargs, jbase.config, jbase), 2, 4))
        assert tpipe.dit is None
        slot = sample.offload_slot(cfg, tpipe, "cpu")
        sample.quantize_trunk(args, cfg, tpipe, slot)
        assert "dit_q" in slot and tpipe.dit.quant_bits == 4
        # both keep the non-quantized tensors in bf16
        want_sd = _as_stored(convert.quantized_dit_state_dict(*jpipe.dit_params, 2), 2)
        got_sd = {k: v.float() if v.is_floating_point() else v
                  for k, v in tpipe.dit.state_dict().items()}
        assert set(got_sd) == set(want_sd)
        for k, v in want_sd.items():
            np.testing.assert_array_equal(got_sd[k].numpy(), v, err_msg=k)
    else:
        jpipe = dataclasses.replace(jbase, cfg_parallel=True)
        tpipe.cfg_parallel = True
    (ids, mask), (nids, nmask) = _tokens(["Person moves forward (W).", ""])
    jctx, tctx = jpipe.encode_text(jnp.asarray(ids), jnp.asarray(mask)), tpipe.encode_text(ids,
                                                                                           mask)
    jnull = jpipe.encode_text(jnp.asarray(nids), jnp.asarray(nmask))
    tnull = tpipe.encode_text(nids, nmask)
    img = np.random.default_rng(76).uniform(-1, 1, (1, 1, 32, 32, 3)).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 3, 8, 8, 8), jnp.float32))
    want_lat, want_video = jpipe.generate(jnp.asarray(img), jctx, jnull, frame_num=5, steps=2)
    got_lat, got_video = tpipe.generate(torch.from_numpy(img), tctx, tnull, frame_num=5,
                                        steps=2, noise=torch.from_numpy(noise))
    assert np.abs(np.asarray(want_lat)[:, -2:] - noise[:, -2:]).max() > 1e-2
    assert_close(got_lat, want_lat, LATENT_TOL)
    assert_close(got_video, want_video, VIDEO_TOL)


def test_released_layout_14b_is_strict(released_14b, tmp_path):
    d, sds, _, tpipe = released_14b
    for name in (sample.T5_FILE, sample.VAE21_FILE):
        os.symlink(d / name, tmp_path / name)
    with pytest.raises(RuntimeError, match=f"missing: DiT .*{sample.CLIP_FILE}"):
        sample.load_torch_weights(tpipe.config, str(tmp_path), device="cpu")
    from yume_tpu_torch.pipelines.i2v import I2VPipeline

    clip = dict(sds["clip"])
    clip.pop("pre_norm.bias")
    with pytest.raises(KeyError, match="lacks 1 keys"):
        I2VPipeline.from_state_dicts(tpipe.config, sds["dit"], sds["vae"], clip_sd=clip,
                                     device="cpu", dtype=torch.float32)


MODES_14B = {
    "euler": [],
    "teacache": ["--teacache"],
    "teacache_interval": ["--teacache", "--teacache_interval", "2"],
    "sde_time_travel": ["--sde", "--time_travel"],
    "distilled": ["--distilled"],
    "w8a8": ["--w8a8"],
    "memory_optimization": ["--memory_optimization", "--caption_file", "{captions}"],
    "int4_memory_optimization": ["--int4", "--memory_optimization", "--caption_file",
                                 "{captions}"],
    "int8_w8a8_teacache": ["--int8", "--w8a8", "--teacache"],
    "cfg_parallel": ["--cfg_parallel"],
}
# the first segment's (sampler, teacache_interval, teacache_threshold)
GENERATE_KW_14B = {"euler": ("euler", 3, None), "teacache": ("teacache", 3, 0.1),
                   "teacache_interval": ("teacache", 2, None),
                   "sde_time_travel": ("tts", 3, None), "distilled": ("euler", 3, None),
                   "w8a8": ("euler", 3, None), "memory_optimization": ("euler", 3, None),
                   "int4_memory_optimization": ("euler", 3, None),
                   "int8_w8a8_teacache": ("teacache", 3, 0.1), "cfg_parallel": ("euler", 3, None)}
# (the trunk's bits, the batch of each forward) of the quantized and CFG-parallel modes
FORWARDS_14B = {"int4_memory_optimization": (4, 1), "int8_w8a8_teacache": (8, 1),
                "cfg_parallel": (None, 2)}


@pytest.mark.parametrize("mode", sorted(MODES_14B))
def test_main_14b_writes_segments(mode, inputs, tmp_path, monkeypatch):
    """``--config i2v-14B --jpg_dir`` with 2 samples: ``generate`` with the
    mode's sampler writes ``segment_000``, one ``generate_next`` of 32
    frames (Euler, as the reference passes no sampler) writes
    ``segment_001``; ``ctx_null`` is the negative prompt's context unless
    ``--distilled``. Under ``--memory_optimization`` umT5 waits on the host
    while the DiT runs, and the VAE and CLIP while umT5 runs."""
    from yume_tpu_torch.pipelines.i2v import I2VPipeline

    seen, nexts, devices = [], [], []
    real_gen, real_next = I2VPipeline.generate, I2VPipeline.generate_next

    def spy_gen(self, frames, ctx, ctx_null, **kw):
        if not kw.get("history_mode"):
            seen.append((kw["sampler"], kw["teacache_interval"], kw["teacache_threshold"],
                         ctx_null is None, tuple(frames.shape)))
        real_dit = self.dit.forward

        def dit_forward(*a, **k):
            devices.append((next(self.t5.parameters()).device.type,
                            next(self.vae.parameters()).device.type,
                            next(self.clip.parameters()).device.type))
            return real_dit(*a, **k)
        self.dit.forward = dit_forward
        try:
            return real_gen(self, frames, ctx, ctx_null, **kw)
        finally:
            del self.dit.forward

    def spy_next(self, video, ctx, ctx_null, **kw):
        nexts.append((tuple(video.shape), kw, ctx_null is None))
        return real_next(self, video, ctx, ctx_null, **kw)

    forwards = []

    def spy_dense(self, x, *a, **k):
        forwards.append((getattr(self, "quant_bits", None), x.shape[0]))
        return real_dense(self, x, *a, **k)

    from yume_tpu_torch.models.dit import WanDiT

    real_dense = WanDiT.forward
    monkeypatch.setattr(WanDiT, "forward", spy_dense)
    monkeypatch.setattr(I2VPipeline, "generate", spy_gen)
    monkeypatch.setattr(I2VPipeline, "generate_next", spy_next)
    fill = dict(captions=str(inputs / "captions.txt"))
    argv = [a.format(**fill) for a in MODES_14B[mode]]
    with torch_threads(2):
        assert sample.main(["--config", "i2v-14B", "--smoke", "--device", "cpu",
                            "--jpg_dir", str(inputs / "jpg"), "--sample_num", "2",
                            "--output_dir", str(tmp_path)] + argv) == 0
    for s in range(2):
        assert os.path.getsize(tmp_path / f"segment_{s:03d}.mp4") > 0, s
    assert not os.path.exists(tmp_path / "segment_002.mp4")
    distilled = mode == "distilled"
    assert seen == [GENERATE_KW_14B[mode] + (distilled, (1, 1, 32, 32, 3))]
    assert len(nexts) == 1
    shape, kw, no_null = nexts[0]
    assert shape == (1, 5, 32, 32, 3) and kw["frame_zero"] == 32 and no_null == distilled
    assert "sampler" not in kw and kw["seed"] == 1
    if mode == "memory_optimization":
        assert devices and all(d == ("cpu", "cpu", "cpu") for d in devices)
    bits, batch = FORWARDS_14B.get(mode, (None, 1))
    assert forwards and all(f == (bits, batch) for f in forwards), forwards
