"""The port's own copies of the JAX package's jax-free modules stay equal to
them: every config dataclass (field names, types, defaults and factory
configs), the sigma ladders, the offline tokenizer, the key/mouse control
vocabulary, the template prompt refiner, the video and PSNR helpers.

Exact comparisons: these are copies, not re-implementations.
"""

import dataclasses

import numpy as np
import pytest

from torch_parity import port_config
from yume_tpu import configs as jconfigs
from yume_tpu.data import controls as jcontrols
from yume_tpu.data import prompt_refine as jrefine
from yume_tpu.data import tokenizer as jtok
from yume_tpu.diffusion import schedule as jschedule
from yume_tpu.utils import metrics as jmetrics
from yume_tpu.utils import video as jvideo
from yume_tpu_torch import configs as tconfigs
from yume_tpu_torch.data import controls as tcontrols
from yume_tpu_torch.data import prompt_refine as trefine
from yume_tpu_torch.data import tokenizer as ttok
from yume_tpu_torch.diffusion import schedule as tschedule
from yume_tpu_torch.utils import metrics as tmetrics
from yume_tpu_torch.utils import video as tvideo

CLASSES = ("DiTConfig", "VAEConfig", "T5Config", "CLIPConfig", "PipelineConfig")


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = dataclasses.asdict(f.default_factory())
        out.append((f.name, str(f.type), default))
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_config_classes_equal(name):
    jcls, tcls = getattr(jconfigs, name), getattr(tconfigs, name)
    assert _fields(tcls) == _fields(jcls)
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


@pytest.mark.parametrize("name", sorted(jconfigs.CONFIGS))
def test_factory_configs_equal(name):
    assert sorted(tconfigs.CONFIGS) == sorted(jconfigs.CONFIGS)
    want = jconfigs.CONFIGS[name]()
    got = tconfigs.CONFIGS[name]()
    assert got == port_config(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.dit.head_dim == want.dit.head_dim


@pytest.mark.parametrize("steps,shift", [(4, 7.0), (50, 5.0), (12, 3.0)])
def test_sigma_ladders_equal(steps, shift):
    np.testing.assert_array_equal(tschedule.sampling_sigmas(steps, shift),
                                  jschedule.sampling_sigmas(steps, shift))
    np.testing.assert_array_equal(tschedule.unipc_sigmas(steps, shift),
                                  jschedule.unipc_sigmas(steps, shift))
    t = np.linspace(0.01, 0.99, 7)
    np.testing.assert_array_equal(tschedule.shift_t(t, shift), jschedule.shift_t(t, shift))
    np.testing.assert_array_equal(tschedule.unshift_t(t, shift), jschedule.unshift_t(t, shift))
    assert tschedule.lin_mu(1024) == jschedule.lin_mu(1024)
    assert tschedule.time_shift(0.7, 1.0, 0.3) == jschedule.time_shift(0.7, 1.0, 0.3)


def test_tokenizer_equal():
    texts = ["The camera moves forward along a sunlit forest path.",
             "  turn   left\ttoward the river ", ""]
    for seq_len, vocab in ((512, 256384), (16, 64)):
        want = jtok.Tokenizer(seq_len=seq_len, vocab_size=vocab, warn_fallback=False)(texts)
        got = ttok.Tokenizer(seq_len=seq_len, vocab_size=vocab, warn_fallback=False)(texts)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert ttok.resolve_tokenizer_path("hash", "/ckpt") is None
    assert ttok.resolve_tokenizer_path(None, None) == jtok.resolve_tokenizer_path(None, None)


def test_controls_equal(tmp_path):
    assert tcontrols.BASE_CAPTION == jcontrols.BASE_CAPTION
    assert tcontrols.KEY_VOCAB == jcontrols.KEY_VOCAB
    assert tcontrols.MOUSE_VOCAB == jcontrols.MOUSE_VOCAB
    for keys in list(jcontrols.KEY_VOCAB) + ["Q", ""]:
        for mouse in list(jcontrols.MOUSE_VOCAB) + ["?"]:
            assert tcontrols.control_caption(keys, mouse) == jcontrols.control_caption(keys, mouse)
    assert tcontrols.control_caption("W", "→", base="B.", metrics="M.") == \
        jcontrols.control_caption("W", "→", base="B.", metrics="M.")
    for text in ("Start Frame: 1381\nEnd Frame: 1431\nKeys: W+A\nMouse: →\n",
                 "Keys: None\n", "\n"):
        path = tmp_path / "c.txt"
        path.write_text(text, encoding="utf-8")
        assert tcontrols.parse_control_txt(str(path)) == jcontrols.parse_control_txt(str(path))


def test_template_refiner_equal():
    for prompt in ("Person moves forward (W).", "a first-person view of a street", ""):
        assert trefine.TemplateRefiner()(prompt) == jrefine.TemplateRefiner()(prompt)
    assert type(trefine.get_refiner(None)).__name__ == type(jrefine.get_refiner(None)).__name__


def test_video_and_metrics_equal(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.uniform(-1.3, 1.3, (3, 8, 8, 3)).astype(np.float32)
    w = np.clip(v + 0.05 * rng.standard_normal(v.shape).astype(np.float32), -1, 1)
    np.testing.assert_array_equal(tvideo.to_uint8(v), jvideo.to_uint8(v))
    assert tmetrics.psnr(v, w) == jmetrics.psnr(v, w)
    assert tmetrics.psnr(v, v) == jmetrics.psnr(v, v) == float("inf")
    np.testing.assert_array_equal(tmetrics.per_frame_psnr(v[None], w[None]),
                                  jmetrics.per_frame_psnr(v[None], w[None]))
    path = str(tmp_path / "f.png")
    tvideo.save_image(v[0], path)
    np.testing.assert_array_equal(tvideo.load_image(path, size=(4, 6)),
                                  jvideo.load_image(path, size=(4, 6)))


def test_i2v_constants_equal():
    """The port's copies of the Wan2.1 latent normalisation and the CLIP
    normalisation (the JAX modules import jax, so the port keeps its own)."""
    from yume_tpu.models import clip as jclip
    from yume_tpu.models import vae as jvae
    from yume_tpu_torch.models import clip as tclip
    from yume_tpu_torch.models import vae as tvae

    for got, want in ((tvae.WAN21_LATENT_MEAN, jvae.WAN21_LATENT_MEAN),
                      (tvae.WAN21_LATENT_STD, jvae.WAN21_LATENT_STD),
                      (tclip.CLIP_MEAN, jclip.CLIP_MEAN), (tclip.CLIP_STD, jclip.CLIP_STD)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("config", ["ti2v-5B", "i2v-14B"])
def test_smoke_configs_equal(config, monkeypatch):
    """``sample.smoke_config`` against the config the JAX CLI's
    ``load_pipeline`` builds its pipeline from with ``--smoke`` (taken at
    the pipeline's ``from_config``, before anything is initialised)."""
    from yume_tpu import sample as jsample
    from yume_tpu.pipelines.i2v import I2VPipeline
    from yume_tpu.pipelines.ti2v import TI2VPipeline
    from yume_tpu_torch import sample as tsample

    class Built(Exception):
        pass

    def capture(cls, cfg, *a, **kw):
        raise Built(cfg)

    for cls in (I2VPipeline, TI2VPipeline):
        monkeypatch.setattr(cls, "from_config", classmethod(capture))
    with pytest.raises(Built) as built:
        jsample.load_pipeline(jsample.build_argparser().parse_args(
            ["--config", config, "--smoke"]))
    want = built.value.args[0]
    assert tsample.smoke_config(tconfigs.CONFIGS[config]()) == port_config(want)
