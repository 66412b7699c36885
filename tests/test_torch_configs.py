"""The port's own copies of the JAX package's jax-free modules stay equal to
them: every config dataclass (field names, types, defaults and factory
configs), the sigma ladders and the offline tokenizer.

Exact comparisons: these are copies, not re-implementations.
"""

import dataclasses

import numpy as np
import pytest

from torch_parity import port_config
from yume_tpu import configs as jconfigs
from yume_tpu.data import tokenizer as jtok
from yume_tpu.diffusion import schedule as jschedule
from yume_tpu_torch import configs as tconfigs
from yume_tpu_torch.data import tokenizer as ttok
from yume_tpu_torch.diffusion import schedule as tschedule

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
