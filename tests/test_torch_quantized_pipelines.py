"""The pipelines' samplers on a quantized DiT trunk against the JAX package
on the CPU, on JAX's noise (and churn draws) injected: JAX's pipeline
quantizes its trunk (``quantize_int8``), and the port's runs the same int8
or int4 bits, carried across by ``utils.convert.quantized_dit_state_dict``.

* TI2V (the reference's 5B smoke config with 4 layers, so that TeaCache's
  edge of 1 leaves a cached middle): the ``euler`` segment, ``teacache``
  at a fixed interval and adaptive (``n_full`` equal), ``generate_t2v``
  with Euler and with UniPC + CFG; the refusals the reference makes (a TTS
  sampler, sequence parallelism on a quantized trunk); ``quantize_int8``
  frees the bf16 trunk's block weights.
* I2V (the reference's 14B smoke config with 4 layers): ``generate`` with
  CFG Euler, ``teacache``, ``tts``, ``cfg_parallel`` (cond and uncond as
  one batch-2 forward) and the distilled cond-only Euler with W8A8,
  latents and videos.

Tolerances as ``test_torch_quantized.py``: latents 1e-4 and videos 1e-3 on
the dequantized trunk; a TeaCache or TTS segment 2e-3 and its video 2e-2
(``test_torch_i2v.py``: one bf16 step of a cached residual or of the DiT
input, carried through the guidance scale); W8A8 segments a relative L2 of
2e-2 (an activation's int8 code a step apart), without guidance: the guidance
scale of 5 multiplies such a step (a CFG Euler segment with W8A8 on int4
came to 2.8e-2), so W8A8 runs the cond-only mode here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_i2v import _jax_draws, _t
from test_torch_pipeline import _params
from test_torch_sample_cli import _jax_smoke_config, _jax_smoke_config_14b
from torch_parity import assert_close, port_config, rel_l2, torch_threads
from yume_tpu.models.clip import CLIPVisual as JaxCLIP
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.models.vae import WanVAE as JaxVAE
from yume_tpu.pipelines.i2v import I2VPipeline as JaxI2V
from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxTI2V
from yume_tpu_torch.models import quantized as tq
from yume_tpu_torch.models.dit import QLinear, WanDiT
from yume_tpu_torch.pipelines.i2v import I2VPipeline
from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
from yume_tpu_torch.utils import convert

TOL, VIDEO_TOL, STEP_TOL, STEP_VIDEO_TOL, W8A8_REL = 1e-4, 1e-3, 2e-3, 2e-2, 2e-2


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with torch_threads(2):
        yield


def _layers(c, n=4):
    return dataclasses.replace(c, dit=dataclasses.replace(c.dit, num_layers=n))


def _w8a8(c, on):
    return dataclasses.replace(c, dit=dataclasses.replace(c.dit, w8a8=on))


def _port_trunk(c, jparams, bits):
    sd = convert.quantized_dit_state_dict(*jparams, c.dit.num_layers)
    return tq.quantized_dit_from_state_dict(port_config(c.dit), sd, bits, device="cpu",
                                            dtype=torch.float32, param_dtype=torch.float32)


def _close(got, want, tol, w8a8):
    if w8a8:
        assert rel_l2(got, want) <= W8A8_REL
    else:
        assert_close(got, want, tol)


# -- TI2V --------------------------------------------------------------------------

TI2V = _layers(_jax_smoke_config())


@pytest.fixture(scope="module")
def ti2v_params():
    dit = JaxDiT(TI2V.dit, dtype=jnp.float32)
    return _params(dit, 41, jnp.zeros((1, 3, 4, 4, 8)), jnp.zeros((1, 3)),
                   jnp.zeros((1, 32, 32)), packed=False)


def _ti2v_pipes(params, bits, w8a8):
    c = _w8a8(TI2V, w8a8)
    jpipe = JaxTI2V(c, JaxDiT(c.dit, dtype=jnp.float32), params, None, None)
    jpipe.quantize_int8(bits)
    tpipe = TI2VPipeline(port_config(c), _port_trunk(c, jpipe.dit_params, bits), None)
    return jpipe, tpipe


# (bits, w8a8, call, kwargs)
TI2V_MODES = {
    "euler": (8, False, "segment", dict(steps=3)),
    "euler_int4_w8a8": (4, True, "segment", dict(steps=3)),
    "teacache_interval": (4, False, "segment", dict(steps=5, sampler="teacache",
                                                    teacache_interval=2)),
    "teacache_adaptive": (8, False, "segment", dict(steps=5, sampler="teacache",
                                                    teacache_threshold=0.3)),
    "t2v_euler": (4, False, "t2v", dict(steps=2)),
    "t2v_unipc_cfg": (8, False, "t2v", dict(steps=3, solver="unipc")),
}


@pytest.mark.parametrize("mode", sorted(TI2V_MODES))
def test_ti2v_quantized_samplers_match_jax(ti2v_params, mode):
    bits, w8a8, call, kw = TI2V_MODES[mode]
    jpipe, tpipe = _ti2v_pipes(ti2v_params, bits, w8a8)
    rng = np.random.default_rng(42)
    ctx, ctx_null = (rng.standard_normal((1, 32, 32)).astype(np.float32) for _ in range(2))
    if call == "t2v":
        noise = rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32)
        if kw.get("solver") == "unipc":
            kw = dict(kw, guide_scale=5.0)
            want = jpipe.generate_t2v(jnp.asarray(ctx), ctx_null=jnp.asarray(ctx_null),
                                      size=(32, 32), frame_num=5, noise=jnp.asarray(noise),
                                      return_latents=True, **kw)
            got = tpipe.generate_t2v(_t(ctx), ctx_null=_t(ctx_null), size=(32, 32),
                                     frame_num=5, noise=_t(noise), return_latents=True, **kw)
        else:
            want = jpipe.generate_t2v(jnp.asarray(ctx), size=(32, 32), frame_num=5,
                                      noise=jnp.asarray(noise), return_latents=True, **kw)
            got = tpipe.generate_t2v(_t(ctx), size=(32, 32), frame_num=5, noise=_t(noise),
                                     return_latents=True, **kw)
        ref = noise
    else:
        hist = rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32)
        tail = rng.standard_normal((1, 2, 4, 4, 8)).astype(np.float32)
        want = jpipe.generate_segment(jnp.asarray(hist), jnp.asarray(ctx),
                                      noise=jnp.asarray(tail), **kw)
        got = tpipe.generate_segment(_t(hist), _t(ctx), noise=_t(tail), **kw)
        ref = np.concatenate([hist, tail], 1)
        if kw.get("sampler") == "teacache":
            assert tpipe.last_teacache_n_full == int(jpipe.last_teacache_n_full)
    assert got.shape == want.shape
    assert np.abs(np.asarray(want) - ref).max() > 1e-2         # the DiT moved the latents
    _close(got, want, STEP_TOL if "teacache" in mode else TOL, w8a8)


def test_ti2v_quantized_refusals_and_frees_the_trunk(ti2v_params):
    """The reference's guards on a quantized trunk, and ``quantize_int8``
    replacing every block projection (its bf16 weight gone) once."""
    _, tpipe = _ti2v_pipes(ti2v_params, 8, False)
    hist, ctx = torch.zeros(1, 3, 4, 4, 8), torch.zeros(1, 32, 32)
    with pytest.raises(NotImplementedError, match="euler/teacache"):
        tpipe.generate_segment(hist, ctx, steps=2, sampler="sde")
    tpipe.sp_groups = object()
    with pytest.raises(NotImplementedError, match="single-chip"):
        tpipe.generate_segment(hist, ctx, steps=2)
    tpipe.sp_groups = None

    sd = convert.dit_state_dict(ti2v_params, TI2V.dit.num_layers)
    dit = WanDiT(port_config(TI2V.dit), torch.float32, device="meta").to_empty(device="cpu")
    convert.load_state_dict(dit, sd)
    pipe = TI2VPipeline(port_config(TI2V), dit, None)
    before = {k for k in dit.state_dict() if k.startswith("blocks.")}
    pipe.quantize_int8(4)
    pipe.quantize_int8(8)                                     # a no-op once quantized
    assert pipe.dit is dit and dit.quant_bits == 4
    after = dit.state_dict()
    weights = {k for k in before if k.endswith(".weight") and k.rsplit(".", 2)[-2] in
               ("q", "k", "v", "o", "0", "2")}
    assert len(weights) == 10 * TI2V.dit.num_layers
    assert not weights & set(after)                           # no bf16 block weight left
    # self-attention q, k and v as one qkv
    stored = [m for m in dit.modules() if isinstance(m, QLinear)]
    assert len(stored) == len(weights) - 2 * TI2V.dit.num_layers
    assert all(m.q.dtype == torch.uint8 for m in stored)
    assert all(f"blocks.{i}.self_attn.qkv.q" in after for i in range(TI2V.dit.num_layers))


# -- I2V ---------------------------------------------------------------------------

I2V = _layers(_jax_smoke_config_14b())


@pytest.fixture(scope="module")
def i2v_parts():
    c = I2V
    dit, vae, clip = JaxDiT(c.dit, dtype=jnp.float32), JaxVAE(c.vae), JaxCLIP(c.clip)
    params = dict(
        dit=_params(dit, 43, jnp.zeros((1, 3, 8, 8, 18)), jnp.zeros((1, 3)),
                    jnp.zeros((1, 32, 32)), packed=False, clip_context=jnp.zeros((1, 5, 12))),
        vae=_params(vae, 44, jnp.zeros((1, 5, 32, 32, 3))),
        clip=_params(clip, 45, jnp.zeros((1, 16, 16, 3))))
    src = JaxI2V(c, dit, params["dit"], vae, params["vae"], None, None, clip, params["clip"])
    sds = convert.pipeline_state_dicts(src)
    tpipe = I2VPipeline.from_state_dicts(port_config(c), None, sds["vae"], clip_sd=sds["clip"],
                                         device="cpu", dtype=torch.float32)
    return params, tpipe


# (bits, w8a8, sampler, kwargs, steps); "distilled" runs without ctx_null
I2V_MODES = {
    "euler": (8, False, "euler", {}, 2),
    "distilled_w8a8": (4, True, "euler", {}, 2),
    "cfg_parallel": (4, False, "euler", {}, 2),
    "teacache_interval": (4, False, "teacache", dict(teacache_interval=2), 4),
    "tts": (8, False, "tts", {}, 3),
}


@pytest.mark.parametrize("mode", sorted(I2V_MODES))
def test_i2v_quantized_samplers_match_jax(i2v_parts, mode):
    params, tbase = i2v_parts
    bits, w8a8, sampler, kw, steps = I2V_MODES[mode]
    c = _w8a8(I2V, w8a8)
    jpipe = JaxI2V(c, JaxDiT(c.dit, dtype=jnp.float32), params["dit"], JaxVAE(c.vae),
                   params["vae"], None, None, JaxCLIP(c.clip), params["clip"],
                   cfg_parallel=mode == "cfg_parallel")
    jpipe.quantize_int8(bits)
    tpipe = dataclasses.replace(tbase, config=port_config(c),
                                dit=_port_trunk(c, jpipe.dit_params, bits),
                                cfg_parallel=mode == "cfg_parallel", _cond_cache=None)
    rng = np.random.default_rng(46)
    img = rng.uniform(-1, 1, (1, 1, 32, 32, 3)).astype(np.float32)
    ctx, ctx_null = (rng.standard_normal((1, 32, 32)).astype(np.float32) for _ in range(2))
    seed = 3
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 3, 8, 8, 8),
                                         jnp.float32))
    distilled = mode.startswith("distilled")
    want_lat, want_video = jpipe.generate(jnp.asarray(img), jnp.asarray(ctx),
                                          None if distilled else jnp.asarray(ctx_null),
                                          frame_num=5, steps=steps, seed=seed,
                                          sampler=sampler, **kw)
    churn = None
    if sampler == "tts":
        churn = [_t(a) for a in _jax_draws(jax.random.PRNGKey(seed + 7777), 20,
                                           (1, 2, 8, 8, 8))]
    forwards = []
    real = WanDiT.forward

    def spy(self, x, *a, **k):
        assert self.quant_bits == bits
        forwards.append(x.shape[0])
        return real(self, x, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(WanDiT, "forward", spy)
        got_lat, got_video = tpipe.generate(_t(img), _t(ctx),
                                            None if distilled else _t(ctx_null), frame_num=5,
                                            steps=steps, seed=seed, sampler=sampler,
                                            noise=_t(noise), churn_noise=churn, **kw)
    if mode == "cfg_parallel":
        assert forwards == [2] * steps                         # one batch-2 forward a step
    elif sampler == "euler":
        assert forwards == [1] * (steps if distilled else 2 * steps)
    if sampler == "teacache":
        assert tpipe.last_teacache_n_full == int(jpipe.last_teacache_n_full)
    assert np.abs(np.asarray(want_lat)[:, -2:] - noise[:, -2:]).max() > 1e-2
    step = sampler != "euler"
    _close(got_lat, want_lat, STEP_TOL if step else TOL, w8a8)
    _close(got_video, want_video, STEP_VIDEO_TOL if step else VIDEO_TOL, w8a8)
