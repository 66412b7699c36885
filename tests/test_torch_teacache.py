"""The headline serving path of the port against the JAX package on the
CPU: a tiny W8A8 ``WanDiT`` with and without the TeaCache hooks
(``return_cache``, ``block_cache``), and ``generate_segment(sampler=
"teacache")`` in interval mode, in adaptive mode and with W8A8 plus
adaptive, on the same perturbed parameters and injected noise.

fp32 compute, 4 layers (so that ``num_layers // 4`` leaves live blocks on
each side of the cached middle). Tolerances: the DiT outputs 1e-4 and the
bf16 residual cache one bf16 step (2⁻⁸ relative) of its magnitude, the
latents 1e-4, from the order of float32 sums differing between XLA:CPU and
ATen (the W8A8 products themselves are exact on both sides, see
``test_torch_quant_matmul.py``). ``n_full`` must be equal.

The adaptive threshold, 0.1 as in the headline, leaves the accumulated
rel-L1 change at least 1e-3 (relative) away from it at every step, which
the tests assert, so that a last-bit difference of the sums cannot move a
refresh. W8A8 rounding is discontinuous: a last-bit difference upstream
can move one activation across a rounding boundary, and over 6 to 8 steps
of this model that happened (a latent gap of 7e-3 to 1e-2 in one of the
two runs); the segments run 5 steps, where none does. On this model the
tail's rel-L1 change grows every step, so no cached step follows a refresh
in 5 steps; the adaptive sampler itself is also held to JAX's on toy
denoisers whose refreshes reset the accumulator (1e-6, fp32 elementwise).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import TINY, _params
from torch_parity import assert_close, port_config
from yume_tpu.diffusion import samplers as jsamplers
from yume_tpu.models.dit import WanDiT as JaxDiT
from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxPipeline
from yume_tpu_torch.diffusion import samplers as tsamplers
from yume_tpu_torch.diffusion.schedule import sampling_sigmas
from yume_tpu_torch.models.dit import WanDiT
from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
from yume_tpu_torch.utils import convert

CFG = dataclasses.replace(TINY, dit=dataclasses.replace(TINY.dit, num_layers=4))
W8A8 = dataclasses.replace(CFG, dit=dataclasses.replace(CFG.dit, w8a8=True))
OUT_TOL, LATENT_TOL = 1e-4, 1e-4
STEPS, F_HIST, LFZ = 5, 3, 2
MARGIN = 1e-3


@pytest.fixture(scope="module")
def setup():
    c = CFG
    dit_p = _params(JaxDiT(c.dit, dtype=jnp.float32), 21, jnp.zeros((1, 3, 4, 4, 8)),
                    jnp.zeros((1, 3)), jnp.zeros((1, 16, 16)), packed=False)
    sd = convert.dit_state_dict(dit_p, c.dit.num_layers)
    tdit = WanDiT(port_config(c.dit), torch.float32, device="meta").to_empty(device="cpu")
    convert.load_state_dict(tdit, sd)
    tpipe = TI2VPipeline(port_config(c), tdit.eval(), None)
    jpipes = {w8a8: JaxPipeline(cfg, JaxDiT(cfg.dit, dtype=jnp.float32), dit_p, None, None)
              for w8a8, cfg in ((False, CFG), (True, W8A8))}
    tpipes = {False: tpipe, True: tpipe.with_w8a8()}
    rng = np.random.default_rng(22)
    data = dict(
        history=rng.standard_normal((1, F_HIST, 4, 4, 8)).astype(np.float32),
        noise=rng.standard_normal((1, LFZ, 4, 4, 8)).astype(np.float32),
        ctx=rng.standard_normal((1, 16, 16)).astype(np.float32),
    )
    return jpipes, tpipes, dit_p, data


def test_w8a8_pipeline_shares_parameters(setup):
    _, tpipes, _, _ = setup
    bf16, w8 = tpipes[False].dit, tpipes[True].dit
    assert w8.cfg.w8a8 and not bf16.cfg.w8a8
    for (name, p), (name2, q) in zip(bf16.named_parameters(), w8.named_parameters()):
        assert name == name2 and p.data_ptr() == q.data_ptr(), name


@pytest.mark.parametrize("mode", ["plain", "return_cache", "block_cache"])
def test_w8a8_dit_matches_jax(setup, mode):
    jpipes, tpipes, dit_p, data = setup
    jdit, tdit = jpipes[True].dit, tpipes[True].dit
    rng = np.random.default_rng(23)
    x = rng.standard_normal((1, F_HIST + LFZ, 4, 4, 8)).astype(np.float32)
    t = np.concatenate([np.zeros((1, F_HIST)), np.full((1, LFZ), 700.0)], 1).astype(np.float32)
    cache_list = (1, 2)
    kw, tkw = {}, {}
    if mode == "return_cache":
        kw = tkw = dict(cache_list=cache_list, return_cache=True)
    elif mode == "block_cache":
        cache = [0.1 * rng.standard_normal((1, 17, 64)).astype(np.float32) for _ in cache_list]
        kw = dict(cache_list=cache_list, block_cache=[jnp.asarray(c, jnp.bfloat16) for c in cache])
        tkw = dict(cache_list=cache_list,
                   block_cache=[torch.from_numpy(c).to(torch.bfloat16) for c in cache])
    want = jdit.apply(dit_p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(data["ctx"]),
                      packed=True, latent_frame_zero=LFZ, **kw)
    with torch.no_grad():
        got = tdit(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(data["ctx"]),
                   latent_frame_zero=LFZ, **tkw)
    if mode == "return_cache":
        (want, want_cache), (got, got_cache) = want, got
        assert len(got_cache) == len(want_cache) == len(cache_list)
        for g, w in zip(got_cache, want_cache):
            assert g.dtype == torch.bfloat16 and g.shape == (1, 17, 64)
            assert_close(g, w, 2.0 ** -8 * float(np.abs(np.asarray(w, np.float32)).max()))
    assert got.shape == (1, LFZ, 4, 4, 8)
    assert np.abs(np.asarray(want)).max() > 1e-2  # not a bias-only output
    assert_close(got, want, OUT_TOL)


def _accumulators(rel_l1s, threshold):
    """The adaptive sampler's accumulator at each decision."""
    acc, out = np.float32(0.0), []
    for r in rel_l1s:
        acc = np.float32(acc + np.float32(r))
        out.append(float(acc))
        if acc >= threshold:
            acc = np.float32(0.0)
    return out


def _toy_full(lat, t_frame):
    """A toy full step for either framework: v = −lat·(1 + t/1000)."""
    v = -lat * (1.0 + t_frame[:, :, None, None, None] / 1000.0)
    return v, v


def _toy_cached(lat, t_frame, cache):
    return cache  # the last full step's velocity


@pytest.mark.parametrize("threshold", [0.25, 0.4])
def test_adaptive_sampler_matches_jax_on_toy_denoisers(monkeypatch, threshold):
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((1, 5, 2, 3, 4)).astype(np.float32)
    sig = sampling_sigmas(10, 3.0)
    rel_l1s = []
    rel_l1 = tsamplers._rel_l1
    monkeypatch.setattr(tsamplers, "_rel_l1",
                        lambda a, b: rel_l1s.append(float(rel_l1(a, b))) or rel_l1(a, b))
    want, j_full = jsamplers.euler_sample_segment_cached_adaptive(
        _toy_full, _toy_cached, jnp.asarray(lat), sig, 2, threshold=threshold)
    got, t_full = tsamplers.euler_sample_segment_cached_adaptive(
        _toy_full, _toy_cached, torch.from_numpy(lat), sig, 2, threshold=threshold)
    assert t_full == int(j_full)
    accs = _accumulators(rel_l1s, threshold)
    assert min(abs(a - threshold) for a in accs) >= MARGIN * threshold, accs
    refresh = [a >= threshold for a in accs]
    assert (True, False) in set(zip(refresh, refresh[1:]))  # a reset was needed
    assert_close(got, want, 1e-6)


@pytest.mark.parametrize("w8a8,interval,threshold", [
    (False, 2, None),
    (False, 3, 0.1),
    (True, 3, 0.1),
])
def test_teacache_segment_matches_jax(setup, monkeypatch, w8a8, interval, threshold):
    jpipes, tpipes, _, data = setup
    jpipe, tpipe = jpipes[w8a8], tpipes[w8a8]
    rel_l1s = []
    rel_l1 = tsamplers._rel_l1
    monkeypatch.setattr(tsamplers, "_rel_l1",
                        lambda a, b: rel_l1s.append(float(rel_l1(a, b))) or rel_l1(a, b))
    kw = dict(steps=STEPS, sampler="teacache", teacache_interval=interval,
              teacache_threshold=threshold)
    want = jpipe.generate_segment(jnp.asarray(data["history"]), jnp.asarray(data["ctx"]),
                                  noise=jnp.asarray(data["noise"]), **kw)
    got = tpipe.generate_segment(torch.from_numpy(data["history"]),
                                 torch.from_numpy(data["ctx"]),
                                 noise=torch.from_numpy(data["noise"]), **kw)
    assert tpipe.last_teacache_n_full == int(jpipe.last_teacache_n_full)
    if threshold is not None:
        accs = _accumulators(rel_l1s, threshold)
        assert len(accs) == STEPS - 1
        assert min(abs(a - threshold) for a in accs) >= MARGIN * threshold, accs
        assert 1 < tpipe.last_teacache_n_full < STEPS  # both kinds of step ran
    assert got.shape == (1, F_HIST + LFZ, 4, 4, 8)
    np.testing.assert_array_equal(got[:, :F_HIST].numpy(), data["history"])
    assert_close(got, want, LATENT_TOL)
