"""The port's training modules that no entry point calls, against the JAX
package on the CPU, each on the same inputs and (where it draws) the same
random numbers:

* ``training.distill.teacher_rollout`` on the tiny t2v pipeline of
  tests/test_torch_t2v.py, with JAX's seeded noise;
* ``diffusion.integrators``: ``odeint`` with fixed-step Euler, Heun and
  midpoint, adaptive dopri5 forward and backward in time through a stiff
  stretch, its ``max_steps``, ``ode_sample``;
* ``diffusion.distill_schedule``: the linear-quadratic schedule, the PCM
  ladder, the FlowMatchDiscrete timesteps, ``EulerSolver``'s tables, its
  Euler step and its multiphase target;
* ``utils.stats.Collector``;
* ``data.diffaugment``: each of the five transforms and the whole policy on
  JAX's draws, and ``draw_augment``'s ranges.

Tolerances: the schedules and tables equal (float32 from the same numpy
code); the fixed-step integrators and augmentations on fp32 elementwise
arithmetic 1e-6 of the largest value (float32 reductions in another
order), ``ode_sample`` 1e-5; dopri5 ten times its own error tolerance (a
borderline step accepted on one side and rejected on the other moves the
path by about that); the rollout's latents 1e-4, as
tests/test_torch_t2v.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, close_rel, torch_threads
from yume_tpu.data import diffaugment as jaug
from yume_tpu.diffusion import distill_schedule as jds
from yume_tpu.diffusion import integrators as jint
from yume_tpu.utils import stats as jstats
from yume_tpu_torch.data import diffaugment as taug
from yume_tpu_torch.diffusion import distill_schedule as tds
from yume_tpu_torch.diffusion import integrators as tint
from yume_tpu_torch.utils import stats as tstats

REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- teacher_rollout ---------------------------------------------------------------


def test_teacher_rollout_matches_jax():
    from test_torch_t2v import FRAME_NUM, SIZE, TINY, _params
    from yume_tpu.models.dit import WanDiT as JaxDiT
    from yume_tpu.models.vae import WanVAE as JaxVAE
    from yume_tpu.pipelines.ti2v import TI2VPipeline as JaxPipeline
    from yume_tpu.training.distill import teacher_rollout as jrollout
    from torch_parity import port_config
    from yume_tpu_torch.pipelines.ti2v import TI2VPipeline
    from yume_tpu_torch.training.distill import teacher_rollout
    from yume_tpu_torch.utils import convert

    c = TINY
    dit_p = _params(JaxDiT(c.dit, dtype=jnp.float32), 35, jnp.zeros((1, 3, 4, 4, 8)),
                    jnp.zeros((1, 3)), jnp.zeros((1, 16, 16)), packed=False)
    vae_p = _params(JaxVAE(c.vae), 36, jnp.zeros((1, 5, 32, 32, 3)))
    jpipe = JaxPipeline(c, JaxDiT(c.dit, dtype=jnp.float32), None, JaxVAE(c.vae), vae_p)
    tpipe = TI2VPipeline.from_state_dicts(
        port_config(c), None, convert.vae22_state_dict(vae_p, c.vae.num_res_blocks),
        device="cpu", dtype=torch.float32)
    teacher = TI2VPipeline.from_state_dicts(
        port_config(c), convert.dit_state_dict(dit_p, c.dit.num_layers),
        convert.vae22_state_dict(vae_p, c.vae.num_res_blocks), device="cpu",
        dtype=torch.float32).dit
    ctx = np.random.default_rng(37).standard_normal((1, 16, 16)).astype(np.float32)
    kw = dict(size=SIZE, frame_num=FRAME_NUM, steps=3, seed=5)
    want = jrollout(jpipe, jnp.asarray(ctx), dit_p, **kw)
    noise = jax.random.normal(jax.random.PRNGKey(5), want.shape, jnp.float32)
    got = teacher_rollout(tpipe, _t(ctx), teacher, noise=_t(noise), **kw)
    assert got.shape == want.shape == (1, 3, 4, 4, 8)
    assert_close(got, want, 1e-4)


# -- integrators -------------------------------------------------------------------


def _field(lib):
    """A smooth, state- and time-dependent velocity field."""
    def f(x, t):
        return -0.7 * x + 0.3 * lib.sin(3.0 * x) * t
    return f


@pytest.mark.parametrize("method,steps", [("euler", 7), ("heun2", 5), ("midpoint", 6)])
def test_fixed_step_odeint_matches_jax(method, steps):
    x0 = np.random.default_rng(1).standard_normal((2, 3, 5)).astype(np.float32)
    want = jint.odeint(_field(jnp), jnp.asarray(x0), 1.0, 0.0, method=method, steps=steps)
    got = tint.odeint(_field(torch), _t(x0), 1.0, 0.0, method=method, steps=steps)
    close_rel(got, want, REL)


@pytest.mark.parametrize("t0,t1,rtol", [(1.0, 0.0, 1e-5), (0.0, 2.0, 1e-3)])
def test_dopri5_matches_jax(t0, t1, rtol):
    """A stiff stretch (a decay at rate 30 while t < 0.2, in the direction
    of integration) makes the controller reject and shrink steps; the end
    state agrees."""
    x0 = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    k = 30.0 if t1 < t0 else -30.0

    def field(lib):
        return lambda x, t: k * x * (t < 0.2) - 0.5 * x + lib.cos(x) * t

    calls = []

    def counted(x, t):
        calls.append(float(t))
        return field(torch)(x, t)

    want = jint.odeint(field(jnp), jnp.asarray(x0), t0, t1, method="dopri5", rtol=rtol,
                       atol=rtol)
    got = tint.odeint(counted, _t(x0), t0, t1, method="dopri5", rtol=rtol, atol=rtol)
    # each end state lies within the controller's tolerance of the exact one;
    # a step that XLA's contracted arithmetic accepts and ATen's rejects (or
    # the reverse) moves the path by that much: 10 times it
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=10 * rtol * (1.0 + np.abs(want).max()), rtol=0)
    # 7 stages a try, many tries
    assert len(calls) % 7 == 0 and len(calls) > 7 * 5


def test_dopri5_max_steps_and_ode_sample():
    x0 = _t(np.ones((3,)))
    # one try of the first step: t moves by at most 1/50 of the span
    out = tint.odeint(lambda x, t: -x, x0, 0.0, 1.0, method="dopri5", max_steps=1)
    assert torch.allclose(out, x0 * np.exp(-1.0 / 50), rtol=1e-5)
    noise = np.random.default_rng(3).standard_normal((2, 4, 3)).astype(np.float32)
    target = np.random.default_rng(4).standard_normal((2, 4, 3)).astype(np.float32)

    def vel(lib, tgt):
        def v(x, sigma):
            s = sigma.reshape(sigma.shape + (1,) * (x.ndim - 1))
            return (x - tgt) / (s + 0.5)
        return v

    for method in ("euler", "dopri5"):
        want = jint.ode_sample(vel(jnp, jnp.asarray(target)), jnp.asarray(noise),
                               method=method, steps=10, rtol=1e-4, atol=1e-4)
        got = tint.ode_sample(vel(torch, _t(target)), _t(noise), method=method, steps=10,
                              rtol=1e-4, atol=1e-4)
        close_rel(got, want, 1e-5, method)


# -- distillation schedules ------------------------------------------------------------


def test_schedules_match_jax():
    for args in ((10,), (50, 0.025), (7, 0.1, 3)):
        np.testing.assert_array_equal(tds.linear_quadratic_schedule(*args),
                                      jds.linear_quadratic_schedule(*args))
    for kw in ({}, {"shift": 3.0, "pcm_timesteps": 25}):
        np.testing.assert_array_equal(tds.pcm_sigmas(**kw), jds.pcm_sigmas(**kw))
    for kw in ({"num_steps": 8}, {"num_steps": 5, "shift": 3.0, "reverse": False}):
        np.testing.assert_array_equal(tds.flow_match_discrete_timesteps(**kw),
                                      jds.flow_match_discrete_timesteps(**kw))


def test_euler_solver_matches_jax():
    sig = np.linspace(1.0, 0.0, 1000, dtype=np.float32)
    js, ts = jds.EulerSolver.create(sig, euler_timesteps=20), tds.EulerSolver.create(
        sig, euler_timesteps=20)
    for f in ("sigmas", "sigmas_prev", "euler_timesteps"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    rng = np.random.default_rng(6)
    x, v = (rng.standard_normal((4, 3, 2, 5)).astype(np.float32) for _ in range(2))
    index = np.array([0, 5, 13, 19], np.int32)
    assert_close(ts.euler_step(_t(x), _t(v), torch.from_numpy(index)),
                 js.euler_step(jnp.asarray(x), jnp.asarray(v), jnp.asarray(index)), 0.0)
    for phases in (1, 3, 4):
        got, got_last = ts.multiphase_pred(_t(x), _t(v), torch.from_numpy(index), phases)
        want, want_last = js.multiphase_pred(jnp.asarray(x), jnp.asarray(v),
                                             jnp.asarray(index), phases)
        assert_close(got, want, 0.0)
        np.testing.assert_array_equal(got_last.numpy(), np.asarray(want_last))


# -- stats -----------------------------------------------------------------------------


def test_collector_matches_jax():
    want, got = jstats.Collector(), tstats.Collector()
    for i in range(5):
        scalars = {"loss": 1.0 / (i + 1), "grad_norm": float(i * i)}
        if i % 2:
            scalars["d_loss"] = -float(i)
        want.report(**{k: jnp.asarray(v) for k, v in scalars.items()})
        got.report(**{k: torch.tensor(v) for k, v in scalars.items()})
    assert got.summary() == want.summary() == got.summary(cross_host=True)
    assert got.mean("d_loss") == want.mean("d_loss") == -2.0
    got.reset()
    assert got.summary() == {}


# -- DiffAugment -------------------------------------------------------------------------


def _jax_augment_draws(rng, x_shape, policy):
    """JAX's draws for ``diff_augment(rng, x, policy)`` (its key splits), in
    the port's form."""
    b, h, w, _ = x_shape
    draws = []
    for p in filter(None, policy.split(",")):
        for name in {"color": ("b", "s", "c"), "translation": ("t",),
                     "cutout": ("o",)}[p.strip()]:
            rng, sub = jax.random.split(rng)
            if name == "t":
                sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
                rh, rw = jax.random.split(sub)
                draws.append({"tx": torch.from_numpy(np.array(
                                  jax.random.randint(rh, (b,), -sh, sh + 1))),
                              "ty": torch.from_numpy(np.array(
                                  jax.random.randint(rw, (b,), -sw, sw + 1)))})
            elif name == "o":
                ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
                rh, rw = jax.random.split(sub)
                draws.append({"oy": torch.from_numpy(np.array(jax.random.randint(
                                  rh, (b, 1, 1), 0, h + (1 - ch % 2))).reshape(b)),
                              "ox": torch.from_numpy(np.array(jax.random.randint(
                                  rw, (b, 1, 1), 0, w + (1 - cw % 2))).reshape(b))})
            else:
                draws.append({"u": _t(jax.random.uniform(sub, (b, 1, 1, 1)))})
    return draws


@pytest.mark.parametrize("policy", ["color", "translation", "cutout",
                                    "color,translation,cutout", ""])
@pytest.mark.parametrize("shape", [(3, 16, 16, 3), (2, 15, 22, 4)])
def test_diff_augment_matches_jax(policy, shape):
    x = np.random.default_rng(7).uniform(0, 1, shape).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    want = jaug.diff_augment(rng, jnp.asarray(x), policy)
    got = taug.diff_augment(_t(x), _jax_augment_draws(rng, shape, policy), policy)
    assert got.shape == shape
    close_rel(got, want, REL)
    if policy:
        assert not np.allclose(np.asarray(want), x)


def test_draw_augment_ranges_and_gradient():
    shape = (64, 15, 22, 3)
    draws = taug.draw_augment(torch.Generator().manual_seed(0), shape)
    assert len(draws) == 5
    co = draws[4]
    assert set(draws[3]) == {"tx", "ty"} and set(co) == {"oy", "ox"}
    assert draws[3]["tx"].abs().max() <= 2 and draws[3]["ty"].abs().max() <= 3
    assert co["oy"].min() >= 0 and co["oy"].max() < 15 + 1 - 8 % 2
    assert co["ox"].max() < 22 + 1 - 11 % 2
    assert all(0 <= d["u"].min() and d["u"].max() < 1 for d in draws[:3])
    # differentiable: the discriminator's input gradient flows through
    x = torch.rand(shape, requires_grad=True)
    taug.diff_augment(x, draws).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="draws"):
        taug.diff_augment(x, draws[:2])
