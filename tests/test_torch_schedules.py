"""pita_torch schedules and remove_mean against pita_tpu (f32, CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu import schedules as js
from pita_tpu.utils.mean_free import remove_mean as jax_remove_mean
from pita_torch import schedules as ts
from pita_torch.utils import remove_mean
from torch_threads import one_intra_op_thread  # noqa: F401

T = np.linspace(0.0, 1.0, 101, dtype=np.float32)
# float32 powers (t^13, t^14) evaluated by two libraries: a few ulp apart
RTOL = 2e-6


def _both(fn_j, fn_t, t=T):
    return np.asarray(fn_j(jnp.asarray(t))), fn_t(torch.as_tensor(t)).numpy()


@pytest.mark.parametrize("method", ["g", "h", "dh_dt"])
def test_elucidating(method):
    kw = dict(sigma_min=0.05, sigma_max=80.0, rho=7.0)
    j, t = js.ElucidatingNoiseSchedule(**kw), ts.ElucidatingNoiseSchedule(**kw)
    a, b = _both(getattr(j, method), getattr(t, method))
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-6)


def test_elucidating_inverse_and_autograd_default():
    kw = dict(sigma_min=0.05, sigma_max=80.0, rho=7.0)
    j, t = js.ElucidatingNoiseSchedule(**kw), ts.ElucidatingNoiseSchedule(**kw)
    hs = np.array(j.h(jnp.asarray(T[1:])))
    np.testing.assert_allclose(t.t(torch.as_tensor(hs)).numpy(), np.asarray(j.t(hs)),
                               rtol=1e-5, atol=1e-6)
    # the base class's autograd dh_dt agrees with the closed form
    auto = ts.NoiseSchedule.dh_dt(t, torch.as_tensor(T))
    np.testing.assert_allclose(auto.numpy(), t.dh_dt(torch.as_tensor(T)).numpy(), rtol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("ConstantAnnealingSchedule", dict(annealing_factor=1.2)),
    ("LinearAnnealingSchedule", dict(annealing_factor=2.0, annealing_factor_start=1.0,
                                     t_start=0.8, t_end=0.2)),
    ("SigmoidAnnealingSchedule", dict(annealing_factor=3.0, annealing_factor_start=1.0,
                                      t_start=0.9, t_end=0.1, sharpness=8.0)),
])
def test_annealing(name, kw):
    j, t = getattr(js, name)(**kw), getattr(ts, name)(**kw)
    for m in ("gamma", "dgamma_dt"):
        a, b = _both(getattr(j, m), getattr(t, m))
        # identical f32 formulas; exp evaluated by two libraries
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_sigmoid_dgamma_sign_is_the_true_derivative():
    s = ts.SigmoidAnnealingSchedule(annealing_factor=3.0, t_start=0.9, t_end=0.1)
    t = torch.linspace(0.05, 0.95, 7, requires_grad=True)
    (g,) = torch.autograd.grad(s.gamma(t).sum(), t)
    np.testing.assert_allclose(s.dgamma_dt(t.detach()).numpy(), g.numpy(), rtol=1e-5)


def test_remove_mean():
    x = np.random.default_rng(0).normal(size=(4, 2, 39)).astype(np.float32)
    a = np.asarray(jax_remove_mean(jnp.asarray(x), 13, 3))
    b = remove_mean(torch.as_tensor(x), 13, 3).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.reshape(4, 2, 13, 3).mean(-2), 0.0, atol=1e-6)


# every schedule of pita_tpu/schedules/noise.py, at parameters its configs use
SCHEDULES = [
    ("LinearNoiseSchedule", dict(beta=3.0)),
    ("QuadraticNoiseSchedule", dict(beta=5.0)),
    ("PowerNoiseSchedule", dict(beta=4.0, power=2.5)),
    ("SubLinearNoiseSchedule", dict(beta=2.0)),
    ("GeometricNoiseSchedule", dict(sigma_min=0.01, sigma_max=10.0)),
    ("ElucidatingNoiseSchedule", dict(sigma_min=0.02, sigma_max=2.0, rho=7.0)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_every_schedule_matches_jax(name, kw):
    """g, h, dh_dt (closed form, or autograd where pita_tpu differentiates h)
    and the inverse t(h) on a grid of t, rel <= 1e-5."""
    j, p = getattr(js, name)(**kw), getattr(ts, name)(**kw)
    grid = T[1:]  # t = 0 is a pole of SubLinear's g and of Power's dh_dt below power 1
    for m in ("g", "h", "dh_dt"):
        a, b = _both(getattr(j, m), getattr(p, m), grid)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7, err_msg=m)
    hs = np.array(j.h(jnp.asarray(grid)))
    np.testing.assert_allclose(p.t(torch.as_tensor(hs)).numpy(), np.asarray(j.t(jnp.asarray(hs))),
                               rtol=1e-5, atol=1e-6)


def test_geometric_ln_sigma_draws_and_bins_match_jax():
    import jax

    kw = dict(sigma_min=0.01, sigma_max=10.0)
    j, p = js.GeometricNoiseSchedule(**kw), ts.GeometricNoiseSchedule(**kw)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(j.sample_ln_sigma(key, 256))
    got = p.sample_ln_sigma(256, torch.as_tensor(np.asarray(jax.random.uniform(key, (256,)))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.ln_sigma_bins(4).numpy(), np.asarray(j.ln_sigma_bins(4)),
                               rtol=1e-6, atol=1e-6)
    many = p.sample_ln_sigma(20000, generator=torch.Generator().manual_seed(0))
    lo, hi = np.log(0.01), np.log(10.0)
    assert lo <= float(many.min()) and float(many.max()) <= hi
    assert abs(float(many.mean()) - 0.5 * (lo + hi)) < 0.05


@pytest.mark.parametrize("kind", ["linear", "quadratic", "power", "sub_linear", "geometric"])
def test_registry_builds_every_schedule(kind):
    from pita_tpu.configs.registry import _build_noise_schedule as jax_build
    from pita_torch.configs.registry import _build_noise_schedule

    spec = dict(kind=kind, **dict(SCHEDULES)[{
        "linear": "LinearNoiseSchedule", "quadratic": "QuadraticNoiseSchedule",
        "power": "PowerNoiseSchedule", "sub_linear": "SubLinearNoiseSchedule",
        "geometric": "GeometricNoiseSchedule"}[kind]])
    j, p = jax_build(spec), _build_noise_schedule(spec)
    assert type(p).__name__ == type(j).__name__
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
