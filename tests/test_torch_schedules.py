"""pita_torch schedules and remove_mean against pita_tpu (f32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu import schedules as js
from pita_tpu.utils.mean_free import remove_mean as jax_remove_mean
from pita_torch import schedules as ts
from pita_torch.utils import remove_mean

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
