"""The port's sampler against pita_tpu: resampling, ESS, and integrate_sde
step for step with the JAX integrator's own random draws replayed (CPU).
Also: the port imports nothing of JAX, and its entry points refuse to run
on the CPU unless asked."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pita_tpu.metrics.ess import effective_sample_size as jax_ess
from pita_tpu.nets import EGNNBackbone as JaxEGNN
from pita_tpu.nets import EnergyWrapper as JaxEnergy
from pita_tpu.nets import ScoreWrapper as JaxScore
from pita_tpu.ops.resampling import count_unique as jax_count_unique
from pita_tpu.ops.resampling import systematic_resample as jax_resample
from pita_tpu.sampler import IntegratorConfig as JaxConfig
from pita_tpu.sampler import integrate_sde as jax_integrate
from pita_tpu.schedules import ConstantAnnealingSchedule as JaxConst
from pita_tpu.schedules import ElucidatingNoiseSchedule as JaxSched
from pita_tpu.targets import LJ13 as JaxLJ13
from pita_torch.io.flax_params import load_egnn_params
from pita_torch.metrics import effective_sample_size
from pita_torch.nets import EGNNBackbone, EnergyWrapper, ScoreWrapper
from pita_torch.ops.resampling import count_unique, systematic_resample
from pita_torch.sampler import IntegratorConfig, integrate_sde
from pita_torch.schedules import ConstantAnnealingSchedule, ElucidatingNoiseSchedule
from pita_torch.targets import LJ13

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_systematic_resample_same_ancestors(seed):
    rng = np.random.default_rng(seed)
    lw = (rng.normal(size=64) * 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_resample(key, jnp.asarray(lw)))
    u0 = torch.as_tensor(np.array(jax.random.uniform(key, (), dtype=jnp.float32)))
    got = systematic_resample(torch.as_tensor(lw), u0)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(count_unique(got, 64)) == int(jax_count_unique(jnp.asarray(ref), 64))


def test_effective_sample_size():
    lw = np.random.default_rng(3).normal(size=100).astype(np.float32) * 2
    for norm in (False, True):
        np.testing.assert_allclose(
            effective_sample_size(torch.as_tensor(lw), normalize=norm).numpy(),
            np.asarray(jax_ess(jnp.asarray(lw), normalize=norm)), rtol=1e-5)


class JaxDraws:
    """The random numbers pita_tpu's integrate_sde draws from ``key``,
    replayed in its key schedule (integrator.py:367,280,460,488-489,562,542;
    ops/divergence.py:102-107; ops/resampling.py:30)."""

    def __init__(self, key, n_steps, resample_at_end, mala_steps):
        key, k = jax.random.split(key)
        self.steps = []
        for _ in range(n_steps):
            k, k_diff, k_res, k_div = jax.random.split(k, 4)
            self.steps.append((k_diff, k_res, k_div))
        self.k_end = None
        if resample_at_end:
            key, self.k_end = jax.random.split(key)
        self.mala = [jax.random.split(k) for k in
                     jax.random.split(jax.random.fold_in(key, 2), max(mala_steps, 1))]

    @staticmethod
    def _t(a):
        return torch.as_tensor(np.array(a))

    def noise(self, i, shape):
        return self._t(jax.random.normal(self.steps[i][0], shape, jnp.float32))

    def probes(self, i, num_probes, shape):
        keys = jax.random.split(self.steps[i][2], num_probes)
        return self._t(jnp.stack([jax.random.rademacher(k, shape, dtype=jnp.float32)
                                  for k in keys]))

    def resample_u0(self, i):
        return self._t(jax.random.uniform(self.steps[i][1], (), dtype=jnp.float32))

    def end_u0(self):
        return self._t(jax.random.uniform(self.k_end, (), dtype=jnp.float32))

    def mala_noise(self, k, shape):
        return self._t(jax.random.normal(self.mala[k][0], shape, jnp.float32))

    def mala_uniform(self, k, shape):
        return self._t(jax.random.uniform(self.mala[k][1], shape))


def _pair(seed):
    mod = JaxEGNN(n_particles=13, hidden_nf=8, n_layers=2)
    params = [mod.init(jax.random.PRNGKey(seed + i), jnp.zeros((2,)), jnp.zeros((2, 39)), 1.0)
              for i in range(2)]
    nets = []
    for p in params:
        bb = EGNNBackbone(13, hidden_nf=8, n_layers=2)
        bb.load_state_dict(load_egnn_params(serialization.to_bytes(p), 2))
        nets.append(bb)
    return mod, params, nets


def _run_both(cfg_kw, seed=0, B=6):
    mod, (ps, pe), (bs, be) = _pair(seed)
    sched_kw = dict(sigma_min=0.05, sigma_max=10.0, rho=7.0)
    x1 = np.random.default_rng(seed).normal(size=(B, 39)).astype(np.float32) * 2.0
    key = jax.random.PRNGKey(seed + 10)
    jcfg = JaxConfig(**cfg_kw)
    ref = jax_integrate(key, jnp.asarray(x1), JaxScore(mod), JaxEnergy(mod), ps, pe,
                        JaxSched(**sched_kw), JaxConst(annealing_factor=1.2),
                        JaxLJ13(temperature=2.0), 1.0, jcfg)
    tcfg = IntegratorConfig(**cfg_kw)
    draws = JaxDraws(key, tcfg.num_integration_steps,
                     tcfg.resample_at_end and tcfg.resampling_interval < tcfg.num_integration_steps,
                     tcfg.post_mcmc_steps)
    got = integrate_sde(torch.as_tensor(x1), ScoreWrapper(bs), EnergyWrapper(be),
                        ElucidatingNoiseSchedule(**sched_kw),
                        ConstantAnnealingSchedule(annealing_factor=1.2), LJ13(temperature=2.0),
                        1.0, tcfg, draws=draws, device="cpu")
    return ref, got


HUTCH = dict(divergence_mode="hutchinson", hutchinson_probes=2, divergence_update_interval=10,
             resampling_interval=1, should_mean_free=True)


def test_integrate_sde_matches_jax_without_resampling():
    """12 EM steps (divergence recomputed at steps 0 and 10, carried in
    between), weights accumulating with resampling never firing, then 3
    adaptive MALA steps."""
    cfg = dict(HUTCH, num_integration_steps=12, end_resampling_step=12,
               ess_resampling_threshold=0.0, post_mcmc_steps=3, dt_negative_time=1e-8)
    ref, got = _run_both(cfg)
    lw_r = np.asarray(ref.logweights)
    # f32 networks in two frameworks, 12 steps and 3 MALA steps compounding
    # reassociation error (JVP vs VJP in the divergence)
    np.testing.assert_allclose(got.logweights.numpy(), lw_r, rtol=1e-3,
                               atol=1e-4 * np.abs(lw_r).max())
    np.testing.assert_array_equal(got.num_unique.numpy(), np.asarray(ref.num_unique))
    s_r = np.asarray(ref.samples)
    np.testing.assert_allclose(got.samples.numpy(), s_r, rtol=1e-3,
                               atol=1e-4 * np.abs(s_r).max())
    np.testing.assert_array_equal(got.acceptance_rates.numpy(),
                                  np.asarray(ref.acceptance_rates))
    assert 0 < float(got.acceptance_rates.max()) < 1  # MALA moved some chains, not all
    for k in ("divergence", "cross_term", "dUt_dt"):
        np.testing.assert_allclose(got.term_stats[k].numpy(), np.asarray(ref.term_stats[k]),
                                   rtol=1e-3, atol=1e-5)


def test_integrate_sde_same_ancestors_when_resampling_fires():
    """Resampling allowed every 4th step and always triggered (ESS < 1.01):
    it first fires at step 3. Both samplers must pick the same ancestors
    there; the trajectories are compared up to that step."""
    cfg = dict(HUTCH, num_integration_steps=4, end_resampling_step=4, resampling_interval=4,
               ess_resampling_threshold=1.01)
    ref, got = _run_both(cfg, seed=3, B=8)
    lw_r = np.asarray(ref.logweights)
    np.testing.assert_allclose(got.logweights.numpy()[:3], lw_r[:3], rtol=1e-3,
                               atol=1e-4 * np.abs(lw_r).max())
    assert np.all(lw_r[3] == 0) and np.all(got.logweights.numpy()[3] == 0)
    assert int(got.num_unique[3]) == int(ref.num_unique[3]) < 8
    s_r = np.asarray(ref.samples)  # right after the resample: ancestors must agree
    np.testing.assert_allclose(got.samples.numpy(), s_r, rtol=1e-3,
                               atol=1e-4 * np.abs(s_r).max())


def test_port_imports_no_jax():
    """Every pita_torch module, and chip_smoke.py, imports under a hook that
    refuses jax, flax, msgpack and pita_tpu."""
    code = r"""
import importlib, pkgutil, sys
BLOCK = ("jax", "jaxlib", "flax", "msgpack", "pita_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
    del sys.modules[m]
import pita_torch
for info in pkgutil.walk_packages(pita_torch.__path__, "pita_torch."):
    importlib.import_module(info.name)
import runpy
runpy.run_path("chip_smoke.py", run_name="not_main")
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_entry_points_need_a_gpu_unless_asked(monkeypatch):
    from pita_torch.io.bench_asset import load_lj55_bench
    from pita_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no GPU"):
        load_lj55_bench()
    with pytest.raises(RuntimeError, match="no GPU"):
        integrate_sde(torch.zeros(2, 39), None, None, None, None, LJ13(), 1.0,
                      IntegratorConfig(num_integration_steps=1))
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("langevin", [False, True])
def test_negative_time_descent_matches_jax(langevin):
    from pita_tpu.sampler.integrator import negative_time_descent as jax_descent
    from pita_torch.sampler import negative_time_descent

    # a jittered lattice: no overlapping pairs, so forces stay moderate
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3)[:13]
    x = grid[None] * 1.1 + 0.1 * np.random.default_rng(5).normal(size=(4, 13, 3))
    x = x.reshape(4, 39).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ref = jax_descent(jnp.asarray(x), JaxLJ13(temperature=2.0), num_steps=4, dt=1e-4,
                      do_langevin=langevin, key=key, mean_free=True)
    keys = jax.random.split(key, 4)

    class Draws:  # the JAX function's per-step keys (integrator.py:522)
        def descent_noise(self, k, shape):
            return torch.as_tensor(np.array(jax.random.normal(keys[k], shape, jnp.float32)))

    got = negative_time_descent(torch.as_tensor(x), LJ13(temperature=2.0), 4, 1e-4, langevin,
                                Draws(), mean_free=True)
    # four force steps of 1e-4: the autograd forces' reassociation only
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
