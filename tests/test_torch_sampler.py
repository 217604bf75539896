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
from torch_threads import one_intra_op_thread  # noqa: F401

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


def _pair(seed, n_layers=2):
    mod = JaxEGNN(n_particles=13, hidden_nf=8, n_layers=n_layers)
    params = [mod.init(jax.random.PRNGKey(seed + i), jnp.zeros((2,)), jnp.zeros((2, 39)), 1.0)
              for i in range(2)]
    nets = []
    for p in params:
        bb = EGNNBackbone(13, hidden_nf=8, n_layers=n_layers)
        bb.load_state_dict(load_egnn_params(serialization.to_bytes(p), n_layers))
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


EXACT = dict(divergence_mode="exact", resampling_interval=1, should_mean_free=True)


def _terms_both(jax_kw, torch_kw, seed=0, B=4):
    from pita_tpu.sampler.terms import compute_sde_terms as jax_terms
    from pita_torch.sampler import compute_sde_terms

    # 3 layers: the G-operator contraction of a layer reaches the trace only
    # through the next layer
    mod, (ps, pe), (bs, be) = _pair(seed, n_layers=3)
    sched_kw = dict(sigma_min=0.05, sigma_max=10.0, rho=7.0)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 39)).astype(np.float32) * 1.5
    t = rng.uniform(0.2, 0.9, size=B).astype(np.float32)
    ref = jax_terms(JaxScore(mod), JaxEnergy(mod), ps, pe, JaxSched(**sched_kw),
                    JaxConst(annealing_factor=1.2), jnp.asarray(t), jnp.asarray(x), 1.0,
                    **jax_kw)
    got = compute_sde_terms(ScoreWrapper(bs), EnergyWrapper(be),
                            ElucidatingNoiseSchedule(**sched_kw),
                            ConstantAnnealingSchedule(annealing_factor=1.2),
                            torch.as_tensor(t), torch.as_tensor(x), 1.0, **torch_kw)
    return ref, got


@pytest.mark.parametrize("route,jax_kw,torch_kw,tol", [
    # f32 in both: reassociation, and pita_tpu's transposed y-operator gathers
    # (tests/test_torch_egnn_fast.py), far below 1e-4 on freshly initialized weights
    ("default", dict(divergence_mode="exact"), dict(divergence_mode="exact"), 1e-4),
    ("chunked", dict(divergence_mode="exact", divergence_chunk_size=3,
                     divergence_tangent_chunk=16),
     dict(divergence_mode="exact", divergence_chunk_size=3, divergence_tangent_chunk=16), 1e-4),
    # G and Bv rounded to bf16 in both (the tolerance of pita_tpu's test of this route)
    ("g_kernel", dict(divergence_mode="exact", divergence_g_kernel=True, pallas_interpret=True),
     dict(divergence_mode="exact", divergence_g_kernel=True), 2e-2),
    # forward mode through the layer tangent (pita_tpu's own tolerance for its Pallas trace)
    ("tangent_kernel", dict(divergence_mode="exact", pallas_divergence=True,
                            pallas_tangent_chunk=8, pallas_interpret=True),
     dict(divergence_mode="exact", divergence_tangent_kernel=True, kernel_tangent_chunk=8), 2e-3),
    ("exact_generic", dict(divergence_mode="exact_generic"),
     dict(divergence_mode="exact_generic", divergence_chunk_size=2), 1e-4),
])
def test_compute_sde_terms_exact_matches_jax(route, jax_kw, torch_kw, tol):
    ref, got = _terms_both(jax_kw, torch_kw)
    for name in ("divergence", "drift_A", "cross_term", "dUt_dt", "drift_X"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=tol,
                                   atol=tol * np.abs(r).max(), err_msg=f"{route}: {name}")


def test_compute_sde_terms_refuses_unported_modes():
    from pita_torch.sampler import compute_sde_terms

    _, _, (bs, be) = _pair(0)
    args = (ElucidatingNoiseSchedule(sigma_min=0.05, sigma_max=10.0),
            ConstantAnnealingSchedule(annealing_factor=1.2), torch.full((2,), 0.5),
            torch.zeros(2, 39) + torch.arange(39.0) * 0.1, 1.0)
    # Hutch++ and the score-free Laplacian are ported: hutchpp needs its
    # probes, an unknown mode is refused, the score-free path runs
    with pytest.raises(ValueError, match="probes"):
        compute_sde_terms(ScoreWrapper(bs), EnergyWrapper(be), *args, divergence_mode="hutchpp")
    with pytest.raises(ValueError, match="unknown divergence_mode"):
        compute_sde_terms(ScoreWrapper(bs), EnergyWrapper(be), *args, divergence_mode="nope")
    terms = compute_sde_terms(None, EnergyWrapper(be), *args, divergence_mode="exact")
    assert torch.isfinite(terms.drift_A).all() and torch.isfinite(terms.divergence).all()


class NoProbes(JaxDraws):
    def probes(self, i, num_probes, shape):
        raise AssertionError("the exact divergence draws no probes")


@pytest.mark.parametrize("interval", [1, 3])
def test_integrate_sde_exact_matches_jax_without_resampling(interval, monkeypatch):
    """7 EM steps in exact mode, the divergence recomputed every ``interval``
    steps and carried in between, weights accumulating and resampling never
    firing. No probes are drawn."""
    monkeypatch.setattr(sys.modules[__name__], "JaxDraws", NoProbes)
    cfg = dict(EXACT, num_integration_steps=7, end_resampling_step=7,
               ess_resampling_threshold=0.0, divergence_update_interval=interval,
               divergence_chunk_size=4)
    ref, got = _run_both(cfg)
    lw_r = np.asarray(ref.logweights)
    # f32 networks in two frameworks, 7 steps compounding reassociation error
    np.testing.assert_allclose(got.logweights.numpy(), lw_r, rtol=1e-3,
                               atol=1e-4 * np.abs(lw_r).max())
    s_r = np.asarray(ref.samples)
    np.testing.assert_allclose(got.samples.numpy(), s_r, rtol=1e-3,
                               atol=1e-4 * np.abs(s_r).max())
    np.testing.assert_array_equal(got.num_unique.numpy(), np.asarray(ref.num_unique))
    for k in ("divergence", "cross_term", "dUt_dt"):
        np.testing.assert_allclose(got.term_stats[k].numpy(), np.asarray(ref.term_stats[k]),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("switch,module,plain", [
    ("divergence_g_kernel", "pita_torch.ops.g_op", "g_operator_contract_plain"),
    ("divergence_tangent_kernel", "pita_torch.ops.egnn_tangent", "layer_tangent"),
])
def test_integrate_sde_exact_kernel_routes_match_default(switch, module, plain, monkeypatch):
    """Each kernel switch reaches its route (on the CPU the kernel's plain
    version, counted here) and moves only the weights: the samples are
    identical with resampling off, the log-weights agree to the route's
    rounding."""
    import importlib

    mod = importlib.import_module(module)
    real, calls = getattr(mod, plain), []
    monkeypatch.setattr(mod, plain, lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, (bs, be) = _pair(1, n_layers=3)
    sched = ElucidatingNoiseSchedule(sigma_min=0.05, sigma_max=10.0, rho=7.0)
    x1 = torch.as_tensor(np.random.default_rng(1).normal(size=(5, 39)).astype(np.float32))
    base = IntegratorConfig(**EXACT, num_integration_steps=4, end_resampling_step=4,
                            ess_resampling_threshold=0.0)
    run = lambda cfg: integrate_sde(x1, ScoreWrapper(bs), EnergyWrapper(be), sched,
                                    ConstantAnnealingSchedule(annealing_factor=1.2),
                                    LJ13(temperature=2.0), 1.0, cfg, seed=5, device="cpu")
    r0 = run(base)
    assert not calls  # the default route materializes G and calls neither
    r1 = run(base.replace(**{switch: True}))
    # 4 steps x (1 launch of K5: layer 1 of 3 | 3 layers of K4, 39 tangents in one super-chunk)
    assert len(calls) == (4 if switch == "divergence_g_kernel" else 12)
    torch.testing.assert_close(r1.samples, r0.samples, rtol=0, atol=0)
    tol = 2e-2 if switch == "divergence_g_kernel" else 1e-4  # bf16 G; f32 forward mode
    for a, b in ((r1.logweights, r0.logweights),
                 (r1.term_stats["divergence"], r0.term_stats["divergence"])):
        assert (a - b).abs().max() <= tol * b.abs().max()


def test_integrate_sde_exact_same_ancestors_when_resampling_fires():
    """Exact mode with resampling at every step (the reference's default):
    it fires at step 0 and both samplers pick the same ancestors."""
    cfg = dict(EXACT, num_integration_steps=1, end_resampling_step=1)
    ref, got = _run_both(cfg, seed=4, B=8)
    assert np.all(np.asarray(ref.logweights)[0] == 0) and np.all(got.logweights.numpy()[0] == 0)
    assert int(got.num_unique[0]) == int(ref.num_unique[0]) < 8
    s_r = np.asarray(ref.samples)
    np.testing.assert_allclose(got.samples.numpy(), s_r, rtol=1e-4,
                               atol=1e-5 * np.abs(s_r).max())


def test_default_divergence_mode_is_exact():
    assert IntegratorConfig().divergence_mode == JaxConfig().divergence_mode == "exact"


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
names = [info.name for info in pkgutil.walk_packages(pita_torch.__path__, "pita_torch.")]
for name in ("pita_torch.nets.egnn_fast", "pita_torch.ops.g_op", "pita_torch.ops.egnn_tangent",
             "pita_torch.ops.divergence", "pita_torch.sampler.terms"):
    assert name in names, name
for name in names:
    importlib.import_module(name)
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
    # the callers of score_divergence_fast: every exact route of integrate_sde
    for kw in (dict(), dict(divergence_g_kernel=True), dict(divergence_tangent_kernel=True)):
        with pytest.raises(RuntimeError, match="no GPU"):
            integrate_sde(torch.zeros(2, 39), None, None, None, None, LJ13(), 1.0,
                          IntegratorConfig(num_integration_steps=1, divergence_mode="exact",
                                           **kw))
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
