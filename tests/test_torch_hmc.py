"""The port's HMC, split-R̂ and gated ground-truth protocol against
pita_tpu/baselines/mcmc.py on the CPU: HMC steps with JAX's draws (the same
accept decisions and positions), the number of log_prob_and_force calls of
a chain, split-R̂ on the same statistics, and the protocol's diagnostics on
the same runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.baselines import mcmc as jmcmc
from pita_tpu.targets import LJ13 as JaxLJ13
from pita_torch.baselines import mcmc
from pita_torch.baselines.mcmc import _hmc_step, hmc_chain, jittered_lattice, split_rhat
from pita_torch.targets import LJ13
from torch_threads import one_intra_op_thread  # noqa: F401


def t(a):
    return torch.as_tensor(np.array(a))


def test_hmc_steps_match_jax_with_its_draws():
    """Five steps of 10 leapfrogs on LJ13 at T = 1, 16 chains, adaptive step
    size: each step is one pita_tpu hmc_chain call of one step, fed the
    previous state; the port's step gets the same momenta and uniforms. The
    same chains accept, the positions within 1e-4 of the largest; the
    chain of five steps gives the stepwise result."""
    B, L = 16, 10
    x0 = jittered_lattice(13, B, torch.Generator().manual_seed(0)).numpy()
    jt, tt = JaxLJ13(temperature=1.0), LJ13(temperature=1.0)
    jx, eps = jnp.asarray(x0), 0.02
    x, lp = t(x0), tt.log_prob_and_force(t(x0))[0]
    teps = torch.tensor(eps, dtype=torch.float32)
    draws, masks = [], []
    for s in range(5):
        key = jax.random.PRNGKey(100 + s)
        (key_t,) = jax.random.split(key, 1)  # hmc_chain's keys for one step
        k_mom, k_acc = jax.random.split(key_t)
        p, u = t(jax.random.normal(k_mom, x0.shape)), t(jax.random.uniform(k_acc, (B,)))
        jx_new, jaccs, jeps = jmcmc.hmc_chain(jt.log_prob_and_force, jx, key, 1,
                                              step_size=eps, n_leapfrog=L)
        x_new, lp, acc, accept = _hmc_step(tt.log_prob_and_force, x, lp, teps, p, u, L)
        teps = torch.where(acc > 0.65, teps * 1.02, teps / 1.02)
        j_moved = np.any(np.array(jx_new) != np.array(jx), axis=1)
        np.testing.assert_array_equal(accept.numpy(), j_moved)
        assert float(acc) == float(jaccs[0])
        np.testing.assert_allclose(x_new.numpy(), np.array(jx_new), rtol=0,
                                   atol=1e-4 * np.abs(np.array(jx_new)).max())
        np.testing.assert_allclose(float(teps), float(jeps), rtol=1e-6)
        draws.append((p, u))
        masks.append(accept)
        jx, eps, x = jx_new, float(jeps), x_new
    accepted = torch.stack(masks).float().mean()
    assert 0.0 < float(accepted) < 1.0  # both decisions were taken
    xc, accs, eps_c = hmc_chain(tt.log_prob_and_force, t(x0), 5, step_size=0.02, n_leapfrog=L,
                                draws=draws)
    torch.testing.assert_close(xc, x, rtol=0, atol=0)
    np.testing.assert_array_equal(accs.numpy(), torch.stack(masks).float().mean(1).numpy())
    assert float(eps_c) == float(teps)


def test_hmc_chain_calls_the_target_1_plus_S_times_L_plus_2():
    tt = LJ13(temperature=1.0)
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return tt.log_prob_and_force(x)

    x0 = jittered_lattice(13, 8, torch.Generator().manual_seed(1))
    x, accs, eps = hmc_chain(counted, x0, 3, n_leapfrog=4,
                             generator=torch.Generator().manual_seed(2))
    assert len(calls) == 1 + 3 * (4 + 2)
    assert accs.shape == (3,) and torch.isfinite(x).all() and torch.isfinite(eps)


def test_split_rhat_matches_jax():
    """Equal to 1e-12 on agreeing chains and on chains whose means disagree
    (tests/test_targets.py:144-151)."""
    rng = np.random.default_rng(0)
    same = rng.normal(size=(8, 400))
    shifted = same + np.linspace(0, 3, 8)[:, None]
    for c in (same, shifted, rng.normal(size=(3, 101))):
        np.testing.assert_allclose(split_rhat(c), jmcmc.split_rhat(c), rtol=1e-12)
    assert split_rhat(same) < 1.02 and split_rhat(shifted) > 1.3


def _fake_runs(target, num_samples, seed=0, warmup=12000, **kw):
    """A stand-in for either package's generate_lj_dataset: jittered
    lattices seeded by the run's seed, so both protocols see the same runs;
    run r's lattice is stretched by 2 r %, so the runs disagree."""
    rng = np.random.default_rng(seed)
    x = jittered_lattice(13, 1, torch.Generator().manual_seed(0)).numpy()
    x = x * (1 + 0.02 * (seed // 1000))
    return (x + 0.01 * rng.normal(size=(num_samples, 39))).astype(np.float32)


def test_reference_protocol_diagnostics_match_jax(monkeypatch):
    """The same ten runs (a stand-in generator seeded by seed + 1000 r):
    pita_tpu's keys, the same pooled samples, R̂ and the per-run energy
    means within rel 1e-5 (f32 energies from two libraries), the per-run
    spreads within 1e-5 of the energies' size (a spread 1 % of the mean
    magnifies their last bits)."""
    monkeypatch.setattr(jmcmc, "generate_lj_dataset", _fake_runs)
    monkeypatch.setattr(mcmc, "generate_lj_dataset", _fake_runs)
    kw = dict(num_samples=95, n_runs=10, seed=7, warmup=10)
    jdata, jdiag = jmcmc.generate_lj_dataset_reference_protocol(JaxLJ13(temperature=1.0),
                                                                **kw)
    data, diag = mcmc.generate_lj_dataset_reference_protocol(LJ13(temperature=1.0),
                                                             device="cpu", **kw)
    np.testing.assert_array_equal(data, jdata)
    assert diag.keys() == jdiag.keys()
    assert diag["converged"] == jdiag["converged"]
    for k in ("rhat_energy", "per_run_energy_mean"):
        np.testing.assert_allclose(diag[k], jdiag[k], rtol=1e-5, err_msg=k)
    size = np.abs(jdiag["per_run_energy_mean"]).max()
    np.testing.assert_allclose(diag["per_run_energy_std"], jdiag["per_run_energy_std"], rtol=0,
                               atol=1e-5 * size)
    assert diag["rhat_energy"] > 1.05 and not diag["converged"]  # the stretched runs disagree


def test_reference_protocol_short_run_at_lj13():
    """Two real runs of the port's generator at LJ13 with a short warmup:
    pooled samples of healthy energy and pita_tpu's diagnostic keys."""
    kw = dict(num_samples=40, n_runs=2, seed=3, warmup=20)
    data, diag = mcmc.generate_lj_dataset_reference_protocol(LJ13(temperature=2.0), device="cpu",
                                                             **kw)
    assert data.shape == (40, 39) and np.isfinite(data).all()
    assert set(diag) == {"rhat_energy", "per_run_energy_mean", "per_run_energy_std", "converged"}
    assert len(diag["per_run_energy_mean"]) == 2 and np.isfinite(diag["rhat_energy"])
    assert max(diag["per_run_energy_mean"]) < 0  # bound clusters


def test_protocol_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        mcmc.generate_lj_dataset_reference_protocol(LJ13(), num_samples=4, n_runs=2)
