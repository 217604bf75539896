"""The port's GMM-40 target and its exact oracles against pita_tpu (CPU):
the densities, the noised density, the oracle score and energy with their
gradients, the exact product GMMs, and 20 sampler steps driven by the
oracles with pita_tpu's own random draws replayed, in the exact,
Hutchinson and Hutch++ modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.sampler import IntegratorConfig as JaxConfig
from pita_tpu.sampler import integrate_sde as jax_integrate
from pita_tpu.schedules import ConstantAnnealingSchedule as JaxConst
from pita_tpu.schedules import ElucidatingNoiseSchedule as JaxSched
from pita_tpu.targets import gmm as jgmm
from pita_torch.sampler import IntegratorConfig, integrate_sde
from pita_torch.schedules import ConstantAnnealingSchedule, ElucidatingNoiseSchedule
from pita_torch.targets import gmm as tgmm
from tests.test_torch_sampler import JaxDraws
from torch_threads import one_intra_op_thread  # noqa: F401


SCHED = dict(sigma_min=0.01, sigma_max=80.0, rho=7.0)


def _inputs(seed, normalized, B=64):
    rng = np.random.default_rng(seed)
    scale = 1.0 / 50.0 if normalized else 1.0
    x = (rng.uniform(-45, 45, size=(B, 2)) * scale).astype(np.float32)
    ht = (np.exp(rng.uniform(-6, 4, size=B)) * scale ** 2).astype(np.float32)
    return x, ht


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _jax_refs(jg):
    """pita_tpu's densities, oracles and their gradients at (x, ht), in one
    jitted function (one compile instead of one a reference)."""
    jS, jE = jgmm.GMMScoreOracle(jg), jgmm.GMMEnergyOracle(jg)

    def refs(x, ht):
        U, (gx, gh) = jax.value_and_grad(
            lambda a, h: jnp.sum(jE.energy({}, h, a, 1.0)), argnums=(0, 1))(x, ht)
        gs = jax.grad(lambda a: jnp.sum(jS.score({}, ht, a, 1.0)[:, 0]))(x)
        return dict(lp=jg.log_prob(x), lp2=jg.at_temperature(2.0).log_prob(x),
                    noised=jgmm.noised_gmm_log_prob(jg, ht, x), score=jS.score({}, ht, x, 1.0),
                    denoiser=jS.denoiser({}, ht, x, 1.0), U=U, gx=gx, gh=gh, gs=gs)

    return jax.jit(refs)


@pytest.mark.parametrize("normalized", [False, True])
def test_log_prob_noised_density_and_oracles(normalized):
    jg, tg = jgmm.GMM40(normalized=normalized), tgmm.GMM40(normalized=normalized)
    x, ht = _inputs(0, normalized)
    ref = _jax_refs(jg)(jnp.asarray(x), jnp.asarray(ht))
    X, H = torch.as_tensor(x), torch.as_tensor(ht)
    _close(tg.log_prob(X), ref["lp"], 1e-5)
    _close(tg.at_temperature(2.0).log_prob(X), ref["lp2"], 1e-5)
    _close(tgmm.noised_gmm_log_prob(tg, H, X), ref["noised"], 1e-5)
    tS, tE = tgmm.GMMScoreOracle(tg), tgmm.GMMEnergyOracle(tg)
    _close(tS.score(H, X, 1.0), ref["score"], 1e-5)
    _close(tS.denoiser(H, X, 1.0), ref["denoiser"], 1e-5)
    # the energy and its gradients in x and in h, as the drift takes them
    xx, hh = X.clone().requires_grad_(True), H.clone().requires_grad_(True)
    U = tE.energy(hh, xx, 1.0)
    gx, gh = torch.autograd.grad(U.sum(), (xx, hh))
    _close(U.sum(), ref["U"], 1e-5)
    _close(gx, ref["gx"], 1e-5)
    _close(gh, ref["gh"], 1e-5)
    # the score's own x-derivative (the divergence differentiates it)
    xs = X.clone().requires_grad_(True)
    (gs,) = torch.autograd.grad(tS.score(H, xs, 1.0)[:, 0].sum(), xs)
    _close(gs, ref["gs"], 1e-4)


def test_gmm_product_and_power_exactly():
    jb, tb = jgmm.GMM40(), tgmm.GMM40()
    for jp, tp in ((jgmm.gmm_product(jb, jb), tgmm.gmm_product(tb, tb)),
                   (jgmm.gmm_power(jb, 2), tgmm.gmm_power(tb, 2)),
                   (jgmm.gmm_power(jb, 3), tgmm.gmm_power(tb, 3))):
        assert tp.n_mixes == jp.n_mixes
        for a in ("locs", "scales", "log_weights"):
            np.testing.assert_array_equal(getattr(tp, a).numpy(), np.asarray(getattr(jp, a)))
    with pytest.raises(ValueError):
        tgmm.gmm_power(tb, 1.5)


def _mode_stats(x, locs):
    m = ((x[:, None] - locs[None]) ** 2).sum(-1).argmin(1)
    return ((x - locs[m]) ** 2).mean(), np.bincount(m, minlength=len(locs)) / len(x)


def test_sets_and_samples_have_the_mixture_s_statistics():
    """Exact draws of p² (a torch.Generator's, not jax.random's) against
    pita_tpu's: the within-mode variance and the mode occupancies of the
    oracle test (tests/test_annealing_oracle.py:53-61), 20,000 draws each."""
    locs = tgmm.GMM40().locs.numpy()
    got = tgmm.gmm_power(tgmm.GMM40(), 2).sample(20000, torch.Generator().manual_seed(0))
    ref = jgmm.gmm_power(jgmm.GMM40(), 2).sample(jax.random.PRNGKey(0), 20000)
    var_t, occ_t = _mode_stats(got.numpy(), locs)
    var_j, occ_j = _mode_stats(np.asarray(ref), locs)
    np.testing.assert_allclose(var_t, var_j, rtol=0.03)
    assert 0.5 * np.abs(occ_t - occ_j).sum() < 0.05
    tr = tgmm.GMM40(normalized=True, train_set_size=500).setup_train_set()
    assert tr.shape == (500, 2) and np.abs(tr).max() < 1.0


class HutchppDraws(JaxDraws):
    """JaxDraws with Hutch++'s S and G from the step's divergence key
    (pita_tpu/ops/divergence.py:123-131)."""

    def hutchpp_probes(self, i, rank, num_probes, shape):
        k1, k2 = jax.random.split(self.steps[i][2])
        return (self._t(jax.random.rademacher(k1, (rank, *shape), dtype=jnp.float32)),
                self._t(jax.random.rademacher(k2, (num_probes, *shape), dtype=jnp.float32)))


@pytest.mark.parametrize("mode", ["exact", "hutchinson", "hutchpp"])
def test_integrate_sde_with_the_oracles_matches_jax(mode):
    """20 EM steps from p towards p² with the oracles, the weights
    accumulating and resampling never firing (interval past the end), the
    same draws: samples and log-weights within 1e-4."""
    B, n = 128, 20
    kw = dict(num_integration_steps=n, end_resampling_step=n, resampling_interval=n + 1,
              should_mean_free=False, divergence_mode=mode, hutchinson_probes=2,
              hutchpp_rank=16)
    x1 = (np.random.default_rng(1).normal(size=(B, 2)) * 56.0).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jb = jgmm.GMM40()
    ref = jax_integrate(key, jnp.asarray(x1), jgmm.GMMScoreOracle(jb), jgmm.GMMEnergyOracle(jb),
                        {}, {}, JaxSched(**SCHED), JaxConst(annealing_factor=2.0),
                        jgmm.gmm_power(jb, 2), 1.0, JaxConfig(**kw))
    tb = tgmm.GMM40()
    got = integrate_sde(torch.as_tensor(x1), tgmm.GMMScoreOracle(tb), tgmm.GMMEnergyOracle(tb),
                        ElucidatingNoiseSchedule(**SCHED),
                        ConstantAnnealingSchedule(annealing_factor=2.0), tgmm.gmm_power(tb, 2),
                        1.0, IntegratorConfig(**kw), draws=HutchppDraws(key, n, False, 0),
                        device="cpu")
    _close(got.samples, ref.samples, 1e-4)
    _close(got.logweights, ref.logweights, 1e-4)
    assert float(got.logweights[-1].std()) > 0  # the weights did move
