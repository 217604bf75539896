"""The port's FAB (pita_torch.fab and PrioritisedBuffer) against pita_tpu.fab
on the CPU: the flow through the weight bridge, the transitions and AIS with
JAX's draws replayed, the prioritised buffer, the eight losses and their
gradients, one outer iteration of the prioritised-buffer loop; and the ports
of tests/test_fab.py's log-Z and mixing checks at their bounds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_torch.fab import (AISConfig, FABConfig, FabDraws, FlowDistribution, GaussianTarget,
                            ManyWell, annealed_importance_sampling, fab_loss, hmc_transition,
                            metropolis_transition, train_fab, train_fab_with_prioritised_buffer)
from pita_torch.fab.ais import beta_spacing
from pita_torch.fab.fab_model import LOSS_TYPES, prioritised_step
from pita_torch.io.flax_params import fab_flow_params_from_tree
from pita_torch.train.buffer import (prioritised_add, prioritised_adjust, prioritised_init,
                                     prioritised_sample)
from pita_torch.train.optim import adam_init
from pita_tpu.fab import AISConfig as JaxAISConfig
from pita_tpu.fab import FABConfig as JaxFABConfig
from pita_tpu.fab import FlowDistribution as JaxFlow
from pita_tpu.fab import GaussianTarget as JaxGaussian
from pita_tpu.fab import ManyWell as JaxManyWell
from pita_tpu.fab import annealed_importance_sampling as jax_ais
from pita_tpu.fab import fab_loss as jax_fab_loss
from pita_tpu.fab import hmc_transition as jax_hmc
from pita_tpu.fab import metropolis_transition as jax_metropolis
from pita_tpu.fab import train_fab_with_prioritised_buffer as jax_train_prioritised
from pita_tpu.fab.ais import beta_spacing as jax_beta_spacing
from pita_tpu.train import buffer as jbuf
from torch_threads import one_intra_op_thread  # noqa: F401


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, ref, tol, what=""):
    """max |got − ref| ≤ tol · max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert err <= tol * scale, (what, err, scale)


@functools.partial(jax.jit, static_argnums=1)
def _sweep_keys(key, n_steps):
    return jax.vmap(jax.random.split)(jax.random.split(key, n_steps))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _sweep_draws(keys, uniform, shape):
    """Every sweep's draws of one kind at once (vmap over the keys gives
    each key's draws bit for bit)."""
    if uniform:
        return jax.vmap(lambda k: jax.random.uniform(k[1], shape))(keys)
    return jax.vmap(lambda k: jax.random.normal(k[0], shape, jnp.float32))(keys)


class JaxSweeps:
    """The draws of pita_tpu's transition sweeps from ``key``: the key split
    into one per sweep, each split into (proposal or momentum, accept
    test) (transition_operators.py:28-37,81-87). Each kind is made for all
    sweeps in one call, op by op each would compile alone."""

    def __init__(self, key, n_steps):
        self.keys = _sweep_keys(key, n_steps)
        self.made = {}

    def _draw(self, uniform, step, shape):
        if (uniform, shape) not in self.made:
            self.made[uniform, shape] = np.asarray(_sweep_draws(self.keys, uniform, shape))
        return torch.as_tensor(self.made[uniform, shape][step])

    def normal(self, step, shape):
        return self._draw(False, step, tuple(shape))

    def uniform(self, step, shape):
        return self._draw(True, step, tuple(shape))


class JaxFabDraws:
    """The random numbers pita_tpu's AIS and FAB draw from ``key``: AIS
    splits it into (base, ladder) and each rung splits the ladder key
    (ais.py:80,93); a flow loss draws the base normals from ``key`` itself
    (fab_model.py:101); ``gumbel_keys`` serve the inner steps in turn."""

    def __init__(self, key, n_rungs=0, n_steps=0, flow=False, gumbel_keys=()):
        k_init, k = jax.random.split(key)
        self.k_base = key if flow else k_init
        self.rungs = []
        for _ in range(n_rungs):
            k, k_t = jax.random.split(k)
            self.rungs.append(JaxSweeps(k_t, n_steps))
        self.gumbel_keys = list(gumbel_keys)

    def base(self, shape):
        return t(jax.random.normal(self.k_base, shape))

    def rung(self, j):
        return self.rungs[j]

    def gumbel(self, shape):
        return t(jax.random.gumbel(self.gumbel_keys.pop(0), shape))


@functools.lru_cache(maxsize=None)
def _jax_flow(dim, n_coupling, hidden, seed, scale):
    """A pita_tpu flow with every weight perturbed (its last layers are zero
    at init, the identity); made once for each set of arguments."""
    jf = JaxFlow(dim, n_coupling=n_coupling, hidden=hidden)
    params = jax.jit(jf.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + scale * rng.normal(size=a.shape),
                                                jnp.float32), params)
    return jf, params


def _perturbed_flow(dim, n_coupling, hidden, seed, scale=0.3):
    """``_jax_flow``'s flow, and a fresh port flow with the same weights."""
    jf, params = _jax_flow(dim, n_coupling, hidden, seed, scale)
    tf = FlowDistribution(dim, n_coupling=n_coupling, hidden=hidden, device="cpu")
    tf.module.load_state_dict(fab_flow_params_from_tree(jax.tree.map(np.asarray, params)))
    return jf, params, tf


def test_flow_forward_inverse_and_log_prob_match_jax():
    """Within 1e-5 of the largest value: forward and inverse maps and their
    log-dets, log_prob and a sample's log q, on perturbed weights."""
    jf, params, tf = _perturbed_flow(4, 2, 16, seed=0, scale=0.15)
    rng = np.random.default_rng(1)
    z = rng.normal(size=(64, 4)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    @jax.jit  # the references in one program: op by op, each primitive compiles alone
    def refs(p, z, k):
        x, ld = jf.module.apply(p, z)
        return (x, ld, *jf.module.apply(p, x, method="inverse"), jf.log_prob(p, x),
                *jf.sample_and_log_prob(p, k, 32))

    x_ref, ld_ref, zi_ref, ldi_ref, lp_ref, xs_ref, lq_ref = refs(params, jnp.asarray(z), key)
    x, ld = tf.module(t(z))
    close(x.detach(), x_ref, 1e-5, "forward")
    close(ld.detach(), ld_ref, 1e-5, "forward logdet")
    zi, ldi = tf.module.inverse(t(x_ref))
    close(zi.detach(), zi_ref, 1e-5, "inverse")
    close(ldi.detach(), ldi_ref, 1e-5, "inverse logdet")
    np.testing.assert_allclose(zi.detach().numpy(), z, atol=1e-5)  # inverse of forward
    close(tf.log_prob(t(x_ref)).detach(), lp_ref, 1e-5, "log_prob")
    xs, lq = tf.sample_and_log_prob(32, eps=t(jax.random.normal(key, (32, 4))))
    close(xs.detach(), xs_ref, 1e-5, "sample")
    close(lq.detach(), lq_ref, 1e-5, "sample log q")
    assert float(jnp.abs(ld_ref).max()) > 0.1  # the couplings are not the identity


def test_fresh_flow_is_the_base_gaussian():
    """The zero last layers: a fresh flow is its N(0, I) base
    (tests/test_fab_model.py:30-36), within 1e-5."""
    tf = FlowDistribution(2, n_coupling=2, hidden=8, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    x = torch.randn(16, 2, generator=torch.Generator().manual_seed(2))
    ref = -0.5 * (x ** 2).sum(-1) - np.log(2 * np.pi)
    np.testing.assert_allclose(tf.log_prob(x).detach().numpy(), ref.numpy(), rtol=1e-5)


@pytest.mark.parametrize("which", ["metropolis", "hmc"])
def test_transitions_match_jax_with_its_draws(which):
    """12 sweeps over 128 chains of ManyWell-4 from a spread start, step
    size adapted: the same accept decisions (identical mean acceptance) and
    states within 1e-5 of the largest."""
    jt, tt = JaxManyWell(dim=4), ManyWell(dim=4)
    x0 = (np.random.default_rng(3).normal(size=(128, 4)) * 1.5).astype(np.float32)
    key = jax.random.PRNGKey(4)
    n = 12
    draws = JaxSweeps(key, n)
    if which == "hmc":
        x_ref, acc_ref = jax.jit(lambda x: jax_hmc(key, x, jt.log_prob, n, 0.2, n_leapfrog=4))(
            jnp.asarray(x0))
        x, acc = hmc_transition(t(x0), tt.log_prob, n, 0.2, draws, n_leapfrog=4)
    else:
        x_ref, acc_ref = jax.jit(lambda x: jax_metropolis(key, x, jt.log_prob, n, 0.5))(
            jnp.asarray(x0))
        x, acc = metropolis_transition(t(x0), tt.log_prob, n, 0.5, draws)
    assert float(acc) == pytest.approx(float(acc_ref), abs=1e-7)
    assert 0.05 < float(acc) < 0.95
    close(x, x_ref, 1e-5, which)


@pytest.mark.parametrize("spacing,transition", [("linear", "hmc"), ("geometric", "hmc"),
                                                ("linear", "metropolis"),
                                                ("geometric", "metropolis")])
def test_ais_matches_jax_with_its_draws(spacing, transition):
    """AIS from N(0, 2²I) to N(1, 0.7²I) in 2-D, 256 chains, 6 intermediate
    distributions of 3 sweeps: the ladder exactly, samples and log-weights
    within 1e-5 of the largest, ESS and log Z within 1e-5."""
    cfg_kw = dict(n_intermediate_distributions=6, distribution_spacing_type=spacing,
                  transition=transition, n_inner_steps=3)
    np.testing.assert_array_equal(beta_spacing(AISConfig(**cfg_kw)),
                                  jax_beta_spacing(JaxAISConfig(**cfg_kw)))
    jb, jt = JaxGaussian(jnp.zeros(2), jnp.full(2, 2.0)), JaxGaussian(jnp.ones(2),
                                                                     jnp.full(2, 0.7))
    tb, tt = GaussianTarget(np.zeros(2), np.full(2, 2.0)), GaussianTarget(np.ones(2),
                                                                          np.full(2, 0.7))
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda k: jax_ais(k, jb.sample_and_log_prob, jb.log_prob, jt.log_prob, 256,
                                    JaxAISConfig(**cfg_kw)))(key)
    res = annealed_importance_sampling(
        lambda n, d: tb.sample_and_log_prob(n, eps=d.base((n, 2))), tb.log_prob, tt.log_prob,
        256, AISConfig(**cfg_kw), JaxFabDraws(key, 7, 3))
    close(res.samples, ref.samples, 1e-5, "samples")
    close(res.log_w, ref.log_w, 1e-5, "log_w")
    for k in ("ess_base", "ess_ais", "log_Z"):
        assert float(getattr(res, k)) == pytest.approx(float(getattr(ref, k)), abs=1e-5), k


def test_ais_masks_non_finite_weights():
    """A chain whose target log-density is NaN keeps its place with weight
    −∞; log Z and ESS come from the others."""
    tb = GaussianTarget(np.zeros(2), np.ones(2))
    nan_first = lambda x: torch.where(torch.arange(x.shape[0]) == 0, torch.nan, tb.log_prob(x))
    res = annealed_importance_sampling(
        lambda n, d: tb.sample_and_log_prob(n, eps=d.base((n, 2))), tb.log_prob, nan_first, 64,
        AISConfig(n_intermediate_distributions=2, transition="metropolis"),
        FabDraws(torch.Generator().manual_seed(0)))
    assert res.samples.shape == (64, 2) and float(res.log_w[0]) == -np.inf
    assert torch.isfinite(res.log_w[1:]).all() and np.isfinite(float(res.log_Z))


def test_prioritised_buffer_matches_jax():
    """Capacity 64: two adds (the second wraps), a Gumbel-top-k sample of
    24 with JAX's Gumbel draws (the same rows), an adjust of the sampled
    rows and of all rows (non-finite killed): every field equal."""
    rng = np.random.default_rng(6)
    # pita_tpu's buffer functions jitted: op by op, each primitive compiles alone
    j_add, j_adjust = jax.jit(jbuf.prioritised_add), jax.jit(jbuf.prioritised_adjust)
    jb, tb = jbuf.prioritised_init(64, 3), prioritised_init(64, 3)
    for n in (40, 40):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        lw, lq = (rng.normal(size=n) * 3).astype(np.float32), rng.normal(size=n).astype(np.float32)
        jb = j_add(jb, jnp.asarray(x), jnp.asarray(lw), jnp.asarray(lq))
        tb = prioritised_add(tb, t(x), t(lw), t(lq))
    key = jax.random.PRNGKey(7)
    ref, gumbel = jax.jit(lambda b, k: (jbuf.prioritised_sample(b, k, 24),
                                        jax.random.gumbel(k, (64,))))(jb, key)
    got = prioritised_sample(tb, 24, t(gumbel))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    new_q = rng.normal(size=24).astype(np.float32)
    new_q[0] = np.inf
    jb = j_adjust(jb, jnp.asarray(new_q), ref[3])
    tb = prioritised_adjust(tb, t(new_q), got[3])
    everything = rng.normal(size=64).astype(np.float32)
    jb = j_adjust(jb, jnp.asarray(everything))
    tb = prioritised_adjust(tb, t(everything))
    for f in ("x", "log_w", "log_q"):
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), rtol=1e-6,
                                   atol=0, err_msg=f)
    assert int(tb.pos) == int(jb.pos) == 16 and int(tb.size) == int(jb.size) == 64
    assert float(tb.log_w[int(got[3][0])]) == -np.inf


def _gauss_lp(mod, mean=1.5, scale=0.7):
    """The Gaussian target of tests/test_fab_model.py:39-45, in either package."""
    return lambda x: (-0.5 * (((x - mean) / scale) ** 2).sum(-1)
                      - x.shape[-1] * (0.5 * mod.log(mod.asarray(2 * np.pi))
                                       + mod.log(mod.asarray(scale))))


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_loss_value_and_gradient_match_jax(loss_type):
    """Each FABModel loss on a perturbed 2-D flow (2 couplings, hidden 8),
    batch 32, AIS over 2 intermediate distributions of Metropolis sweeps
    (HMC's AIS is held against JAX's in the AIS cases and in the loop
    iteration below; in a loss its compile is 3 s) with JAX's draws: the
    value within 1e-5 (relative) and every weight gradient within 1e-4 of
    its tensor's largest entry."""
    jf, params, tf = _perturbed_flow(2, 2, 8, seed=8, scale=0.2)
    key = jax.random.PRNGKey(9)
    data = np.random.default_rng(10).normal(1.5, 0.7, size=(32, 2)).astype(np.float32)
    kw = dict(loss_type=loss_type, batch_size=32, n_intermediate_distributions=2,
              transition="metropolis")
    jcfg = JaxFABConfig(**kw)
    loss_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda p: jax_fab_loss(jf, p, _gauss_lp(jnp), key, jcfg, data=jnp.asarray(data))))(params)
    draws = JaxFabDraws(key, 3, 5, flow=loss_type.startswith("flow_"))
    cfg = FABConfig(**kw)
    loss = fab_loss(tf, _gauss_lp(torch_ops), cfg, draws, data=t(data))
    assert np.isfinite(float(loss_ref))
    assert float(loss.detach()) == pytest.approx(float(loss_ref), rel=1e-5, abs=1e-6)
    grads = torch.autograd.grad(loss, tf.parameters())
    ref = fab_flow_params_from_tree(jax.tree.map(np.asarray, g_ref))
    names = [n for n, _ in tf.module.named_parameters()]
    for name, g in zip(names, grads):
        close(g, ref[name], 1e-4, name)
    assert max(float(g.abs().max()) for g in grads) > 0


class torch_ops:
    """The two functions _gauss_lp needs, in torch."""

    log = staticmethod(torch.log)
    asarray = staticmethod(lambda v: torch.tensor(v, dtype=torch.float32))


def test_prioritised_loop_iteration_matches_jax():
    """One outer iteration of train_fab_with_prioritised_buffer on ManyWell-4
    (a flow of 2 couplings, hidden 16; batch 32, AIS over 2 intermediate
    distributions, 2 inner steps at lr 1e-3): with JAX's draws, the flow's
    weights after it within 1e-3 lr (a few f32 ulps of weights near 0.5),
    the buffer's rows, log w and log q within 1e-5 of the largest, and the
    loss within 1e-5."""
    jf, params, tf = _perturbed_flow(4, 2, 16, seed=11, scale=0.1)
    before = [p.detach().clone() for p in tf.parameters()]
    jt, tt = JaxManyWell(dim=4), ManyWell(dim=4)
    kw = dict(batch_size=32, n_intermediate_distributions=2, buffer_capacity=64,
              min_buffer_length=32, n_batches_buffer_sampling=2, lr=1e-3)
    key = jax.random.PRNGKey(12)
    p_ref, buf_ref, hist_ref = jax_train_prioritised(jf, jt.log_prob, JaxFABConfig(**kw), key,
                                                     1, params=params)
    _, k_ais, k_in = jax.random.split(key, 3)
    draws = JaxFabDraws(k_ais, 3, 5, gumbel_keys=[jax.random.fold_in(k_in, j) for j in range(2)])
    buf, hist = train_fab_with_prioritised_buffer(tf, tt.log_prob, FABConfig(**kw), 1,
                                                  draws=draws)
    ref = fab_flow_params_from_tree(jax.tree.map(np.asarray, p_ref))
    change = max(float((p.detach() - b).abs().max()) for p, b in zip(tf.parameters(), before))
    assert change > 1e-4
    for (name, p) in tf.module.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) <= 1e-3 * 1e-3, name
    for f in ("x", "log_w", "log_q"):
        close(getattr(buf, f)[:32], np.asarray(getattr(buf_ref, f))[:32], 1e-5, f)
    assert buf.size == int(buf_ref.size) == 32
    assert hist[0]["loss"] == pytest.approx(hist_ref[0]["loss"], rel=1e-5)
    assert hist[0]["ess_ais"] == pytest.approx(hist_ref[0]["ess_ais"], abs=1e-5)


def test_prioritised_step_skips_a_non_finite_loss():
    """A NaN row with the dominant weight makes the loss NaN: the weights,
    Adam's state and the buffer stay as they were; the next finite step
    moves them (:181-189)."""
    tf = FlowDistribution(2, n_coupling=2, hidden=8, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    buf = prioritised_init(16, 2)
    x = torch.randn(16, 2, generator=torch.Generator().manual_seed(1))
    x[3] = torch.nan
    lw = torch.zeros(16)
    lw[3] = 50.0
    buf = prioritised_add(buf, x, lw, torch.zeros(16))
    state = adam_init(tf.parameters())
    before = [p.detach().clone() for p in tf.parameters()]
    cfg = FABConfig(batch_size=4)
    lw0, lq0 = buf.log_w.clone(), buf.log_q.clone()
    state, buf, loss, ok = prioritised_step(tf, buf, state, cfg, torch.zeros(16))
    assert not ok and not np.isfinite(float(loss)) and state.count == 0
    assert all(torch.equal(p, b) for p, b in zip(tf.parameters(), before))
    assert torch.equal(buf.log_w, lw0) and torch.equal(buf.log_q, lq0)
    buf.log_w[3] = -np.inf
    state, buf, loss, ok = prioritised_step(tf, buf, state, cfg, torch.zeros(16))
    assert ok and state.count == 1 and not torch.equal(buf.log_q, lq0)
    assert any(not torch.equal(p, b) for p, b in zip(tf.parameters(), before))


def test_many_well_modes_and_log_prob_match_jax():
    """dim 8: the 16 modes equal JAX's, are local maxima, and log_prob at
    T = 1 and T = 2 matches within 1e-6 relative (tests/test_fab.py:73-86)."""
    mw, jmw = ManyWell(dim=8), JaxManyWell(dim=8)
    modes = mw.mode_locations()
    assert modes.shape == (16, 8)
    np.testing.assert_array_equal(modes, jmw.mode_locations())
    lp_modes = mw.log_prob(torch.as_tensor(modes))
    assert bool((lp_modes > mw.log_prob(torch.as_tensor(modes) + 0.3)).all())
    x = np.random.default_rng(13).normal(size=(32, 8)).astype(np.float32)
    for T in (1.0, 2.0):
        np.testing.assert_allclose(ManyWell(dim=8, temperature=T).log_prob(t(x)).numpy(),
                                   np.asarray(JaxManyWell(dim=8, temperature=T).log_prob(x)),
                                   rtol=1e-6)


def test_ais_recovers_log_Z_of_normalized_target():
    """tests/test_fab.py:19-31 on the port: AIS from N(0, 2²I) to N(1, I),
    2048 chains, 16 intermediate distributions of 3 HMC sweeps: |log Z| <
    0.1, ESS rises, the weighted mean within 0.15 of 1."""
    base = GaussianTarget(np.zeros(2), np.full(2, 2.0))
    target = GaussianTarget(np.ones(2), np.ones(2))
    cfg = AISConfig(n_intermediate_distributions=16, transition="hmc", n_inner_steps=3)
    res = annealed_importance_sampling(
        lambda n, d: base.sample_and_log_prob(n, eps=d.base((n, 2))), base.log_prob,
        target.log_prob, 2048, cfg, FabDraws(torch.Generator().manual_seed(0)))
    assert abs(float(res.log_Z)) < 0.1, float(res.log_Z)
    assert float(res.ess_ais) > float(res.ess_base)
    m = np.average(res.samples.numpy(), axis=0, weights=torch.softmax(res.log_w, 0).numpy())
    np.testing.assert_allclose(m, 1.0, atol=0.15)


def test_ais_geometric_spacing_recovers_log_Z():
    """tests/test_fab.py:34-46: geometric ladder, Metropolis, 1024 chains to
    N(0, 0.5²I): |log Z| < 0.15."""
    base = GaussianTarget(np.zeros(2), np.full(2, 2.0))
    target = GaussianTarget(np.zeros(2), np.full(2, 0.5))
    cfg = AISConfig(n_intermediate_distributions=16, distribution_spacing_type="geometric",
                    transition="metropolis", n_inner_steps=5)
    res = annealed_importance_sampling(
        lambda n, d: base.sample_and_log_prob(n, eps=d.base((n, 2))), base.log_prob,
        target.log_prob, 1024, cfg, FabDraws(torch.Generator().manual_seed(0)))
    assert abs(float(res.log_Z)) < 0.15, float(res.log_Z)


def test_transitions_mix():
    """tests/test_fab.py:49-63: 300 Metropolis sweeps of 1024 chains from
    x = 4 reach N(0, I) (acceptance in (0.1, 0.95), mean within 0.3); 50
    HMC sweeps of 512 chains from x = 3 in 4-D (acceptance > 0.3, variance
    within 30 % of 1)."""
    d = FabDraws(torch.Generator().manual_seed(0))
    target = GaussianTarget(np.zeros(2), np.ones(2))
    x, acc = metropolis_transition(torch.full((1024, 2), 4.0), target.log_prob, 300, 0.5, d)
    assert 0.1 < float(acc) < 0.95
    np.testing.assert_allclose(x.numpy().mean(0), 0.0, atol=0.3)
    target = GaussianTarget(np.zeros(4), np.ones(4))
    x, acc = hmc_transition(torch.full((512, 4), 3.0), target.log_prob, 50, 0.2, d, n_leapfrog=5)
    assert float(acc) > 0.3
    np.testing.assert_allclose(x.numpy().var(0), 1.0, rtol=0.3)


@pytest.mark.slow
def test_train_fab_learns_gaussian():
    """tests/test_fab_model.py:63-74 on the port: 150 iterations of
    fab_alpha_div to N(1, 0.5²I): mean within 0.15 of 1, std within 0.15 of
    0.5."""
    tf = FlowDistribution(2, n_coupling=4, hidden=32, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    cfg = FABConfig(loss_type="fab_alpha_div", batch_size=128, lr=5e-3,
                    n_intermediate_distributions=2)
    losses = train_fab(tf, _gauss_lp(torch_ops, 1.0, 0.5), cfg, 150, seed=0)
    assert len(losses) == 150 and np.isfinite(losses[-1])
    with torch.no_grad():
        x = tf.sample(2000, generator=torch.Generator().manual_seed(9)).numpy()
    np.testing.assert_allclose(x.mean(0), 1.0, atol=0.15)
    np.testing.assert_allclose(x.std(0), 0.5, atol=0.15)


@pytest.mark.slow
def test_train_fab_prioritised_buffer_learns():
    """tests/test_fab_model.py:77-89 on the port: 60 outer iterations to
    N(−1, 0.6²I): finite losses, mean within 0.2 of −1."""
    tf = FlowDistribution(2, n_coupling=4, hidden=32, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    cfg = FABConfig(batch_size=128, lr=5e-3, n_intermediate_distributions=2,
                    min_buffer_length=128, n_batches_buffer_sampling=4)
    buf, hist = train_fab_with_prioritised_buffer(tf, _gauss_lp(torch_ops, -1.0, 0.6), cfg, 60)
    assert len(hist) > 0 and np.isfinite(hist[-1]["loss"])
    with torch.no_grad():
        x = tf.sample(2000, generator=torch.Generator().manual_seed(9)).numpy()
    np.testing.assert_allclose(x.mean(0), -1.0, atol=0.2)
