"""The port's training pieces against pita_tpu on the CPU: the noise levels,
the priors, the augmentations, score clipping, the EMA, the replay buffer,
the six losses and their weight gradients, clip + Adam, and the flax initial
distributions. Random numbers are drawn with jax.random from the keys JAX
uses and handed to the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from pita_tpu.nets import EGNNBackbone as JaxEGNN
from pita_tpu.nets import EnergyWrapper as JaxEnergy
from pita_tpu.nets import ScoreWrapper as JaxScore
from pita_tpu.nets.ema import ema_init, ema_update
from pita_tpu.schedules import ElucidatingNoiseSchedule as JaxSched
from pita_tpu.targets import LJ13 as JaxLJ13
from pita_tpu.targets.priors import IsotropicGaussianPrior as JaxIso
from pita_tpu.targets.priors import MeanFreePrior as JaxMF
from pita_tpu.train import buffer as jbuf
from pita_tpu.train.augment import com_augment as jax_com
from pita_tpu.train.augment import rotate_augment as jax_rotate
from pita_tpu.train.dem_estimator import clip_scores as jax_clip
from pita_tpu.train.losses import LossConfig as JaxLossConfig
from pita_tpu.train.losses import compute_losses as jax_losses
from pita_tpu.train.losses import stratified_losses as jax_strat
from pita_torch.io.flax_params import egnn_params_from_tree, load_egnn_params
from pita_torch.nets import EGNNBackbone, EnergyWrapper, ScoreWrapper
from pita_torch.nets.ema import EMA
from pita_torch.schedules import ElucidatingNoiseSchedule
from pita_torch.targets import LJ13
from pita_torch.targets.priors import IsotropicGaussianPrior, MeanFreePrior, Prior
from pita_torch.train import buffer as tbuf
from pita_torch.train.augment import com_augment, rotate_augment
from pita_torch.train.dem_estimator import clip_scores
from pita_torch.train.losses import LossConfig, LossDraws, compute_losses, stratified_losses
from pita_torch.train.optim import adam_init, adam_update, clip_by_global_norm, make_lr_schedule
from torch_threads import one_intra_op_thread  # noqa: F401

SCHED = dict(sigma_min=0.05, sigma_max=80.0, rho=7.0)


def t(a):
    return torch.as_tensor(np.array(a))


def _lattice13(B, seed, jitter=0.08):
    """LJ13 configurations near a relaxed cluster: energies in the masks' range."""
    rng = np.random.default_rng(seed)
    side = np.array([[i, j, k] for i in range(3) for j in range(3) for k in range(3)])[:13]
    x = (side - side.mean(0)) * 1.12 + jitter * rng.normal(size=(B, 13, 3))
    return x.reshape(B, 39).astype(np.float32)


def test_sample_ln_sigma_and_bins():
    key = jax.random.PRNGKey(3)
    js, ts = JaxSched(**SCHED), ElucidatingNoiseSchedule(**SCHED)
    ref = js.sample_ln_sigma(key, 64)
    got = ts.sample_ln_sigma(64, normal=t(jax.random.normal(key, (64,))))
    np.testing.assert_allclose(got.numpy(), np.array(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.ln_sigma_bins(4).numpy(), np.array(js.ln_sigma_bins(4)),
                               rtol=1e-6, atol=1e-6)
    # drawn from a generator: N(P_mean, P_std^2)
    many = ts.sample_ln_sigma(20000, generator=torch.Generator().manual_seed(0))
    assert abs(float(many.mean()) - ts.P_mean) < 0.05
    assert abs(float(many.std()) - ts.P_std) < 0.05


@pytest.mark.parametrize("mean_free", [True, False])
def test_priors_match_jax_given_the_same_normals(mean_free):
    key = jax.random.PRNGKey(5)
    if mean_free:
        jp, tp = JaxMF(13, 3, 1.7), MeanFreePrior(13, 3, 1.7)
        normal = jax.random.normal(key, (7, 13, 3))
    else:
        jp, tp = JaxIso(39, 1.7), IsotropicGaussianPrior(39, 1.7)
        normal = jax.random.normal(key, (7, 39))
    x_ref = jp.sample(key, 7)
    x = tp.sample(7, normal=t(normal))
    np.testing.assert_allclose(x.numpy(), np.array(x_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.log_prob(x).numpy(), np.array(jp.log_prob(x_ref)), rtol=1e-6)
    assert isinstance(Prior(1.0, 13, 3, should_mean_free=mean_free),
                      MeanFreePrior if mean_free else IsotropicGaussianPrior)


def test_augmentations_match_jax_with_its_draws():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 39)).astype(np.float32)
    f = rng.normal(size=(9, 39)).astype(np.float32)
    k_rot, k_com = jax.random.split(jax.random.PRNGKey(7))
    xr, fr = jax_rotate(k_rot, jnp.asarray(x), jnp.asarray(f), 13, 3)
    gx, gf = rotate_augment(t(x), t(f), 13, 3, normal=t(jax.random.normal(k_rot, (9, 3, 3))))
    np.testing.assert_allclose(gx.numpy(), np.array(xr), rtol=0, atol=2e-5)
    np.testing.assert_allclose(gf.numpy(), np.array(fr), rtol=0, atol=2e-5)
    # rotations: norms per particle kept, proper (det +1)
    np.testing.assert_allclose(np.linalg.norm(gx.numpy().reshape(9, 13, 3), axis=-1),
                               np.linalg.norm(x.reshape(9, 13, 3), axis=-1), rtol=1e-5)
    xc = jax_com(k_com, jnp.asarray(x), 13, 3)
    gc = com_augment(t(x), 13, 3, normal=t(jax.random.normal(k_com, (9, 1, 3))))
    np.testing.assert_allclose(gc.numpy(), np.array(xc), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_particles", [13, None])
def test_clip_scores_matches_jax(n_particles):
    s = np.random.default_rng(1).normal(size=(6, 39)).astype(np.float32) * 40
    kw = dict(n_particles=n_particles, n_spatial_dim=3 if n_particles else None)
    ref = jax_clip(jnp.asarray(s), 50.0, **kw)
    np.testing.assert_allclose(clip_scores(t(s), 50.0, **kw).numpy(), np.array(ref),
                               rtol=1e-6, atol=1e-5)


def _jax_net(n=13, hidden=8, layers=2, seed=0):
    mod = JaxEGNN(n_particles=n, hidden_nf=hidden, n_layers=layers)
    params = mod.init(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, 3 * n)), 1.0)
    return mod, params


def _port_net(mod, params, route="autograd"):
    bb = EGNNBackbone(mod.n_particles, hidden_nf=mod.hidden_nf, n_layers=mod.n_layers,
                      route=route)
    with torch.no_grad():
        for k, v in load_egnn_params(serialization.to_bytes(params), mod.n_layers).items():
            bb.get_parameter(k).copy_(v)
    return bb


def test_ema_five_updates_match_jax():
    mod, p0 = _jax_net(seed=0)
    state = ema_init(p0)
    net = _port_net(mod, p0)
    ema = EMA(net)
    for i in range(5):
        _, pi = _jax_net(seed=i + 1)
        state = ema_update(state, pi, 0.999)
        ema.update(_port_net(mod, pi), 0.999)
    assert ema.num_updates == int(state.num_updates) == 5
    ref = egnn_params_from_tree(jax.tree.map(np.asarray, state.params), 2)
    for k, v in ema.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-7)
    assert ema.module.route == "kernels"
    assert not any(p.requires_grad for p in ema.module.parameters())


def _jax_buffer_and_port(cap=10, dim=4):
    rng = np.random.default_rng(2)
    jb, tb = jbuf.buffer_init(cap, dim), tbuf.buffer_init(cap, dim)
    for n, masked in ((4, False), (5, True), (6, False)):  # the third add wraps around
        x = rng.normal(size=(n, dim)).astype(np.float32)
        e = rng.normal(size=n).astype(np.float32)
        f = rng.normal(size=(n, dim)).astype(np.float32)
        m = (np.arange(n) % 2 == 0) if masked else None
        jb = jbuf.buffer_add(jb, jnp.asarray(x), jnp.asarray(e), jnp.asarray(f),
                             mask=None if m is None else jnp.asarray(m))
        tb = tbuf.buffer_add(tb, t(x), t(e), t(f), mask=None if m is None else t(m))
    return jb, tb


def test_buffer_add_wraps_and_samples_like_jax(tmp_path):
    jb, tb = _jax_buffer_and_port()
    assert (tb.pos, tb.size) == (int(jb.pos), int(jb.size)) == (3, 10)
    for name in ("x", "energy", "force"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.array(getattr(jb, name)))
    for a, b in zip(tbuf.buffer_last_n(tb, 4), jbuf.buffer_last_n(jb, 4)):
        np.testing.assert_array_equal(a.numpy(), np.array(b))
    key = jax.random.PRNGKey(0)
    for replacement in (True, False):
        ref = jbuf.buffer_sample(jb, key, 8, replacement=replacement)
        got = tbuf.buffer_sample(tb, 8, idx=t(ref[3]))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.array(b))
    # the port's own draws: a subset without replacement, indices in range
    gen = torch.Generator().manual_seed(0)
    idx = tbuf.sample_indices(tb, 8, replacement=False, generator=gen)
    assert len(set(idx.tolist())) == 8 and int(idx.max()) < 10
    idx = tbuf.sample_indices(tb, 30, prioritize=True, replacement=True, generator=gen)
    assert int(idx.max()) < 10
    # save/load, and a pita_tpu file loads into the port
    tbuf.buffer_save(tb, tmp_path / "t.npz")
    jbuf.buffer_save(jb, str(tmp_path / "j.npz"))
    for path in ("t.npz", "j.npz"):
        lb = tbuf.buffer_load(tmp_path / path)
        assert (lb.pos, lb.size) == (3, 10)
        np.testing.assert_array_equal(lb.x.numpy(), tb.x.numpy())


def test_stacked_buffers_view_and_set():
    bufs = tbuf.stack_buffers([tbuf.buffer_init(6, 2) for _ in range(3)])
    b1 = tbuf.buffer_add(tbuf.buffer_view(bufs, 1), torch.ones(4, 2), torch.ones(4))
    bufs = tbuf.buffer_set(bufs, 1, b1)
    assert bufs.size.tolist() == [0, 4, 0] and bufs.pos.tolist() == [0, 4, 0]
    assert float(bufs.x[1, :4].sum()) == 8.0 and float(bufs.x[[0, 2]].abs().sum()) == 0.0


# every weight nonzero in at least one case; both mean-free settings
LOSS_CASES = {
    "default_terms": dict(w_target_score=0.5, w_dU_dt_regularization=0.1,
                          time_threshold_score=0.1, time_threshold_target_score=0.5),
    "dem_energy": dict(w_dem_energy=0.5, w_energy_score=0.0, dem_num_mc_samples=8,
                       dem_time_threshold=0.6, energy_threshold=50.0),
    "only_score": dict(only_train_score=True),
}


def _loss_pair(case, mean_free):
    B = 12
    mod, ps = _jax_net(seed=1)
    _, pe = _jax_net(seed=2)
    cfg_kw = LOSS_CASES[case]
    x0 = _lattice13(B, seed=3)
    jt = JaxLJ13(temperature=1.5)
    e0, f0 = jt.log_prob_and_force(jnp.asarray(x0))
    key = jax.random.PRNGKey(11)
    beta = 0.75

    def jloss(both):
        return jax_losses(JaxScore(mod), JaxEnergy(mod), both[0], both[1], JaxSched(**SCHED),
                          JaxLossConfig(**cfg_kw), key, jnp.asarray(x0), e0, f0, beta,
                          target=jt, n_particles=13, n_spatial_dim=3, mean_free=mean_free)

    # one compiled program: faster on the CPU than JAX's op-by-op dispatch
    (ref_total, ref_aux), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))((ps, pe))

    k_sigma, k_noise, k_dem = jax.random.split(key, 3)
    dem = None
    if cfg_kw.get("w_dem_energy", 0) > 0:
        K = cfg_kw["dem_num_mc_samples"]
        dem = t(jnp.stack([jax.random.normal(k, (K, 39)) for k in jax.random.split(k_dem, B)]))
    draws = LossDraws(t(jax.random.normal(k_sigma, (B,))),
                      t(jax.random.normal(k_noise, (B, 39), jnp.float32)), dem)
    sn, en = _port_net(mod, ps), _port_net(mod, pe)
    total, aux = compute_losses(ScoreWrapper(sn), EnergyWrapper(en), ElucidatingNoiseSchedule(
        **SCHED), LossConfig(**cfg_kw), t(x0), t(e0), t(f0), beta, target=LJ13(temperature=1.5),
        n_particles=13, n_spatial_dim=3, mean_free=mean_free, draws=draws)
    params = list(sn.parameters()) + list(en.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return (ref_total, ref_aux, ref_grads), (total, aux, grads, sn, en)


@pytest.mark.parametrize("case,mean_free", [("default_terms", True), ("default_terms", False),
                                            ("dem_energy", True), ("only_score", True)])
def test_compute_losses_and_weight_grads_match_jax(case, mean_free):
    (ref_total, ref_aux, ref_grads), (total, aux, grads, sn, en) = _loss_pair(case, mean_free)
    # f32 sums in another order, through a second derivative: 2e-5 relative
    for k, v in ref_aux.items():
        np.testing.assert_allclose(aux[k].detach().numpy(), np.array(v), rtol=2e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=2e-5)
    if case != "only_score":  # each term of the case is nonzero
        weights = {k[2:]: v for k, v in dataclasses.asdict(LossConfig(**LOSS_CASES[case])).items()
                   if k.startswith("w_") and v}
        for name in weights:
            key = "dU_dt_regularization_loss" if name == "dU_dt_regularization" else name + "_loss"
            assert abs(float(aux[key].detach())) > 0, key
    # weight gradients of both nets: per tensor, max error within 1e-4 of its largest entry
    names = [f"s.{n}" for n, _ in sn.named_parameters()] + [f"e.{n}" for n, _ in
                                                            en.named_parameters()]
    ref = {**{f"s.{k}": v for k, v in egnn_params_from_tree(
        jax.tree.map(np.asarray, ref_grads[0]), 2).items()},
           **{f"e.{k}": v for k, v in egnn_params_from_tree(
               jax.tree.map(np.asarray, ref_grads[1]), 2).items()}}
    for name, g in zip(names, grads):
        r = ref[name].numpy()
        g = np.zeros_like(r) if g is None else g.numpy()
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(g - r).max() <= 1e-4 * scale + 1e-12, (name, np.abs(g - r).max(), scale)


def test_stratified_losses_match_jax():
    rng = np.random.default_rng(0)
    ln, per = rng.normal(-1.2, 1.2, 200).astype(np.float32), rng.random(200).astype(np.float32)
    edges = ElucidatingNoiseSchedule(**SCHED).ln_sigma_bins(4).numpy()
    ref = jax_strat(ln, per, edges, loss_name="score_loss")
    got = stratified_losses(ln, per, edges, loss_name="score_loss")
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12)


@pytest.mark.parametrize("schedule,clip", [("constant", 0.5), ("constant", 100.0),
                                           ("cosine", 0.5), ("exponential", 0.5)])
def test_three_optimizer_steps_match_optax(schedule, clip):
    """clip_by_global_norm then Adam over two parameter trees, three steps,
    with the same gradients: within 1e-3 lr of optax (f32 rounding only)."""
    lr, steps_per_epoch, total = 1e-3, 2, 6
    rng = np.random.default_rng(4)
    shapes = [(8, 8), (8,), (3, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if schedule == "cosine":
        sched = optax.cosine_decay_schedule(lr, total, alpha=0.1)
    elif schedule == "exponential":
        sched = optax.exponential_decay(lr, steps_per_epoch, 0.9)
    else:
        sched = lr
    opt = optax.chain(optax.clip_by_global_norm(clip), optax.adam(sched))
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [t(p) for p in params]
    tstate = adam_init(tp)
    lr_at = make_lr_schedule(schedule, lr, total, steps_per_epoch, 0.9, 0.1)
    for step in range(3):
        grads = [rng.normal(size=s).astype(np.float32) * (1e-6 if i == 2 else 1.0)
                 for i, s in enumerate(shapes)]
        upd, state = opt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        cg, _ = clip_by_global_norm([t(g) for g in grads], clip)
        tu, tstate = adam_update(cg, tstate, lr_at(tstate.count))
        tp = [p + u for p, u in zip(tp, tu)]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=0, atol=1e-3 * lr)
    adam = state[1][0]
    assert tstate.count == int(adam.count) == 3
    for a, b in zip(tstate.mu + tstate.nu, list(adam.mu) + list(adam.nu)):
        # the clip scale 0.5/norm is an f32 quotient of sums taken in another order
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=2e-5, atol=1e-12)


def test_flax_initial_distributions():
    """reset_parameters draws flax's distributions: lecun-normal kernels
    (variance 1/fan_in, truncated at 2 sigma), zero biases, the coordinate
    head uniform with variance 3e-6/fan_avg. Moments over a wide net against
    the analytic values and against flax's own init."""
    F = 128
    bb = EGNNBackbone(13, hidden_nf=F, n_layers=1, route="autograd")
    bb.reset_parameters(torch.Generator().manual_seed(0))
    mod, params = _jax_net(hidden=F, layers=1, seed=0)
    ref = egnn_params_from_tree(jax.tree.map(np.asarray, params), 1)
    for name, p in bb.named_parameters():
        v, r = p.detach().numpy(), ref[name].numpy()
        if name.split(".")[-1].startswith("b_"):
            assert not v.any() and not r.any(), name
            continue
        if name.endswith("w_c2"):
            var = 3e-6 / ((F + 1) / 2)
            bound = np.sqrt(3 * var)
        else:
            var = 1.0 / p.shape[0]
            bound = 2 * np.sqrt(var) / 0.87962566103423978
        # 2 (w_emb, w_scal) to F*F samples: the sample variance within 6 of its
        # standard errors (kurtosis below 3 for both laws)
        tol = 6 * var * np.sqrt(2 / v.size)
        assert abs(v.var() - var) <= tol, (name, v.var(), var)
        assert abs(r.var() - var) <= tol, (name, r.var(), var)
        assert np.abs(v).max() <= bound * (1 + 1e-6) and np.abs(r).max() <= bound * (1 + 1e-6)
    assert all(p.requires_grad for p in bb.parameters())


def test_log_expectation_reward_matches_jax():
    from pita_tpu.train.dem_estimator import log_expectation_reward as jax_ler
    from pita_torch.train.dem_estimator import log_expectation_reward

    x = _lattice13(1, seed=5)[0]
    key = jax.random.PRNGKey(2)
    jt = JaxLJ13(temperature=1.5)
    ref = jax_ler(key, 0.01, jnp.asarray(x), jt.log_prob, 16)
    eps = t(jax.random.normal(key, (16, 39)))
    got = log_expectation_reward(0.01, t(x), LJ13(temperature=1.5).log_prob, eps)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("precondition_beta", [False, True])
def test_wrapper_gradients_and_denoisers_match_jax(precondition_beta):
    """ScoreWrapper.denoiser(return_score=True), EnergyWrapper.grad_x,
    denoiser and denoiser_and_energy against pita_tpu's (f32, 1e-5 relative
    to each output's largest entry), at two noise levels and β = 0.8."""
    mod, params = _jax_net(seed=4)
    net = _port_net(mod, params)
    x = _lattice13(6, seed=6)
    ht = np.array([0.05, 0.05, 0.5, 0.5, 2.0, 2.0], np.float32)
    js, je = JaxScore(mod, precondition_beta), JaxEnergy(mod, precondition_beta)
    ts, te = ScoreWrapper(net, precondition_beta), EnergyWrapper(net, precondition_beta)
    ref = (*js.denoiser(params, ht, jnp.asarray(x), 0.8, return_score=True),
           je.grad_x(params, ht, jnp.asarray(x), 0.8),
           je.denoiser(params, ht, jnp.asarray(x), 0.8),
           *je.denoiser_and_energy(params, ht, jnp.asarray(x), 0.8))
    got = (*ts.denoiser(t(ht), t(x), 0.8, return_score=True),
           te.grad_x(t(ht), t(x), 0.8), te.denoiser(t(ht), t(x), 0.8),
           *te.denoiser_and_energy(t(ht), t(x), 0.8))
    for g, r in zip(got, ref):
        r = np.array(r)
        assert np.abs(g.detach().numpy() - r).max() <= 1e-5 * np.abs(r).max()
    # create_graph: the energy denoiser differentiates again in the weights
    (gw,) = torch.autograd.grad(got[4].sum(), net.layers[0].w_e2)
    assert torch.isfinite(gw).all() and gw.abs().max() > 0
