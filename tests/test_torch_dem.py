"""The port's DEM pretraining against pita_tpu on the CPU: the iDEM score
target ∇ₓR_t (closed form from the target's force) against jax.grad through
pita_tpu's LJ13, Richardson extrapolation, the pretraining loss in both
modes, two DEM steps of the trainer from one bridged state with JAX's draws,
and fit's DEM phase. Random numbers are drawn with jax.random from the keys
JAX uses and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.configs import build_trainer as jax_build_trainer
from pita_tpu.configs import compose as jax_compose
from pita_tpu.io.checkpoint import _state_pytree
from pita_tpu.nets import ScoreWrapper as JaxScore
from pita_tpu.targets import LJ13 as JaxLJ13
from pita_tpu.train import buffer as jbuf
from pita_tpu.train.dem import DEMConfig as JaxDEMConfig
from pita_tpu.train.dem import pretrain_loss as jax_pretrain_loss
from pita_tpu.train.dem_estimator import estimate_grad_Rt as jax_grad_Rt
from pita_tpu.train.dem_estimator import wrap_for_richardsons as jax_richardson
from pita_torch.configs import build_trainer, compose
from pita_torch.io.flax_params import egnn_params_from_tree, trainer_state_from_tree
from pita_torch.nets import ScoreWrapper
from pita_torch.targets import LJ13
from pita_torch.train.dem import DEMConfig, DEMDraws, pretrain_loss
from pita_torch.train.dem_estimator import estimate_grad_Rt, wrap_for_richardsons
from pita_torch.train.trainer import DEMStepDraws
from tests.test_torch_train import _jax_net, _lattice13, _port_net, t
from tests.test_torch_trainer import _lj13_data_dir
from torch_threads import one_intra_op_thread  # noqa: F401

LR = 1e-3
HT = np.array([1e-3, 3e-3, 1e-2, 2e-2, 5e-3, 4e-2], np.float32)


def _probes(key, B, K, D=39):
    """The probes of pita_tpu's estimate_grad_Rt: one key per sample
    (dem_estimator.py:41-52, 17-20)."""
    return t(jnp.stack([jax.random.normal(k, (K, D)) for k in jax.random.split(key, B)]))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("clamped", [False, True])
def test_estimate_grad_Rt_matches_jax_grad(clamped):
    """Σ softmax(lr)·force against jax.grad of R_t through pita_tpu's LJ13,
    with and without the min_log_reward clamp (here the median of the
    probes' log p, so half of them are clamped; halfway between two of them,
    since jnp.maximum splits the gradient at a tie): within 1e-4 of the
    largest."""
    B, K = len(HT), 64
    x = _lattice13(B, seed=4)
    jt, tt = JaxLJ13(temperature=1.5), LJ13(temperature=1.5)
    key = jax.random.PRNGKey(2)
    eps = _probes(key, B, K)
    min_lr = None
    if clamped:
        lp = tt.log_prob(t(x)[:, None] + eps * torch.sqrt(t(HT))[:, None, None])
        v = lp.flatten().sort().values
        min_lr = float(v[v.numel() // 2 - 1] + v[v.numel() // 2]) / 2
    ref = jax_grad_Rt(key, jnp.asarray(HT), jnp.asarray(x), jt.log_prob, K,
                      min_log_reward=min_lr)
    got = estimate_grad_Rt(t(HT), t(x), tt.log_prob_and_force, eps, min_log_reward=min_lr)
    assert got.shape == (B, 39)
    assert _rel(got.numpy(), ref) <= 1e-4


def test_richardson_matches_jax():
    B, K = len(HT), 64
    x = _lattice13(B, seed=5)
    jt, tt = JaxLJ13(temperature=2.0), LJ13(temperature=2.0)
    key = jax.random.PRNGKey(9)
    ref = jax_richardson(jax_grad_Rt)(key, jnp.asarray(HT), jnp.asarray(x), jt.log_prob, K)
    k1, k2 = jax.random.split(key)
    got = wrap_for_richardsons(estimate_grad_Rt)(t(HT), t(x), tt.log_prob_and_force,
                                                 _probes(k1, B, K), _probes(k2, B, K // 2))
    assert _rel(got.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("mc", [False, True], ids=["force_target", "idem_target"])
def test_pretrain_loss_matches_jax(mc):
    """Loss and score-weight gradients from one bridged net, JAX's draws:
    the loss within rel 1e-4, each gradient tensor within 1e-4 of its largest."""
    B, K = 12, 32
    mod, ps = _jax_net(seed=3)
    x0 = _lattice13(B, seed=6)
    jt, tt = JaxLJ13(temperature=1.5), LJ13(temperature=1.5)
    _, f0 = jt.log_prob_and_force(jnp.asarray(x0))
    key = jax.random.PRNGKey(13)
    kw = dict(num_training_epochs=1, num_mc_samples=K, use_mc_target=mc)
    jdem, tdem = JaxDEMConfig(**kw), DEMConfig(**kw)

    def jloss(p):
        return jax_pretrain_loss(JaxScore(mod), p, jdem, key, jnp.asarray(x0), f0, 0.8,
                                 target=jt, n_particles=13, n_spatial_dim=3, mean_free=True)

    ref, ref_g = jax.jit(jax.value_and_grad(jloss))(ps)
    k_sigma, k_noise, k_mc = jax.random.split(key, 3)
    draws = DEMDraws(t(jax.random.normal(k_sigma, (B,))), t(jax.random.normal(k_noise, (B, 39))),
                     _probes(k_mc, B, K) if mc else None)
    net = _port_net(mod, ps)
    loss = pretrain_loss(ScoreWrapper(net), tdem, t(x0), t(f0), 0.8, target=tt, n_particles=13,
                         n_spatial_dim=3, mean_free=True, draws=draws)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-4)
    grads = dict(zip([n for n, _ in net.named_parameters()],
                     torch.autograd.grad(loss, list(net.parameters()), allow_unused=True)))
    want = egnn_params_from_tree(jax.tree.map(np.asarray, ref_g), 2)
    for name, g in grads.items():
        r = want[name].numpy()
        g = np.zeros_like(r) if g is None else g.numpy()  # a weight the score does not use
        assert np.abs(g - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-30) + 1e-12, name


# ------------------------------------------------------------- the trainer

NARROW = {"trainer.temperatures": (4.0, 3.0), "trainer.num_epochs_per_temp": (2,),
          "trainer.buffer_capacity": 256, "net.hidden_nf": 8, "net.n_layers": 2}
DEM_KW = dict(num_training_epochs=2, training_batch_size=16, num_mc_samples=8)


def _with_moments(opt_state, seed):
    """The optax state with random Adam moments and count 3, so that the
    energy net's zero gradients still move its weights."""
    rng = np.random.default_rng(seed)
    if hasattr(opt_state, "mu"):
        mu = lambda a: jnp.asarray((rng.normal(size=a.shape) * 1e-3).astype(np.float32))
        nu = lambda a: jnp.asarray((np.abs(rng.normal(size=a.shape)) * 1e-6).astype(np.float32))
        return opt_state._replace(count=jnp.asarray(3, opt_state.count.dtype),
                                  mu=jax.tree.map(mu, opt_state.mu),
                                  nu=jax.tree.map(nu, opt_state.nu))
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        return tuple(_with_moments(s, seed) for s in opt_state)
    return opt_state


def _dem_trainers(tmp_path, mc: bool, n_steps: int = 2):
    """pita_tpu's trainer with a DEM phase, buffer 0 holding LJ13 lattices
    and random Adam moments, and the port's trainer loaded with its state."""
    ov = dict(NARROW, **{"trainer.n_train_batches_per_epoch": n_steps})
    jtr = jax_build_trainer(jax_compose("lj13", debug="short",
                                        overrides=dict(ov, out_dir=str(tmp_path / "j"))))
    # the DEM phase as tests/test_dem.py sets it on a built trainer
    jtr.dem_cfg = JaxDEMConfig(use_mc_target=mc, **DEM_KW)
    jtr.cfg = jtr.cfg.replace(dem_num_training_epochs=2)
    x = jnp.asarray(_lattice13(48, seed=8))
    e, f = jtr.targets[0].log_prob_and_force(x)
    jtr.buffers = jbuf.buffer_set(jtr.buffers, 0, jbuf.buffer_add(
        jbuf.buffer_view(jtr.buffers, 0), x, e, f))
    jtr.opt_state = _with_moments(jtr.opt_state, seed=1)
    ttr = build_trainer(compose("lj13", debug="short",
                                overrides=dict(ov, out_dir=str(tmp_path / "t"))),
                        dem_cfg=DEMConfig(use_mc_target=mc, **DEM_KW), device="cpu")
    ttr.load_state_dict(trainer_state_from_tree(jax.tree.map(np.asarray, _state_pytree(jtr)),
                                                n_layers=2))
    return jtr, ttr


def _jax_dem_draws(jtr, mc: bool):
    """The draws of pita_tpu's dem_train_one_epoch (trainer.py:516-565,
    dem.py:59-77) in its key schedule."""
    B, K, D = DEM_KW["training_batch_size"], DEM_KW["num_mc_samples"], jtr.dim
    _, k = jax.random.split(jtr.key)
    out = []
    for key_t in jax.random.split(k, jtr.cfg.n_train_batches_per_epoch):
        k_sample, k_aug, k_loss = jax.random.split(key_t, 3)
        idx = jbuf.buffer_sample(jbuf.buffer_view(jtr.buffers, 0), k_sample, B,
                                 replacement=True)[3]
        k_sigma, k_noise, k_mc = jax.random.split(k_loss, 3)
        loss = DEMDraws(t(jax.random.normal(k_sigma, (B,))), t(jax.random.normal(k_noise, (B, D))),
                        _probes(k_mc, B, K, D) if mc else None)
        out.append(DEMStepDraws(t(idx), t(jax.random.normal(k_aug, (B, 3, 3))), loss))
    return out


@pytest.mark.parametrize("mc", [False, True], ids=["force_target", "idem_target"])
def test_two_dem_steps_match_jax_trainer(tmp_path, mc):
    """Params, EMA and Adam state of both nets after two DEM steps from one
    state with the same draws, at LJ13, hidden 8, 2 layers. The energy net
    gets zero gradients through the clipping and Adam, and its weights move
    by what its moments hold, as optax's do. Weights within 1e-3 lr, the
    moments within 1e-3 of each tensor's largest entry."""
    jtr, ttr = _dem_trainers(tmp_path, mc)
    energy_before = {k: v.clone() for k, v in ttr.energy_net.state_dict().items()}
    draws = _jax_dem_draws(jtr, mc)
    jtr.dem_train_one_epoch()
    for d in draws:
        loss, _ = ttr.dem_train_step(draws=d)
        assert torch.isfinite(loss)
    got = ttr.state_dict()
    want = trainer_state_from_tree(jax.tree.map(np.asarray, _state_pytree(jtr)), n_layers=2)
    for which in ("params_score", "params_energy"):
        for k, v in got[which].items():
            np.testing.assert_allclose(v.numpy(), want[which][k].numpy(), rtol=0,
                                       atol=1e-3 * LR, err_msg=f"{which}.{k}")
    assert any(not torch.equal(v, energy_before[k]) for k, v in got["params_energy"].items())
    for which in ("ema_score", "ema_energy"):
        assert got[which]["num_updates"] == want[which]["num_updates"] == 2
        for k, v in got[which]["params"].items():
            np.testing.assert_allclose(v.numpy(), want[which]["params"][k].numpy(), rtol=0,
                                       atol=1e-3 * LR, err_msg=f"{which}.{k}")
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 5
    for m in ("mu", "nu"):
        for k, v in got["opt_state"][m].items():
            r = want["opt_state"][m][k].numpy()
            assert np.abs(v.numpy() - r).max() <= 1e-3 * max(np.abs(r).max(), 1e-30), (m, k)


# the metrics pita_tpu's eval_epoch_end_dem logs with a val set (trainer.py:603-617),
# and the cropped distances energy_distances adds when the threshold masks a sample
DEM_VAL_KEYS = {f"val/dem/{k}" for k in ("energy_mean", "energy_w2", "energy_w1",
                                         "energy_mean_gap", "dist_w2")}
CROPPED = {f"val/dem/{k}_cropped" for k in ("energy_w2", "energy_w1", "energy_mean_gap")}


def test_fit_runs_the_dem_phase_and_refills_buffer_0(tmp_path):
    """fit with 2 DEM epochs: buffer 0 from the prior, a plain-SDE refill of
    buffer 0 after the second epoch, the ladder offset by the DEM epochs
    (tests/test_dem.py:37-59 for pita_tpu)."""
    data = tmp_path / "data"
    _lj13_data_dir(data, temps=(4.0,))
    dem = DEMConfig(num_training_epochs=2, training_batch_size=32,
                    num_samples_to_generate_per_epoch=64, num_integration_steps=8,
                    check_val_every_n_epochs=1)
    tr = build_trainer(compose("lj13", debug="short", overrides=dict(
        NARROW, out_dir=str(tmp_path), **{"energy.data_dir": str(data),
                                           "trainer.num_init_samples": 64})),
        dem_cfg=dem, device="cpu")
    assert tr.cfg.dem_num_training_epochs == 2
    assert tr.update_temp_epoch.tolist() == [4]
    tr.populate_initial_buffer()
    x0 = tr.buffers.x[0, :64]
    assert float(x0.reshape(64, 13, 3).mean(1).abs().max()) < 1e-4  # the mean-free prior
    size_before = int(tr.buffers.size[0])
    history = tr.fit(max_epochs=2)
    assert int(tr.buffers.size[0]) == size_before + 64
    assert any("pretrain" in str(k) or "dem" in str(k) for m in history for k in m)
    dem_metrics = [m for m in history if any(k.startswith("val/dem/") for k in m)]
    assert len(dem_metrics) == 1 and dem_metrics[0]["epoch"] == 1
    assert DEM_VAL_KEYS <= set(dem_metrics[0]) - {"epoch"} <= DEM_VAL_KEYS | CROPPED
    assert all(np.isfinite(v) for v in dem_metrics[0].values())
    with open(tmp_path / "lj13" / "metrics.csv") as f:
        assert "train/pretrain_target_score_loss" in f.readline()
