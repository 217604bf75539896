"""The port's MLP backbone and the gmm preset against pita_tpu (CPU): the
forward from carried-across weights, three trainer steps of the gmm preset
from one state with pita_tpu's draws, and ``train_cli`` with no
experiment, which trains gmm as pita_tpu's does."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.configs import build_trainer as jax_build_trainer
from pita_tpu.configs import compose as jax_compose
from pita_tpu.io.checkpoint import _state_pytree
from pita_tpu.nets import MLPBackbone as JaxMLP
from pita_tpu.train import buffer as jbuf
from pita_torch import train_cli
from pita_torch.configs import build_trainer, compose
from pita_torch.io.flax_params import mlp_params_from_tree, trainer_state_from_tree
from pita_torch.nets import MLPBackbone
from pita_torch.nets.mlp import sinusoidal_embedding
from pita_torch.train.losses import LossDraws
from pita_torch.train.trainer import StepDraws
from torch_threads import one_intra_op_thread  # noqa: F401


LR = 1e-3
NARROW = {"net.hidden_size": 16, "net.emb_size": 8, "net.hidden_layers": 1,
          "trainer.training_batch_size": 64, "trainer.buffer_capacity": 512}


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("cond_t", [True, False])
def test_forward_matches_jax_from_carried_weights(cond_t):
    """pita_tpu's init tree (its last Dense zero), then the same tree with
    every weight perturbed so that the output is not zero."""
    mod = JaxMLP(out_dim=4, hidden_size=16, hidden_layers=2, emb_size=8,
                 condition_on_temperature=cond_t)
    p = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.zeros(2), jnp.zeros((2, 4)), jnp.ones(2))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 4)).astype(np.float32)
    tt = rng.normal(size=32).astype(np.float32)
    beta = rng.uniform(0.3, 1.0, size=32).astype(np.float32)
    noisy = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.2 * rng.normal(size=a.shape),
                                               jnp.float32), p)
    for tree in (p, noisy):
        net = MLPBackbone(4, 4, hidden_size=16, hidden_layers=2, emb_size=8,
                          condition_on_temperature=cond_t)
        net.load_state_dict(mlp_params_from_tree(jax.tree.map(np.asarray, tree)))
        ref = np.asarray(jax.jit(mod.apply)(tree, jnp.asarray(tt), jnp.asarray(x),
                                            jnp.asarray(beta)))
        got = net(torch.as_tensor(tt), torch.as_tensor(x), torch.as_tensor(beta))
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
    assert np.abs(ref).max() > 0.1
    # the embedding: sin before cos, frequencies exp(k·−ln 1e4/(half−1))
    emb = sinusoidal_embedding(torch.tensor([0.5]), 8)[0]
    f = np.exp(np.arange(4) * -(np.log(1e4) / 3))
    np.testing.assert_allclose(emb.numpy(), np.r_[np.sin(0.5 * f), np.cos(0.5 * f)], rtol=1e-6)


def test_reset_parameters_draws_flax_s_distributions():
    net = MLPBackbone(2, 2, hidden_size=256, hidden_layers=1, emb_size=64)
    net.reset_parameters(torch.Generator().manual_seed(0))
    w = net.inp.weight
    np.testing.assert_allclose(float(w.detach().std()), (1.0 / w.shape[1]) ** 0.5, rtol=0.05)
    assert float(net.out.weight.abs().max()) == 0.0 and float(net.inp.bias.abs().max()) == 0.0
    assert net.with_route("kernels").route == net.sampler_route == "autograd"


def test_three_gmm_train_steps_match_jax_trainer(tmp_path):
    """The gmm preset (MLP, no molecule: no augmentation) cut to batch 64
    and a 16-wide net: weights and EMA after three steps within 1e-3 lr and
    Adam's moments within 1e-3 of each tensor's largest, as
    tests/test_torch_trainer.py holds the LJ13 steps (the largest weight gap
    seen here is 1.5e-4 lr: a few f32 ulps of weights near 0.5)."""
    ov = dict(NARROW, **{"trainer.n_train_batches_per_epoch": 3,
                         "energy.train_set_size": 1000})
    jtr = jax_build_trainer(jax_compose("gmm", debug="short",
                                        overrides=dict(ov, out_dir=str(tmp_path / "j"))))
    jtr.populate_initial_buffer()
    ttr = build_trainer(compose("gmm", debug="short",
                                overrides=dict(ov, out_dir=str(tmp_path / "t"))), device="cpu")
    state = jax.tree.map(np.asarray, _state_pytree(jtr))
    ttr.load_state_dict(trainer_state_from_tree(state, n_layers=0))

    cfg = jtr.cfg
    _, k_epoch, k_temps = jax.random.split(jtr.key, 3)
    temp_idxs = jax.random.randint(k_temps, (3,), 0, jtr.active_temp_index() + 1)
    draws = []
    for key_t, ti in zip(jax.random.split(k_epoch, 3), temp_idxs):
        k_sample, _, _, k_loss = jax.random.split(key_t, 4)
        idx = jbuf.buffer_sample(jbuf.buffer_view(jtr.buffers, int(ti)), k_sample,
                                 cfg.training_batch_size, replacement=True)[3]
        k_sigma, k_noise, _ = jax.random.split(k_loss, 3)
        loss = LossDraws(t(jax.random.normal(k_sigma, (64,))),
                         t(jax.random.normal(k_noise, (64, 2))))
        draws.append((int(ti), StepDraws(t(idx), None, None, loss)))
    jtr.train_one_epoch()
    for ti, d in draws:
        ttr.train_step(ti, draws=d)
    want = trainer_state_from_tree(jax.tree.map(np.asarray, _state_pytree(jtr)), n_layers=0)
    got = ttr.state_dict()
    for which in ("params_score", "params_energy"):
        for k, v in got[which].items():
            np.testing.assert_allclose(v.numpy(), want[which][k].numpy(), rtol=0,
                                       atol=1e-3 * LR, err_msg=f"{which}.{k}")
    for which in ("ema_score", "ema_energy"):
        assert got[which]["num_updates"] == want[which]["num_updates"] == 3
        for k, v in got[which]["params"].items():
            np.testing.assert_allclose(v.numpy(), want[which]["params"][k].numpy(), rtol=0,
                                       atol=1e-3 * LR, err_msg=f"{which}.{k}")
    for m in ("mu", "nu"):
        for k, v in got["opt_state"][m].items():
            r = want["opt_state"][m][k].numpy()
            assert np.abs(v.numpy() - r).max() <= 1e-3 * max(np.abs(r).max(), 1e-30), (m, k)


def test_train_cli_with_no_experiment_trains_gmm(tmp_path, capsys):
    """python -m pita_torch.train_cli debug=short device=cpu: the gmm
    preset, cut to two rungs of one epoch and a narrow MLP, to its test,
    with the evaluation figures."""
    train_cli.main(["debug=short", "device=cpu", f"out_dir={tmp_path}",
                    "trainer.temperatures=3.0,2.0", "trainer.num_epochs_per_temp=1,",
                    "trainer.max_epochs=2", "net.hidden_size=16", "net.emb_size=8",
                    "energy.train_set_size=2000", "energy.val_set_size=500",
                    "energy.test_set_size=500", "trainer.buffer_capacity=1024",
                    "trainer.check_val_every_n_epoch=2", "trainer.make_plots=true"])
    out = capsys.readouterr().out
    assert "experiment=gmm" in out and "final metrics" in out
    with open(tmp_path / "gmm" / "metrics.csv", newline="") as f:
        header = next(csv.reader(f))
    for col in ("train/loss", "val/energy_w2", "val/buffer_filled_temp",
                "test/T=3.00->2.00/energy_w2"):
        assert col in header, col
    assert (tmp_path / "gmm" / "buffer_samples_temperature_2.000.npz").exists()
    # the GMM branch of the evaluation figures (trainer.py:1084-1085)
    assert (tmp_path / "gmm" / "plots" / "epoch_1" / "gmm_samples.png").exists()
