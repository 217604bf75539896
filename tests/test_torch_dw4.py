"""The port's DW4 target and its 2-D EGNN against pita_tpu (CPU): the
energy and force, the EGNN forward in two dimensions and its exact trace by
the materialized edge operators, the kernel routes' refusal of 2-D, and
``train_cli experiment=dw4`` on a tiny MALA-generated set."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pita_tpu.configs import EXPERIMENTS as JAX_EXPERIMENTS
from pita_tpu.configs import compose as jax_compose
from pita_tpu.nets import EGNNBackbone as JaxEGNN
from pita_tpu.nets import ScoreWrapper as JaxScore
from pita_tpu.nets.egnn_fast import score_divergence_fast as jax_div_fast
from pita_tpu.targets import DoubleWell4 as JaxDW4
from pita_tpu.train.augment import random_rotations as jax_rotations
from pita_torch import train_cli
from pita_torch.configs import EXPERIMENTS, build_trainer, compose
from pita_torch.io.flax_params import load_egnn_params
from pita_torch.nets import EGNNBackbone, MLPBackbone, ScoreWrapper
from pita_torch.nets.egnn_fast import score_divergence_fast
from pita_torch.ops.divergence import exact_divergence
from pita_torch.targets import DoubleWell4
from pita_torch.train.augment import random_rotations, rotate_augment
from torch_threads import one_intra_op_thread  # noqa: F401


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _x(B=64, seed=0):
    return (np.random.default_rng(seed).normal(size=(B, 8)) * 2.0).astype(np.float32)


@pytest.mark.parametrize("T", [1.0, 3.0])
def test_energy_and_force_match_jax(T):
    x = _x()
    lp, f = DoubleWell4(temperature=T).log_prob_and_force(torch.as_tensor(x))
    jlp, jf = JaxDW4(temperature=T).log_prob_and_force(jnp.asarray(x))
    _close(lp, jlp, 1e-5)
    _close(f, jf, 1e-5)
    assert DoubleWell4().is_molecule and DoubleWell4().n_spatial_dim == 2


def _egnn(seed=0, n_layers=2):
    mod = JaxEGNN(n_particles=4, n_spatial_dim=2, hidden_nf=8, n_layers=n_layers)
    p = jax.jit(mod.init)(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, 8)), 1.0)
    net = EGNNBackbone(4, n_spatial_dim=2, hidden_nf=8, n_layers=n_layers, route="autograd")
    net.load_state_dict(load_egnn_params(serialization.to_bytes(p), n_layers))
    return mod, p, net


def test_2d_egnn_forward_and_exact_trace_match_jax():
    """The forward on the autograd route (the plain layer_step), and the
    exact score divergence by the materialized edge operators in 2-D against
    pita_tpu's score_divergence_fast and against D VJPs."""
    mod, p, net = _egnn(1)
    x = _x(32, 1)
    t = np.random.default_rng(2).uniform(-2, 1, size=32).astype(np.float32)
    ref = jax.jit(mod.apply)(p, jnp.asarray(t), jnp.asarray(x), 1.0)
    _close(net(torch.as_tensor(t), torch.as_tensor(x), 1.0), ref, 1e-5)

    ht = np.exp(np.random.default_rng(3).uniform(-3, 2, size=32)).astype(np.float32)
    sw = ScoreWrapper(net)
    got = score_divergence_fast(sw, torch.as_tensor(ht), torch.as_tensor(x), 1.0)
    jref = jax.jit(lambda h, xx: jax_div_fast(JaxScore(mod), p, h, xx, 1.0))(
        jnp.asarray(ht), jnp.asarray(x))
    _close(got, jref, 1e-4)
    vjps = exact_divergence(lambda hq, xq: sw.score(hq, xq, 1.0), torch.as_tensor(ht),
                            torch.as_tensor(x))
    _close(got, vjps.numpy(), 1e-4)


def test_2d_egnn_routes():
    """2-D runs on the autograd route, which its sampler uses; the kernel
    route and the K4 and K5 trace routes refuse it."""
    _, _, net = _egnn()
    assert net.sampler_route == "autograd"
    assert net.with_route("autograd").sampler_route == "autograd"
    assert EGNNBackbone(4, hidden_nf=8).sampler_route == "kernels"
    with pytest.raises(ValueError, match="3-D"):
        EGNNBackbone(4, n_spatial_dim=2, hidden_nf=8)
    sw, x = ScoreWrapper(net), torch.as_tensor(_x(4))
    for kw in (dict(tangent_kernel=True), dict(g_kernel=True)):
        with pytest.raises(ValueError, match="3-D"):
            score_divergence_fast(sw, torch.ones(4), x, 1.0, **kw)


def test_train_cli_dw4_short_runs_to_its_end(tmp_path, capsys):
    """python -m pita_torch.train_cli experiment=dw4 debug=short device=cpu
    with sets of a few hundred MALA samples, two rungs of one epoch: the
    transition fill takes the exact trace through the 2-D edge operators."""
    train_cli.main(["experiment=dw4", "debug=short", "device=cpu", f"out_dir={tmp_path}",
                    "trainer.temperatures=3.0,2.0", "trainer.num_epochs_per_temp=1,",
                    "trainer.max_epochs=2", "net.hidden_nf=8", "net.n_layers=2",
                    "energy.train_set_size=300", "energy.val_set_size=100",
                    "energy.test_set_size=100", "energy.n_warmup_steps=50",
                    "energy.n_block_steps=10", "trainer.buffer_capacity=1024"])
    assert "final metrics" in capsys.readouterr().out
    with open(tmp_path / "dw4" / "metrics.csv", newline="") as f:
        header = next(csv.reader(f))
    for col in ("train/loss", "val/energy_w2", "val/dist_w2", "test/T=3.00->2.00/dist_w2"):
        assert col in header, col
    buf = np.load(tmp_path / "dw4" / "buffer_samples_temperature_2.000.npz")
    assert buf["samples"].shape[1] == 8 and np.isfinite(buf["samples"]).all()


@pytest.mark.parametrize("name", ["gmm", "dw4"])
def test_presets_equal_pita_tpu_and_compose_the_sampler_overrides(name, tmp_path):
    """The gmm and dw4 presets are pita_tpu's; the sampler keys pita_tpu
    composes (pin_energy, hutchpp and its rank) compose here too."""
    assert EXPERIMENTS[name]() == JAX_EXPERIMENTS[name]()
    ov = {"integrator.pin_energy": True, "integrator.divergence_mode": "hutchpp",
          "integrator.hutchpp_rank": 4}
    got, ref = compose(name, overrides=ov), jax_compose(name, overrides=ov)
    for k in ("pin_energy", "divergence_mode", "hutchpp_rank", "hutchinson_probes"):
        assert getattr(got.integrator, k) == getattr(ref.integrator, k), k
    assert (got.energy, got.net, got.name) == (ref.energy, ref.net, ref.name)
    # another backbone behind the preset: net.kind=mlp starts the net group
    # afresh from the MLP's defaults
    tr = build_trainer(compose(name, debug="short", overrides={
        "net.kind": "mlp", "net.hidden_size": 16, "out_dir": str(tmp_path)}), device="cpu")
    assert isinstance(tr.score_net, MLPBackbone)


def test_rotations_in_2d_match_jax():
    """The trainer's augmentation at d = 2 (trainer.py:320,389): the same
    Gaussians give pita_tpu's rotations, proper and orthogonal."""
    key = jax.random.PRNGKey(3)
    A = np.asarray(jax.random.normal(key, (16, 2, 2)))
    R = random_rotations(torch.as_tensor(A))
    _close(R, jax_rotations(key, 16, 2), 1e-6)
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, rtol=1e-6)
    x = torch.as_tensor(_x(16))
    xr, _ = rotate_augment(x, None, 4, 2, torch.as_tensor(A))
    d = lambda v: torch.cdist(v.reshape(16, 4, 2), v.reshape(16, 4, 2))
    _close(d(xr), d(x).numpy(), 1e-5)
