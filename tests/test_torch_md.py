"""The port's Langevin MD against pita_tpu's on the CPU: 200 BAOAB steps from
pita_tpu's own normal draws, the data set's file, and the CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pita_tpu.baselines import md as jmd
from pita_tpu.targets.alp import ALPEnergy as JaxALP
from pita_torch import generate_md_cli
from pita_torch.baselines import md as tmd
from pita_torch.targets.alp import ALPEnergy
from torch_threads import one_intra_op_thread  # noqa: F401


def _jax_draws(key, shape, cfg):
    """The normals langevin_md draws (md.py:58-76), in the order the port
    asks for them: the initial velocities, then one draw per step."""
    k_init, k_scan = jax.random.split(key)
    out = [jax.random.normal(k_init, shape)]
    for k in jax.random.split(k_scan, cfg.n_steps // cfg.report_interval):
        out += [jax.random.normal(ks, shape) for ks in jax.random.split(k, cfg.report_interval)]
    return [torch.as_tensor(np.array(a)) for a in out]


def test_baoab_steps_follow_pita_tpu_draws():
    """200 steps of 1 fs at 300 K, 4 replicas, a frame every 20 steps: every
    frame within 1e-5 nm; the frame energies within 1e-3 kcal/mol (float32
    sums of terms of hundreds of kcal/mol, on frames 1e-6 nm apart)."""
    cfg = dict(temperature=300.0, n_steps=200, report_interval=20)
    jt, tt = JaxALP("aldp"), ALPEnergy("aldp")
    rng = np.random.default_rng(0)
    x0 = (jt.initial_structure()[None] + 1e-3 * rng.standard_normal((4, 66))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda k, x: jmd.langevin_md(k, jt, x, jmd.MDConfig(**cfg)))(key, jnp.asarray(x0))
    draws = iter(_jax_draws(key, x0.shape, jmd.MDConfig(**cfg)))
    got = tmd.langevin_md(tt, torch.as_tensor(x0), tmd.MDConfig(**cfg),
                          normal=lambda shape: next(draws))
    assert next(draws, None) is None  # every draw used
    assert got.positions.shape == ref.positions.shape == (10, 4, 66)
    assert np.abs(got.positions.numpy() - np.asarray(ref.positions)).max() <= 1e-5
    assert np.abs(got.potential_energies.numpy()
                  - np.asarray(ref.potential_energies)).max() <= 1e-3
    assert np.abs(got.velocities.numpy() - np.asarray(ref.velocities)).max() <= 1e-2


def test_generate_md_dataset_writes_pita_tpu_keys_and_shapes(tmp_path):
    kw = dict(n_steps=200, n_replicas=3, seed=1, checkpoint_every=100)
    a = tmd.generate_md_dataset(ALPEnergy("aldp"), str(tmp_path / "t.npz"), device="cpu", **kw)
    b = jmd.generate_md_dataset(JaxALP("aldp"), str(tmp_path / "j.npz"), **kw)
    za, zb = np.load(a), np.load(b)
    assert sorted(za.keys()) == sorted(zb.keys()) == ["energies", "positions", "temperature"]
    for k in za.keys():
        assert za[k].shape == zb[k].shape and za[k].dtype == zb[k].dtype, k
    assert za["positions"].shape == (2, 3, 66) and float(za["temperature"]) == 300.0
    assert np.isfinite(za["positions"]).all() and np.isfinite(za["energies"]).all()
    # the energies are the force field's at the saved frames
    e = ALPEnergy("aldp").energy_kcal(torch.as_tensor(za["positions"])).numpy()
    np.testing.assert_allclose(za["energies"], e, rtol=0, atol=1e-4)


def test_generate_md_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "al3.npz"
    path = generate_md_cli.main(["peptide=al3", "temperature=600", "n_steps=100",
                                 "n_replicas=2", "seed=4", f"out={out}", "device=cpu"])
    z = np.load(path)
    assert z["positions"].shape == (1, 2, 96) and float(z["temperature"]) == 600.0
    assert np.isfinite(z["energies"]).all()
