"""The port's ground-truth MCMC against pita_tpu/baselines/mcmc.py on the
CPU: one MALA step with JAX's draws, the relaxation's Adam steps against
optax.adam on the energy gradient, and a short run of the dataset generator
through the data-set files of the LJ target."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pita_tpu.baselines.mcmc import _mala_step as jax_mala_step
from pita_tpu.targets import LJ13 as JaxLJ13
from pita_torch.baselines.mcmc import (
    _mala_step,
    generate_lj_dataset,
    jittered_lattice,
    mala_chain,
    relax_step,
)
from pita_torch.targets import LJ13
from pita_torch.train.optim import adam_init
from torch_threads import one_intra_op_thread  # noqa: F401


def t(a):
    return torch.as_tensor(np.array(a))


def _start(B=16, seed=0):
    x = jittered_lattice(13, B, torch.Generator().manual_seed(seed))
    return x.numpy()


@pytest.mark.parametrize("dt", [1e-4, 3e-3])
def test_mala_step_matches_jax_with_its_draws(dt):
    x = _start()
    jt, tt = JaxLJ13(temperature=1.5), LJ13(temperature=1.5)
    lp, f = jt.log_prob_and_force(jnp.asarray(x))
    key = jax.random.PRNGKey(4)
    ref = jax_mala_step(jt.log_prob_and_force, jnp.asarray(x), lp, f, jnp.float32(dt), key)
    k_noise, k_acc = jax.random.split(key)
    got = _mala_step(tt.log_prob_and_force, t(x), t(lp), t(f),
                     torch.tensor(dt, dtype=torch.float32),
                     t(jax.random.normal(k_noise, x.shape)),
                     t(jax.random.uniform(k_acc, (x.shape[0],))))
    # the same accept/reject decisions, then f32 values of one LJ evaluation
    np.testing.assert_allclose(got[0].numpy(), np.array(ref[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.array(ref[1]), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), np.array(ref[2]), rtol=1e-4, atol=1e-2)
    assert float(got[3]) == float(ref[3])
    assert 0.0 < float(got[3]) <= 1.0


def test_relax_steps_match_optax_adam():
    """Three steps of the relaxation (Adam 3e-3 on the raw energy): the port
    takes ∇E as −T·force, JAX differentiates the energy; within 1e-2 lr."""
    x = _start(seed=1)
    jt, tt = JaxLJ13(temperature=2.0), LJ13(temperature=2.0)
    opt = optax.adam(3e-3)
    jx = jnp.asarray(x)
    state = opt.init(jx)
    tx, tstate = t(x), adam_init([t(x)])
    for _ in range(3):
        g = jax.grad(lambda xx: jnp.sum(jt.energy(xx)))(jx)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        upd, state = opt.update(g, state, jx)
        jx = optax.apply_updates(jx, upd)
        tx, tstate = relax_step(tt, tx, tstate)
    np.testing.assert_allclose(tx.numpy(), np.array(jx), rtol=0, atol=1e-2 * 3e-3)
    assert tstate.count == 3


def test_mala_chain_adapts_the_step_size():
    x = t(_start(B=32, seed=2))
    tt = LJ13(temperature=1.0)
    gen = torch.Generator().manual_seed(0)
    x1, accs, dt = mala_chain(tt.log_prob_and_force, x, 20, dt=1e-1, generator=gen)
    assert accs.shape == (20,) and torch.isfinite(x1).all()
    assert float(dt) < 1e-1  # a step far too large shrinks


def test_generate_lj_dataset_short_run_and_files(tmp_path):
    """A few steps of each stage (not the 12,000 warmup steps of a real
    set); the LJ target loads the file it names, or generates and saves it."""
    tt = LJ13(temperature=1.5)
    data = generate_lj_dataset(tt, num_samples=40, seed=3, warmup=6, thin=1, relax_steps=20,
                               device="cpu")
    assert data.shape == (40, 39) and np.isfinite(data).all()
    assert (np.abs(tt.log_prob(t(data)).numpy()) < 1e3).all()
    again = generate_lj_dataset(tt, num_samples=40, seed=3, warmup=6, thin=1, relax_steps=20,
                                device="cpu")
    np.testing.assert_array_equal(data, again)  # seeded
    # the data-set file convention of pita_tpu/targets/lj.py:141-174
    path = tmp_path / "LJ13_temp_1.5_val.npy"
    np.save(path, data[:25])
    target = LJ13(temperature=1.5, data_dir=str(tmp_path))
    x = target.sample_val_set(10, torch.Generator().manual_seed(0))
    assert x.shape == (10, 39)
    assert all(any(np.array_equal(r, d) for d in data[:25]) for r in x.numpy())
    assert target.at_temperature(1.2)._val_set is None
