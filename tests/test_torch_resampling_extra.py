"""The port's QMC and birth–death resampling against pita_tpu's on the same
draws (CPU): the offset, the replacement ids and the Exp(1) thresholds are
drawn from the JAX function's own key, as it draws them, and passed to the
port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.ops.resampling import birth_death_resample as jax_birth_death
from pita_tpu.ops.resampling import qmc_resample as jax_qmc
from pita_torch.ops.resampling import birth_death_resample, qmc_resample


# each reference jitted with its draws: one compile a shape, where op-by-op
# dispatch compiles every op
@jax.jit
def _qmc_reference(key, lw):
    """pita_tpu's ancestors and the offset it draws from ``key``."""
    return jax_qmc(key, lw), jax.random.uniform(key, ())


@jax.jit
def _birth_death_reference(key, birth, death, thresh):
    """pita_tpu's outputs and the draws of pita_tpu/ops/resampling.py:84-91
    from ``key``: the replacement ids and the fresh thresholds."""
    k_repl, k_thresh = jax.random.split(key)
    probs = birth / jnp.maximum(jnp.sum(birth), 1e-12)
    replace = jax.random.categorical(k_repl, jnp.log(jnp.clip(probs, 1e-12, 1.0)),
                                     shape=birth.shape)
    fresh = jax.random.exponential(k_thresh, birth.shape)
    return jax_birth_death(key, birth, death, thresh), replace, fresh


@pytest.mark.parametrize("B,seed,scale", [(64, 0, 3.0), (257, 1, 1.0), (512, 2, 8.0),
                                          (1000, 3, 0.1)])
def test_qmc_resample_same_ancestors(B, seed, scale):
    """Equal ancestors, but where a point lies within 1e-6 of a CDF value:
    there XLA's f32 cumsum and torch's, summed in another order, may put it
    on either side (one of the 1,000 points at B = 1000), and the two
    ancestors must be neighbours."""
    rng = np.random.default_rng(seed)
    lw = (rng.normal(size=B) * scale).astype(np.float32)
    ref, u = (np.array(a) for a in _qmc_reference(jax.random.PRNGKey(seed), lw))
    got = qmc_resample(torch.as_tensor(lw), torch.as_tensor(u)).numpy()
    # the shifted van der Corput points and the clipped CDF, written out here
    bits = np.arange(B, dtype=np.uint64)
    rev = np.zeros(B, dtype=np.uint64)
    for k in range(32):
        rev |= ((bits >> np.uint64(k)) & np.uint64(1)) << np.uint64(31 - k)
    pts = np.sort((rev.astype(np.float32) / np.float32(2 ** 32) + u) % np.float32(1))
    w = np.exp(lw.astype(np.float64) - lw.max())
    cdf = np.cumsum(np.clip(w / w.sum(), 1e-6, 1.0))
    off = np.nonzero(got != ref)[0]
    assert np.all(np.abs(got[off] - ref[off]) == 1)
    assert np.all(np.abs(pts[off] - cdf[np.minimum(got[off], ref[off])]) <= 1e-6)
    assert off.size <= B // 500


@pytest.mark.parametrize("B,seed", [(64, 0), (300, 1), (1024, 2)])
def test_birth_death_resample_same_draws(B, seed):
    rng = np.random.default_rng(seed)
    birth = rng.exponential(size=B).astype(np.float32)
    birth[rng.integers(B)] *= 50.0
    thresh = rng.exponential(size=B).astype(np.float32)
    death = (thresh * rng.uniform(0.0, 2.0, size=B)).astype(np.float32)
    death[:3] = thresh[:3]  # a clock exactly at its threshold dies
    ref, replace, fresh = _birth_death_reference(jax.random.PRNGKey(seed), birth, death, thresh)
    got = birth_death_resample(*(torch.as_tensor(a) for a in (birth, death, thresh)),
                               torch.as_tensor(np.array(replace)),
                               torch.as_tensor(np.array(fresh)))
    names = ("ids", "accum_birth", "accum_death", "thresh_times", "n_killed")
    for name, a, b in zip(names, got, ref):
        np.testing.assert_array_equal(a.numpy(), np.array(b), err_msg=name)
    assert 3 <= int(got[4]) < B
