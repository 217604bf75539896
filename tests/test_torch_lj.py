"""pita_torch LJ target and kernel K1's plain version against pita_tpu (CPU).
K1 itself is held against its plain version in test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pita_tpu.ops.pallas.lj import lj_log_prob_and_force as pallas_lj
from pita_tpu.targets import LennardJones as JaxLJ
from pita_torch.ops import lj as ljop
from pita_torch.targets import LennardJones
from torch_threads import one_intra_op_thread  # noqa: F401


def _configs(n, B, scale, seed=0):
    """Jittered cubic lattice (no overlaps) plus noise: some pairs closer
    than the spline's range_min at larger noise."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    base = grid[:n].astype(np.float32) * 1.1
    x = base[None] + scale * rng.normal(size=(B, n, 3)).astype(np.float32)
    return x.reshape(B, n * 3).astype(np.float32)


CASES = [
    (13, dict(smooth=False)),
    (13, dict(smooth=True, temperature=2.0)),
    (55, dict(smooth=True, temperature=2.0 / 1.2)),
    (55, dict(smooth=False, oscillator=False, energy_factor=0.5)),
]


@pytest.mark.parametrize("n,kw", CASES)
def test_energy_logprob_force_match_jax(n, kw):
    x = _configs(n, 6, 0.25)
    j, t = JaxLJ(n, **kw), LennardJones(n, **kw)
    xt = torch.as_tensor(x)
    # the same f32 pair sums in the same order; pow and sqrt from two libraries
    np.testing.assert_allclose(t.energy(xt).numpy(), np.asarray(j.energy(jnp.asarray(x))),
                               rtol=1e-5)
    lp_j, f_j = j.log_prob_and_force(jnp.asarray(x))
    lp_t, f_t = t.log_prob_and_force(xt)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5)
    scale = np.abs(np.asarray(f_j)).max()
    # autograd in two frameworks: reassociated sums of up to 54 pair forces
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-4, atol=1e-5 * scale)


def test_spline_branch_is_exercised_and_matches():
    x = _configs(13, 8, 0.35, seed=4)
    xr = x.reshape(8, 13, 3)
    d = np.linalg.norm(xr[:, :, None] - xr[:, None], axis=-1)
    assert (d[d > 0] < 0.65).any()
    j, t = JaxLJ(13, smooth=True), LennardJones(13, smooth=True)
    lp_j, f_j = j.log_prob_and_force(jnp.asarray(x))
    lp_t, f_t = t.log_prob_and_force(torch.as_tensor(x))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(f_j)).max())


@pytest.mark.parametrize("n,smooth", [(13, True), (55, False)])
def test_plain_matches_pallas_interpret(n, smooth):
    """The port's plain K1 against the Pallas kernel run in interpret mode."""
    x = _configs(n, 4, 0.3, seed=2)
    t = LennardJones(n, smooth=smooth, temperature=1.5)
    kw = dict(eps=t.eps, rm=t.rm, oscillator_scale=t._osc, energy_factor=t.energy_factor,
              temperature=t.temperature, spline=t.spline)
    lp_p, f_p = pallas_lj(jnp.asarray(x), n, block_b=4, interpret=True, **kw)
    lp_t, f_t = ljop.lj_log_prob_and_force(torch.as_tensor(x), n, **kw)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_p), rtol=1e-5)
    # closed-form force (Pallas) vs autograd (plain): different formulas
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_p), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(f_p)).max())


def test_wrapper_checks_its_inputs():
    with pytest.raises(ValueError):
        ljop.lj_log_prob_and_force(torch.zeros(2, 38), 13)
    with pytest.raises(TypeError):
        ljop.lj_log_prob_and_force(torch.zeros(2, 39, dtype=torch.float64), 13)
    before = ljop.lj_log_prob_and_force.launches
    ljop.lj_log_prob_and_force(torch.as_tensor(_configs(13, 2, 0.1)), 13)
    assert ljop.lj_log_prob_and_force.launches == before  # CPU: plain version, no launch
