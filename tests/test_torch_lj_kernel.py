"""Kernel K1's host side on the CPU: the launch geometry, the packed
constants and the wrapper's dispatch. The kernel itself is held against its
plain version in test_torch_kernels_gpu.py."""

import ctypes

import numpy as np
import pytest
import torch

from pita_torch.ops import lj as ljop
from pita_torch.targets import LennardJones
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("n,lanes,threads", [
    (1, 1, 1), (4, 1, 4), (5, 1, 8), (13, 1, 16), (13, 2, 32), (13, 4, 64), (13, 8, 128),
    (55, 1, 64), (55, 2, 128), (55, 4, 224), (55, 8, 448), (256, 2, 512),
])
def test_group_threads(n, lanes, threads):
    assert ljop.group_threads(n, lanes) == threads


@pytest.mark.parametrize("n,batch,lanes", [
    # LJ55: the sampler's 2048 chains and the train set's 512 put a warp on
    # every scheduler with one lane a particle, the fill's 256 need two
    (55, 2048, 1), (55, 512, 1), (55, 256, 2), (55, 1, 8),
    (13, 2048, 1), (13, 512, 4), (13, 256, 8), (13, 1, 8),
    (256, 1, 2),  # N * lanes <= MAX_GROUP
])
def test_lanes_per_particle(n, batch, lanes):
    assert ljop.lanes_per_particle(n, batch, 132) == lanes


@pytest.mark.parametrize("n", [2, 13, 38, 55, 100, 256])
def test_lanes_fill_the_card_or_take_the_most(n):
    target = 32 * ljop.WARPS_PER_SM * 132
    prev = None
    for batch in (1, 7, 64, 256, 300, 512, 1024, 2048, 4096, 10 ** 5):
        lanes = ljop.lanes_per_particle(n, batch, 132)
        assert lanes in (1, 2, 4, 8) and n * lanes <= ljop.MAX_GROUP
        most = max(l for l in (1, 2, 4, 8) if n * l <= ljop.MAX_GROUP)
        fills = batch * ljop.group_threads(n, lanes) >= target
        assert fills or lanes == most
        if fills and lanes > 1:  # the fewest lanes that fill it
            assert batch * ljop.group_threads(n, lanes // 2) < target
        assert prev is None or lanes <= prev  # more chains, fewer lanes
        prev = lanes


def test_params_layout_is_the_kernels():
    # LJParams in csrc/lj.cu: 15 floats, then the spline flag
    names = [f[0] for f in ljop._LJParams._fields_]
    assert names[-1] == "spline" and len(names) == 16
    assert ctypes.sizeof(ljop._LJParams) == 64
    assert ljop._LJParams.spline.offset == 60


def test_pack_params_is_cached_and_refuses_what_the_kernel_cannot_fold():
    a = ljop.pack_params(1.0, 1.0, 1.0, 1.0, 2.0, (1.0, 2.0, 3.0, 4.0, 0.65))
    assert ljop.pack_params(1.0, 1.0, 1.0, 1.0, 2.0, (1.0, 2.0, 3.0, 4.0, 0.65)) is a
    assert a.spline == 1 and ljop.pack_params().spline == 0
    with pytest.raises(ValueError, match="rm > 0"):
        ljop.pack_params(1.0, 0.0)
    with pytest.raises(ValueError, match="eps != 0"):
        ljop.pack_params(0.0, 1.0)


def _configs(n, B, seed, close):
    """Jittered lattices; with ``close`` every other configuration has
    particle 1 at r = 0.5 from particle 0 (below the spline's r_min)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    x = grid[:n][None] * 1.1 + 0.15 * rng.normal(size=(B, n, 3))
    if close:
        x[::2, 1] = x[::2, 0] + np.array([0.5, 0.0, 0.0])
    return torch.as_tensor(x.reshape(B, n * 3))


def _emulate(x, n, p):
    """The kernel's arithmetic (csrc/lj.cu:lj_pairs_kernel) in float64 from
    the packed float32 constants: scaled coordinates, the folded factors, the
    shifted centre-of-mass sums."""
    B = x.shape[0]
    xs = x.reshape(B, n, 3) * p.inv_rm
    d = xs[:, :, None] - xs[:, None]
    eye = torch.eye(n, dtype=torch.bool)
    r2 = torch.where(eye, torch.ones(()), (d ** 2).sum(-1))
    s = 1 / r2
    s3 = s ** 3
    s6 = s3 * s3
    ep, gd = s6 - 2 * s3, s * (s3 - s6)
    if p.spline:
        r = torch.sqrt(r2)
        dx = r * p.rm - p.r_min
        es = ((p.c0 * dx + p.c1) * dx + p.c2) * dx + p.c3
        gs = ((p.q0 * dx + p.q1) * dx + p.q2) / r
        close = r2 < p.rmin2
        ep, gd = torch.where(close, es, ep), torch.where(close, gs, gd)
    ep, gd = ep.masked_fill(eye, 0), gd.masked_fill(eye, 0)
    g = (gd[..., None] * d).sum(2)
    u = xs - xs[:, :1]
    s1 = u.sum(1)
    osc = (u ** 2).sum((1, 2)) - (s1 ** 2).sum(-1) / n
    logp = p.ke * ep.sum((1, 2)) + p.ko * osc
    force = p.kg * g + p.kc * (u - s1[:, None] / n)
    return logp, force.reshape(B, n * 3)


@pytest.mark.parametrize("n,kw", [
    (13, dict(smooth=False)),
    (13, dict(smooth=True, temperature=2.0)),
    (55, dict(smooth=True, temperature=2.0 / 1.2)),
    (55, dict(smooth=False, oscillator=False, energy_factor=0.5)),
    (13, dict(smooth=True, rm=1.2, eps=0.7, energy_factor=0.5, oscillator_scale=2.0,
              temperature=1.3)),
    (13, dict(smooth=False, rm=0.9, eps=1.5, temperature=0.8)),
])
def test_packed_constants_reproduce_the_plain_version(n, kw):
    """The folded constants, used as the kernel uses them, give the plain
    energy and autograd force (float64; the constants are rounded to
    float32 once, ~6e-8 each)."""
    t = LennardJones(n, **kw)
    x = _configs(n, 6, seed=n, close=t.spline is not None)
    p = ljop.pack_params(t.eps, t.rm, t._osc, t.energy_factor, t.temperature, t.spline)
    lp, f = _emulate(x, n, p)
    lp_p, f_p = ljop.lj_log_prob_and_force_plain(
        x, n, eps=t.eps, rm=t.rm, oscillator_scale=t._osc, energy_factor=t.energy_factor,
        temperature=t.temperature, spline=t.spline)
    if t.spline is not None:  # the spline's branch is taken
        xr = x.reshape(6, n, 3)
        dist = (xr[:, :, None] - xr[:, None]).norm(dim=-1) + torch.eye(n) * 9
        assert (dist < t.spline[4]).any()
    assert (lp - lp_p).abs().max() <= 1e-6 * lp_p.abs().max()
    assert (f - f_p).abs().max() <= 1e-6 * f_p.abs().max()


def test_cpu_tensors_launch_no_kernel():
    x = _configs(55, 3, seed=1, close=True).float()
    t = LennardJones(55, smooth=True)
    before = (ljop.lj_log_prob_and_force.launches, ljop._lj_scalar.launches)
    lp, f = t.log_prob_and_force(x)
    assert lp.shape == (3,) and f.shape == (3, 165)
    # the CUDA limits do not apply to the plain version
    big = torch.randn(2, 3 * (ljop.MAX_N + 1))
    ljop.lj_log_prob_and_force(big, ljop.MAX_N + 1)
    assert (ljop.lj_log_prob_and_force.launches, ljop._lj_scalar.launches) == before
    with pytest.raises(ValueError, match="yardstick"):
        ljop._lj_scalar(x, 55)
