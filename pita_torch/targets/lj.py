"""Lennard-Jones cluster targets (LJ13, LJ55).

Counterpart of ``pita_tpu/targets/lj.py:28-139`` (energy, ``log_prob`` and
``log_prob_and_force``; dataset generation is not ported yet). Pair energy
``eps·((rm/r)¹²−2(rm/r)⁶)`` over ordered pairs, the CoM oscillator, the
optional cubic-spline smoothing below ``range_min`` (only the first spline
segment is ever used there, so it is five scalars), ``log_prob = −E/T``.

``log_prob_and_force`` of a (B, D) batch goes through
``pita_torch.ops.lj.lj_log_prob_and_force``: the CUDA kernel for a CUDA
tensor, the autograd force of the same energy for a CPU tensor.
"""

import numpy as np

from pita_torch.ops.lj import lj_energy, lj_log_prob_and_force
from pita_torch.targets.base import Target


def fit_smoothing_spline(eps, rm, range_min, range_max, interpolation=1000):
    """Cubic-spline knots and coefficients of the pair energy on
    [range_min, range_max] (copy of pita_tpu/targets/lj.py:34-45)."""
    from scipy.interpolate import CubicSpline

    xs = np.linspace(range_min, range_max, interpolation)
    es = eps * ((rm / xs) ** 12 - 2 * (rm / xs) ** 6)
    c = CubicSpline(xs, es).c  # (4, K-1)
    return xs.astype(np.float32), c.astype(np.float32)


class LennardJones(Target):
    """LJ cluster of ``n_particles`` in 3D with CoM oscillator."""

    is_molecule = True
    n_spatial_dim = 3

    def __init__(self, n_particles: int, eps: float = 1.0, rm: float = 1.0,
                 oscillator: bool = True, oscillator_scale: float = 1.0,
                 energy_factor: float = 1.0, smooth: bool = False,
                 range_min: float = 0.65, range_max: float = 2.0,
                 temperature: float = 1.0):
        self.n_particles = n_particles
        self.dim = n_particles * 3
        self.eps = eps
        self.rm = rm
        self.oscillator = oscillator
        self.oscillator_scale = oscillator_scale
        self.energy_factor = energy_factor
        self.smooth = smooth
        self.range_min = range_min
        self.temperature = float(temperature)
        self.name = f"lj{n_particles}"
        self.spline = None
        if smooth:
            knots, coeffs = fit_smoothing_spline(eps, rm, range_min, range_max)
            # the float32 values, as the JAX target stores them
            self.spline = (
                float(coeffs[0, 0]), float(coeffs[1, 0]), float(coeffs[2, 0]),
                float(coeffs[3, 0]), float(knots[0]),
            )

    @property
    def _osc(self):
        return self.oscillator_scale if self.oscillator else 0.0

    def energy(self, x):
        """Untempered energy E(x); x: (..., dim)."""
        return lj_energy(x, self.n_particles, self.eps, self.rm, self._osc,
                         self.energy_factor, self.spline)

    def log_prob(self, x):
        return -self.energy(x) / self.temperature

    def log_prob_and_force(self, x):
        if x.dim() != 2:
            return super().log_prob_and_force(x)
        return lj_log_prob_and_force(
            x, self.n_particles, eps=self.eps, rm=self.rm,
            oscillator_scale=self._osc, energy_factor=self.energy_factor,
            temperature=self.temperature, spline=self.spline,
        )


def LJ13(**kw) -> LennardJones:
    return LennardJones(n_particles=13, **kw)


def LJ55(**kw) -> LennardJones:
    return LennardJones(n_particles=55, **kw)
