"""FAB's target densities.

Counterpart of ``pita_tpu/fab/targets.py:18-93`` (fab's
``target_distributions/``): the 1-D double well
E(x₁) = a·x₁ + b·x₁² + c·x₁⁴ (a = −0.5, b = −6, c = 1), ManyWell, the
product of dim/2 independent 2-D wells E = E(x₁) + ½x₂², and a diagonal
Gaussian. GMM lives in ``pita_torch.targets.gmm``.
"""

import math

import numpy as np
import torch

from pita_torch.targets.base import Target


class DoubleWell1D:
    """The 1-D marginal double well (the first coordinate of the 2-D well)."""

    def __init__(self, a=-0.5, b=-6.0, c=1.0):
        self.a, self.b, self.c = a, b, c

    def energy(self, x1):
        return self.a * x1 + self.b * x1 ** 2 + self.c * x1 ** 4


class ManyWell(Target):
    """Product of dim/2 independent 2-D double wells (many_well.py)."""

    is_molecule = False
    name = "many_well"

    def __init__(self, dim: int = 32, a=-0.5, b=-6.0, c=1.0, temperature: float = 1.0):
        if dim % 2:
            raise ValueError(f"ManyWell needs an even dim, got {dim}")
        self.dim = dim
        self.n_wells = dim // 2
        self.a, self.b, self.c = a, b, c
        self.temperature = float(temperature)

    def energy(self, x):
        x1, x2 = x[..., 0::2], x[..., 1::2]
        e1 = self.a * x1 + self.b * x1 ** 2 + self.c * x1 ** 4
        e2 = 0.5 * x2 ** 2
        return (e1 + e2).sum(-1)

    def log_prob(self, x):
        return -self.energy(x) / self.temperature

    def mode_locations(self) -> np.ndarray:
        """The 2^n_wells modes (many_well.py:67-79): x₁ at the outer roots of
        dE/dx₁ = a + 2b·x₁ + 4c·x₁³ in each well, x₂ = 0."""
        roots = np.roots([4 * self.c, 0.0, 2 * self.b, self.a])
        real = np.sort(roots[np.abs(roots.imag) < 1e-9].real)
        lo, hi = real[0], real[-1]
        bits = (np.arange(2 ** self.n_wells)[:, None] >> np.arange(self.n_wells)) & 1
        modes = np.zeros((2 ** self.n_wells, self.dim))
        modes[:, 0::2] = np.where(bits == 1, hi, lo)
        return modes


class GaussianTarget(Target):
    """Diagonal Gaussian (fab's target_distributions/gaussian.py)."""

    is_molecule = False
    name = "gaussian"

    def __init__(self, mean, scale, temperature: float = 1.0, device=None):
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
        self.scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
        self.dim = int(self.mean.shape[-1])
        self.temperature = float(temperature)

    def log_prob(self, x):
        z = (x - self.mean) / self.scale
        lp = (-0.5 * (z ** 2).sum(-1) - torch.log(self.scale).sum()
              - 0.5 * self.dim * math.log(2 * math.pi))
        return lp / self.temperature

    def sample(self, num_samples: int, generator=None, eps=None):
        """``num_samples`` draws; ``eps`` (num_samples, dim) standard normals,
        else drawn from ``generator``."""
        if eps is None:
            eps = torch.randn((num_samples, self.dim), generator=generator,
                              device=self.mean.device)
        return self.mean + self.scale * eps

    def sample_and_log_prob(self, num_samples: int, generator=None, eps=None):
        x = self.sample(num_samples, generator, eps)
        return x, self.log_prob(x)
