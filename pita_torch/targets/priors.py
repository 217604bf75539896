"""Priors for the reverse-SDE start state.

Counterpart of ``pita_tpu/targets/priors.py:19-60``. The sampler starts from
an isotropic Gaussian at scale ``sqrt(h(t_start) / γ(t_start))``; for
molecules the Gaussian is projected onto the CoM-free hyperplane, with an
(N−1)·D-degrees-of-freedom log-density. ``sample`` takes its standard
normal draw as an argument, or draws it from a ``torch.Generator``.
"""

import math

import torch


def _normal(shape, normal, generator, device):
    if normal is None:
        return torch.randn(shape, generator=generator, device=device)
    if tuple(normal.shape) != tuple(shape):
        raise ValueError(f"normal draw must be {tuple(shape)}, got {tuple(normal.shape)}")
    return normal


class IsotropicGaussianPrior:
    """N(0, scale² I) on R^dim."""

    def __init__(self, dim: int, scale: float):
        self.dim = dim
        self.scale = scale

    def sample(self, num_samples: int, normal=None, generator=None, device=None):
        """``normal``: (num_samples, dim) standard normals."""
        return _normal((num_samples, self.dim), normal, generator, device) * self.scale

    def log_prob(self, x):
        r2 = (x ** 2).sum(-1) / self.scale ** 2
        logz = -0.5 * self.dim * math.log(2 * math.pi * self.scale ** 2)
        return -0.5 * r2 + logz


class MeanFreePrior:
    """Gaussian projected on the CoM-free hyperplane."""

    def __init__(self, n_particles: int, spatial_dim: int, scale: float):
        self.n_particles = n_particles
        self.spatial_dim = spatial_dim
        self.dim = n_particles * spatial_dim
        self.scale = scale

    def sample(self, num_samples: int, normal=None, generator=None, device=None):
        """``normal``: (num_samples, n_particles, spatial_dim) standard normals."""
        x = _normal((num_samples, self.n_particles, self.spatial_dim), normal, generator,
                    device) * self.scale
        x = x - x.mean(-2, keepdim=True)
        return x.reshape(num_samples, self.dim)

    def log_prob(self, x):
        xr = x.reshape(*x.shape[:-1], self.n_particles, self.spatial_dim)
        r2 = (xr ** 2).sum((-1, -2)) / self.scale ** 2
        dof = (self.n_particles - 1) * self.spatial_dim
        logz = -0.5 * dof * math.log(2 * math.pi * self.scale ** 2)
        return -0.5 * r2 + logz


def Prior(scale: float, n_particles: int = None, spatial_dim: int = None, dim: int = None,
          should_mean_free: bool = True):
    """The reference's ``Prior`` dispatch (base_prior.py:8-46)."""
    if should_mean_free:
        if n_particles is None or spatial_dim is None:
            raise ValueError("a mean-free prior needs n_particles and spatial_dim")
        return MeanFreePrior(n_particles, spatial_dim, scale)
    if dim is None:
        dim = n_particles * spatial_dim
    return IsotropicGaussianPrior(dim, scale)
