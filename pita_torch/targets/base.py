"""Base Boltzmann target density.

Counterpart of ``pita_tpu/targets/base.py:28-60`` (the density API only):
``log_prob(x)`` ``(..., D) -> (...,)`` and ``log_prob_and_force(x)``, whose
force is ∇ₓ log_prob by autograd. Temperature enters as ``-E(x)/T``.
"""

import torch


class Target:
    """A (possibly tempered) Boltzmann density on R^dim."""

    dim: int
    n_particles: int = 1
    n_spatial_dim: int = 1
    is_molecule: bool = False
    temperature: float = 1.0
    name: str = "target"

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_prob_and_force(self, x: torch.Tensor):
        """(log_prob, force) with force = ∇ₓ log_prob."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            lp = self.log_prob(xx)
            (force,) = torch.autograd.grad(lp.sum(), xx)
        return lp.detach(), force
