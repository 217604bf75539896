"""Center-of-mass utilities for particle systems.

Counterpart of ``pita_tpu/utils/mean_free.py:10-26``.
"""

import torch


def remove_mean(x: torch.Tensor, n_particles: int, n_spatial_dim: int) -> torch.Tensor:
    """Subtract the per-sample center of mass from flattened particle coords.

    x: ``(..., n_particles * n_spatial_dim)``; returns the same shape with zero
    center of mass per sample.
    """
    shape = x.shape
    xr = x.reshape(*shape[:-1], n_particles, n_spatial_dim)
    xr = xr - xr.mean(dim=-2, keepdim=True)
    return xr.reshape(shape)
