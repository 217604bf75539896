"""Data augmentation: random SO(d) rotations and CoM jitter.

Counterpart of ``pita_tpu/train/augment.py:14-45``: uniform rotations from
the QR factorization of Gaussian d×d matrices (d = 3, or 2 for DW4; signs
fixed so R's diagonal is positive and det = +1), applied to coordinates and forces alike, and a
Gaussian CoM shift of σ = 1/sqrt(N·d). Each function takes its standard
normal draw as an argument (the trainer draws it, a test replays JAX's).
"""

import math

import torch


def random_rotations(normal):
    """Haar-uniform rotation matrices (B, d, d) from Gaussians (B, d, d)
    (rotation.py:37-49)."""
    Q, R = torch.linalg.qr(normal)
    Q = Q * torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))[:, None, :]
    d = torch.sign(torch.linalg.det(Q))
    return torch.cat([Q[:, :, :1] * d[:, None, None], Q[:, :, 1:]], dim=-1)


def rotate_augment(x, force, n_particles: int, n_spatial_dim: int, normal):
    """One random rotation per sample, applied to x and force (B, N·d);
    ``normal``: the (B, d, d) Gaussians the rotations come from."""
    B = x.shape[0]
    rot = random_rotations(normal)
    x_out = torch.einsum("bij,bki->bkj", rot, x.reshape(B, n_particles, n_spatial_dim))
    if force is None:
        return x_out.reshape(B, -1), None
    f_out = torch.einsum("bij,bki->bkj", rot, force.reshape(B, n_particles, n_spatial_dim))
    return x_out.reshape(B, -1), f_out.reshape(B, -1)


def com_augment(x, n_particles: int, n_spatial_dim: int, normal):
    """Gaussian CoM jitter with σ = 1/sqrt(N·d); ``normal``: (B, 1, d)."""
    B = x.shape[0]
    noise = normal * (1.0 / math.sqrt(float(n_particles * n_spatial_dim)))
    return (x.reshape(B, n_particles, n_spatial_dim) + noise).reshape(B, -1)
