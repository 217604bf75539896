"""RealNVP normalizing flow, FAB's trainable base distribution.

Counterpart of ``pita_tpu/fab/flow.py:15-101`` (fab's
``TrainableDistribution`` over a normflows RealNVP, fab/fab/core.py:18-35):
affine couplings with alternating binary masks, log-scales bounded by
cap·tanh(s/cap), each conditioner's last layer zero at initialization (the
flow starts as the identity), forward and inverse with their log-dets, and a
Gaussian base of scale ``base_scale``.

``pita_torch.io.flax_params.fab_flow_params_from_tree`` maps pita_tpu's
flax tree (``coupling_{i}``) onto ``RealNVP``'s state dict.
"""

import math

import torch
from torch import nn

from pita_torch.nets.egnn import lecun_normal_
from pita_torch.utils.device import resolve_device


class RealNVP(nn.Module):
    """``n_coupling`` affine couplings of a ``dim``-vector; coupling i keeps
    the coordinates of parity i mod 2 and transforms the others from them."""

    def __init__(self, dim: int, n_coupling: int = 8, hidden: int = 64,
                 log_scale_cap: float = 3.0):
        super().__init__()
        self.dim = dim
        self.log_scale_cap = log_scale_cap
        self.conditioners = nn.ModuleList(
            nn.Sequential(nn.Linear(dim, hidden), nn.SiLU(), nn.Linear(hidden, hidden),
                          nn.SiLU(), nn.Linear(hidden, 2 * dim))
            for _ in range(n_coupling))
        self.register_buffer("masks", torch.stack(
            [(torch.arange(dim) % 2 == i % 2).to(torch.float32) for i in range(n_coupling)]),
            persistent=False)

    def reset_parameters(self, generator=None):
        """flax's initial distributions: lecun-normal kernels, zero biases,
        each conditioner's last layer all zeros."""
        with torch.no_grad():
            for net in self.conditioners:
                for lin in (net[0], net[2]):
                    lecun_normal_(lin.weight.T, generator)
                    lin.bias.zero_()
                net[4].weight.zero_()
                net[4].bias.zero_()

    def _scale_shift(self, i, y):
        st = self.conditioners[i](y * self.masks[i])
        s, t = st[..., :self.dim], st[..., self.dim:]
        return torch.tanh(s / self.log_scale_cap) * self.log_scale_cap, t

    def forward(self, z):
        """z → (x, log |det ∂x/∂z|)."""
        logdet = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for i in range(len(self.conditioners)):
            m = self.masks[i]
            s, t = self._scale_shift(i, z)
            z = m * z + (1 - m) * (z * torch.exp(s) + t)
            logdet = logdet + ((1 - m) * s).sum(-1)
        return z, logdet

    def inverse(self, x):
        """x → (z, log |det ∂z/∂x|)."""
        logdet = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in reversed(range(len(self.conditioners))):
            m = self.masks[i]
            s, t = self._scale_shift(i, x)
            x = m * x + (1 - m) * ((x - t) * torch.exp(-s))
            logdet = logdet - ((1 - m) * s).sum(-1)
        return x, logdet


class FlowDistribution:
    """Sampling and log-density of a ``RealNVP`` over a Gaussian base.

    ``device`` defaults to CUDA (raising without a GPU); the weights are
    drawn from ``generator`` (flax's distributions) unless loaded later.
    """

    def __init__(self, dim: int, n_coupling: int = 8, hidden: int = 64,
                 base_scale: float = 1.0, device=None, generator=None):
        self.dim = dim
        self.base_scale = base_scale
        self.device = resolve_device(device)
        self.module = RealNVP(dim, n_coupling, hidden).to(self.device)
        self.module.reset_parameters(generator)

    def parameters(self):
        return list(self.module.parameters())

    def _base_log_prob(self, z):
        s = self.base_scale
        return (-0.5 * ((z / s) ** 2).sum(-1)
                - self.dim * (0.5 * math.log(2 * math.pi) + math.log(s)))

    def sample_and_log_prob(self, num_samples: int, generator=None, eps=None):
        """(x, log q(x)) for ``num_samples`` draws; ``eps`` (num_samples,
        dim) standard normals of the base, else drawn from ``generator``."""
        if eps is None:
            eps = torch.randn((num_samples, self.dim), generator=generator, device=self.device)
        z = eps * self.base_scale
        x, logdet = self.module(z)
        return x, self._base_log_prob(z) - logdet

    def sample(self, num_samples: int, generator=None, eps=None):
        return self.sample_and_log_prob(num_samples, generator, eps)[0]

    def log_prob(self, x):
        z, logdet = self.module.inverse(x)
        return self._base_log_prob(z) + logdet
