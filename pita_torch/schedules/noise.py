"""Variance-exploding noise schedules as functions of t.

Counterpart of ``pita_tpu/schedules/noise.py:25-40,149-192``. Each schedule
gives ``g(t)`` (diffusion coefficient), ``h(t) = ∫_0^t g(s)² ds`` and, where
it has one, ``t(h)`` and ``dh_dt``; the training noise levels come from
``sample_ln_sigma`` and the loss diagnostics bin them on ``ln_sigma_bins``.
Only the Elucidating (Karras rho) schedule is ported so far; it is the one
the LJ presets use.
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Base class; subclasses define g(t) and h(t)."""

    def g(self, t):
        raise NotImplementedError

    def h(self, t):
        raise NotImplementedError

    def dh_dt(self, t):
        """Default: autograd of h."""
        with torch.enable_grad():
            tt = t.detach().requires_grad_(True)
            (d,) = torch.autograd.grad(self.h(tt).sum(), tt)
        return d

    def t(self, ht):
        raise NotImplementedError(f"{type(self).__name__} has no analytic inverse h^-1")


@dataclasses.dataclass(frozen=True)
class ElucidatingNoiseSchedule(NoiseSchedule):
    """Karras rho-schedule (defaults of configs/model/noise_schedule/elucidating.yaml)."""

    sigma_min: float = 0.002
    sigma_max: float = 80.0
    rho: float = 7.0
    P_mean: float = -1.2
    P_std: float = 1.2

    @property
    def term1(self):
        return self.sigma_max ** (1 / self.rho)

    @property
    def term2(self):
        return self.sigma_min ** (1 / self.rho) - self.sigma_max ** (1 / self.rho)

    def g(self, t):
        return (
            -2 * self.rho * (self.term1 + (1 - t) * self.term2) ** (2 * self.rho - 1) * self.term2
        ) ** 0.5

    def h(self, t):
        return (self.term1 + (1 - t) * self.term2) ** (2 * self.rho)

    def t(self, ht):
        return 1 - ((ht ** (1 / (2 * self.rho)) - self.term1) / self.term2)

    def dh_dt(self, t):
        return (
            -2 * self.rho * self.term2 * (self.term1 + (1 - t) * self.term2) ** (2 * self.rho - 1)
        )

    def sample_ln_sigma(self, num_samples, normal=None, generator=None, device=None):
        """ln σ ~ N(P_mean, P_std²) (noise.py:185-187). ``normal``: the
        standard normal draw (num_samples,); drawn from ``generator`` if not
        given."""
        if normal is None:
            normal = torch.randn(num_samples, generator=generator, device=device)
        return normal * self.P_std + self.P_mean

    def ln_sigma_bins(self, num_bins):
        """Bin edges at P_mean ± 2 P_std (noise.py:189-192)."""
        return torch.linspace(self.P_mean - 2 * self.P_std, self.P_mean + 2 * self.P_std,
                              num_bins + 1)
