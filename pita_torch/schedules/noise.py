"""Variance-exploding noise schedules as functions of t.

Counterpart of ``pita_tpu/schedules/noise.py``. Each schedule gives
``g(t)`` (diffusion coefficient), ``h(t) = ∫_0^t g(s)² ds`` and, where it
has one, ``t(h)`` and ``dh_dt`` (the base class differentiates ``h`` by
autograd). The two schedules a trainer can use, Geometric and Elucidating
(Karras rho), also draw the training noise levels (``sample_ln_sigma``,
from the standard draw ``draw_ln_sigma`` gives or one passed in) and bin
them for the loss diagnostics (``ln_sigma_bins``); Linear, Quadratic, Power
and SubLinear serve the sampler only, as in ``pita_tpu``.
"""

import dataclasses
import math

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
class LinearNoiseSchedule(NoiseSchedule):
    """h(t) = beta * t (noise.py:43)."""

    beta: float

    def g(self, t):
        return torch.full_like(t, self.beta**0.5)

    def h(self, t):
        return self.beta * t

    def dh_dt(self, t):
        return torch.full_like(t, self.beta)

    def t(self, ht):
        return ht / self.beta


@dataclasses.dataclass(frozen=True)
class QuadraticNoiseSchedule(NoiseSchedule):
    """h(t) = beta * t² (noise.py:62)."""

    beta: float

    def g(self, t):
        return torch.sqrt(self.beta * 2 * t)

    def h(self, t):
        return self.beta * t**2

    def dh_dt(self, t):
        return 2 * self.beta * t

    def t(self, ht):
        return torch.sqrt(ht / self.beta)


@dataclasses.dataclass(frozen=True)
class PowerNoiseSchedule(NoiseSchedule):
    """h(t) = beta * t^power (noise.py:81)."""

    beta: float
    power: float

    def g(self, t):
        return torch.sqrt(self.beta * self.power * t ** (self.power - 1))

    def h(self, t):
        return self.beta * t**self.power

    def dh_dt(self, t):
        return self.beta * self.power * t ** (self.power - 1)

    def t(self, ht):
        return (ht / self.beta) ** (1.0 / self.power)


@dataclasses.dataclass(frozen=True)
class SubLinearNoiseSchedule(NoiseSchedule):
    """h(t) = beta * sqrt(t) (noise.py:101); dh_dt by autograd."""

    beta: float

    def g(self, t):
        return torch.sqrt(self.beta * 0.5 / (t**0.5 + 1e-3))

    def h(self, t):
        return self.beta * t**0.5

    def t(self, ht):
        return (ht / self.beta) ** 2


@dataclasses.dataclass(frozen=True)
class GeometricNoiseSchedule(NoiseSchedule):
    """EDM's geometric schedule (noise.py:117)."""

    sigma_min: float
    sigma_max: float

    @property
    def sigma_diff(self):
        return self.sigma_max / self.sigma_min

    def g(self, t):
        return self.sigma_min * (self.sigma_diff**t) * math.sqrt(2 * math.log(self.sigma_diff))

    def h(self, t):
        return (self.sigma_min * ((self.sigma_diff ** (2 * t)) - 1) ** 0.5) ** 2

    def dh_dt(self, t):
        return self.g(t) ** 2

    def t(self, ht):
        # sigma_diff^{2t} = ht / sigma_min^2 + 1
        return torch.log(ht / self.sigma_min**2 + 1.0) / (2 * math.log(self.sigma_diff))

    def draw_ln_sigma(self, num_samples, generator=None, device=None):
        """The standard draw of ``sample_ln_sigma``: uniforms on [0, 1)."""
        return torch.rand(num_samples, generator=generator, device=device)

    def sample_ln_sigma(self, num_samples, uniform=None, generator=None, device=None):
        """ln σ ~ U[ln σ_min, ln σ_max] (noise.py:140-143), as jax.random.uniform
        maps its uniforms. ``uniform``: the (num_samples,) draw on [0, 1);
        drawn from ``generator`` if not given."""
        if uniform is None:
            uniform = self.draw_ln_sigma(num_samples, generator, device)
        lo, hi = math.log(self.sigma_min), math.log(self.sigma_max)
        return torch.clamp_min(uniform * (hi - lo) + lo, lo)

    def ln_sigma_bins(self, num_bins):
        return torch.linspace(math.log(self.sigma_min), math.log(self.sigma_max), num_bins + 1)


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

    def draw_ln_sigma(self, num_samples, generator=None, device=None):
        """The standard draw of ``sample_ln_sigma``: standard normals."""
        return torch.randn(num_samples, generator=generator, device=device)

    def sample_ln_sigma(self, num_samples, normal=None, generator=None, device=None):
        """ln σ ~ N(P_mean, P_std²) (noise.py:185-187). ``normal``: the
        standard normal draw (num_samples,); drawn from ``generator`` if not
        given."""
        if normal is None:
            normal = self.draw_ln_sigma(num_samples, generator, device)
        return normal * self.P_std + self.P_mean

    def ln_sigma_bins(self, num_bins):
        """Bin edges at P_mean ± 2 P_std (noise.py:189-192)."""
        return torch.linspace(self.P_mean - 2 * self.P_std, self.P_mean + 2 * self.P_std,
                              num_bins + 1)
