"""Annealing-factor schedules gamma(t) with analytic dgamma/dt.

Counterpart of ``pita_tpu/schedules/annealing.py:15-106``. gamma goes from 1
at t=1 to ``annealing_factor`` = beta_low / beta_high at t=0. The sigmoid
schedule keeps the JAX package's sign of dγ/dt (the true derivative), not the
sign of the original PyTorch code.
"""

import dataclasses

import torch


def _f32(t):
    return torch.as_tensor(t, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class AnnealingSchedule:
    annealing_factor: float = 1.0

    def gamma(self, t):
        raise NotImplementedError

    def dgamma_dt(self, t):
        raise NotImplementedError

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ConstantAnnealingSchedule(AnnealingSchedule):
    """gamma(t) = annealing_factor."""

    def gamma(self, t):
        return torch.ones_like(_f32(t)) * self.annealing_factor

    def dgamma_dt(self, t):
        return torch.zeros_like(_f32(t))


@dataclasses.dataclass(frozen=True)
class LinearAnnealingSchedule(AnnealingSchedule):
    """Piecewise-linear start→target over [t_start, t_end] in reverse time."""

    annealing_factor_start: float = 1.0
    t_start: float = 1.0
    t_end: float = 0.0

    def _slope(self):
        return (self.annealing_factor - self.annealing_factor_start) / (self.t_end - self.t_start)

    def gamma(self, t):
        t = _f32(t)
        linear = self._slope() * (t - self.t_start) + self.annealing_factor_start
        start = torch.full_like(t, self.annealing_factor_start)
        end = torch.full_like(t, self.annealing_factor)
        return torch.where(t > self.t_start, start, torch.where(t < self.t_end, end, linear))

    def dgamma_dt(self, t):
        t = _f32(t)
        return torch.where(
            (t > self.t_start) | (t < self.t_end),
            torch.zeros_like(t),
            torch.full_like(t, self._slope()),
        )


@dataclasses.dataclass(frozen=True)
class SigmoidAnnealingSchedule:
    """Smooth sigmoid transition with configurable sharpness."""

    annealing_factor: float = 1.0
    annealing_factor_start: float = 1.0
    t_start: float = 1.0
    t_end: float = 0.0
    sharpness: float = 10.0

    @property
    def center(self):
        return (self.t_start + self.t_end) / 2

    @property
    def width(self):
        return self.t_start - self.t_end

    def _smooth(self, t):
        x = (self.center - t) / self.width
        return 1.0 / (1.0 + torch.exp(-self.sharpness * x))

    def gamma(self, t):
        t = _f32(t)
        return self.annealing_factor_start + (
            self.annealing_factor - self.annealing_factor_start
        ) * self._smooth(t)

    def dgamma_dt(self, t):
        t = _f32(t)
        smooth = self._smooth(t)
        d_smooth_dt = -(self.sharpness / self.width) * smooth * (1 - smooth)
        return (self.annealing_factor - self.annealing_factor_start) * d_smooth_dt

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
