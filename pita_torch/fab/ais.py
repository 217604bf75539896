"""Annealed importance sampling.

Counterpart of ``pita_tpu/fab/ais.py:26-108`` (fab's
``sampling_methods/ais.py:18-238``): AIS from a base distribution q to the
target p, or to the α-target g ∝ p^α q^{1−α} (``p_target=False``), over a
linear or geometric β ladder. Rung j has log π_j = (1−β_j)·log q + β_j·log p;
the chains take Metropolis or HMC sweeps at each rung and add the weight
increment log π_{j+1} − log π_j. Non-finite weights are masked to −∞ rather
than dropped, so the batch keeps its size. Returns ESS before and after, and
log Z = logsumexp(log w) − log B.

The random numbers come from a draws object: ``base(shape)`` gives the
standard normals of the base sample, ``rung(j)`` the transition draws of
rung j (``normal(step, shape)``, ``uniform(step, shape)``). ``FabDraws``
draws all of them from one ``torch.Generator``; a test can replay JAX's.
"""

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pita_torch.fab.transition_operators import hmc_transition, metropolis_transition
from pita_torch.metrics.ess import effective_sample_size


@dataclasses.dataclass(frozen=True)
class AISConfig:
    n_intermediate_distributions: int = 8
    distribution_spacing_type: str = "linear"  # or "geometric"
    transition: str = "hmc"  # or "metropolis"
    n_inner_steps: int = 5
    step_size: float = 0.2
    n_leapfrog: int = 5
    p_target: bool = True
    alpha: Optional[float] = None  # AIS to g ∝ p^α q^{1-α} when p_target=False


class AISResult(NamedTuple):
    samples: torch.Tensor  # (B, D)
    log_w: torch.Tensor  # (B,), −∞ where non-finite
    ess_base: torch.Tensor  # normalized ESS of the base sample's weights
    ess_ais: torch.Tensor  # normalized ESS of the AIS weights
    log_Z: torch.Tensor


class FabDraws:
    """AIS's and FAB's random numbers from one ``torch.Generator``, in call
    order: standard normals (``base``, ``normal``), uniforms and Gumbels."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator
        self.device = generator.device

    def base(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def rung(self, j):
        return self

    def normal(self, step, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def uniform(self, step, shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def gumbel(self, shape):
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def beta_spacing(cfg: AISConfig) -> np.ndarray:
    """The β ladder with its end points (ais.py:113-135): linear, or the
    AIS paper's geometric heuristic (a quarter linear on [0, 0.01), the rest
    log-spaced to 1)."""
    n = cfg.n_intermediate_distributions
    if cfg.distribution_spacing_type == "linear":
        return np.linspace(0.0, 1.0, n + 2)
    n_low = max((n + 2) // 4, 1)
    betas_low = np.linspace(0.0, 0.01, n_low, endpoint=False)
    betas_high = np.geomspace(0.01, 1.0, (n + 2) - n_low)
    return np.concatenate([betas_low, betas_high])


def annealed_importance_sampling(base_sample_and_log_prob: Callable, base_log_prob: Callable,
                                 target_log_prob: Callable, batch_size: int,
                                 cfg: AISConfig = AISConfig(), draws=None) -> AISResult:
    """Run AIS. ``base_sample_and_log_prob(n, draws)`` gives n base samples
    and their log q from ``draws.base``; ``base_log_prob`` and
    ``target_log_prob`` map (n, D) to (n,). HMC differentiates them in x."""
    if not (cfg.p_target or cfg.alpha is not None):
        raise ValueError("AIS to the alpha-target needs alpha")

    def ends(x):
        """(log q, log of the target) at x, with one evaluation of each."""
        lq, lp = base_log_prob(x), target_log_prob(x)
        return lq, (lp if cfg.p_target else cfg.alpha * lp + (1 - cfg.alpha) * lq)

    def intermediate(lq, tgt, beta):
        return (1 - beta) * lq + beta * tgt

    x, log_q0 = base_sample_and_log_prob(batch_size, draws)
    # the ladder in float32, as pita_tpu holds it
    betas = torch.tensor(beta_spacing(cfg), dtype=torch.float32, device=x.device)
    lq, tgt = ends(x)
    log_w = intermediate(lq, tgt, betas[1]) - log_q0
    ess_base = effective_sample_size(tgt - log_q0, normalize=True)
    for j in range(len(betas) - 2):
        beta, beta_next = betas[j + 1], betas[j + 2]
        log_pi = lambda xx, b=beta: intermediate(*ends(xx), b)
        if cfg.transition == "hmc":
            x, _ = hmc_transition(x, log_pi, cfg.n_inner_steps, cfg.step_size, draws.rung(j),
                                  cfg.n_leapfrog)
        else:
            x, _ = metropolis_transition(x, log_pi, cfg.n_inner_steps, cfg.step_size,
                                         draws.rung(j))
        lq, tgt = ends(x)
        log_w = log_w + intermediate(lq, tgt, beta_next) - intermediate(lq, tgt, beta)
    log_w = torch.where(torch.isfinite(log_w), log_w, -math.inf)
    ess_ais = effective_sample_size(log_w, normalize=True)
    log_Z = torch.logsumexp(log_w, dim=0) - math.log(batch_size)
    return AISResult(x, log_w, ess_base, ess_ais, log_Z)
