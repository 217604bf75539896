"""Continuous normalizing flow for exact-likelihood evaluation.

Counterpart of ``pita_tpu/sampler/cnf.py``: the probability-flow ODE of the
learned score,

    dx/dt = −½ g(t)² s_θ(x, t),      d log p/dt = ½ g(t)² div s_θ,

integrated from t = 0 to 1 by fixed-step RK4 on x and the midpoint rule on
the divergence integral, with the exact divergence (D VJPs,
``pita_torch.ops.divergence.exact_divergence``; ``exact_divergence_replicated``
for a score on the EGNN's kernel route) or the Hutchinson estimate.
NLL(x0) = −log N(x1; 0, h(1)) + ∫ ½ g² div s dt. The Hutchinson probes come
from a ``torch.Generator`` (pita_tpu's from its key).
"""

import math
from typing import NamedTuple, Optional

import torch

from pita_torch.ops.divergence import (exact_divergence, exact_divergence_replicated,
                                       hutchinson_divergence)


class CNFResult(NamedTuple):
    x1: torch.Tensor
    delta_logp: torch.Tensor  # ∫ div term (log p0 = log p1 − delta)
    nll: torch.Tensor


def cnf_nll(x0: torch.Tensor, score_wrapper, noise_schedule, beta=1.0, num_steps: int = 100,
            exact: bool = True, hutchinson_probes: int = 1,
            divergence_chunk_size: Optional[int] = None, generator=None) -> CNFResult:
    """Integrate the probability-flow ODE 0→1 from ``x0`` (B, D) and return
    the per-sample NLL. ``generator`` draws the Rademacher probes when
    ``exact`` is off."""
    B, D = x0.shape
    dev = x0.device
    ts = torch.linspace(0.0, 1.0, num_steps + 1, device=dev)
    dt = 1.0 / num_steps
    score_fn = lambda tt, xx: score_wrapper.score(noise_schedule.h(tt), xx, beta)
    backbone = getattr(score_wrapper, "backbone", None)
    trace = (exact_divergence_replicated if getattr(backbone, "route", "autograd") == "kernels"
             else exact_divergence)

    def vector_field(t, x):
        tb = t.expand(B)
        with torch.no_grad():
            s = score_fn(tb, x)
        return -0.5 * (noise_schedule.g(tb) ** 2)[:, None] * s

    def div_term(t, x):
        tb = t.expand(B).contiguous()
        if exact:
            div_s = trace(score_fn, tb, x, chunk_size=divergence_chunk_size)
        else:
            r = torch.randint(0, 2, (hutchinson_probes, B, D), generator=generator, device=dev)
            div_s = hutchinson_divergence(score_fn, tb, x, r.to(x.dtype) * 2 - 1)
        return 0.5 * noise_schedule.g(tb) ** 2 * div_s

    x, dlogp = x0, torch.zeros(B, dtype=x0.dtype, device=dev)
    for t in ts[:-1]:
        k1 = vector_field(t, x)
        k2 = vector_field(t + dt / 2, x + dt / 2 * k1)
        k3 = vector_field(t + dt / 2, x + dt / 2 * k2)
        k4 = vector_field(t + dt, x + dt * k3)
        dlogp = dlogp + dt * div_term(t + dt / 2, x + dt / 2 * k1).detach()
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    h1 = float(noise_schedule.h(torch.tensor(1.0)))
    logp1 = -0.5 * (x ** 2).sum(-1) / h1 - 0.5 * D * math.log(2 * math.pi * h1)
    return CNFResult(x1=x, delta_logp=dlogp, nll=-(logp1 - dlogp))
