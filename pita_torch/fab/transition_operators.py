"""MCMC transition operators for AIS.

Counterpart of ``pita_tpu/fab/transition_operators.py:14-91``: random-walk
Metropolis and HMC sweeps over a batch of chains, with the step size
multiplied or divided by 1.05 after each sweep around a target acceptance of
0.65, and the mean acceptance over the sweeps returned. HMC's leapfrog takes
∇ log π by autograd in x.

The random numbers come from ``draws``: ``normal(step, shape)`` (proposal or
momentum) and ``uniform(step, shape)`` (the accept test) per sweep, so a
test can replay JAX's. ``FabDraws`` (``pita_torch.fab.ais``) draws them from
a ``torch.Generator``.

``pita_torch.baselines.mcmc._hmc_step`` takes the same leapfrog but is not
reused: it accepts a ratio of +inf, where this one rejects every non-finite
ratio as pita_tpu's does (:74).
"""

import math

import torch


def _log_prob_and_grad(log_prob_fn, x):
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        lp = log_prob_fn(xx)
        (g,) = torch.autograd.grad(lp.sum(), xx)
    return lp.detach(), g


def _adapt(eps, acc, target_accept):
    return torch.where(acc > target_accept, eps * 1.05, eps / 1.05)


def metropolis_transition(x, log_prob_fn, n_steps: int, step_size: float, draws,
                          target_accept: float = 0.65, adapt: bool = True):
    """Random-walk MH sweeps; returns (x, mean acceptance)."""
    lp = log_prob_fn(x)
    eps = torch.tensor(step_size, dtype=x.dtype, device=x.device)
    accs = []
    for k in range(n_steps):
        prop = x + draws.normal(k, x.shape) * eps
        lp_prop = log_prob_fn(prop)
        accept = torch.log(draws.uniform(k, lp.shape)) < (lp_prop - lp)
        x = torch.where(accept[:, None], prop, x)
        lp = torch.where(accept, lp_prop, lp)
        acc = accept.to(torch.float32).mean()
        if adapt:
            eps = _adapt(eps, acc, target_accept)
        accs.append(acc)
    return x, torch.stack(accs).mean()


def hmc_transition(x, log_prob_fn, n_steps: int, step_size: float, draws,
                   n_leapfrog: int = 5, target_accept: float = 0.65, adapt: bool = True):
    """HMC sweeps of ``n_leapfrog`` leapfrog steps; returns (x, mean
    acceptance). A non-finite acceptance ratio rejects. Each chain's
    log π and gradient are kept from the evaluation that gave them, so a
    sweep evaluates ``log_prob_fn`` ``n_leapfrog`` times, where pita_tpu's
    leapfrog asks for n_leapfrog + 2 gradients and one more log π (XLA
    merges the repeats; eager PyTorch would run them)."""
    lp, g = _log_prob_and_grad(log_prob_fn, x)
    eps = torch.tensor(step_size, dtype=x.dtype, device=x.device)
    accs = []
    for k in range(n_steps):
        p = draws.normal(k, x.shape)
        ke0 = 0.5 * (p ** 2).sum(-1)
        x_new, lp_new, g_new = x, lp, g
        p_new = p + 0.5 * eps * g_new
        for _ in range(n_leapfrog):
            x_new = x_new + eps * p_new
            lp_new, g_new = _log_prob_and_grad(log_prob_fn, x_new)
            p_new = p_new + eps * g_new
        p_new = p_new - 0.5 * eps * g_new
        ke1 = 0.5 * (p_new ** 2).sum(-1)
        log_ratio = (lp_new - lp) + (ke0 - ke1)
        log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio, -math.inf)
        accept = torch.log(draws.uniform(k, lp.shape)) < log_ratio
        x = torch.where(accept[:, None], x_new, x)
        lp = torch.where(accept, lp_new, lp)
        g = torch.where(accept[:, None], g_new, g)
        acc = accept.to(torch.float32).mean()
        if adapt:
            eps = _adapt(eps, acc, target_accept)
        accs.append(acc)
    return x, torch.stack(accs).mean()
