"""Monte-Carlo noised-energy estimates and score clipping (iDEM).

Counterpart of ``pita_tpu/train/dem_estimator.py``:
``R_t(x) = log E_ε[exp(log p(x + sqrt(h)·ε))]`` over K Gaussian probes (the
DEM energy loss's target), its gradient ∇ₓR_t (the iDEM score target),
Richardson extrapolation, and per-particle score-norm clipping. The probes
are an argument.

``pita_tpu`` differentiates R_t through the target with ``jax.grad``. Here
the gradient is closed-form: with lr_k = log p(x + √h·ε_k),
∇ₓR_t = Σ_k softmax(lr)_k · ∇ log p(x + √h·ε_k), and the target's
``log_prob_and_force`` gives log p and its gradient for all B·K probes in
one call (one launch of the LJ kernel on CUDA). Nothing is differentiated
through that kernel, which has no backward.
"""

import math

import torch


def estimate_Rt(ht, x, log_prob_fn, eps, min_log_reward=None):
    """Batched R_t: ht (B,), x (B, D), ``eps`` (B, K, D) standard normals,
    K the number of MC samples (score_estimator.py:55-67)."""
    B, D = x.shape
    num_mc_samples = eps.shape[1]
    samples = x[:, None, :] + eps * torch.sqrt(ht)[:, None, None]
    log_rewards = log_prob_fn(samples.reshape(-1, D)).reshape(B, -1)
    if min_log_reward is not None:
        log_rewards = torch.clamp(log_rewards, min=min_log_reward)
    return torch.logsumexp(log_rewards, dim=1) - math.log(num_mc_samples)


def estimate_grad_Rt(ht, x, log_prob_and_force, eps, min_log_reward=None):
    """∇ₓR_t, the DEM score target (score_estimator.py:41-52): ht (B,),
    x (B, D), ``eps`` (B, K, D) standard normals, ``log_prob_and_force``
    mapping (n, D) to (log p (n,), ∇ log p (n, D)). A probe whose log p is
    clamped at ``min_log_reward`` contributes no gradient."""
    B, D = x.shape
    samples = x[:, None, :] + eps * torch.sqrt(ht)[:, None, None]
    lp, force = log_prob_and_force(samples.reshape(-1, D))
    lr, force = lp.reshape(B, -1), force.reshape(B, -1, D)
    if min_log_reward is not None:
        force = force * (lr > min_log_reward)[..., None]
        lr = torch.clamp(lr, min=min_log_reward)
    w = torch.softmax(lr, dim=1)
    return (w[..., None] * force).sum(1)


def wrap_for_richardsons(estimator):
    """Richardson extrapolation, 2·est(K) − est(K/2) (score_estimator.py:8-18):
    the wrapped estimator takes the K probes ``eps`` and the K/2 probes
    ``eps_half`` (B, K//2, D) of the second estimate."""

    def _fxn(ht, x, log_prob_fn, eps, eps_half, **kw):
        return 2 * estimator(ht, x, log_prob_fn, eps, **kw) - estimator(ht, x, log_prob_fn,
                                                                        eps_half, **kw)

    return _fxn


def log_expectation_reward(ht, x, log_prob_fn, eps, min_log_reward=None):
    """R_t for one sample x (D,) at noise level ht; ``eps`` (K, D)
    (score_estimator.py:21-38)."""
    return estimate_Rt(torch.as_tensor(ht, dtype=x.dtype, device=x.device).reshape(1),
                       x[None], log_prob_fn, eps[None], min_log_reward)[0]


def clip_scores(scores, max_norm: float, n_particles: int = None, n_spatial_dim: int = None):
    """Per-particle (or per-sample) score-norm clipping (clipper.py:38-50)."""
    eps = 1e-6
    if n_particles is not None and n_particles > 1:
        s = scores.reshape(-1, n_particles, n_spatial_dim)
        norms = torch.linalg.norm(s, dim=-1)
        coef = torch.clamp(max_norm / (norms + eps), max=1.0)
        return (s * coef[..., None]).reshape(scores.shape)
    norms = torch.linalg.norm(scores, dim=-1, keepdim=True)
    return scores * torch.clamp(max_norm / (norms + eps), max=1.0)
