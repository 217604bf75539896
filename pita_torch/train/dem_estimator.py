"""Monte-Carlo noised-energy estimate and score clipping (iDEM).

Counterpart of ``pita_tpu/train/dem_estimator.py:17-37,65-76``:
``R_t(x) = log E_ε[exp(log p(x + sqrt(h)·ε))]`` over ``num_mc_samples``
Gaussian probes (the DEM energy loss's target), and per-particle score-norm
clipping. The probes are an argument.
``estimate_grad_Rt`` and ``wrap_for_richardsons`` are not ported.
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
