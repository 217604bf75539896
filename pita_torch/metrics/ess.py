"""Effective sample size of importance weights.

Counterpart of ``pita_tpu/metrics/ess.py:11-21``: ESS = 1 / E[w̄²] with
normalized weights, in log space.
"""

import torch


def log_effective_sample_size(log_w: torch.Tensor) -> torch.Tensor:
    """log ESS (in [0, log N])."""
    log_norm = log_w - torch.logsumexp(log_w, dim=0)
    return -torch.logsumexp(2 * log_norm, dim=0)


def effective_sample_size(log_w: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    ess = torch.exp(log_effective_sample_size(log_w))
    if normalize:
        ess = ess / log_w.shape[0]
    return ess
