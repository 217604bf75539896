"""SMC resampling on the device.

Counterpart of ``pita_tpu/ops/resampling.py:19-42``. The systematic uniform
``u0`` is passed in, so a caller can replay another generator's draws.
"""

import torch


def systematic_resample(log_weights: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
    """Systematic categorical resampling; log_weights (B,), u0 a scalar in
    [0, 1). Returns (B,) int64 ancestor indices."""
    B = log_weights.shape[0]
    ar = torch.arange(B, dtype=torch.float32, device=log_weights.device)
    u = (u0.to(torch.float32) + ar / B) % 1.0
    w = torch.clamp(torch.softmax(log_weights.float(), dim=0), 1e-6, 1.0)
    cdf = torch.cumsum(w, dim=0)
    # np.digitize(u, bins, right=True) == searchsorted(bins, u, side='left')
    idx = torch.searchsorted(cdf, u, right=False)
    return torch.clamp(idx, 0, B - 1)


def count_unique(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Number of distinct values in ``idx`` (all < size), without a host sync."""
    hits = torch.zeros(size, dtype=torch.int32, device=idx.device)
    hits[idx] = 1
    return hits.sum()
