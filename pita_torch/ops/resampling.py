"""SMC resampling on the device.

Counterpart of ``pita_tpu/ops/resampling.py``: ``systematic_resample``
(:19-36), ``count_unique`` (:39-42), ``qmc_resample`` (:45-67) and
``birth_death_resample`` (:70-92). The random draws are passed in (the
systematic or QMC offset; the birth–death replacement ids and Exp(1)
thresholds), so a caller can replay another generator's draws.
"""

import torch


def _clipped_cdf(log_weights: torch.Tensor) -> torch.Tensor:
    """CDF of the softmax of the log-weights, each weight clipped to [1e-6, 1]."""
    w = torch.clamp(torch.softmax(log_weights.float(), dim=0), 1e-6, 1.0)
    return torch.cumsum(w, dim=0)


def systematic_resample(log_weights: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
    """Systematic categorical resampling; log_weights (B,), u0 a scalar in
    [0, 1). Returns (B,) int64 ancestor indices."""
    B = log_weights.shape[0]
    ar = torch.arange(B, dtype=torch.float32, device=log_weights.device)
    u = (u0.to(torch.float32) + ar / B) % 1.0
    # np.digitize(u, bins, right=True) == searchsorted(bins, u, side='left')
    idx = torch.searchsorted(_clipped_cdf(log_weights), u, right=False)
    return torch.clamp(idx, 0, B - 1)


def count_unique(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Number of distinct values in ``idx`` (all < size), without a host sync."""
    hits = torch.zeros(size, dtype=torch.int32, device=idx.device)
    hits[idx] = 1
    return hits.sum()


def qmc_resample(log_weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Low-discrepancy categorical resampling: the CDF inverted at a van der
    Corput (base-2 radical inverse) sequence of B points shifted by the
    uniform offset ``u`` (a scalar in [0, 1)) mod 1. Returns (B,) int64
    ancestor indices."""
    B = log_weights.shape[0]
    v = torch.arange(B, dtype=torch.int64, device=log_weights.device)
    # reverse the 32 bits of i (int64 holds them without a sign)
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        v = ((v & mask) << shift) | ((v >> shift) & mask)
    v = ((v << 16) | (v >> 16)) & 0xFFFFFFFF
    rad = v.to(torch.float32) / 2.0 ** 32
    pts = torch.sort((rad + u.to(torch.float32)) % 1.0).values
    idx = torch.searchsorted(_clipped_cdf(log_weights), pts, right=False)
    return torch.clamp(idx, 0, B - 1)


def birth_death_resample(accum_birth, accum_death, thresh_times, replace_ids, new_thresh):
    """Birth–death clock resampling (global-transition variant): chains whose
    accumulated death clock reached their threshold take the replacement id
    drawn for them (``replace_ids``, (B,), categorical draws with
    probabilities proportional to ``accum_birth``), a fresh threshold
    (``new_thresh``, (B,) Exp(1) draws) and reset clocks.

    Returns (ids, accum_birth, accum_death, thresh_times, n_killed).
    """
    B = accum_birth.shape[0]
    death = accum_death >= thresh_times
    ids = torch.where(death, replace_ids.to(torch.int64),
                      torch.arange(B, dtype=torch.int64, device=accum_birth.device))
    thresh_times = torch.where(death, new_thresh.to(thresh_times.dtype), thresh_times)
    accum_birth = torch.where(death, torch.zeros_like(accum_birth), accum_birth)
    accum_death = torch.where(death, torch.zeros_like(accum_death), accum_death)
    return ids, accum_birth, accum_death, thresh_times, death.sum()
