from pita_torch.metrics.distances import (
    emd_1d_unequal,
    energy_distances,
    interatomic_dist_w2,
)
from pita_torch.metrics.ess import effective_sample_size, log_effective_sample_size

__all__ = [
    "effective_sample_size",
    "emd_1d_unequal",
    "energy_distances",
    "interatomic_dist_w2",
    "log_effective_sample_size",
]
