from pita_torch.metrics.distances import (
    compute_distribution_distances,
    emd_1d_unequal,
    energy_distances,
    interatomic_dist_w2,
    sinkhorn_divergence,
    torus_wasserstein,
    wasserstein1_exact,
    wasserstein2_exact,
)
from pita_torch.metrics.ess import effective_sample_size, log_effective_sample_size
from pita_torch.metrics.mmd import linear_mmd2, mix_rbf_mmd2, poly_mmd2

__all__ = [
    "compute_distribution_distances",
    "effective_sample_size",
    "emd_1d_unequal",
    "energy_distances",
    "interatomic_dist_w2",
    "linear_mmd2",
    "log_effective_sample_size",
    "mix_rbf_mmd2",
    "poly_mmd2",
    "sinkhorn_divergence",
    "torus_wasserstein",
    "wasserstein1_exact",
    "wasserstein2_exact",
]
