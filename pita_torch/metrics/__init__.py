from pita_torch.metrics.distances import emd_1d_unequal
from pita_torch.metrics.ess import effective_sample_size, log_effective_sample_size

__all__ = ["effective_sample_size", "emd_1d_unequal", "log_effective_sample_size"]
