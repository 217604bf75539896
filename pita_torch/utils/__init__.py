from pita_torch.utils.device import resolve_device
from pita_torch.utils.mean_free import remove_mean

__all__ = ["remove_mean", "resolve_device"]
