from pita_torch.targets.base import Target
from pita_torch.targets.lj import LJ13, LJ55, LennardJones

__all__ = ["LJ13", "LJ55", "LennardJones", "Target"]
