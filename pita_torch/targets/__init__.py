from pita_torch.targets.alp import ALPEnergy
from pita_torch.targets.base import Target
from pita_torch.targets.lj import LJ13, LJ55, LennardJones

__all__ = ["ALPEnergy", "LJ13", "LJ55", "LennardJones", "Target"]
