from pita_torch.targets.alp import ALPEnergy
from pita_torch.targets.base import Target
from pita_torch.targets.dw4 import DoubleWell4
from pita_torch.targets.gmm import GMM40, gmm_power, gmm_product
from pita_torch.targets.lj import LJ13, LJ55, LennardJones

__all__ = ["ALPEnergy", "DoubleWell4", "GMM40", "LJ13", "LJ55", "LennardJones", "Target",
           "gmm_power", "gmm_product"]
