from pita_torch.fab.ais import AISConfig, FabDraws, annealed_importance_sampling
from pita_torch.fab.fab_model import (
    FABConfig,
    fab_loss,
    train_fab,
    train_fab_with_prioritised_buffer,
)
from pita_torch.fab.flow import FlowDistribution, RealNVP
from pita_torch.fab.targets import DoubleWell1D, GaussianTarget, ManyWell
from pita_torch.fab.transition_operators import hmc_transition, metropolis_transition

__all__ = ["AISConfig", "DoubleWell1D", "FABConfig", "FabDraws", "FlowDistribution",
           "GaussianTarget", "ManyWell", "RealNVP", "annealed_importance_sampling", "fab_loss",
           "hmc_transition", "metropolis_transition", "train_fab",
           "train_fab_with_prioritised_buffer"]
