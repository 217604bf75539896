from pita_torch.train.losses import LossConfig, compute_losses
from pita_torch.train.trainer import EnergyTempTrainer, TrainerConfig

__all__ = ["EnergyTempTrainer", "LossConfig", "TrainerConfig", "compute_losses"]
