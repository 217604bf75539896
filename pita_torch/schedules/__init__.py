from pita_torch.schedules.annealing import (
    AnnealingSchedule,
    ConstantAnnealingSchedule,
    LinearAnnealingSchedule,
    SigmoidAnnealingSchedule,
)
from pita_torch.schedules.noise import ElucidatingNoiseSchedule, NoiseSchedule

__all__ = [
    "AnnealingSchedule",
    "ConstantAnnealingSchedule",
    "ElucidatingNoiseSchedule",
    "LinearAnnealingSchedule",
    "NoiseSchedule",
    "SigmoidAnnealingSchedule",
]
