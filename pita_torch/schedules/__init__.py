from pita_torch.schedules.annealing import (
    AnnealingSchedule,
    ConstantAnnealingSchedule,
    LinearAnnealingSchedule,
    SigmoidAnnealingSchedule,
)
from pita_torch.schedules.noise import (
    ElucidatingNoiseSchedule,
    GeometricNoiseSchedule,
    LinearNoiseSchedule,
    NoiseSchedule,
    PowerNoiseSchedule,
    QuadraticNoiseSchedule,
    SubLinearNoiseSchedule,
)

__all__ = [
    "AnnealingSchedule",
    "ConstantAnnealingSchedule",
    "ElucidatingNoiseSchedule",
    "GeometricNoiseSchedule",
    "LinearAnnealingSchedule",
    "LinearNoiseSchedule",
    "NoiseSchedule",
    "PowerNoiseSchedule",
    "QuadraticNoiseSchedule",
    "SigmoidAnnealingSchedule",
    "SubLinearNoiseSchedule",
]
