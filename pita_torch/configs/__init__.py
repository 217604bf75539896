from pita_torch.configs.registry import (
    DEBUG_OVERLAYS,
    EXPERIMENTS,
    ExperimentConfig,
    build_trainer,
    compose,
    parse_overrides,
)

__all__ = [
    "DEBUG_OVERLAYS",
    "EXPERIMENTS",
    "ExperimentConfig",
    "build_trainer",
    "compose",
    "parse_overrides",
]
