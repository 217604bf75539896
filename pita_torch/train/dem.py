"""DEM pretraining: train the score net before the PITA phase begins.

Counterpart of ``pita_tpu/train/dem.py`` (the reference's
``energytemp_module.py:567-618``): the force-based target-score loss
``pre_training_step`` and its iDEM variant, which regresses the score on the
Monte-Carlo target −∇ₓR_t. The trainer runs it for the first
``num_training_epochs`` epochs and refills buffer 0 by a plain reverse SDE
(``EnergyTempTrainer.eval_epoch_end_dem``). Randomness enters through
``DEMDraws`` or a ``torch.Generator``.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch

from pita_torch.schedules.noise import ElucidatingNoiseSchedule
from pita_torch.train.dem_estimator import clip_scores, estimate_grad_Rt
from pita_torch.utils.mean_free import remove_mean


@dataclasses.dataclass(frozen=True)
class DEMConfig:
    """configs/model/energytemp.yaml:114-131, ``pita_tpu``'s defaults (dem.py:22-38)."""

    num_training_epochs: int = 0
    training_batch_size: int = 512
    num_samples_to_generate_per_epoch: int = 2000
    num_mc_samples: int = 1000
    num_integration_steps: int = 1000
    check_val_every_n_epochs: int = 10
    max_score_norm: float = 100.0
    noise_schedule: ElucidatingNoiseSchedule = ElucidatingNoiseSchedule(
        sigma_min=0.02, sigma_max=2.0, rho=7.0
    )
    use_mc_target: bool = False  # False: the force-based target score (the default)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class DEMDraws(NamedTuple):
    ln_sigma_draw: torch.Tensor  # (B,) the DEM schedule's standard draw of ln σ
    noise: torch.Tensor  # (B, D) standard normals of the noise
    mc_eps: Optional[torch.Tensor] = None  # (B, K, D) the iDEM probes, with use_mc_target


def draw_dem(dem_cfg: DEMConfig, B: int, D: int, generator, device) -> DEMDraws:
    """The draws of one ``pretrain_loss`` call from ``generator``."""
    ln = dem_cfg.noise_schedule.draw_ln_sigma(B, generator, device)
    z = torch.randn((B, D), generator=generator, device=device)
    eps = None
    if dem_cfg.use_mc_target:
        eps = torch.randn((B, dem_cfg.num_mc_samples, D), generator=generator, device=device)
    return DEMDraws(ln, z, eps)


def pretrain_loss(score_wrapper, dem_cfg: DEMConfig, x0, x0_forces, beta, target=None,
                  n_particles: int = 1, n_spatial_dim: int = 1, mean_free: bool = False,
                  draws: DEMDraws = None, generator=None):
    """One pretraining loss (dem.py:42-83): the mean over the batch of the
    squared error of the score net's denoiser against xt − clip(−force)·h,
    or with ``use_mc_target`` of its score against −clip(∇ₓR_t)."""
    B, D = x0.shape
    if draws is None:
        draws = draw_dem(dem_cfg, B, D, generator, x0.device)
    ln_sigma = dem_cfg.noise_schedule.sample_ln_sigma(B, draws.ln_sigma_draw)
    ht = torch.exp(2 * ln_sigma)
    z = draws.noise
    if mean_free:
        z = remove_mean(z, n_particles, n_spatial_dim)
        x0 = remove_mean(x0, n_particles, n_spatial_dim)
    xt = x0 + z * torch.sqrt(ht)[:, None]

    if dem_cfg.use_mc_target:
        if target is None:
            raise ValueError("the iDEM target needs the target density")
        pred = score_wrapper.score(ht, xt, beta)
        with torch.no_grad():
            nabla_Ut = -estimate_grad_Rt(ht, xt.detach(), target.log_prob_and_force,
                                         draws.mc_eps)
            nabla_Ut = clip_scores(nabla_Ut, dem_cfg.max_score_norm, n_particles, n_spatial_dim)
        return ((nabla_Ut - pred) ** 2).sum(-1).mean()

    D_score = score_wrapper.denoiser(ht, xt, beta)
    nabla_U0 = clip_scores(-x0_forces, dem_cfg.max_score_norm, n_particles, n_spatial_dim)
    target_x0 = xt - nabla_U0 * ht[:, None]
    return ((target_x0 - D_score) ** 2).sum(-1).mean()
