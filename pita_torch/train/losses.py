"""The PITA multi-loss training objective.

Counterpart of ``pita_tpu/train/losses.py:37-216``: six weighted losses on
buffer samples at a noise level ln σ drawn by the schedule's
``sample_ln_sigma`` (N(P_mean, P_std²) for Elucidating):

1. score matching: denoiser MSE to x0 with the EDM weight λ(h) = (h+1)/h,
   gated to h ≥ h(time_threshold_score);
2. energy-score distillation: the energy net's denoiser x − h·∇ₓE_θ matches
   the score net's, which is detached (the reference detaches, :450);
3. target score: force-based denoising target x̂0 = xt − clip(−force)·h,
   averaged over the subset h < h(time_threshold_target_score);
4. DEM energy: MC-estimated noised energy regression on the small-noise
   subset, masked at |U| > energy_threshold;
5. energy matching: U_θ(h0, x0) ≈ −log p(x0), masked at the threshold;
6. dU/dt L2 regularization (summed over the batch, as the reference does).

The gradient flows to both nets from one ``backward``; the energy-score term
differentiates ∇ₓE_θ again in the weights, which takes backbones on the
``"autograd"`` route (``pita_torch.nets.egnn``). Randomness enters through
``LossDraws`` (the schedule's standard draw of ln σ, the standard
normals of the noise and of the DEM probes) or a ``torch.Generator``.

With a ``group`` (``pita_torch.parallel``) the batch is one rank's rows of a
global batch and every loss is this rank's share of the global loss: a mean
is the local sum over the global batch size, a subset mean the local sum
over the global subset's size. The shares' gradients sum over the ranks to
the global loss's gradient.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from pita_torch.train.dem_estimator import clip_scores, estimate_Rt
from pita_torch.utils.mean_free import remove_mean


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights and gates (configs/model/energytemp.yaml:96-110)."""

    w_energy_score: float = 1.0
    w_score: float = 1.0
    w_energy_matching: float = 1.0
    w_target_score: float = 0.01
    w_dem_energy: float = 0.0
    w_dU_dt_regularization: float = 0.0
    time_threshold_score: float = 0.0
    time_threshold_target_score: float = 0.2
    dem_time_threshold: float = 0.2
    dem_num_mc_samples: int = 1000
    energy_threshold: float = 1e3
    max_score_norm: float = 1000.0
    only_train_score: bool = False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class LossDraws(NamedTuple):
    # (B,) the schedule's standard draw of ln σ (draw_ln_sigma): normals for
    # Elucidating, uniforms on [0, 1) for Geometric
    ln_sigma_draw: torch.Tensor
    noise: torch.Tensor  # (B, D) standard normals of the noise
    dem_eps: Optional[torch.Tensor] = None  # (B, K, D) DEM probes, when that loss is on


def draw_losses(cfg: LossConfig, noise_schedule, B: int, D: int, generator,
                device) -> LossDraws:
    """The draws of one ``compute_losses`` call from ``generator``."""
    ln = noise_schedule.draw_ln_sigma(B, generator, device)
    z = torch.randn((B, D), generator=generator, device=device)
    dem = None
    if cfg.w_dem_energy > 0:
        dem = torch.randn((B, cfg.dem_num_mc_samples, D), generator=generator, device=device)
    return LossDraws(ln, z, dem)


def _mean(per_sample, group=None):
    """The batch mean, or with a group this rank's share of the global one."""
    if group is None:
        return per_sample.mean()
    return per_sample.sum() / (per_sample.shape[0] * group.world_size)


def _subset_mean(per_sample, mask, group=None):
    """Mean over the masked subset (the reference indexes the subset, then
    .mean()); with a group this rank's share of the global subset's mean."""
    count = mask.to(per_sample.dtype).sum()
    if group is not None:
        count = group.sum(count)
    return (per_sample * mask).sum() / count.clamp_min(1.0)


def _h_at(noise_schedule, t, like):
    return noise_schedule.h(torch.tensor(t, dtype=like.dtype, device=like.device))


def compute_losses(score_wrapper, energy_wrapper, noise_schedule, cfg: LossConfig, x0,
                   x0_energies, x0_forces, beta, target=None, n_particles: int = 1,
                   n_spatial_dim: int = 1, mean_free: bool = False, draws: LossDraws = None,
                   generator=None, group=None):
    """Returns (total loss, aux) for one batch (energytemp_module.py:323-390,620-694).

    ``x0_energies`` are log-probabilities and ``x0_forces`` their gradients,
    as the buffer stores them.
    """
    B, D = x0.shape
    if draws is None:
        draws = draw_losses(cfg, noise_schedule, B, D, generator, x0.device)
    ln_sigma = noise_schedule.sample_ln_sigma(B, draws.ln_sigma_draw)
    ht = torch.exp(2 * ln_sigma)
    h0 = noise_schedule.h(torch.zeros_like(ht))

    z = draws.noise
    if mean_free:
        z = remove_mean(z, n_particles, n_spatial_dim)
        x0 = remove_mean(x0, n_particles, n_spatial_dim)
    xt = x0 + z * torch.sqrt(ht)[:, None]
    lambda_t = (ht + 1.0) / ht
    zero = torch.zeros((), dtype=x0.dtype, device=x0.device)
    zeros_b = torch.zeros(B, dtype=x0.dtype, device=x0.device)

    D_score = score_wrapper.denoiser(ht, xt, beta)

    # 1. score matching (:392-415)
    if cfg.w_score > 0:
        t_mask = ht >= _h_at(noise_schedule, cfg.time_threshold_score, ht)
        score_loss_vec = lambda_t * (((D_score - x0) ** 2).sum(-1) * t_mask)
        score_loss = _mean(score_loss_vec, group)
    else:
        score_loss_vec, score_loss = zeros_b, zero

    if cfg.only_train_score:
        total = cfg.w_score * score_loss
        aux = {
            "loss": total, "score_loss": score_loss, "energy_score_loss": zero,
            "target_score_loss": zero, "dem_energy_loss": zero,
            "energy_matching_loss": zero, "dU_dt_regularization_loss": zero,
            "ln_sigma": ln_sigma, "score_loss_per_sample": score_loss_vec,
            "energy_score_loss_per_sample": zeros_b,
        }
        return total, aux

    # 3. target score (:457-495): force-based denoising target near t=0
    if cfg.w_target_score > 0:
        ts_mask = ht < _h_at(noise_schedule, cfg.time_threshold_target_score, ht)
        nabla_U0 = clip_scores(-x0_forces, cfg.max_score_norm, n_particles, n_spatial_dim)
        target_x0 = xt - nabla_U0 * ht[:, None]
        target_score_loss = _subset_mean(((target_x0 - D_score) ** 2).sum(-1), ts_mask,
                                         group)
    else:
        target_score_loss = zero

    # 2. energy-score distillation (:417-455) + dU/dt by the chain rule
    need_Ut = cfg.w_dem_energy > 0
    if cfg.w_energy_score > 0:
        D_energy, dU_dh, U_t = energy_wrapper.denoiser_and_energy(ht, xt, beta)
        dU_dt = dU_dh * noise_schedule.dh_dt(noise_schedule.t(ht))
        es_loss_vec = lambda_t * ((D_energy - D_score.detach()) ** 2).sum(-1)
        energy_score_loss = _mean(es_loss_vec, group)
    else:
        U_t = energy_wrapper.energy(ht, xt, beta) if need_Ut else zeros_b
        dU_dt, es_loss_vec, energy_score_loss = zeros_b, zeros_b, zero

    # 5. energy matching at h0 (:541-565)
    if cfg.w_energy_matching > 0:
        U0_true = -x0_energies
        em_mask = U0_true <= cfg.energy_threshold
        U0_pred = energy_wrapper.energy(h0, x0, beta)
        energy_matching_loss = _mean((U0_true - U0_pred) ** 2 * em_mask, group)
    else:
        energy_matching_loss = zero

    # 4. DEM energy regression (:497-523)
    if cfg.w_dem_energy > 0 and target is not None:
        dem_mask = ht < _h_at(noise_schedule, cfg.dem_time_threshold, ht)
        Ut_est = -estimate_Rt(ht, xt, target.log_prob, draws.dem_eps)
        ok = Ut_est <= cfg.energy_threshold
        dem_energy_loss = _subset_mean((Ut_est - U_t) ** 2 * ok, dem_mask, group)
    else:
        dem_energy_loss = zero

    # 6. dU/dt L2 regularization (:379-382; the reference sums over the batch)
    dU_dt_reg = (dU_dt ** 2).sum() if cfg.w_dU_dt_regularization > 0 else zero

    total = (
        cfg.w_energy_score * energy_score_loss
        + cfg.w_score * score_loss
        + cfg.w_target_score * target_score_loss
        + cfg.w_dem_energy * dem_energy_loss
        + cfg.w_energy_matching * energy_matching_loss
        + cfg.w_dU_dt_regularization * dU_dt_reg
    )
    aux = {
        "loss": total,
        "score_loss": score_loss,
        "energy_score_loss": energy_score_loss,
        "target_score_loss": target_score_loss,
        "dem_energy_loss": dem_energy_loss,
        "energy_matching_loss": energy_matching_loss,
        "dU_dt_regularization_loss": dU_dt_reg,
        # for the ln-sigma-stratified diagnostics (energytemp_module.py:300-321)
        "ln_sigma": ln_sigma,
        "score_loss_per_sample": score_loss_vec,
        "energy_score_loss_per_sample": es_loss_vec,
    }
    return total, aux


def stratified_losses(ln_sigma, per_sample_loss, bin_edges, loss_name="loss"):
    """Per-sample losses binned by ln σ (energytemp_module.py:300-321), on the host."""
    ln_sigma = np.asarray(ln_sigma).ravel()
    losses = np.asarray(per_sample_loss).ravel()
    edges = np.asarray(bin_edges)
    num_bins = len(edges) - 1
    idx = np.clip(np.digitize(ln_sigma, edges), 0, num_bins - 1)
    sums = np.bincount(idx, weights=losses, minlength=num_bins)
    counts = np.bincount(idx, minlength=num_bins)
    return {
        f"{loss_name} ln_sigma=[{edges[b]:.2f},{edges[b + 1]:.2f})": sums[b] / max(counts[b], 1)
        for b in np.unique(idx)
    }
