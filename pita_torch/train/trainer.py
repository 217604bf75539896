"""EnergyTempTrainer: training down the temperature ladder.

Counterpart of ``pita_tpu/train/trainer.py`` (``fill_with_quality_floor``
:82, ``TrainerConfig`` :163, ``EnergyTempTrainer`` :253):

- twin score and energy backbones on the ``"autograd"`` route (the energy
  net starts as a copy of the score net, :305-307) with EMA shadows on the
  route the backbone names as its ``sampler_route``, which the sampler runs:
  ``"kernels"`` for a 3-D EGNN, ``"autograd"`` for a 2-D one (DW4), the
  MLP (GMM), TorchMD-ET and the DiT3D of the peptide presets;
- a per-rung replay buffer, seeded from the rung-0 train set or the prior;
- the ladder: the active rung from the epoch by the cumulative
  ``num_epochs_per_temp``;
- training epochs of ``n_train_batches_per_epoch`` buffer batches with SO(3)
  and CoM augmentation, the six losses, global-norm clipping and Adam in
  optax's form over both nets at once, and an EMA update after every step;
- evaluation: annealed sampling through ``pita_torch.sampler.integrate_sde``
  in chain islands of at most ``max_chains_per_integrate``, and at a rung
  transition the next rung's buffer fill, with the measured-quality floor
  and its escalation;
- the test phase over ladder pairs, and atomic checkpoints;
- with a ``DEMConfig`` (``dem_cfg``), DEM pretraining first (:510-620):
  ``num_training_epochs`` epochs of the score net on ``pretrain_loss`` over
  buffer 0, which starts from the prior, with a plain reverse-SDE refill of
  buffer 0 every ``check_val_every_n_epochs`` epochs; the ladder starts after
  them;
- the evaluation figures (``make_plots``, :1066-1092) and the target's
  ``log_on_epoch_end`` hook.

A JAX epoch is one jitted ``lax.scan``; here it is a Python loop of steps
that never wait on the device (the rung of each batch is drawn once an
epoch). Randomness comes from the trainer's ``torch.Generator`` (seeded with
``cfg.seed``); ``train_step`` and ``dem_train_step`` also take their draws
as an argument (``StepDraws``, ``DEMStepDraws``), so a test can feed them
the numbers JAX drew. ``prewarm_eval_compiles`` (:729) warms XLA compiles
and has no counterpart here.
"""

import dataclasses
import math
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pita_torch.metrics.distances import energy_distances, interatomic_dist_w2
from pita_torch.metrics.ess import effective_sample_size
from pita_torch.nets.ema import EMA
from pita_torch.nets.precondition import EnergyWrapper, ScoreWrapper
from pita_torch.sampler.integrator import GeneratorDraws, IntegratorConfig, integrate_sde
from pita_torch.targets.priors import Prior
from pita_torch.train.augment import com_augment, rotate_augment
from pita_torch.train.buffer import (
    buffer_add,
    buffer_init,
    buffer_sample,
    buffer_set,
    buffer_view,
    sample_indices,
    stack_buffers,
)
from pita_torch.train.dem import DEMDraws, draw_dem, pretrain_loss
from pita_torch.train.losses import LossConfig, LossDraws, compute_losses, draw_losses
from pita_torch.train.losses import stratified_losses
from pita_torch.train.optim import adam_init, adam_update, clip_by_global_norm, make_lr_schedule
from pita_torch.utils.device import resolve_device
from pita_torch.utils.tracing import span


def fill_with_quality_floor(sample_fn, integrator_cfg, trainer_cfg, n_request: int,
                            fill_floor=None, fill_cfg=None):
    """The transition fill with the measured-quality floor and its escalation.

    ``sample_fn(n_request, fill_cfg) -> (res, res_nores, energies, forces)``.
    A fill whose raw ESS (from the no-resampling pass) is below
    ``fill_floor`` is retried with ESS-triggered resampling, more MALA steps
    and more chains, up to ``transition_fill_max_retries`` times; the attempt
    with the most effective samples (ESS × chains) wins. Returns
    ``((res, res_nores, energies, forces), fill_info, fill_cfg)``, with
    ``fill_info`` {} when no floor is active. (``pita_tpu`` also retries a
    sample after a TPU runtime error; there is nothing to retry here.)
    """
    cfg = trainer_cfg
    fill_attempt, best = 0, None
    while True:
        out = sample_fn(n_request, fill_cfg)
        res, res_nores = out[0], out[1]
        if fill_floor is None:
            return out, {}, fill_cfg
        used_cfg = fill_cfg or integrator_cfg
        lw_f = min(used_cfg.end_resampling_step, used_cfg.num_integration_steps) - 1
        fill_ess_v = float(effective_sample_size(res_nores.logweights[lw_f], normalize=True))
        eff = fill_ess_v * res.samples.shape[0]
        if best is None or eff > best[0]:
            best = (eff, fill_ess_v, out)
        if (fill_ess_v >= fill_floor or eff >= cfg.transition_fill_effective_floor
                or fill_attempt >= cfg.transition_fill_max_retries):
            break
        fill_attempt += 1
        base_fill = fill_cfg or integrator_cfg
        fill_cfg = base_fill.replace(
            post_mcmc_steps=base_fill.post_mcmc_steps + cfg.transition_fill_extra_mcmc,
            ess_resampling_threshold=(base_fill.ess_resampling_threshold
                                      or cfg.transition_ess_threshold or 0.3),
        )
        n_request = int(n_request * cfg.transition_fill_chain_multiplier)
        print(f"[trainer] transition fill ESS {fill_ess_v:.4f} below floor {fill_floor}; "
              f"retry {fill_attempt} with {n_request} chains, {fill_cfg.post_mcmc_steps} "
              f"MALA steps")
    eff, fill_ess_v, out = best
    fill_info = {
        "fill_ess": fill_ess_v,
        "fill_effective_samples": eff,
        "fill_attempts": float(fill_attempt),
        "fill_below_floor": float(fill_ess_v < fill_floor
                                  and eff < cfg.transition_fill_effective_floor),
    }
    return out, fill_info, fill_cfg


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Ladder and loop configuration (configs/model/energytemp.yaml and the
    experiment overlays); the fields of pita_tpu's TrainerConfig, with its
    defaults and meanings (trainer.py:163-247)."""

    temperatures: tuple = (4.0, 3.0, 2.0, 1.5, 1.2, 1.0)
    num_epochs_per_temp: tuple = (150, 200, 150, 200, 300)
    max_epochs: Optional[int] = None  # default: the ladder's end
    n_train_batches_per_epoch: int = 250
    training_batch_size: int = 512
    check_val_every_n_epoch: int = 100
    lr: float = 1e-3
    grad_clip: float = 0.5
    # chains per integrate call; larger requests run in islands of this size
    max_chains_per_integrate: Optional[int] = 1024
    ema_decay: float = 0.999
    eval_ema: bool = True
    buffer_capacity: int = 60000
    num_init_samples: int = 10000
    num_eval_samples: int = 2048
    num_temp_annealed_samples: int = 5000
    num_samples_to_save: int = 10000
    test_batch_size: int = 5000
    energy_masking_threshold: float = 1e3
    train_on_all_temps: bool = True
    init_from_prior: bool = False
    reinitialize_networks: bool = False
    prioritize_buffer: bool = False
    sample_with_replacement: bool = True
    make_plots: bool = False
    should_mean_free: bool = True
    precondition_beta: bool = False
    seed: int = 12345
    dem_num_training_epochs: int = 0  # set from dem_cfg when one is given
    skip_temp: bool = False
    num_skip_temps: int = 1
    # transition fills (trainer.py:206-234): ESS-triggered resampling and
    # extra MALA for fills, and the fill-quality floor with its escalation
    transition_ess_threshold: Optional[float] = None
    transition_post_mcmc_steps: Optional[int] = None
    transition_min_fill_ess: Optional[float] = None
    transition_fill_max_retries: int = 2
    transition_fill_chain_multiplier: float = 2.0
    transition_fill_extra_mcmc: int = 30
    transition_fill_effective_floor: float = 100.0
    temps_to_anneal_test: Optional[tuple] = None
    lr_schedule: str = "constant"  # "constant" | "cosine" | "exponential"
    lr_decay_rate: float = 0.99
    lr_min_fraction: float = 0.1
    early_stopping_metric: Optional[str] = None
    early_stopping_patience: int = 3
    early_stopping_min_delta: float = 0.0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class StepDraws(NamedTuple):
    """The random numbers of one training step."""

    idx: torch.Tensor  # (batch,) buffer rows
    rot_normal: Optional[torch.Tensor]  # (batch, d, d) Gaussians of the rotations
    com_normal: Optional[torch.Tensor]  # (batch, 1, d) CoM jitter, when not mean-free
    loss: LossDraws


class DEMStepDraws(NamedTuple):
    """The random numbers of one DEM pretraining step."""

    idx: torch.Tensor  # (batch,) rows of buffer 0
    rot_normal: Optional[torch.Tensor]  # (batch, d, d) Gaussians of the rotations
    loss: DEMDraws


class EnergyTempTrainer:
    def __init__(self, target, backbone_factory: Callable, noise_schedule,
                 annealing_schedule_factory: Callable, loss_cfg: LossConfig,
                 integrator_cfg: IntegratorConfig, cfg: TrainerConfig,
                 out_dir: str = "outputs", logger=None, dem_cfg=None, device=None):
        if dem_cfg is not None and dem_cfg.num_training_epochs != cfg.dem_num_training_epochs:
            cfg = cfg.replace(dem_num_training_epochs=dem_cfg.num_training_epochs)
        self.dem_cfg = dem_cfg
        self.device = resolve_device(device)
        self.cfg = cfg
        self.loss_cfg = loss_cfg
        self.integrator_cfg = integrator_cfg
        self.noise_schedule = noise_schedule
        self.make_annealing = annealing_schedule_factory
        self.out_dir = out_dir
        self.logger = logger
        os.makedirs(out_dir, exist_ok=True)

        self.dim = target.dim
        self.n_particles = getattr(target, "n_particles", 1)
        self.n_spatial_dim = getattr(target, "n_spatial_dim", self.dim)
        self.is_molecule = getattr(target, "is_molecule", False)
        self.mean_free = cfg.should_mean_free and self.is_molecule

        temps = np.asarray(cfg.temperatures, dtype=np.float64)
        self.temperatures = temps
        # β_i = round(T_0 / T_i, 2) (energytemp_module.py:180-184)
        self.inverse_temperatures = np.round(temps[0] / temps, 2)
        self.n_temps = len(temps)
        self.targets = [target.at_temperature(float(T)) for T in temps]
        if cfg.num_epochs_per_temp is not None:
            if len(cfg.num_epochs_per_temp) != self.n_temps - 1:
                raise ValueError("num_epochs_per_temp needs one entry per rung transition")
            # the ladder starts after the DEM epochs (:294-298)
            self.update_temp_epoch = (np.cumsum(cfg.num_epochs_per_temp)
                                      + cfg.dem_num_training_epochs)
        else:
            if self.n_temps != 1:
                raise ValueError("a ladder of several rungs needs num_epochs_per_temp")
            self.update_temp_epoch = np.asarray([], dtype=np.int64)

        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.score_net = backbone_factory().to(self.device)
        if getattr(self.score_net, "route", None) != "autograd":
            raise ValueError("the trainer trains backbones on the 'autograd' route")
        self.score = ScoreWrapper(self.score_net, precondition_beta=cfg.precondition_beta)
        self.energy_net = None
        self._reinitialize_networks()

        total_steps = (int(cfg.max_epochs or np.sum(cfg.num_epochs_per_temp or [100]))
                       * cfg.n_train_batches_per_epoch)
        self.lr_at = make_lr_schedule(cfg.lr_schedule, cfg.lr, total_steps,
                                      cfg.n_train_batches_per_epoch, cfg.lr_decay_rate,
                                      cfg.lr_min_fraction)
        self.buffers = stack_buffers([buffer_init(cfg.buffer_capacity, self.dim, self.device)
                                      for _ in range(self.n_temps)])
        self.epoch = 0
        self.metrics_history = []
        self._last_n_islands = 1

    def _reinitialize_networks(self):
        """Fresh score weights from flax's distributions, the energy net a
        copy of them (:305-312, :1094-1101), new EMA shadows and optimizer
        state."""
        self.score_net.reset_parameters(self.generator)
        if self.energy_net is None:
            self.energy_net = self.score_net.with_route("autograd")
            self.energy = EnergyWrapper(self.energy_net,
                                        precondition_beta=self.cfg.precondition_beta)
        else:
            with torch.no_grad():
                for p, q in zip(self.energy_net.parameters(), self.score_net.parameters()):
                    p.copy_(q)
        self.ema_score = EMA(self.score_net)
        self.ema_energy = EMA(self.energy_net)
        self.params = list(self.score_net.parameters()) + list(self.energy_net.parameters())
        self.opt_state = adam_init(self.params)

    # ---------------------------------------------------------------- setup

    def active_temp_index(self, epoch: Optional[int] = None) -> int:
        """Rung active at ``epoch`` (energytemp_module.py:195-200)."""
        epoch = self.epoch if epoch is None else epoch
        return int(np.searchsorted(self.update_temp_epoch, epoch, side="right"))

    @property
    def t_start(self) -> float:
        """Integration start time = times[start_resampling_step] (:192-193)."""
        n = self.integrator_cfg.num_integration_steps
        return float(np.linspace(1.0, 0.0, n + 1)[self.integrator_cfg.start_resampling_step])

    def _h_start(self) -> float:
        return float(self.noise_schedule.h(torch.tensor(self.t_start, dtype=torch.float32)))

    def _prior(self, annealing_factor: float):
        gamma_start = float(self.make_annealing(annealing_factor).gamma(
            torch.tensor(self.t_start, dtype=torch.float32)))
        return Prior(scale=math.sqrt(self._h_start() / gamma_start),
                     n_particles=self.n_particles, spatial_dim=self.n_spatial_dim,
                     dim=self.dim, should_mean_free=self.mean_free)

    def populate_initial_buffer(self):
        """Fill the rung-0 buffer from the train set, or from the prior with
        ``init_from_prior`` or a DEM phase (:378-393)."""
        if self.cfg.init_from_prior or self.cfg.dem_num_training_epochs > 0:
            prior = Prior(scale=math.sqrt(self._h_start()), n_particles=self.n_particles,
                          spatial_dim=self.n_spatial_dim, dim=self.dim,
                          should_mean_free=self.mean_free)
            x = prior.sample(self.cfg.num_init_samples, generator=self.generator,
                             device=self.device)
        else:
            x = self.targets[0].sample_train_set(self.cfg.num_init_samples, self.generator)
        energies, forces = self.targets[0].log_prob_and_force(x)
        buf0 = buffer_add(buffer_view(self.buffers, 0), x, energies, forces)
        self.buffers = buffer_set(self.buffers, 0, buf0)

    # ------------------------------------------------------------ train step

    def draw_step(self, temp_idx: int) -> StepDraws:
        """One step's draws from the trainer's generator."""
        cfg, gen, dev = self.cfg, self.generator, self.device
        B, d = cfg.training_batch_size, self.n_spatial_dim
        idx = sample_indices(buffer_view(self.buffers, temp_idx), B, cfg.prioritize_buffer,
                             cfg.sample_with_replacement, gen)
        rot = torch.randn((B, d, d), generator=gen, device=dev) if self.is_molecule else None
        com = None
        if self.is_molecule and not self.mean_free:
            com = torch.randn((B, 1, d), generator=gen, device=dev)
        return StepDraws(idx, rot, com,
                         draw_losses(self.loss_cfg, self.noise_schedule, B, self.dim, gen, dev))

    def train_step(self, temp_idx: int, draws: Optional[StepDraws] = None):
        """One optimizer step on a batch of rung ``temp_idx``'s buffer
        (trainer.py:411-452). Returns (the losses as 0-d tensors, the global
        gradient norm before clipping)."""
        with span("train.step", rung=temp_idx):
            cfg = self.cfg
            n_p, n_d = self.n_particles, self.n_spatial_dim
            with span("train.batch"):
                d = draws if draws is not None else self.draw_step(temp_idx)
                x0, e0, f0, _ = buffer_sample(buffer_view(self.buffers, temp_idx),
                                              cfg.training_batch_size, idx=d.idx)
                if self.is_molecule:
                    x0, f0 = rotate_augment(x0, f0, n_p, n_d, normal=d.rot_normal)
                if self.is_molecule and not self.mean_free:
                    x0 = com_augment(x0, n_p, n_d, normal=d.com_normal)
            with span("train.losses"):
                total, aux = compute_losses(
                    self.score, self.energy, self.noise_schedule, self.loss_cfg, x0, e0, f0,
                    float(self.inverse_temperatures[temp_idx]), target=self.targets[temp_idx],
                    n_particles=n_p, n_spatial_dim=n_d, mean_free=self.mean_free, draws=d.loss)
            with span("train.backward"):
                grads = torch.autograd.grad(total, self.params, allow_unused=True)
            g_norm = self._apply_gradients(grads)
            scalars = {k: v.detach() for k, v in aux.items()
                       if not k.endswith("per_sample") and k != "ln_sigma"}
            return scalars, g_norm

    def _apply_gradients(self, grads) -> torch.Tensor:
        """Global-norm clipping and Adam over both nets (a None gradient
        counts as zeros), the update, then the EMA of both nets. Returns the
        global gradient norm before clipping."""
        cfg = self.cfg
        with span("train.optimizer"):
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
            grads, g_norm = clip_by_global_norm(grads, cfg.grad_clip)
            updates, self.opt_state = adam_update(grads, self.opt_state,
                                                  self.lr_at(self.opt_state.count))
            with torch.no_grad():
                for p, u in zip(self.params, updates):
                    p.add_(u)
        if cfg.ema_decay > 0:
            with span("train.ema"):
                self.ema_score.update(self.score_net, cfg.ema_decay)
                self.ema_energy.update(self.energy_net, cfg.ema_decay)
        return g_norm.detach()

    def epoch_temp_indices(self) -> list:
        """The rung of each batch of an epoch: uniform over the active rungs
        with ``train_on_all_temps`` (:703-710), else the active one."""
        n, active = self.cfg.n_train_batches_per_epoch, self.active_temp_index()
        if self.cfg.train_on_all_temps:
            return torch.randint(0, active + 1, (n,), generator=self.generator,
                                 device=self.device).tolist()
        return [active] * n

    def train_one_epoch(self) -> dict:
        """One epoch of buffer-batch training; the mean of each loss."""
        steps = [self.train_step(i)[0] for i in self.epoch_temp_indices()]
        return {k: float(torch.stack([s[k] for s in steps]).mean()) for k in steps[0]}

    # -------------------------------------------------------- DEM pretraining

    def dem_draw_step(self) -> DEMStepDraws:
        """One DEM step's draws from the trainer's generator."""
        dem, gen, dev = self.dem_cfg, self.generator, self.device
        B, d = dem.training_batch_size, self.n_spatial_dim
        idx = sample_indices(buffer_view(self.buffers, 0), B, False,
                             self.cfg.sample_with_replacement, gen)
        rot = torch.randn((B, d, d), generator=gen, device=dev) if self.is_molecule else None
        return DEMStepDraws(idx, rot, draw_dem(dem, B, self.dim, gen, dev))

    def dem_train_step(self, draws: Optional[DEMStepDraws] = None):
        """One DEM pretraining step on a rotated batch of buffer 0
        (trainer.py:522-552). The score net gets the gradient of
        ``pretrain_loss``; the energy net's gradient is zeros, which go
        through the clipping and Adam as optax's do: they count in the global
        norm, decay the moments and move the weights by what the moments
        still hold. Returns (the loss, the global gradient norm)."""
        dem = self.dem_cfg
        d = draws if draws is not None else self.dem_draw_step()
        n_p, n_d = self.n_particles, self.n_spatial_dim
        x0, _, f0, _ = buffer_sample(buffer_view(self.buffers, 0), dem.training_batch_size,
                                     idx=d.idx)
        if self.is_molecule:
            x0, f0 = rotate_augment(x0, f0, n_p, n_d, normal=d.rot_normal)
        loss = pretrain_loss(self.score, dem, x0, f0, float(self.inverse_temperatures[0]),
                             target=self.targets[0], n_particles=n_p, n_spatial_dim=n_d,
                             mean_free=self.mean_free, draws=d.loss)
        n_score = len(list(self.score_net.parameters()))
        g_s = torch.autograd.grad(loss, self.params[:n_score], allow_unused=True)
        g_norm = self._apply_gradients(list(g_s) + [None] * (len(self.params) - n_score))
        return loss.detach(), g_norm

    def dem_train_one_epoch(self) -> dict:
        """One DEM pretraining epoch of ``n_train_batches_per_epoch`` steps
        (energytemp_module.py:696-701); the mean loss."""
        losses = [self.dem_train_step()[0] for _ in range(self.cfg.n_train_batches_per_epoch)]
        return {"pretrain_target_score_loss": float(torch.stack(losses).mean())}

    def eval_epoch_end_dem(self, prefix: str = "val") -> dict:
        """Plain reverse-SDE sampling (no energy net, no weights, no
        resampling) to refill buffer 0 (:576-620)."""
        dem = self.dem_cfg
        target0 = self.targets[0]
        cfg_dem = self.integrator_cfg.replace(
            num_integration_steps=dem.num_integration_steps, debias_inference=False,
            resampling_interval=-1, resample_at_end=False, start_resampling_step=0,
            end_resampling_step=dem.num_integration_steps)
        res = self.generate_samples(target0, dem.num_samples_to_generate_per_epoch,
                                    inverse_temp=float(self.inverse_temperatures[0]),
                                    annealing_factor=1.0, integrator_cfg=cfg_dem)
        samples = res.samples
        energies, forces = target0.log_prob_and_force(samples)
        buf0 = buffer_add(buffer_view(self.buffers, 0), samples, energies, forces)
        self.buffers = buffer_set(self.buffers, 0, buf0)
        metrics = {f"{prefix}/dem/energy_mean": float(-energies.mean())}
        try:
            data = target0.sample_val_set(samples.shape[0], self.generator)
        except (ValueError, NotImplementedError):
            data = None
        if data is not None:
            metrics.update(energy_distances(energies, target0.log_prob(data),
                                            prefix=f"{prefix}/dem",
                                            energy_threshold=self.cfg.energy_masking_threshold))
            if self.is_molecule:
                metrics[f"{prefix}/dem/dist_w2"] = interatomic_dist_w2(target0, samples, data)
        if self.logger is not None:
            self.logger.log_metrics(metrics, step=self.epoch)
        self.metrics_history.append(dict(metrics, epoch=self.epoch))
        return metrics

    # -------------------------------------------------------------- sampling

    def _eval_wrappers(self):
        """The nets that sample (pita_tpu's ``_eval_params``, :621-625, which
        returns their weights): the EMA shadows or frozen copies of the
        trained weights, on the backbone's ``sampler_route``."""
        pb = self.cfg.precondition_beta
        if self.cfg.ema_decay > 0 and self.cfg.eval_ema:
            s, e = self.ema_score.module, self.ema_energy.module
        else:
            route = self.score_net.sampler_route
            s, e = self.score_net.with_route(route), self.energy_net.with_route(route)
        return ScoreWrapper(s, precondition_beta=pb), EnergyWrapper(e, precondition_beta=pb)

    def _integrate(self, x1, nets, anneal, target, beta, cfg):
        return integrate_sde(x1, nets[0], nets[1], self.noise_schedule, anneal, target, beta,
                             cfg, draws=GeneratorDraws(self.generator), device=self.device)

    def generate_samples(self, target, num_samples: int, inverse_temp: float = 1.0,
                         annealing_factor: float = 1.0, resampling_interval: Optional[int] = None,
                         return_logweights: bool = False,
                         integrator_cfg: Optional[IntegratorConfig] = None, nets=None):
        """Annealed sample generation (energytemp_module.py:237-298).

        Above ``max_chains_per_integrate`` chains the request runs in equal
        islands with per-island resampling (:650-685); the diagnostics are
        aggregated across islands. With ``return_logweights`` a second pass
        over at most 512 of the last island's prior samples runs without
        resampling and comes back as well.
        """
        cfg = integrator_cfg or self.integrator_cfg
        if resampling_interval is not None:
            cfg = cfg.replace(resampling_interval=resampling_interval)
        anneal = self.make_annealing(annealing_factor)
        prior = self._prior(annealing_factor)
        nets = nets or self._eval_wrappers()
        draw = lambda n: prior.sample(n, generator=self.generator, device=self.device)

        cap = self.cfg.max_chains_per_integrate
        if cap is not None and num_samples > cap:
            n_islands = -(-num_samples // cap)
            parts = []
            for i in range(n_islands):
                x1 = draw(cap)  # equal islands, as in pita_tpu
                parts.append((min(cap, num_samples - i * cap),
                              self._integrate(x1, nets, anneal, target, inverse_temp, cfg)))
            res = parts[0][1]._replace(
                samples=torch.cat([r.samples[:n] for n, r in parts]),
                logweights=torch.cat([r.logweights[:, :n] for n, r in parts], dim=1),
                acceptance_rates=torch.stack([r.acceptance_rates for _, r in parts]).mean(0),
                num_unique=torch.stack([r.num_unique for _, r in parts]).sum(0),
            )
            self._last_n_islands = n_islands
        else:
            x1 = draw(num_samples)
            res = self._integrate(x1, nets, anneal, target, inverse_temp, cfg)
            self._last_n_islands = 1
        if not return_logweights:
            return res
        n_diag = min(num_samples, 512)
        res_nores = self._integrate(
            x1[:n_diag], nets, anneal, target, inverse_temp,
            cfg.replace(resampling_interval=cfg.num_integration_steps + 1))
        return res, res_nores

    # ------------------------------------------------------------ evaluation

    def eval_step_losses(self, prefix: str = "val") -> dict:
        """Model losses on true val/test data (energytemp_module.py:734-767)."""
        index = self.active_temp_index()
        target = self.targets[index]
        num = min(self.cfg.num_eval_samples, self.cfg.training_batch_size)
        try:
            if prefix.startswith("test"):
                x0 = target.sample_test_set(num, self.generator)
            else:
                x0 = target.sample_val_set(num, self.generator)
        except (ValueError, NotImplementedError):
            return {}
        e0, f0 = target.log_prob_and_force(x0)
        with torch.no_grad():
            total, aux = compute_losses(
                self.score, self.energy, self.noise_schedule, self.loss_cfg, x0, e0, f0,
                float(self.inverse_temperatures[index]), target=target,
                n_particles=self.n_particles, n_spatial_dim=self.n_spatial_dim,
                mean_free=self.mean_free, generator=self.generator)
        T = self.temperatures[index]
        out = {f"{prefix}/temp={T:.3f}/{k}": float(v) for k, v in aux.items()
               if not k.endswith("per_sample") and k != "ln_sigma"}
        out[f"{prefix}/loss"] = float(total)
        edges = self.noise_schedule.ln_sigma_bins(4).numpy()
        ln_sigma = aux["ln_sigma"].detach().cpu().numpy()
        for lname in ("score_loss", "energy_score_loss"):
            strat = stratified_losses(ln_sigma, aux[f"{lname}_per_sample"].detach().cpu().numpy(),
                                      edges, loss_name=lname)
            out.update({f"{prefix}/temp={T:.3f}/{k}": float(v) for k, v in strat.items()})
        if self.logger is not None:
            self.logger.log_metrics(out, step=self.epoch)
        return out

    def evaluate(self, prefix: str = "val") -> dict:
        """Validation-epoch evaluation and, at a rung transition, the next
        rung's buffer fill (:885-1069)."""
        cfg = self.cfg
        index = self.active_temp_index()
        index_lower = index
        num_samples = cfg.num_eval_samples
        anneal_to_lower = (index < self.n_temps - 1 and len(self.update_temp_epoch) > 0
                           and (self.epoch + 1) == self.update_temp_epoch[index])
        if anneal_to_lower:
            num_samples = cfg.num_temp_annealed_samples
            index_lower += 1
            if cfg.skip_temp:
                index_lower = min(index_lower + cfg.num_skip_temps, self.n_temps - 1)
        inverse_temp = float(self.inverse_temperatures[index])
        annealing_factor = float(self.inverse_temperatures[index_lower]) / inverse_temp
        target_lower = self.targets[index_lower]

        fill_cfg = None
        if anneal_to_lower:
            repl = {}
            if cfg.transition_ess_threshold is not None:
                repl["ess_resampling_threshold"] = cfg.transition_ess_threshold
            if cfg.transition_post_mcmc_steps is not None:
                repl["post_mcmc_steps"] = cfg.transition_post_mcmc_steps
            if repl:
                fill_cfg = self.integrator_cfg.replace(**repl)

        def sample_and_energies(n_request, f_cfg):
            res, res_nores = self.generate_samples(
                target_lower, n_request, inverse_temp=inverse_temp,
                annealing_factor=annealing_factor, return_logweights=True, integrator_cfg=f_cfg)
            energies, forces = target_lower.log_prob_and_force(res.samples)
            return res, res_nores, energies, forces

        fill_floor = cfg.transition_min_fill_ess if anneal_to_lower else None
        (res, res_nores, energies, forces), fill_info, fill_cfg = fill_with_quality_floor(
            sample_and_energies, self.integrator_cfg, cfg, num_samples, fill_floor=fill_floor,
            fill_cfg=fill_cfg)
        metrics = {f"{prefix}/{k}": v for k, v in fill_info.items()}
        samples = res.samples
        if anneal_to_lower:
            # |E| mask, then fill the next rung's buffer (:881-901)
            mask = energies.abs() <= cfg.energy_masking_threshold
            if not bool(mask.any()):
                mask = torch.ones_like(mask)
            buf = buffer_add(buffer_view(self.buffers, index_lower), samples, energies, forces,
                             mask=mask)
            self.buffers = buffer_set(self.buffers, index_lower, buf)
            np.savez(os.path.join(
                self.out_dir,
                f"buffer_samples_temperature_{self.temperatures[index_lower]:.3f}.npz"),
                samples=samples.cpu().numpy(), energies=energies.cpu().numpy(),
                samples_not_resampled=res_nores.samples.cpu().numpy())
            if cfg.reinitialize_networks and not cfg.train_on_all_temps:
                self._reinitialize_networks()
            metrics[f"{prefix}/buffer_filled_temp"] = float(self.temperatures[index_lower])
            if fill_cfg is not None:
                metrics[f"{prefix}/transition_ess_threshold"] = float(
                    cfg.transition_ess_threshold or -1.0)
                metrics[f"{prefix}/transition_post_mcmc_steps"] = float(fill_cfg.post_mcmc_steps)

        try:
            data = target_lower.sample_val_set(samples.shape[0], self.generator)
        except (ValueError, NotImplementedError):
            data = None
        if data is not None:
            data_energies = target_lower.log_prob(data)
            metrics.update(energy_distances(energies, data_energies, prefix=prefix,
                                            energy_threshold=cfg.energy_masking_threshold))
            metrics[f"{prefix}/data_energy_std"] = float(data_energies.std(correction=0))
            if self.is_molecule:
                metrics[f"{prefix}/dist_w2"] = interatomic_dist_w2(target_lower, samples, data)
            # the target's own evaluation hook (energytemp_module.py:954)
            metrics.update(target_lower.log_on_epoch_end(
                samples, data, prefix=prefix,
                out_dir=os.path.join(self.out_dir, "plots", f"epoch_{self.epoch}"),
                samples_not_resampled=res_nores.samples, make_plots=cfg.make_plots))
        metrics[f"{prefix}/energy_mean"] = float(-energies.mean())
        metrics[f"{prefix}/energy_mean_no_resampling"] = float(
            -target_lower.log_prob(res_nores.samples).mean())
        metrics[f"{prefix}/lower_temp"] = float(self.temperatures[index_lower])
        # the log-weights at the end of the accumulation window
        lw_step = min(self.integrator_cfg.end_resampling_step,
                      self.integrator_cfg.num_integration_steps) - 1
        final_lw = res_nores.logweights[lw_step]
        metrics[f"{prefix}/ess"] = float(effective_sample_size(final_lw, normalize=True))
        metrics[f"{prefix}/logweight_std"] = float(final_lw.std(correction=0))
        metrics[f"{prefix}/n_resampling_islands"] = float(self._last_n_islands)
        if res.acceptance_rates.shape[0] > 0:
            metrics[f"{prefix}/acceptance_rate_mean"] = float(res.acceptance_rates.mean())
        if self.logger is not None:
            self.logger.log_metrics(metrics, step=self.epoch)
        self.metrics_history.append(dict(metrics, epoch=self.epoch))
        if cfg.make_plots:
            self._make_eval_plots(res, res_nores, target_lower, samples, energies, data)
        return metrics

    def _make_eval_plots(self, res, res_nores, target, samples, energies, data):
        """The reference's evaluation figures under out_dir/plots/epoch_<n>
        (trainer.py:1066-1092): the GMM's contours for the gmm target, the
        Ramachandran plot of a target that has dihedrals; needs matplotlib."""
        from pita_torch.io import plotting as P

        pdir = os.path.join(self.out_dir, "plots", f"epoch_{self.epoch}")
        if data is not None:
            P.plot_energy_histograms(energies, target.log_prob(data), pdir,
                                     not_resampled_energies=target.log_prob(res_nores.samples))
            if self.is_molecule:
                P.plot_interatomic_distances(target, samples, data, pdir)
        if getattr(target, "name", "") == "gmm":
            P.plot_gmm_contours(target, samples, pdir)
        if hasattr(target, "dihedrals"):
            phi, psi = target.dihedrals(samples)
            P.plot_ramachandran(phi, psi, pdir, temperature=target.temperature)
        P.plot_logweights(res_nores.logweights, pdir)
        P.plot_num_unique(res.num_unique, pdir)
        P.plot_acceptance(res.acceptance_rates, pdir)
        P.plot_sde_term_stats(res.term_stats, pdir)

    # --------------------------------------------------------------- state

    def state_dict(self) -> dict:
        """Everything a resumed run needs (the checkpoint's content)."""
        names = ([f"score.{n}" for n, _ in self.score_net.named_parameters()]
                 + [f"energy.{n}" for n, _ in self.energy_net.named_parameters()])
        copy = lambda sd: {k: v.detach().clone() for k, v in sd.items()}
        return {
            "params_score": copy(self.score_net.state_dict()),
            "params_energy": copy(self.energy_net.state_dict()),
            "ema_score": {"params": copy(self.ema_score.module.state_dict()),
                          "num_updates": self.ema_score.num_updates},
            "ema_energy": {"params": copy(self.ema_energy.module.state_dict()),
                           "num_updates": self.ema_energy.num_updates},
            "opt_state": {"count": self.opt_state.count,
                          "mu": dict(zip(names, (m.clone() for m in self.opt_state.mu))),
                          "nu": dict(zip(names, (v.clone() for v in self.opt_state.nu)))},
            "buffers": self.buffers._asdict(),
            "generator": self.generator.get_state(),
            "epoch": self.epoch,
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Copy ``state`` into the trainer's tensors in place; a state with no
        ``generator`` (a bridged JAX state) keeps the current one."""
        def load(module, sd):
            for k, p in module.state_dict().items():
                p.copy_(sd[k])

        load(self.score_net, state["params_score"])
        load(self.energy_net, state["params_energy"])
        load(self.ema_score.module, state["ema_score"]["params"])
        load(self.ema_energy.module, state["ema_energy"]["params"])
        self.ema_score.num_updates = int(state["ema_score"]["num_updates"])
        self.ema_energy.num_updates = int(state["ema_energy"]["num_updates"])
        names = ([f"score.{n}" for n, _ in self.score_net.named_parameters()]
                 + [f"energy.{n}" for n, _ in self.energy_net.named_parameters()])
        opt = state["opt_state"]
        for n, m, v in zip(names, self.opt_state.mu, self.opt_state.nu):
            m.copy_(opt["mu"][n])
            v.copy_(opt["nu"][n])
        self.opt_state = self.opt_state._replace(count=int(opt["count"]))
        b = state["buffers"]
        for name in ("x", "energy", "force"):
            getattr(self.buffers, name).copy_(torch.as_tensor(b[name]))
        self.buffers.pos.copy_(torch.as_tensor(b["pos"]))
        self.buffers.size.copy_(torch.as_tensor(b["size"]))
        if state.get("generator") is not None:
            self.generator.set_state(state["generator"].cpu())
        self.epoch = int(state["epoch"])

    # ------------------------------------------------------------------ fit

    def fit(self, max_epochs: Optional[int] = None, log_every: int = 10,
            ckpt_path: Optional[str] = None, resume: bool = False,
            time_checkpoint_seconds: Optional[float] = None):
        """The training loop (train.py:106 and Lightning's epoch loop): the
        DEM epochs first, with a refill of buffer 0 every
        ``dem_cfg.check_val_every_n_epochs`` of them; then an evaluation every
        ``check_val_every_n_epoch`` epochs and at every rung transition, a
        checkpoint after each evaluation and at the end."""
        from pita_torch.io.checkpoint import (TimeIntervalCheckpointer, restore_checkpoint,
                                              save_checkpoint)

        cfg = self.cfg
        if max_epochs is None:
            max_epochs = cfg.max_epochs or (
                int(self.update_temp_epoch[-1]) if len(self.update_temp_epoch) else 100)
        if ckpt_path and resume:
            restore_checkpoint(self, ckpt_path)
        if int(self.buffers.size[0]) == 0:
            self.populate_initial_buffer()
        timer = (TimeIntervalCheckpointer(self, ckpt_path, time_checkpoint_seconds)
                 if ckpt_path and time_checkpoint_seconds else None)
        best_metric, stall = np.inf, 0
        while self.epoch < max_epochs:
            t0 = time.time()
            in_dem_phase = self.dem_cfg is not None and self.epoch < cfg.dem_num_training_epochs
            aux = self.dem_train_one_epoch() if in_dem_phase else self.train_one_epoch()
            dt = time.time() - t0
            if self.logger is not None and self.epoch % log_every == 0:
                self.logger.log_metrics({f"train/{k}": v for k, v in aux.items()}
                                        | {"train/epoch_s": dt}, step=self.epoch)
            if in_dem_phase:
                # the DEM refill cadence (energytemp_module.py:725-732)
                if self.epoch % self.dem_cfg.check_val_every_n_epochs == 0 and self.epoch > 0:
                    self.eval_epoch_end_dem("val")
            elif ((self.epoch + 1) % cfg.check_val_every_n_epoch == 0
                    or (self.epoch + 1) in self.update_temp_epoch):
                self.eval_step_losses("val")
                val_metrics = self.evaluate("val")
                if ckpt_path:
                    save_checkpoint(self, ckpt_path)
                if cfg.early_stopping_metric is not None:
                    cur = val_metrics.get(cfg.early_stopping_metric, np.inf)
                    if cur < best_metric - cfg.early_stopping_min_delta:
                        best_metric, stall = cur, 0
                    else:
                        stall += 1
                        if stall >= cfg.early_stopping_patience:
                            print(f"early stopping at epoch {self.epoch}: "
                                  f"{cfg.early_stopping_metric} stalled at {best_metric:.4g} "
                                  f"for {stall} evals")
                            break
            if timer is not None:
                timer.maybe_save()
            self.epoch += 1
        if ckpt_path:
            save_checkpoint(self, ckpt_path)
        return self.metrics_history

    # ----------------------------------------------------------------- test

    def test(self, temps_to_anneal=None, ckpt_path: Optional[str] = None) -> dict:
        """Final sampling across ladder pairs (:1197-1275), from the saved
        checkpoint when ``ckpt_path`` is given."""
        cfg = self.cfg
        if ckpt_path:
            from pita_torch.io.checkpoint import restore_checkpoint

            restore_checkpoint(self, ckpt_path)
        temps_to_anneal = temps_to_anneal or cfg.temps_to_anneal_test
        if temps_to_anneal is None:
            pairs = [(i, i + 1) for i in range(self.n_temps - 1)]
        else:
            pairs = [(int(np.argmin(np.abs(self.temperatures - Ta))),
                      int(np.argmin(np.abs(self.temperatures - Tb))))
                     for Ta, Tb in temps_to_anneal]
        all_metrics = {}
        for i, j in pairs:
            beta_i = float(self.inverse_temperatures[i])
            beta_j = float(self.inverse_temperatures[j])
            res = self.generate_samples(self.targets[j], cfg.num_samples_to_save,
                                        inverse_temp=beta_i, annealing_factor=beta_j / beta_i)
            samples = res.samples.cpu().numpy()
            np.savez(os.path.join(self.out_dir,
                                  f"samples_temperature_{self.temperatures[i]:.3f}"
                                  f"_annealed_to_{self.temperatures[j]:.3f}.npz"),
                     samples=samples)
            sub = torch.as_tensor(samples[np.random.default_rng(0).integers(
                0, len(samples), cfg.test_batch_size)], device=self.device)
            energies = self.targets[j].log_prob(sub)
            try:
                data = self.targets[j].sample_test_set(len(sub), self.generator)
            except (ValueError, NotImplementedError):
                data = None
            prefix = f"test/T={self.temperatures[i]:.2f}->{self.temperatures[j]:.2f}"
            if data is not None:
                data_energies = self.targets[j].log_prob(data)
                m = energy_distances(energies, data_energies, prefix=prefix,
                                     energy_threshold=cfg.energy_masking_threshold)
                m[f"{prefix}/data_energy_std"] = float(data_energies.std(correction=0))
                if self.is_molecule:
                    m[f"{prefix}/dist_w2"] = interatomic_dist_w2(self.targets[j], sub, data)
                m.update(self.targets[j].log_on_epoch_end(
                    sub, data, prefix=prefix, out_dir=os.path.join(self.out_dir, "plots", "test"),
                    make_plots=cfg.make_plots))
                all_metrics.update(m)
            all_metrics[f"{prefix}/energy_mean"] = float(-energies.mean())
        if self.logger is not None:
            self.logger.log_metrics(all_metrics, step=self.epoch)
        return all_metrics
