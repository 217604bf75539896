"""Weighted reverse-SDE integrator.

Counterpart of ``pita_tpu/sampler/integrator.py`` (``IntegratorConfig``,
``integrate_sde``, ``negative_time_descent``, ``mala``). The ``lax.scan``
becomes a Python loop over Euler–Maruyama steps: drift terms → EM update →
mean-free projection → log-weight accumulation in the [start, end) window →
ESS-triggered systematic resampling, with the divergence recomputed every
``divergence_update_interval`` steps and carried (following its chain
through resampling) in between. Then the optional final resample against
the true target, negative-time descent and adaptive MALA on the target's
``log_prob_and_force`` (kernel K1 on CUDA).

The step flags are host-side numpy, so the loop branches only on them; every
data-dependent choice (the ESS trigger, MALA acceptance, the step-size
update) is a ``torch.where`` on the device. Nothing inside a step waits for
the device, so a later change can capture the step in a CUDA graph. Each
step and its parts are marked by spans (``pita_torch/utils/tracing.py``:
``sampler.step`` over ``sampler.update``, ``energy_grad``, ``score``,
``divergence``, ``weights``, ``resample``), which record only under a
profiler and do no device work.

Randomness comes from a ``draws`` object (see ``GeneratorDraws``), so a test
can replay another framework's draws step for step.

With a ``group`` (``pita_torch.parallel``) each rank integrates its own rows
of the chains, and every reduction over chains is taken over the global
batch: the drift's quantile clamp, the resample's softmax and cumsum, the ESS
trigger, ``count_unique``, the term diagnostics, the final resample and
MALA's acceptance. After a resample the chain state is gathered and indexed
by the global ancestor choice, which every rank computes alike from a
replicated uniform. The result is global on every rank.
"""

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pita_torch.metrics.ess import effective_sample_size
from pita_torch.ops.resampling import count_unique, systematic_resample
from pita_torch.sampler.terms import compute_sde_terms
from pita_torch.utils.device import resolve_device
from pita_torch.utils.mean_free import remove_mean
from pita_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    """Sampler configuration: the fields of pita_tpu's IntegratorConfig that
    this path reads (configs/model/energytemp.yaml:72-87 defaults).

    ``divergence_mode``: "exact" (Jacobian trace; EGNN backbones take the
    edge-operator route), "exact_generic" (D VJPs), "hutchinson" or
    "hutchpp" (``hutchpp_rank`` sketch vectors and ``hutchinson_probes``
    residual probes). ``pin_energy`` pins the energy net to the target's
    ``log_prob`` near t = 0, in the drift and in the final resample.
    ``divergence_chunk_size`` chains and ``divergence_tangent_chunk`` tangents
    are in flight at a time in the exact modes. ``divergence_g_kernel`` takes
    the dominant contraction of the edge-operator route from the G-operator
    kernel (K5, ``pita_torch/ops/g_op.py``); ``divergence_tangent_kernel``
    (pita_tpu's ``pallas_divergence``) takes the whole trace in forward mode
    from the layer tangent kernel (K4, ``pita_torch/ops/egnn_tangent.py``),
    ``kernel_tangent_chunk`` tangents to a block (``pallas_tangent_chunk``).
    With both off G is materialized and contracted by ``torch.einsum``.
    pita_tpu's ``g_rows_per_block``, ``pallas_divergence_block_b``,
    ``pallas_interpret`` and ``segment_size`` and its
    PITA_TPU_ENABLE_EXPERIMENTAL_PALLAS gate are TPU tiling and compile
    matters and have no counterpart here.
    """

    num_integration_steps: int = 1000
    start_resampling_step: int = 0
    end_resampling_step: int = 1000
    resampling_interval: int = 1
    resample_at_end: bool = False
    time_range: float = 1.0
    diffusion_scale: float = 1.0
    num_negative_time_steps: int = 0
    dt_negative_time: float = 1e-13
    do_langevin: bool = False
    post_mcmc_steps: int = 0
    adaptive_mcmc: bool = True
    should_mean_free: bool = True
    debias_inference: bool = True
    pin_energy: bool = False
    divergence_mode: str = "exact"
    divergence_chunk_size: Optional[int] = None
    divergence_tangent_chunk: Optional[int] = None
    divergence_g_kernel: bool = False
    divergence_tangent_kernel: bool = False
    kernel_tangent_chunk: int = 16
    hutchinson_probes: int = 1
    hutchpp_rank: int = 16
    weight_clip_quantile: float = 0.9
    ess_resampling_threshold: Optional[float] = None
    divergence_update_interval: int = 1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class IntegrateResult(NamedTuple):
    samples: torch.Tensor  # (B, D)
    logweights: torch.Tensor  # (steps[+1], B)
    num_unique: torch.Tensor  # (steps[+1],)
    term_stats: dict  # {name: (steps,) std over chains}
    acceptance_rates: torch.Tensor  # (post_mcmc_steps,)


class GeneratorDraws:
    """The sampler's random numbers from one ``torch.Generator``.

    Each method is called once per use, in sampler order: ``noise`` and
    ``resample_u0`` every step, ``probes`` (or ``hutchpp_probes``) on steps
    that recompute a Hutchinson (Hutch++) divergence, ``end_u0`` once,
    ``descent_noise`` per Langevin descent step, ``mala_noise`` and
    ``mala_uniform`` per MALA step.
    """

    def __init__(self, generator: torch.Generator):
        self.gen = generator
        self.device = generator.device

    def _randn(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def _rand(self, shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def noise(self, step, shape):
        return self._randn(shape)

    def probes(self, step, num_probes, shape):
        r = torch.randint(0, 2, (num_probes, *shape), generator=self.gen, device=self.device)
        return r.to(torch.float32) * 2 - 1

    def hutchpp_probes(self, step, rank, num_probes, shape):
        """(S (rank, *shape), G (num_probes, *shape)), Rademacher."""
        return self.probes(step, rank, shape), self.probes(step, num_probes, shape)

    def resample_u0(self, step):
        return self._rand(())

    def end_u0(self):
        return self._rand(())

    def descent_noise(self, k, shape):
        return self._randn(shape)

    def mala_noise(self, k, shape):
        return self._randn(shape)

    def mala_uniform(self, k, shape):
        return self._rand(shape)


def step_flags(cfg: IntegratorConfig, resampling_interval: int):
    """Per-step gating flags (sde_integration.py:277-297)."""
    steps = np.arange(cfg.num_integration_steps)
    in_window = (steps >= cfg.start_resampling_step) & (steps < cfg.end_resampling_step)
    freeze = steps < cfg.start_resampling_step
    if resampling_interval == -1:
        resample = np.zeros_like(in_window)
    else:
        resample = in_window & (((steps + 1) % resampling_interval) == 0)
    rediv = steps % max(cfg.divergence_update_interval, 1) == 0
    return in_window, freeze, resample, rediv


def _all(group, v):
    """The global vector of per-chain values ``v``: this rank's rows alone
    without a group."""
    return v if group is None else group.gather_rows(v)


def _pick(group, choice, *vs):
    """The rows ``choice`` (global indices) of each of the chains' ``vs``,
    this rank's share of them: one gather with a group."""
    if group is None:
        return [v[choice] for v in vs]
    cols = [v.reshape(v.shape[0], -1) for v in vs]
    rows = group.gather_rows(torch.cat(cols, 1))[group.shard(choice)]
    return [r.reshape(v.shape) for r, v in zip(rows.split([c.shape[1] for c in cols], 1), vs)]


def _stds(vs, like, group=None):
    """The population std over all chains of each per-chain vector of
    ``vs`` (0 for a None): one gather with a group."""
    present = [v for v in vs if v is not None]
    if group is not None and present:
        rows = iter(group.gather_rows(torch.stack(present), dim=1).contiguous())
        vs = [None if v is None else next(rows) for v in vs]
    return [torch.zeros((), device=like.device) if v is None else v.std(correction=0) for v in vs]


def integrate_sde(x1, score_wrapper, energy_wrapper, noise_schedule, annealing_schedule,
                  target, beta, cfg: IntegratorConfig, *, draws=None, seed: int = 0,
                  device=None, group=None) -> IntegrateResult:
    """Integrate the annealed reverse SDE from prior samples ``x1`` (B, D).

    ``device`` defaults to CUDA (raising without a GPU); the networks must
    already live there. ``draws`` defaults to ``GeneratorDraws`` over a
    generator seeded with ``seed``. With a ``group``, ``x1`` and the draws
    are this rank's rows (``pita_torch.parallel.sharded_integrate`` makes
    both) and the result is global.
    """
    with span("sampler.integrate", chains=x1.shape[0], steps=cfg.num_integration_steps):
        dev = resolve_device(device)
        x = x1.to(dev, torch.float32)
        if draws is None:
            draws = GeneratorDraws(torch.Generator(dev).manual_seed(seed))
        resampling_interval = cfg.resampling_interval
        B, D = x.shape
        n = cfg.num_integration_steps
        times = torch.linspace(cfg.time_range, 0.0, n + 1, device=dev)[:-1]
        dt = cfg.time_range / n
        sqrt_dt = math.sqrt(dt)
        in_window, freeze, resample_f, rediv = (
            f.tolist() for f in step_flags(cfg, resampling_interval))
        weights_on = resampling_interval != -1
        carry_div = cfg.divergence_update_interval > 1 and weights_on
        mean_free = cfg.should_mean_free and getattr(target, "is_molecule", False)
        n_part = getattr(target, "n_particles", 1)
        n_sdim = getattr(target, "n_spatial_dim", D)

        a = torch.zeros(B, device=dev)
        div_c = torch.zeros(B, device=dev)
        B_all = B if group is None else B * group.world_size
        full_B = torch.full((), B_all, dtype=torch.int32, device=dev)
        lw_rows, nu_rows = [], []
        stats = {"divergence": [], "cross_term": [], "dUt_dt": []}
        for i in range(n):
            with span("sampler.step", step=i, rediv=rediv[i], resample=resample_f[i]):
                t = times[i].expand(B)
                override = div_c if carry_div and not rediv[i] else None
                probes = None
                with span("sampler.update"):
                    if weights_on and override is None and cfg.debias_inference:
                        if cfg.divergence_mode == "hutchinson":
                            probes = draws.probes(i, cfg.hutchinson_probes, (B, D))
                        elif cfg.divergence_mode == "hutchpp":
                            probes = draws.hutchpp_probes(i, cfg.hutchpp_rank,
                                                          cfg.hutchinson_probes, (B, D))
                terms = compute_sde_terms(
                    score_wrapper, energy_wrapper, noise_schedule, annealing_schedule, t, x,
                    beta, debias=cfg.debias_inference, compute_weights=weights_on,
                    clip_quantile=cfg.weight_clip_quantile,
                    divergence_mode=cfg.divergence_mode,
                    divergence_chunk_size=cfg.divergence_chunk_size,
                    divergence_tangent_chunk=cfg.divergence_tangent_chunk,
                    divergence_g_kernel=cfg.divergence_g_kernel,
                    divergence_tangent_kernel=cfg.divergence_tangent_kernel,
                    kernel_tangent_chunk=cfg.kernel_tangent_chunk,
                    probes=probes, div_bt_override=override, pin_energy=cfg.pin_energy,
                    energy_function=target.log_prob if cfg.pin_energy else None, group=group,
                )
                div_new = terms.divergence if terms.divergence is not None else div_c
                with span("sampler.update"):
                    noise = draws.noise(i, (B, D))
                    u0 = draws.resample_u0(i)
                    if freeze[i]:
                        x_next = x
                    else:
                        diffusion = cfg.diffusion_scale * noise_schedule.g(times[i]) * noise
                        x_next = x + terms.drift_X * dt + diffusion * sqrt_dt
                    if mean_free:
                        x_next = remove_mean(x_next, n_part, n_sdim)
                    a_next = a + terms.drift_A * dt if in_window[i] else torch.zeros_like(a)

                n_unique = full_B
                if resample_f[i]:
                    with span("sampler.resample"):
                        a_all = _all(group, a_next)
                        choice = systematic_resample(a_all, u0)
                        fire = torch.ones((), dtype=torch.bool, device=dev)
                        if cfg.ess_resampling_threshold is not None:
                            ess = effective_sample_size(a_all, normalize=True)
                            fire = ess < cfg.ess_resampling_threshold
                        # the carried divergence follows its chain through resampling
                        x_pick, div_pick = _pick(group, choice, x_next, div_new)
                        x_next = torch.where(fire, x_pick, x_next)
                        a_next = torch.where(fire, torch.zeros_like(a_next), a_next)
                        div_new = torch.where(fire, div_pick, div_new)
                        n_unique = torch.where(fire, count_unique(choice, B_all), full_B)

                with span("sampler.update"):
                    x, a, div_c = x_next, a_next, div_new
                    lw_rows.append(a)
                    nu_rows.append(n_unique)
                    for k, v in zip(stats, _stds((terms.divergence, terms.cross_term,
                                                  terms.dUt_dt), x, group)):
                        stats[k].append(v)

        if cfg.resample_at_end and weights_on and resampling_interval < n:
            # final resample against the true target, the learned energy as the
            # proposal log-density (sde_integration.py:158-184)
            t_end = times[min(cfg.end_resampling_step, n - 1)].expand(B)
            pin_kw = (dict(pin=True, t=t_end, energy_function=target.log_prob)
                      if cfg.pin_energy else {})
            with torch.no_grad():
                model_energy = energy_wrapper.energy(noise_schedule.h(t_end), x, beta, **pin_kw)
            logq0 = -model_energy * annealing_schedule.gamma(t_end)
            a_end = _all(group, target.log_prob(x) - logq0 + a)
            a_end = torch.minimum(a_end, torch.quantile(a_end, 0.9))
            choice = systematic_resample(a_end, draws.end_u0())
            (x,) = _pick(group, choice, x)
            lw_rows.append(a_end if group is None else group.shard(a_end))
            nu_rows.append(count_unique(choice, B_all))

        if cfg.num_negative_time_steps > 0:
            x = negative_time_descent(x, target, cfg.num_negative_time_steps,
                                      cfg.dt_negative_time, cfg.do_langevin, draws, mean_free)

        acceptance = torch.zeros(0, device=dev)
        if cfg.post_mcmc_steps > 0:
            x, acceptance = mala(x, target, cfg.post_mcmc_steps, cfg.dt_negative_time,
                                 cfg.adaptive_mcmc, draws, mean_free, group=group)

        lw = torch.stack(lw_rows)
        if group is not None:
            x, lw = group.gather_rows(x), group.gather_rows(lw, dim=1)
        return IntegrateResult(
            x, lw, torch.stack(nu_rows), {k: torch.stack(v) for k, v in stats.items()}, acceptance,
        )


def negative_time_descent(x, target, num_steps, dt, do_langevin, draws, mean_free):
    """Gradient ascent on log p, optionally unadjusted Langevin
    (sde_integration.py:353-360)."""
    n_part = getattr(target, "n_particles", 1)
    n_sdim = getattr(target, "n_spatial_dim", x.shape[-1])
    for k in range(num_steps):
        _, force = target.log_prob_and_force(x)
        x = x + force * dt
        if do_langevin:
            x = x + draws.descent_noise(k, x.shape) * math.sqrt(2 * dt)
        if mean_free:
            x = remove_mean(x, n_part, n_sdim)
    return x


def mala(x, target, num_steps, dt_init, adaptive, draws, mean_free,
         target_accept: float = 0.55, group=None):
    """Metropolis-adjusted Langevin refinement (sde_integration.py:362-470).

    Non-finite chains stay frozen in place. Adaptive mode multiplies or
    divides the step size by 1.1 around the target acceptance rate, taken
    over all ranks' chains with a ``group``.
    """
    total = (lambda v: v) if group is None else group.sum
    n_part = getattr(target, "n_particles", 1)
    n_sdim = getattr(target, "n_spatial_dim", x.shape[-1])
    lp, force = target.log_prob_and_force(x)
    valid = torch.isfinite(lp)
    n_valid = torch.clamp(total(valid.sum()), min=1)
    dt = torch.full((), dt_init, dtype=x.dtype, device=x.device)
    rates = []
    for k in range(num_steps):
        noise = draws.mala_noise(k, x.shape)
        u = draws.mala_uniform(k, lp.shape)
        prop = x + 0.5 * dt * force + torch.sqrt(dt) * noise
        lp_prop, force_prop = target.log_prob_and_force(prop)
        fwd_mean = x + 0.5 * dt * force
        bwd_mean = prop + 0.5 * dt * force_prop
        log_q_fwd = -((prop - fwd_mean) ** 2).sum(-1) / (2 * dt)
        log_q_bwd = -((x - bwd_mean) ** 2).sum(-1) / (2 * dt)
        log_ratio = (lp_prop - lp) + (log_q_bwd - log_q_fwd)
        accept = (torch.log(u) < log_ratio) & valid
        acc_rate = total((accept & valid).sum()) / n_valid
        x_new = torch.where(accept[:, None], prop, x)
        if mean_free:
            x_new = torch.where(valid[:, None], remove_mean(x_new, n_part, n_sdim), x_new)
        x = x_new
        lp = torch.where(accept, lp_prop, lp)
        force = torch.where(accept[:, None], force_prop, force)
        if adaptive:
            dt = torch.where(acc_rate > target_accept, dt * 1.1, dt / 1.1)
        rates.append(acc_rate)
    return x, torch.stack(rates)
