"""Sharded sampling and data-parallel training on ``torch.distributed``.

Counterpart of ``pita_tpu/parallel/sharded.py:34-146``. Where JAX jits
``integrate_sde`` once with sharding annotations and lets XLA insert the
collectives, here each rank runs ``integrate_sde`` on its own rows of the
chains with a ``group`` (``pita_torch.parallel.mesh.ChainGroup``), and the
sampler takes every reduction over chains globally:

- the per-step quantile clamp, softmax and cumsum, ESS and ``count_unique``
  read the global weight vector (one ``all_gather`` of B floats);
- after a resample the chain state is gathered (B × D floats) and each rank
  keeps the rows of its share of the global ancestor choice;
- MALA's acceptance rate, which sets its adaptive step, is summed over ranks.

Every random tensor is drawn at the global shape from a generator that every
rank seeds alike (``ShardedDraws``), and each rank keeps its rows: the
ancestor choice is the same on every rank, and a sharded run equals the
one-process run with the same draws.

Data-parallel training likewise: the batch is sharded, the parameters are
replicated, each rank's loss is its share of the global loss
(``compute_losses(..., group=)``), the shares' gradients are summed over the
ranks, and global-norm clipping and Adam follow the reduction.
"""

import math

import torch

from pita_torch.sampler.integrator import GeneratorDraws, IntegratorConfig, integrate_sde
from pita_torch.train.losses import compute_losses
from pita_torch.train.optim import adam_update, clip_by_global_norm


def shard_batch(group, x):
    """This rank's rows of the leading axis of ``x``: a tensor, None, or a
    tuple (a NamedTuple too) of them."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return group.shard(x)
    parts = [shard_batch(group, v) for v in x]
    return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)


class ShardedDraws:
    """A sampler's draws (``GeneratorDraws``'s methods) made at the global
    shape by ``draws`` and cut to this rank's chains; the resampling
    uniforms are replicated."""

    def __init__(self, draws, group):
        self.draws = draws
        self.group = group

    def _global(self, shape):
        return (shape[0] * self.group.world_size, *shape[1:])

    def noise(self, step, shape):
        return self.group.shard(self.draws.noise(step, self._global(shape)))

    def probes(self, step, num_probes, shape):
        return self.group.shard(self.draws.probes(step, num_probes, self._global(shape)), dim=1)

    def hutchpp_probes(self, step, rank, num_probes, shape):
        S, G = self.draws.hutchpp_probes(step, rank, num_probes, self._global(shape))
        return self.group.shard(S, dim=1), self.group.shard(G, dim=1)

    def resample_u0(self, step):
        return self.draws.resample_u0(step)

    def end_u0(self):
        return self.draws.end_u0()

    def descent_noise(self, k, shape):
        return self.group.shard(self.draws.descent_noise(k, self._global(shape)))

    def mala_noise(self, k, shape):
        return self.group.shard(self.draws.mala_noise(k, self._global(shape)))

    def mala_uniform(self, k, shape):
        return self.group.shard(self.draws.mala_uniform(k, self._global(shape)))


def sharded_integrate(group, x1, score_wrapper, energy_wrapper, noise_schedule,
                      annealing_schedule, target, beta, cfg: IntegratorConfig, *, draws=None,
                      seed: int = 0):
    """``integrate_sde`` with the chains sharded over the group's ranks.

    ``x1`` is the global batch (B, D), the same on every rank, which keeps
    its B/W rows; a B that the world size W does not divide is refused (the
    reference drops the remainder, sde_integration.py:227-233). ``draws``
    are global draws, by default ``GeneratorDraws`` over a generator on the
    rank's device seeded with ``seed`` (the same on every rank). The
    networks must live on the rank's device. Samples and diagnostics come
    back global on every rank.
    """
    if x1.shape[0] % group.world_size:
        raise ValueError(f"a chain batch of {x1.shape[0]} does not divide over "
                         f"{group.world_size} ranks")
    if draws is None:
        draws = GeneratorDraws(torch.Generator(group.device).manual_seed(seed))
    return integrate_sde(group.shard(x1), score_wrapper, energy_wrapper, noise_schedule,
                         annealing_schedule, target, beta, cfg, draws=ShardedDraws(draws, group),
                         device=group.device, group=group)


def make_dp_train_step(group, score_wrapper, energy_wrapper, noise_schedule, loss_cfg, lr,
                       grad_clip: float = math.inf, n_particles: int = 1,
                       n_spatial_dim: int = 1, mean_free: bool = False, target=None):
    """A data-parallel training step of both wrappers' backbones: the batch
    sharded, the parameters replicated (each rank holds the same weights and
    Adam state and applies the same update).

    ``lr`` is a float or a function of Adam's step count. The step
    ``step(opt_state, x0, e0, f0, beta, draws)`` takes the global batch and
    its global ``LossDraws``, the same on every rank, and returns (the new
    Adam state, the scalar losses of the global batch, the global gradient
    norm before clipping). The weights are updated in place.
    """
    params = list(score_wrapper.backbone.parameters()) + list(
        energy_wrapper.backbone.parameters())
    lr_at = lr if callable(lr) else (lambda count: lr)

    def step(opt_state, x0, e0, f0, beta, draws):
        x0, e0, f0, draws = shard_batch(group, (x0, e0, f0, draws))
        share, aux = compute_losses(
            score_wrapper, energy_wrapper, noise_schedule, loss_cfg, x0, e0, f0, beta,
            target=target, n_particles=n_particles, n_spatial_dim=n_spatial_dim,
            mean_free=mean_free, draws=draws, group=group)
        grads = torch.autograd.grad(share, params, allow_unused=True)
        flat = group.sum(torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                                    for g, p in zip(grads, params)]))
        grads = [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in params]), params)]
        grads, g_norm = clip_by_global_norm(grads, grad_clip)
        updates, opt_state = adam_update(grads, opt_state, lr_at(opt_state.count))
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        names = [k for k in aux if not k.endswith("per_sample") and k != "ln_sigma"]
        totals = group.sum(torch.stack([aux[k].detach().to(flat.dtype) for k in names]))
        return opt_state, dict(zip(names, totals)), g_norm

    return step
