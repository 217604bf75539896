"""Rank processes for tests/test_torch_parallel.py.

The test starts the ranks of both world sizes at once. Each rank joins its
world's gloo group through a file store, runs every case on the inputs the
test wrote (``inputs.npz``) and writes what it got to ``<case>_<rank>.npz``
in its world's directory. This module imports torch and
pita_torch only, so the ranks start without JAX. It is not a test file.
"""

import os
import time

import numpy as np
import torch

from pita_torch.nets import EnergyWrapper, MLPBackbone, ScoreWrapper
from pita_torch.parallel import (ShardedBufferOps, make_dp_train_step, make_group,
                                 sharded_integrate)
from pita_torch.sampler import IntegratorConfig
from pita_torch.schedules import ConstantAnnealingSchedule, ElucidatingNoiseSchedule
from pita_torch.targets import Target
from pita_torch.train.buffer import buffer_add, buffer_init
from pita_torch.train.losses import LossConfig, LossDraws
from pita_torch.train.optim import adam_init

SIGMA0_SQ = 1.0
SCHED = dict(sigma_min=0.01, sigma_max=10.0, rho=7.0)
ANNEAL = 2.0
# the analytic case of tests/test_parallel.py, and a second configuration
# that runs every other global reduction of the sampler
GAUSS_CFG = dict(num_integration_steps=40, end_resampling_step=36, resampling_interval=4,
                 resample_at_end=True)
FULL_CFG = dict(num_integration_steps=12, end_resampling_step=12, resampling_interval=1,
                resample_at_end=True, divergence_mode="hutchinson", hutchinson_probes=2,
                divergence_update_interval=4, ess_resampling_threshold=0.7,
                post_mcmc_steps=4, dt_negative_time=0.05)
MLP = dict(hidden_size=32, hidden_layers=2, emb_size=16)
BUFFER_MODES = ((False, True), (False, False), (True, False))
SEED = 5


class GaussianTarget(Target):
    """N(0, σ0² I) in 2-D (tests/test_sampler.py:29-37)."""

    dim = 2

    def log_prob(self, x):
        return -(x ** 2).sum(-1) / (2 * SIGMA0_SQ)


class AnalyticScore:
    """The exact score of the noised Gaussian (tests/test_sampler.py:40-52)."""

    def score(self, ht, xt, beta):
        ht = torch.as_tensor(ht, dtype=xt.dtype).reshape(-1).expand(xt.shape[0])
        return -xt / (SIGMA0_SQ + ht[:, None])


class AnalyticEnergy:
    """The exact noised energy (tests/test_sampler.py:55-63)."""

    def energy(self, ht, xt, beta, **kw):
        ht = torch.as_tensor(ht, dtype=xt.dtype).reshape(-1).expand(xt.shape[0])
        return (xt ** 2).sum(-1) / (2 * (SIGMA0_SQ + ht))


class ArrayDraws:
    """A sampler's draws from arrays made ahead: ``noise`` (steps, B, D)
    and ``u0`` (steps,) per step, ``end_u0``."""

    def __init__(self, noise, u0, end_u0):
        self.n, self.u, self.e = noise, u0, end_u0

    def noise(self, i, shape):
        assert tuple(shape) == self.n.shape[1:], shape
        return torch.as_tensor(self.n[i])

    def resample_u0(self, i):
        return torch.as_tensor(self.u[i])

    def end_u0(self):
        return torch.as_tensor(self.e)


def gaussian_run(group, x1, cfg_kw, draws=None, seed=SEED):
    """The analytic-Gaussian run, sharded when ``group`` is a ChainGroup,
    else in this process on the CPU."""
    from pita_torch.sampler import integrate_sde

    args = (AnalyticScore(), AnalyticEnergy(), ElucidatingNoiseSchedule(**SCHED),
            ConstantAnnealingSchedule(annealing_factor=ANNEAL), GaussianTarget(), 1.0,
            IntegratorConfig(**cfg_kw))
    if group is None:
        return integrate_sde(x1, *args, draws=draws, seed=seed, device="cpu")
    return sharded_integrate(group, x1, *args, draws=draws, seed=seed)


def mlp_pair(z):
    """Score and energy wrappers over MLPs with the weights in ``z``."""
    nets = []
    for which in ("score", "energy"):
        net = MLPBackbone(2, 2, **MLP)
        sd = {k[len(which) + 1:]: torch.as_tensor(z[k]) for k in z.files
              if k.startswith(which + ".")}
        net.load_state_dict(sd)
        nets.append(net)
    return ScoreWrapper(nets[0]), EnergyWrapper(nets[1])


def dp_inputs(z, case):
    t = lambda k: torch.as_tensor(z[f"{case}.{k}"])
    draws = LossDraws(t("ln_sigma_draw"), t("noise"))
    return t("x0"), t("e0"), t("f0"), draws


DP_LOSS = {"gmm": LossConfig(), "mask": LossConfig(w_target_score=1.0,
                                                   time_threshold_target_score=0.3)}


def dp_step(group, z, case):
    """One data-parallel step of the case's loss (Adam at 1e-3, no clip);
    returns the weights after it, flattened, and the scalar losses. Without
    a group it is the one-process step."""
    sw, ew = mlp_pair(z)
    params = list(sw.backbone.parameters()) + list(ew.backbone.parameters())
    sched = ElucidatingNoiseSchedule(**SCHED)
    x0, e0, f0, draws = dp_inputs(z, case)
    if group is None:  # the one-process step: compute_losses on the whole batch
        from pita_torch.train.losses import compute_losses
        from pita_torch.train.optim import adam_update

        total, aux = compute_losses(sw, ew, sched, DP_LOSS[case], x0, e0, f0, 1.0, draws=draws)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if gr is None else gr for gr, p in zip(grads, params)]
        updates, _ = adam_update(grads, adam_init(params), 1e-3)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        scalars = {k: v.detach() for k, v in aux.items()
                   if not k.endswith("per_sample") and k != "ln_sigma"}
    else:
        step = make_dp_train_step(group, sw, ew, sched, DP_LOSS[case], 1e-3)
        _, scalars, _ = step(adam_init(params), x0, e0, f0, 1.0, draws)
    flat = torch.cat([p.detach().reshape(-1) for p in params]).numpy()
    return flat, {k: float(v) for k, v in scalars.items()}


def buffer_rounds(z):
    """The three masked adds of the buffer case, as (x, e, f, mask)."""
    return [tuple(torch.as_tensor(z[f"buf{r}.{k}"]) for k in ("x", "e", "f"))
            + (torch.as_tensor(z[f"buf{r}.e"]) < 0.5,) for r in range(3)]


WORLD_SIZES = (2, 4)


def run_process(i, out_root, timeout_s):
    """Process ``i`` of sum(WORLD_SIZES): rank i of the first world, then
    the ranks of the next, each world in ``<out_root>/ranks<W>``. It waits up
    to ``timeout_s`` for ``<out_root>/inputs.npz``, which the test writes
    while the processes start."""
    for ws in WORLD_SIZES:
        if i < ws:
            break
        i -= ws
    inputs = os.path.join(out_root, "inputs.npz")
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(inputs):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {inputs} after {timeout_s} s")
        time.sleep(0.05)
    run_rank(i, ws, os.path.join(out_root, f"ranks{ws}"), np.load(inputs))


def run_rank(rank, world_size, out_dir, z):
    """Every case on one rank."""
    torch.set_num_threads(1)
    group = make_group(f"file://{os.path.join(out_dir, 'store')}", world_size, rank,
                       device="cpu")
    save = lambda case, **kw: np.savez(os.path.join(out_dir, f"{case}_{rank}.npz"), **kw)

    res = gaussian_run(group, torch.as_tensor(z["x1"]), GAUSS_CFG,
                       draws=ArrayDraws(z["noise"], z["u0"], z["end_u0"]))
    save("gauss", samples=res.samples.numpy(), logweights=res.logweights.numpy(),
         num_unique=res.num_unique.numpy(),
         **{f"stat.{k}": v.numpy() for k, v in res.term_stats.items()})
    res = gaussian_run(group, torch.as_tensor(z["x1"]), FULL_CFG)
    save("full", samples=res.samples.numpy(), logweights=res.logweights.numpy(),
         num_unique=res.num_unique.numpy(), acceptance=res.acceptance_rates.numpy(),
         **{f"stat.{k}": v.numpy() for k, v in res.term_stats.items()})

    try:
        gaussian_run(group, torch.zeros(8 * world_size + 1, 2), GAUSS_CFG)
        refused = ""
    except ValueError as e:
        refused = str(e)
    save("indivisible", refused=np.array(refused))

    for case in DP_LOSS:
        flat, scalars = dp_step(group, z, case)
        save(f"dp_{case}", params=flat, **{f"loss.{k}": v for k, v in scalars.items()})

    ops = ShardedBufferOps(group)
    buf = ops.place(buffer_init(int(z["buf_capacity"]), z["buf0.x"].shape[1]))
    for x, e, f, m in buffer_rounds(z):
        buf = ops.add(buf, x, e, f, mask=m)
    out = dict(x=buf.x.numpy(), energy=buf.energy.numpy(), force=buf.force.numpy(),
               pos=buf.pos, size=buf.size, rows=ops.rows_per_rank(buf))
    try:
        ops.place(buffer_init(int(z["buf_capacity"]) + 1, z["buf0.x"].shape[1]))
        out["refused"] = np.array("")
    except ValueError as e:
        out["refused"] = np.array(str(e))
    for prioritize, replacement in BUFFER_MODES:
        gen = torch.Generator().manual_seed(99)
        xs, es, fs, idx = ops.sample(buf, 64, prioritize, replacement, generator=gen)
        key = f"p{int(prioritize)}r{int(replacement)}"
        out.update({f"{key}.x": xs.numpy(), f"{key}.e": es.numpy(), f"{key}.f": fs.numpy(),
                    f"{key}.idx": idx.numpy()})
    save("buffer", **out)


def one_process_buffer(z):
    """The buffer case in this process: (the buffer, {mode: sample})."""
    from pita_torch.train.buffer import buffer_sample

    buf = buffer_init(int(z["buf_capacity"]), z["buf0.x"].shape[1])
    for x, e, f, m in buffer_rounds(z):
        buf = buffer_add(buf, x, e, f, mask=m)
    out = {}
    for prioritize, replacement in BUFFER_MODES:
        gen = torch.Generator().manual_seed(99)
        out[f"p{int(prioritize)}r{int(replacement)}"] = buffer_sample(
            buf, 64, prioritize, replacement, generator=gen)
    return buf, out
