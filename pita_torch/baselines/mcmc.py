"""Ground-truth MCMC: batched adaptive MALA and HMC, the LJ dataset
generator, and the reference's gated ground-truth protocol.

Counterpart of ``pita_tpu/baselines/mcmc.py`` (``_mala_step``,
``mala_chain``, ``hmc_chain``, ``generate_lj_dataset``, ``split_rhat``,
``generate_lj_dataset_reference_protocol``). The ``lax.scan`` programs
become Python loops over device tensors; the step-size adaptation is a
``torch.where`` on the device, so no step waits for it. Every log-density
and force comes from the target's ``log_prob_and_force``: kernel K1 for an
LJ target on CUDA, its plain version on the CPU. The relaxation's energy
gradient is −T·force from the same call.

Randomness: ``_mala_step`` and ``_hmc_step`` take their normal and uniform
draws as arguments; ``mala_chain`` and ``generate_lj_dataset`` draw them
from a ``torch.Generator``, and ``hmc_chain`` from one or from a list of
draws passed in.
"""

import itertools
import math

import numpy as np
import torch

from pita_torch.train.optim import adam_init, adam_update
from pita_torch.utils.device import resolve_device


def _mala_step(log_prob_and_force, x, lp, force, dt, noise, u):
    """One MALA step over a batch of chains, given the proposal's standard
    normals ``noise`` (B, D) and the acceptance uniforms ``u`` (B,).
    Returns (x, log_prob, force, acceptance rate)."""
    prop = x + 0.5 * dt * force + torch.sqrt(dt) * noise
    lp_prop, force_prop = log_prob_and_force(prop)
    # forward/backward Gaussian proposal log-densities (sde_integration.py:28-45)
    fwd_mean = x + 0.5 * dt * force
    bwd_mean = prop + 0.5 * dt * force_prop
    log_q_fwd = -((prop - fwd_mean) ** 2).sum(-1) / (2 * dt)
    log_q_bwd = -((x - bwd_mean) ** 2).sum(-1) / (2 * dt)
    log_ratio = (lp_prop - lp) + (log_q_bwd - log_q_fwd)
    accept = torch.log(u) < log_ratio
    x_new = torch.where(accept[:, None], prop, x)
    lp_new = torch.where(accept, lp_prop, lp)
    force_new = torch.where(accept[:, None], force_prop, force)
    return x_new, lp_new, force_new, accept.float().mean()


def mala_chain(log_prob_and_force, x0, num_steps: int, dt=1e-4, adapt: bool = True,
               target_accept: float = 0.574, generator=None):
    """``num_steps`` MALA steps on a batch of chains; the step size grows or
    shrinks by 2 % a step around ``target_accept``.

    Returns (x_final, acceptance rates (num_steps,), dt_final as a 0-d tensor).
    """
    x = x0
    lp, force = log_prob_and_force(x)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=x.device)
    accs = []
    for _ in range(num_steps):
        noise = torch.randn(x.shape, generator=generator, device=x.device)
        u = torch.rand(lp.shape, generator=generator, device=x.device)
        x, lp, force, acc = _mala_step(log_prob_and_force, x, lp, force, dt, noise, u)
        if adapt:
            dt = torch.where(acc > target_accept, dt * 1.02, dt / 1.02)
        accs.append(acc)
    return x, torch.stack(accs), dt


def _hmc_step(log_prob_and_force, x, lp, eps, momentum, u, n_leapfrog: int):
    """One HMC step over a batch of chains (mcmc.py:99-111): ``n_leapfrog``
    leapfrog steps of size ``eps`` from the momenta ``momentum`` (B, D),
    then Metropolis with the uniforms ``u`` (B,). Calls
    ``log_prob_and_force`` n_leapfrog + 2 times. Returns (x, log_prob,
    acceptance rate, accept mask)."""
    _, force = log_prob_and_force(x)
    p = momentum + 0.5 * eps * force
    x_new = x
    for _ in range(n_leapfrog):
        x_new = x_new + eps * p
        _, force = log_prob_and_force(x_new)
        p = p + eps * force
    p = p - 0.5 * eps * force  # halve the final kick
    lp_new, _ = log_prob_and_force(x_new)
    ke0 = 0.5 * (momentum**2).sum(-1)
    ke1 = 0.5 * (p**2).sum(-1)
    log_ratio = (lp_new - lp) + (ke0 - ke1)
    accept = torch.log(u) < log_ratio
    x = torch.where(accept[:, None], x_new, x)
    lp = torch.where(accept, lp_new, lp)
    return x, lp, accept.float().mean(), accept


def hmc_chain(log_prob_and_force, x0, num_steps: int, step_size=1e-2, n_leapfrog: int = 10,
              adapt: bool = True, target_accept: float = 0.65, generator=None, draws=None):
    """Batched HMC with leapfrog integration (mcmc.py:68-116; fab's hmc.py):
    ``num_steps`` steps, the step size growing or shrinking by 2 % a step
    around ``target_accept``. ``draws``: a (momenta (B, D), uniforms (B,))
    pair per step; else drawn from ``generator``. Calls
    ``log_prob_and_force`` 1 + num_steps·(n_leapfrog + 2) times.

    Returns (x_final, acceptance rates (num_steps,), step size as a 0-d tensor).
    """
    x = x0
    lp, _ = log_prob_and_force(x)
    eps = torch.as_tensor(step_size, dtype=torch.float32, device=x.device)
    accs = []
    for i in range(num_steps):
        if draws is not None:
            momentum, u = draws[i]
        else:
            momentum = torch.randn(x.shape, generator=generator, device=x.device)
            u = torch.rand(lp.shape, generator=generator, device=x.device)
        x, lp, acc, _ = _hmc_step(log_prob_and_force, x, lp, eps, momentum, u, n_leapfrog)
        if adapt:
            eps = torch.where(acc > target_accept, eps * 1.02, eps / 1.02)
        accs.append(acc)
    return x, torch.stack(accs), eps


def energy_grad(target, x):
    """∇ₓE of a tempered target from ``log_prob_and_force``: −T·force."""
    _, force = target.log_prob_and_force(x)
    return -target.temperature * force


def relax_step(target, x, state, lr: float = 3e-3):
    """One Adam step (optax.adam(lr)) down the energy; non-finite gradient
    entries count as zero. Returns (x, state)."""
    g = energy_grad(target, x)
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    (u,), state = adam_update([g], state, lr)
    return x + u, state


def relax(target, x, steps: int = 2000, lr: float = 3e-3):
    """Batched Adam minimization of the energy from ``x`` (mcmc.py:151-166)."""
    state = adam_init([x])
    for _ in range(steps):
        x, state = relax_step(target, x, state, lr)
    return x


def jittered_lattice(n_particles: int, n_chains: int, generator=None, device=None):
    """The generator's start: a cubic lattice of spacing 1.12, centred, with
    N(0, 0.05²) jitter, one copy per chain (mcmc.py:139-147)."""
    side = int(np.ceil(n_particles ** (1 / 3)))
    pts = np.array(list(itertools.product(range(side), repeat=3)), np.float32)[:n_particles]
    pts = pts * np.float32(1.12)
    pts -= pts.mean(0)
    x0 = torch.as_tensor(pts.reshape(1, -1), device=device).repeat(n_chains, 1)
    return x0 + torch.randn(x0.shape, generator=generator, device=device) * 0.05


def generate_lj_dataset(target, num_samples: int, seed: int = 0, warmup: int = 12000,
                        thin: int = 10, energy_threshold: float = 1e3, relax_steps: int = 2000,
                        device=None) -> np.ndarray:
    """Approximate ground-truth LJ samples by batched adaptive MALA
    (mcmc.py:118-195): min(num_samples, 512) chains from relaxed jittered
    lattices, ``warmup`` adaptive-MALA steps in chunks of 2000 (``pita_tpu``
    rounds a warmup that is not a multiple of 2000 up to whole chunks), every chain
    still at |log p| ≥ ``energy_threshold`` replaced by a random healthy
    one, then rounds of ``thin``·20 steps, one sample per chain per round.

    ``device`` defaults to CUDA (raising without a GPU). Returns a numpy
    array (num_samples, dim).
    """
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    n_chains = min(num_samples, 512)
    x = relax(target, jittered_lattice(target.n_particles, n_chains, gen, dev),
              steps=relax_steps)

    lpf = target.log_prob_and_force
    dt = 5e-5
    warm_chunk = 2000
    for w in range(int(math.ceil(warmup / warm_chunk))):
        x, _, dt = mala_chain(lpf, x, min(warm_chunk, warmup - w * warm_chunk), dt=dt,
                              generator=gen)

    lp, _ = lpf(x)
    healthy = lp.abs() < energy_threshold
    idx_healthy = torch.nonzero(healthy).flatten()
    if idx_healthy.numel() > 0:
        pick = torch.randint(0, idx_healthy.numel(), (n_chains,), generator=gen, device=dev)
        x = torch.where(healthy[:, None], x, x[idx_healthy[pick]])

    out = []
    for _ in range(int(math.ceil(num_samples / n_chains))):
        x, _, dt = mala_chain(lpf, x, thin * 20, dt=dt, generator=gen)
        out.append(x.cpu().numpy())
    return np.concatenate(out, axis=0)[:num_samples]


def split_rhat(chains_stat: np.ndarray) -> float:
    """Split-R̂ of a scalar statistic; chains_stat (n_chains, n_draws)
    (mcmc.py:197-211, Gelman et al.'s split-chain potential scale reduction)."""
    c = np.asarray(chains_stat, np.float64)
    n = c.shape[1] // 2
    halves = np.concatenate([c[:, :n], c[:, n:2 * n]], axis=0)  # (2m, n)
    m, n = halves.shape
    means = halves.mean(axis=1)
    W = halves.var(axis=1, ddof=1).mean()
    B = n * means.var(ddof=1)
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / max(W, 1e-300)))


def generate_lj_dataset_reference_protocol(target, num_samples: int = 20000, n_runs: int = 10,
                                           seed: int = 0, warmup: int = 12000,
                                           rhat_tolerance: float = 1.05, device=None):
    """The reference's ground-truth protocol with a convergence gate
    (mcmc.py:214-253): ``n_runs`` independently seeded ensembles of
    ``generate_lj_dataset`` (seed ``seed + 1000·r``), pooled; the split-R̂
    of the per-run energy traces must stay below ``rhat_tolerance`` for
    ``converged``. Returns (samples (num_samples, dim), diagnostics)."""
    dev = resolve_device(device)
    per_run = int(np.ceil(num_samples / n_runs))
    runs, energies = [], []
    for r in range(n_runs):
        data = generate_lj_dataset(target, per_run, seed=seed + 1000 * r, warmup=warmup,
                                   device=dev)
        runs.append(data)
        energies.append(target.energy(torch.as_tensor(data, device=dev)).cpu().numpy())
    e = np.stack(energies)  # (n_runs, per_run)
    rhat = split_rhat(e)
    diag = {
        "rhat_energy": rhat,
        "per_run_energy_mean": [float(m) for m in e.mean(axis=1)],
        "per_run_energy_std": [float(s) for s in e.std(axis=1)],
        "converged": bool(rhat < rhat_tolerance),
    }
    if not diag["converged"]:
        print(f"WARNING: ground-truth runs disagree (R-hat {rhat:.3f} > {rhat_tolerance}); "
              "treat the pooled dataset with caution")
    return np.concatenate(runs, axis=0)[:num_samples], diag
