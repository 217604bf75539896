"""Ground-truth MCMC: batched adaptive MALA and the LJ dataset generator.

Counterpart of ``pita_tpu/baselines/mcmc.py:18-195`` (``_mala_step``,
``mala_chain``, ``generate_lj_dataset``). The ``lax.scan`` programs become
Python loops over device tensors; the step-size adaptation is a
``torch.where`` on the device, so no step waits for it. Every log-density
and force comes from the target's ``log_prob_and_force``: kernel K1 for an
LJ target on CUDA, its plain version on the CPU. The relaxation's energy
gradient is −T·force from the same call.

Randomness: ``_mala_step`` takes its normal and uniform draws as arguments;
``mala_chain`` and ``generate_lj_dataset`` draw them from a
``torch.Generator``. ``hmc_chain``, ``split_rhat`` and the reference
protocol (``generate_lj_dataset_reference_protocol``) are not ported.
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
