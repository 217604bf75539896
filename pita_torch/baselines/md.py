"""Langevin molecular dynamics on the plain-PyTorch force field.

Counterpart of ``pita_tpu/baselines/md.py``: BAOAB Langevin dynamics over a
batch of replicas, with frames and potential energies every
``report_interval`` steps, and a data-set generator that writes a
checkpointed ``.npz`` (``positions``, ``energies``, ``temperature``) every
``checkpoint_every`` steps. The ``lax.scan`` becomes a Python loop; the
force is the target's autograd force.

Units: positions nm, time ps, masses amu; kT in kcal/mol converted into the
amu·nm²/ps² energy scale. The friction and noise coefficients are computed
in float32, as ``pita_tpu`` computes them (1 − c1² loses digits there).

Randomness: ``langevin_md`` takes its standard normals from ``normal(shape)``
when given (first the initial velocities, then one draw per step, in order),
else from a ``torch.Generator``.
"""

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pita_torch.targets.alp import _MASS
from pita_torch.targets.forcefield import BOLTZMANN_KCAL
from pita_torch.utils.device import resolve_device

# 1 kJ/mol == 1 amu·nm²/ps² (the MD unit identity) ⇒ 1 kcal/mol = 4.184
KCAL_TO_MD = 4.184


@dataclasses.dataclass(frozen=True)
class MDConfig:
    temperature: float = 300.0  # K
    friction: float = 1.0  # 1/ps
    dt: float = 0.001  # ps
    n_steps: int = 10000
    report_interval: int = 100


class MDResult(NamedTuple):
    positions: torch.Tensor  # (n_frames, R, dim) nm
    velocities: torch.Tensor  # final velocities (R, dim)
    potential_energies: torch.Tensor  # (n_frames, R) kcal/mol


def langevin_md(target, x0: torch.Tensor, cfg: MDConfig, generator=None,
                normal: Optional[Callable] = None) -> MDResult:
    """BAOAB Langevin dynamics (md.py:40-79); x0: (R, dim) replicas in nm,
    on the device the dynamics run on."""
    dev = x0.device
    if normal is None:
        normal = lambda shape: torch.randn(shape, generator=generator, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    masses = torch.tensor([_MASS[t] for t in target.topology["types"]], **f32)
    m = masses.repeat_interleave(3)[None, :]  # (1, dim)
    kT = BOLTZMANN_KCAL * cfg.temperature * KCAL_TO_MD  # amu nm²/ps²
    dt = cfg.dt
    c1 = torch.exp(torch.tensor(-cfg.friction * dt, **f32))
    c3 = torch.sqrt(kT * (1 - c1 ** 2))
    noise_scale = c3 / torch.sqrt(m)
    force_scale = BOLTZMANN_KCAL * target.temperature

    def force_md(x):
        # force in kcal/mol/nm → amu·nm/ps²
        _, f = target.log_prob_and_force(x)
        return f * force_scale * KCAL_TO_MD

    x = x0
    v = normal(x0.shape) * torch.sqrt(kT / m)
    f = force_md(x)
    frames, energies = [], []
    for _ in range(cfg.n_steps // cfg.report_interval):
        for _ in range(cfg.report_interval):
            v = v + 0.5 * dt * f / m  # B
            x = x + 0.5 * dt * v  # A
            v = c1 * v + noise_scale * normal(v.shape)  # O
            x = x + 0.5 * dt * v  # A
            f = force_md(x)
            v = v + 0.5 * dt * f / m  # B
        frames.append(x)
        with torch.no_grad():
            energies.append(target.energy_kcal(x))
    return MDResult(torch.stack(frames), v, torch.stack(energies))


def generate_md_dataset(target, out_path: str, n_steps: int = 100000, n_replicas: int = 8,
                        temperature: Optional[float] = None, seed: int = 0,
                        checkpoint_every: int = 20000, device=None) -> str:
    """Run MD from the target's relaxed structure (plus 1e-3 nm noise per
    replica) and rewrite the ``.npz`` after every ``checkpoint_every``
    steps (md.py:88-120). Runs on CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    checkpoint_every = min(checkpoint_every, n_steps)
    cfg = MDConfig(temperature=temperature or target.temperature, n_steps=checkpoint_every)
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.as_tensor(target.initial_structure(), dtype=torch.float32,
                        device=device)[None].repeat(n_replicas, 1)
    x = x + torch.randn(x.shape, generator=gen, device=device) * 1e-3
    all_frames, all_energies = [], []
    for _ in range(max(n_steps // checkpoint_every, 1)):
        res = langevin_md(target, x, cfg, generator=gen)
        x = res.positions[-1]
        all_frames.append(res.positions.cpu().numpy())
        all_energies.append(res.potential_energies.cpu().numpy())
        np.savez(out_path, positions=np.concatenate(all_frames),
                 energies=np.concatenate(all_energies), temperature=cfg.temperature)
    return out_path
