"""Parameterized classical force field in plain PyTorch.

Counterpart of ``pita_tpu/targets/forcefield.py``: bonds, angles, periodic
torsions and impropers, 12-6 Lennard-Jones and Coulomb with amber's 1-4
scaling, and an OBC generalized-Born implicit solvent, as dense index
gathers and full N×N pair matrices over (..., N, 3) coordinates. Units:
kcal/mol, Å, elementary charges. The force comes by autograd
(``Target.log_prob_and_force``), as ``pita_tpu`` takes it by ``jax.grad``.

The guards are ``pita_tpu``'s: ``sqrt(… + 1e-12)`` in the bond length and
the angle's norm product, the angle's cosine clipped at ±(1 − 1e-7), the
dihedral's middle bond normalized with its norm clipped at 1e-9, and the
Born radii's inverse floored at 1e-6.
"""

from typing import NamedTuple

import numpy as np
import torch

BOLTZMANN_KCAL = 0.0019872041  # kcal/mol/K
COULOMB_CONST = 332.0637128  # kcal·Å/(mol·e²)


class ForceFieldParams(NamedTuple):
    """Static parameter arrays for one molecule topology (numpy from
    ``build_forcefield_params``, tensors from ``as_tensors``)."""

    # bonded
    bond_idx: np.ndarray  # (nb, 2) int
    bond_k: np.ndarray  # (nb,) kcal/mol/Å²  (E = k (r - r0)², amber convention)
    bond_r0: np.ndarray  # (nb,) Å
    angle_idx: np.ndarray  # (na, 3) int
    angle_k: np.ndarray  # (na,) kcal/mol/rad²
    angle_t0: np.ndarray  # (na,) rad
    torsion_idx: np.ndarray  # (nt, 4) int (proper + improper)
    torsion_k: np.ndarray  # (nt,) kcal/mol (barrier/2 per amber)
    torsion_n: np.ndarray  # (nt,) periodicity
    torsion_phase: np.ndarray  # (nt,) rad
    # nonbonded
    charges: np.ndarray  # (N,) e
    lj_sigma: np.ndarray  # (N,) Å  (sigma, not rmin/2)
    lj_eps: np.ndarray  # (N,) kcal/mol
    nb_scale: np.ndarray  # (N, N) 0 for excluded (1-2, 1-3), 1/2 for 1-4
    coul_scale: np.ndarray  # (N, N)
    # GB-OBC implicit solvent
    gb_radii: np.ndarray  # (N,) Å intrinsic (mbondi2)
    gb_screen: np.ndarray  # (N,) screening factors


def as_tensors(p: ForceFieldParams, device=None) -> ForceFieldParams:
    """The parameters as tensors on ``device``: floats in float32 (as
    ``pita_tpu``'s ALPEnergy holds them), indices as int64."""
    def conv(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return torch.as_tensor(a, dtype=torch.float32, device=device)
        return torch.as_tensor(a.astype(np.int64), device=device)

    return ForceFieldParams(*[conv(a) for a in p])


def bonded_energy(p: ForceFieldParams, x: torch.Tensor) -> torch.Tensor:
    """Bond + angle + torsion energy; x: (..., N, 3) Å -> (...,) kcal/mol."""
    bi = p.bond_idx
    d = x[..., bi[:, 0], :] - x[..., bi[:, 1], :]
    r = torch.sqrt((d ** 2).sum(-1) + 1e-12)
    e = (p.bond_k * (r - p.bond_r0) ** 2).sum(-1)

    ai = p.angle_idx
    v1 = x[..., ai[:, 0], :] - x[..., ai[:, 1], :]
    v2 = x[..., ai[:, 2], :] - x[..., ai[:, 1], :]
    cos_t = (v1 * v2).sum(-1) / torch.sqrt((v1 ** 2).sum(-1) * (v2 ** 2).sum(-1) + 1e-12)
    theta = torch.arccos(torch.clamp(cos_t, -1 + 1e-7, 1 - 1e-7))
    e = e + (p.angle_k * (theta - p.angle_t0) ** 2).sum(-1)

    phi = dihedral_angles(x, p.torsion_idx)
    return e + (p.torsion_k * (1 + torch.cos(p.torsion_n * phi - p.torsion_phase))).sum(-1)


def dihedral_angles(x: torch.Tensor, idx) -> torch.Tensor:
    """Signed dihedral angles for index quads; x: (..., N, 3) -> (..., nt)."""
    idx = torch.as_tensor(idx, device=x.device)
    p0, p1, p2, p3 = (x[..., idx[:, i], :] for i in range(4))
    b0, b1, b2 = p1 - p0, p2 - p1, p3 - p2
    n1 = torch.linalg.cross(b0, b1, dim=-1)
    n2 = torch.linalg.cross(b1, b2, dim=-1)
    b1n = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True).clamp(min=1e-9)
    m1 = torch.linalg.cross(n1, b1n, dim=-1)
    return torch.atan2((m1 * n2).sum(-1), (n1 * n2).sum(-1))


def nonbonded_energy(p: ForceFieldParams, x: torch.Tensor) -> torch.Tensor:
    """LJ + Coulomb with exclusion/1-4 scale masks; dense N×N, each
    unordered pair counted once (the upper triangle)."""
    N = x.shape[-2]
    diff = x[..., :, None, :] - x[..., None, :, :]
    eye = torch.eye(N, dtype=torch.bool, device=x.device)
    r2 = torch.where(eye, 1.0, (diff ** 2).sum(-1))
    inv_r = torch.rsqrt(r2)

    sig = 0.5 * (p.lj_sigma[:, None] + p.lj_sigma[None, :])
    eps = torch.sqrt(p.lj_eps[:, None] * p.lj_eps[None, :])
    sr6 = (sig ** 2 / r2) ** 3
    e_lj = 4 * eps * (sr6 ** 2 - sr6) * p.nb_scale
    qq = p.charges[:, None] * p.charges[None, :]
    e_coul = COULOMB_CONST * qq * inv_r * p.coul_scale
    mask = torch.ones(N, N, dtype=torch.bool, device=x.device).triu(1)
    return torch.where(mask, e_lj + e_coul, 0.0).sum((-2, -1))


def obc_gb_energy(p: ForceFieldParams, x: torch.Tensor, dielectric_offset: float = 0.09,
                  alpha: float = 1.0, beta: float = 0.8, gamma: float = 4.85,
                  solute_dielectric: float = 1.0, solvent_dielectric: float = 78.5,
                  surface_tension: float = 0.00542, probe_radius: float = 1.4) -> torch.Tensor:
    """OBC generalized-Born energy (OBC-II defaults α=1, β=0.8, γ=4.85):
    HCT pairwise descreening integrals, OBC tanh rescaling of the Born
    radii, the Still pair sum over all ordered pairs (i = j included), and
    the ACE surface-area term."""
    N = x.shape[-2]
    diff = x[..., :, None, :] - x[..., None, :, :]
    eye = torch.eye(N, dtype=torch.bool, device=x.device)
    r = torch.sqrt(torch.where(eye, 1.0, (diff ** 2).sum(-1)))

    rho = p.gb_radii - dielectric_offset  # offset radii
    sr = p.gb_screen * rho  # scaled (descreening) radii of the other atom
    rho_i = rho[:, None]
    sr_j = sr[None, :]

    # HCT integral I_ij
    L = torch.maximum(torch.abs(r - sr_j), rho_i)
    U = r + sr_j
    inv_L, inv_U = 1.0 / L, 1.0 / U
    I = 0.5 * ((inv_L - inv_U) + 0.25 * (r - sr_j ** 2 / r) * (inv_U ** 2 - inv_L ** 2)
               + 0.5 / r * torch.log(L / U))
    I = torch.where(U < rho_i, 0.0, I)  # engulfed atom
    I = I + torch.where(rho_i < sr_j - r, 2.0 * (1.0 / rho_i - inv_L), 0.0)
    I = torch.where(eye, 0.0, I)
    Ii = I.sum(-1)  # (..., N)

    psi = Ii * rho
    born_inv = 1.0 / rho - torch.tanh(alpha * psi - beta * psi ** 2 + gamma * psi ** 3) / p.gb_radii
    born = 1.0 / torch.clamp(born_inv, min=1e-6)

    prefac = -0.5 * COULOMB_CONST * (1.0 / solute_dielectric - 1.0 / solvent_dielectric)
    bb = born[..., :, None] * born[..., None, :]
    r2 = torch.where(eye, 0.0, r ** 2)
    f_gb = torch.sqrt(r2 + bb * torch.exp(-r2 / (4.0 * bb)))
    qq = p.charges[:, None] * p.charges[None, :]
    e_gb = (prefac * qq / f_gb).sum((-2, -1))

    sa = surface_tension * (
        4.0 * np.pi * (p.gb_radii + probe_radius) ** 2 * (p.gb_radii / born) ** 6).sum(-1)
    return e_gb + sa


def forcefield_energy(p: ForceFieldParams, x: torch.Tensor,
                      implicit_solvent: bool = True) -> torch.Tensor:
    """Total potential energy; x: (..., N, 3) Å -> (...,) kcal/mol."""
    e = bonded_energy(p, x) + nonbonded_energy(p, x)
    if implicit_solvent:
        e = e + obc_gb_energy(p, x)
    return e
