"""Alanine-peptide targets on the plain-PyTorch force field.

Counterpart of ``pita_tpu/targets/alp.py``: ACE-(ALA)n-NME peptides with the
amber-ff99SB-style parameter set (atom types, charges, bonds, angles,
torsions, LJ, mbondi2 GB radii with OBC screening) and OBC implicit
solvent. The tables are this package's own copy of ``pita_tpu``'s.

Coordinates are in nanometers; the force field works in Å. Temperature is
in Kelvin and ``log_prob = −E/(k_B·T)``. The force is autograd's, from
``Target.log_prob_and_force``.

A data set is ``{peptide}_temp_{T:.2f}_{which}.npy`` under ``data_dir``
when it is there; else, with a ``data_dir`` and a ``data_url`` (a format
string of ``peptide`` and ``which``), it is downloaded there by
``pita_torch.io.datamodule.download_dataset`` (checked against
``data_sha256`` when given); otherwise it is generated on the device asked
for, by Langevin MD (``data_source="md"``, ``pita_torch.baselines.md``) or
adaptive MALA (``"mala"``), seeds 11, 12 and 13 for train, val and test, and
saved under ``data_dir`` when that is set.
"""

import os
import tempfile
from collections import deque
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from pita_torch.targets.base import Target
from pita_torch.targets.forcefield import (
    BOLTZMANN_KCAL,
    ForceFieldParams,
    as_tensors,
    dihedral_angles,
    forcefield_energy,
)

NM_TO_ANGSTROM = 10.0
ASSETS = Path(__file__).resolve().parents[2] / "pita_tpu" / "assets"

# ---- amber atom-type tables (parm99) ----
# LJ: (Rmin/2 [Å], eps [kcal/mol]);  sigma = 2·(Rmin/2)·2^(-1/6)
_LJ = {
    "CT": (1.9080, 0.1094),
    "C": (1.9080, 0.0860),
    "N": (1.8240, 0.1700),
    "O": (1.6612, 0.2100),
    "H": (0.6000, 0.0157),
    "H1": (1.3870, 0.0157),
    "HC": (1.4870, 0.0157),
}
_MASS = {"CT": 12.01, "C": 12.01, "N": 14.01, "O": 16.0, "H": 1.008, "H1": 1.008, "HC": 1.008}
# mbondi2 intrinsic GB radii [Å] + OBC screening (by element; H-on-N = 1.3)
_GB = {"C": (1.70, 0.72), "N": (1.55, 0.79), "O": (1.50, 0.85), "H": (1.20, 0.85)}

_BONDS = {  # (k [kcal/mol/Å²], r0 [Å])
    ("CT", "HC"): (340.0, 1.090),
    ("CT", "H1"): (340.0, 1.090),
    ("CT", "CT"): (310.0, 1.526),
    ("C", "CT"): (317.0, 1.522),
    ("C", "O"): (570.0, 1.229),
    ("C", "N"): (490.0, 1.335),
    ("N", "CT"): (337.0, 1.449),
    ("N", "H"): (434.0, 1.010),
}

_ANGLES = {  # (k [kcal/mol/rad²], theta0 [deg])
    ("HC", "CT", "HC"): (35.0, 109.5),
    ("H1", "CT", "H1"): (35.0, 109.5),
    ("CT", "CT", "HC"): (50.0, 109.5),
    ("CT", "CT", "H1"): (50.0, 109.5),
    ("C", "CT", "HC"): (50.0, 109.5),
    ("C", "CT", "H1"): (50.0, 109.5),
    ("C", "CT", "CT"): (63.0, 111.1),
    ("C", "CT", "N"): (63.0, 110.1),
    ("N", "CT", "CT"): (80.0, 109.7),
    ("N", "CT", "HC"): (50.0, 109.5),
    ("N", "CT", "H1"): (50.0, 109.5),
    ("CT", "C", "O"): (80.0, 120.4),
    ("CT", "C", "N"): (70.0, 116.6),
    ("O", "C", "N"): (80.0, 122.9),
    ("C", "N", "CT"): (50.0, 121.9),
    ("C", "N", "H"): (50.0, 120.0),
    ("CT", "N", "H"): (50.0, 118.04),
}

# torsions: type quad -> list of (periodicity, k [kcal/mol], phase [deg]).
# 'X' is a wildcard. Specific entries take precedence over wildcards.
_TORSIONS = {
    ("X", "C", "N", "X"): [(2, 2.5, 180.0)],
    ("X", "CT", "N", "X"): [],
    ("X", "CT", "C", "X"): [],
    ("X", "CT", "CT", "X"): [(3, 1.40 / 9.0, 0.0)],
    ("H", "N", "C", "O"): [(2, 2.5, 180.0), (1, 2.0, 0.0)],
    ("HC", "CT", "C", "O"): [(1, 0.80, 0.0), (3, 0.08, 180.0)],
    # ff99SB backbone corrections
    ("C", "N", "CT", "C"): [(2, 0.27, 0.0), (3, 0.42, 0.0)],  # φ (V1 = 0)
    ("N", "CT", "C", "N"): [(1, 0.45, 180.0), (2, 1.58, 180.0), (3, 0.55, 180.0)],  # ψ
    ("CT", "CT", "N", "C"): [(1, 2.00, 0.0), (2, 2.00, 0.0), (3, 0.40, 0.0)],  # φ'
    ("CT", "CT", "C", "N"): [(1, 0.20, 0.0), (2, 0.20, 0.0), (3, 0.40, 0.0)],  # ψ'
}
_IMPROPERS = {  # central atom third: (X, X, C, O) / (X, X, N, H)
    ("X", "X", "C", "O"): (2, 10.5, 180.0),
    ("X", "X", "N", "H"): (2, 1.0, 180.0),
}

# ---- residue templates: (atom_name, type, charge), bonds by name ----
_ACE = dict(
    atoms=[
        ("CH3", "CT", -0.3662), ("HH31", "HC", 0.1123), ("HH32", "HC", 0.1123),
        ("HH33", "HC", 0.1123), ("C", "C", 0.5972), ("O", "O", -0.5679),
    ],
    bonds=[("CH3", "HH31"), ("CH3", "HH32"), ("CH3", "HH33"), ("CH3", "C"), ("C", "O")],
    head=None,
    tail="C",
)
_ALA = dict(
    atoms=[
        ("N", "N", -0.4157), ("H", "H", 0.2719), ("CA", "CT", 0.0337),
        ("HA", "H1", 0.0823), ("CB", "CT", -0.1825), ("HB1", "HC", 0.0603),
        ("HB2", "HC", 0.0603), ("HB3", "HC", 0.0603), ("C", "C", 0.5973),
        ("O", "O", -0.5679),
    ],
    bonds=[
        ("N", "H"), ("N", "CA"), ("CA", "HA"), ("CA", "CB"), ("CB", "HB1"),
        ("CB", "HB2"), ("CB", "HB3"), ("CA", "C"), ("C", "O"),
    ],
    head="N",
    tail="C",
)
_NME = dict(
    atoms=[
        ("N", "N", -0.4157), ("H", "H", 0.2719), ("CH3", "CT", -0.1490),
        ("HH31", "H1", 0.0976), ("HH32", "H1", 0.0976), ("HH33", "H1", 0.0976),
    ],
    bonds=[("N", "H"), ("N", "CH3"), ("CH3", "HH31"), ("CH3", "HH32"), ("CH3", "HH33")],
    head="N",
    tail=None,
)

PEPTIDES = {"aldp": 1, "al3": 2, "al4": 3, "al5": 4, "al6": 5}


def build_peptide_topology(n_ala: int = 1):
    """Assemble ACE-(ALA)n-NME: atom lists, bond graph, φ/ψ index quads."""
    residues = [_ACE] + [_ALA] * n_ala + [_NME]
    names, types, charges, res_id = [], [], [], []
    bonds: List[Tuple[int, int]] = []
    offsets = []
    idx = 0
    for ri, res in enumerate(residues):
        offsets.append(idx)
        local = {}
        for name, typ, q in res["atoms"]:
            local[name] = idx
            names.append(name)
            types.append(typ)
            charges.append(q)
            res_id.append(ri)
            idx += 1
        for a, b in res["bonds"]:
            bonds.append((local[a], local[b]))

    def find(ri, name):
        return offsets[ri] + [a[0] for a in residues[ri]["atoms"]].index(name)

    # backbone links: tail(C) of residue i — head(N) of residue i+1
    for ri in range(len(residues) - 1):
        bonds.append((find(ri, residues[ri]["tail"]), find(ri + 1, residues[ri + 1]["head"])))

    # φ = C(i-1)-N(i)-CA(i)-C(i); ψ = N(i)-CA(i)-C(i)-N(i+1) for each ALA
    phi_idx, psi_idx = [], []
    for ri in range(1, 1 + n_ala):
        phi_idx.append([find(ri - 1, "C"), find(ri, "N"), find(ri, "CA"), find(ri, "C")])
        psi_idx.append([find(ri, "N"), find(ri, "CA"), find(ri, "C"), find(ri + 1, "N")])
    return dict(
        names=names, types=types, charges=np.asarray(charges, np.float64),
        res_id=res_id, bonds=bonds,
        phi_idx=np.asarray(phi_idx), psi_idx=np.asarray(psi_idx),
    )


def _adjacency(n, bonds):
    adj = [[] for _ in range(n)]
    for a, b in bonds:
        adj[a].append(b)
        adj[b].append(a)
    return adj


def _lookup_torsion(tq):
    a, b, c, d = tq
    for key in [(a, b, c, d), (d, c, b, a)]:
        if key in _TORSIONS:
            return _TORSIONS[key]
    for key in [("X", b, c, "X"), ("X", c, b, "X")]:
        if key in _TORSIONS:
            return _TORSIONS[key]
    return []


def build_forcefield_params(topology) -> ForceFieldParams:
    """The force-field arrays of a topology (numpy; ``pita_tpu``'s dtypes)."""
    types = topology["types"]
    bonds = topology["bonds"]
    n = len(types)
    adj = _adjacency(n, bonds)

    def btype(pair):
        key = (types[pair[0]], types[pair[1]])
        return _BONDS[key] if key in _BONDS else _BONDS[key[::-1]]

    def atype(tr):
        key = (types[tr[0]], types[tr[1]], types[tr[2]])
        return _ANGLES[key] if key in _ANGLES else _ANGLES[key[::-1]]

    # angles: all bonded triples
    angle_list = []
    for j in range(n):
        nb = adj[j]
        for ii in range(len(nb)):
            for kk in range(ii + 1, len(nb)):
                angle_list.append((nb[ii], j, nb[kk]))

    # proper torsions: all bonded quads i-j-k-l with i≠l
    tor_idx, tor_k, tor_n, tor_ph = [], [], [], []

    def add_torsion(quad, per, kk, ph):
        tor_idx.append(quad)
        tor_k.append(kk)
        tor_n.append(per)
        tor_ph.append(np.deg2rad(ph))

    for j, k in bonds:
        for i in adj[j]:
            if i == k:
                continue
            for l in adj[k]:
                if l == j or l == i:
                    continue
                for (per, kk, ph) in _lookup_torsion((types[i], types[j], types[k], types[l])):
                    if kk != 0:
                        add_torsion((i, j, k, l), per, kk, ph)
    # impropers: carbonyl C (bonded to O) and amide N (bonded to H)
    for c in range(n):
        for center, partner, key in (("C", "O", ("X", "X", "C", "O")),
                                     ("N", "H", ("X", "X", "N", "H"))):
            if types[c] != center:
                continue
            p = [a for a in adj[c] if types[a] == partner]
            others = [a for a in adj[c] if types[a] != partner]
            if p and len(others) == 2:
                add_torsion((others[0], others[1], c, p[0]), *_IMPROPERS[key])

    # exclusions: 1-2 and 1-3 excluded; 1-4 scaled (amber: LJ 1/2, coul 1/1.2)
    dist = np.full((n, n), 99, np.int32)
    for src in range(n):
        dist[src, src] = 0
        q = deque([src])
        while q:
            a = q.popleft()
            if dist[src, a] >= 4:
                continue
            for b in adj[a]:
                if dist[src, b] > dist[src, a] + 1:
                    dist[src, b] = dist[src, a] + 1
                    q.append(b)
    nb_scale = np.ones((n, n))
    coul_scale = np.ones((n, n))
    nb_scale[dist <= 2] = 0.0
    coul_scale[dist <= 2] = 0.0
    nb_scale[dist == 3] = 1.0 / 2.0
    coul_scale[dist == 3] = 1.0 / 1.2

    gb_radii, gb_screen = [], []
    for i, t in enumerate(types):
        el = t[0] if t[0] != "H" else "H"
        r, s = _GB[el]
        if el == "H" and any(types[a] == "N" for a in adj[i]):
            r = 1.3  # mbondi2: H on N
        gb_radii.append(r)
        gb_screen.append(s)

    return ForceFieldParams(
        bond_idx=np.asarray(bonds, np.int32),
        bond_k=np.asarray([btype(p)[0] for p in bonds]),
        bond_r0=np.asarray([btype(p)[1] for p in bonds]),
        angle_idx=np.asarray(angle_list, np.int32),
        angle_k=np.asarray([atype(t)[0] for t in angle_list]),
        angle_t0=np.deg2rad([atype(t)[1] for t in angle_list]),
        torsion_idx=np.asarray(tor_idx, np.int32),
        torsion_k=np.asarray(tor_k),
        torsion_n=np.asarray(tor_n, np.float64),
        torsion_phase=np.asarray(tor_ph),
        charges=topology["charges"],
        lj_sigma=np.asarray([2 * _LJ[t][0] * 2 ** (-1 / 6) for t in types]),
        lj_eps=np.asarray([_LJ[t][1] for t in types]),
        nb_scale=nb_scale,
        coul_scale=coul_scale,
        gb_radii=np.asarray(gb_radii),
        gb_screen=np.asarray(gb_screen),
    )


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class ALPEnergy(Target):
    """ACE-(ALA)n-NME Boltzmann target at temperature T [Kelvin]."""

    is_molecule = True
    n_spatial_dim = 3

    def __init__(self, peptide: str = "aldp", temperature: float = 300.0,
                 implicit_solvent: bool = True, data_dir: Optional[str] = None,
                 data_source: str = "md", data_url: Optional[str] = None,
                 data_sha256: Optional[str] = None):
        if data_source not in ("md", "mala"):
            raise ValueError(f"data_source must be 'md' or 'mala', got {data_source!r}")
        self.peptide = peptide
        self.topology = build_peptide_topology(PEPTIDES[peptide])
        # the float32 tensors on the CPU, and a copy on each device used
        self.params = as_tensors(build_forcefield_params(self.topology))
        self._params_on = {torch.device("cpu"): self.params}
        self.n_particles = len(self.topology["types"])
        self.dim = self.n_particles * 3
        self.temperature = float(temperature)
        self.implicit_solvent = implicit_solvent
        self.name = peptide
        self.data_dir = data_dir
        self.data_source = data_source
        self.data_url = data_url
        self.data_sha256 = data_sha256
        self._initial_structure = None

    def params_on(self, device) -> ForceFieldParams:
        device = torch.device(device)
        if device not in self._params_on:
            self._params_on[device] = ForceFieldParams(*[a.to(device) for a in self.params])
        return self._params_on[device]

    # ---- energy ----

    def energy_kcal(self, x: torch.Tensor) -> torch.Tensor:
        """Potential energy [kcal/mol]; x: (..., dim) in nm."""
        xr = x.reshape(*x.shape[:-1], self.n_particles, 3) * NM_TO_ANGSTROM
        return forcefield_energy(self.params_on(x.device), xr,
                                 implicit_solvent=self.implicit_solvent)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return -self.energy_kcal(x) / (BOLTZMANN_KCAL * self.temperature)

    # ---- geometry ----

    def dihedrals(self, x: torch.Tensor):
        """(φ, ψ) [rad] per ALA residue; x: (..., dim) nm."""
        x = torch.as_tensor(x)
        xr = x.reshape(*x.shape[:-1], self.n_particles, 3)
        return (dihedral_angles(xr, self.topology["phi_idx"]),
                dihedral_angles(xr, self.topology["psi_idx"]))

    def initial_structure(self) -> np.ndarray:
        """A relaxed structure [nm]: the minimized asset, else embed + minimize."""
        if self._initial_structure is None:
            asset = ASSETS / f"{self.peptide}_minimized.npy"
            if asset.exists():
                self._initial_structure = np.load(asset)
            else:
                self._initial_structure = _minimize(self, _rough_embed(self.topology))
        return self._initial_structure

    # ---- data sets ----

    def _load_or_generate(self, which, num_samples, device):
        path = None
        if self.data_dir is not None:
            path = os.path.join(self.data_dir,
                                f"{self.peptide}_temp_{self.temperature:.2f}_{which}.npy")
            if os.path.exists(path):
                return np.load(path).reshape(-1, self.dim).astype(np.float32)
            if self.data_url is not None:
                from pita_torch.io.datamodule import download_dataset

                download_dataset(self.data_url.format(peptide=self.peptide, which=which), path,
                                 sha256=self.data_sha256)
                return np.load(path).reshape(-1, self.dim).astype(np.float32)
        seed = dict(train=11, val=12, test=13)[which]
        gen = self._generate_md_set if self.data_source == "md" else self._generate_mala_set
        data = gen(num_samples, seed, device)
        if path is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, data)
        return data

    def _generate_md_set(self, num_samples, seed, device):
        """Replicas from the relaxed structure, BAOAB at the target
        temperature, the warmup half of the frames discarded, frames pooled
        and shuffled."""
        from pita_torch.baselines.md import generate_md_dataset

        n_replicas = 32
        # report_interval=100 → frames = steps/100; generate 2× for warmup
        n_steps = max(int(np.ceil(2 * num_samples / n_replicas)) * 100, 2000)
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "md.npz")
            generate_md_dataset(self, out, n_steps=n_steps, n_replicas=n_replicas, seed=seed,
                                device=device)
            frames = np.load(out)["positions"]  # (T, R, dim)
        data = frames[frames.shape[0] // 2:].reshape(-1, self.dim)
        idx = np.random.default_rng(seed).permutation(len(data))[:num_samples]
        return data[idx].astype(np.float32)

    def _generate_mala_set(self, num_samples, seed, device):
        from pita_torch.baselines.mcmc import mala_chain
        from pita_torch.utils.device import resolve_device

        device = resolve_device(device)
        gen = torch.Generator(device).manual_seed(seed)
        n_chains = 128
        x0 = torch.as_tensor(self.initial_structure(), dtype=torch.float32,
                             device=device).reshape(1, -1).repeat(n_chains, 1)
        x0 = x0 + torch.randn(x0.shape, generator=gen, device=device) * 1e-3
        x, _, dt = mala_chain(self.log_prob_and_force, x0, 3000, dt=1e-7, generator=gen)
        out = []
        for _ in range(int(np.ceil(num_samples / n_chains))):
            x, _, dt = mala_chain(self.log_prob_and_force, x, 200, dt=float(dt), generator=gen)
            out.append(x.cpu().numpy())
        return np.concatenate(out)[:num_samples]

    def setup_train_set(self, device=None):
        return self._load_or_generate("train", 5000, device)

    def setup_val_set(self, device=None):
        return self._load_or_generate("val", 2000, device)

    def setup_test_set(self, device=None):
        return self._load_or_generate("test", 2000, device)

    # ---- evaluation ----

    def log_on_epoch_end(self, samples, data, *, prefix: str = "val", out_dir=None,
                         samples_not_resampled=None, make_plots: bool = False,
                         num_eval_samples: int = 5000) -> dict:
        """Peptide evaluation (alp.py:499-623): Ramachandran distances and
        torus-W on φ/ψ, resampled and not resampled; the correct and
        uncorrectable chirality rates; distances in TICA space; the
        internal-coordinate KLDs; with ``make_plots`` the figures."""
        from pita_torch.metrics.distances import compute_distribution_distances, torus_wasserstein
        from pita_torch.metrics.internal_coords import evaluate_internal_coords
        from pita_torch.utils.chirality import (check_and_fix_chirality, chirality_sign,
                                                find_chirality_centers)

        samples = _host(samples)[:num_eval_samples]
        data = _host(data)[:num_eval_samples]
        metrics = {}

        def phi_psi(x):
            phi, psi = self.dihedrals(torch.as_tensor(x))
            return np.concatenate([_host(phi), _host(psi)], axis=-1)

        x_true = phi_psi(data)

        def rama_metrics(x_gen, tag):
            n = min(len(x_gen), len(x_true))
            a = phi_psi(x_gen)[:n]
            m = compute_distribution_distances(a, x_true[:n], prefix=f"{prefix}/rama/{tag}")
            m[f"{prefix}/rama/{tag}/torus_wasserstein"] = torus_wasserstein(a, x_true[:n])
            return m

        metrics.update(rama_metrics(samples, "resampled"))
        if samples_not_resampled is not None:
            samples_not_resampled = _host(samples_not_resampled)
            metrics.update(rama_metrics(samples_not_resampled, "not_resampled"))

        # chirality: reference signs from one data structure; mirror the
        # generated samples that flipped, report the correct and
        # uncorrectable rates
        elements = [n[0] for n in self.topology["names"]]
        centers = find_chirality_centers(self.topology["bonds"], elements)
        if centers:
            xr_data = data.reshape(-1, self.n_particles, 3)
            ref_signs = [chirality_sign(xr_data[[1]], c, nbrs)[0] for c, nbrs in centers]
            fixed, flipped = check_and_fix_chirality(
                samples.reshape(-1, self.n_particles, 3), centers, ref_signs)
            metrics[f"{prefix}/correct_symmetry_rate"] = float(1.0 - flipped.mean())
            _, still = check_and_fix_chirality(fixed, centers, ref_signs)
            metrics[f"{prefix}/uncorrectable_symmetry_rate"] = float(still.mean())
            samples_fixed = fixed[~still].reshape(-1, self.dim)
        else:
            samples_fixed = samples

        # TICA fitted on the (time-ordered) data features, both sets projected
        try:
            from pita_torch.metrics.tica import run_tica

            tica = run_tica(self, data, generated=samples_fixed)
            n = min(len(tica["generated_proj"]), len(tica["data_proj"]))
            metrics.update(compute_distribution_distances(
                tica["generated_proj"][:n], tica["data_proj"][:n], prefix=f"{prefix}/tica"))
        except (AssertionError, ValueError) as e:
            print(f"TICA skipped: {e}")
            tica = None

        metrics.update(evaluate_internal_coords(self, samples_fixed, data, prefix=f"{prefix}/ic"))

        if make_plots and out_dir is not None:
            from pita_torch.io import plotting as P

            for name, x in (("ramachandran_resampled", samples_fixed),
                            ("ramachandran_ground_truth", data),
                            ("ramachandran_not_resampled", samples_not_resampled)):
                if x is not None:
                    phi, psi = self.dihedrals(torch.as_tensor(x))
                    P.plot_ramachandran(phi, psi, out_dir, name=name,
                                        temperature=self.temperature)
            if tica is not None:
                P.plot_tica_density(tica["data_proj"], out_dir, name="tica",
                                    proj_generated=tica.get("generated_proj"))
        return metrics


# per-residue template offsets [nm] for an extended-chain embed; the chain
# advances 0.35 nm per residue along +x. Crude — followed by minimization.
_EMBED_TEMPLATES = {
    "ACE": {
        "CH3": (0.10, 0.02, 0.00), "HH31": (0.04, -0.04, -0.06),
        "HH32": (0.05, 0.08, 0.08), "HH33": (0.16, -0.05, 0.06),
        "C": (0.21, 0.12, 0.05), "O": (0.15, 0.22, 0.08),
    },
    "ALA": {
        "N": (0.00, 0.00, 0.00), "H": (-0.05, 0.09, 0.00),
        "CA": (0.145, 0.00, 0.00), "HA": (0.175, 0.06, 0.085),
        "CB": (0.19, -0.10, -0.10), "HB1": (0.29, -0.08, -0.12),
        "HB2": (0.15, -0.08, -0.19), "HB3": (0.18, -0.21, -0.08),
        "C": (0.21, 0.12, 0.05), "O": (0.15, 0.22, 0.08),
    },
    "NME": {
        "N": (0.00, 0.00, 0.00), "H": (-0.05, 0.09, 0.00),
        "CH3": (0.145, 0.00, 0.00), "HH31": (0.25, 0.02, 0.00),
        "HH32": (0.12, 0.06, 0.09), "HH33": (0.12, -0.10, 0.03),
    },
}


def _rough_embed(topology) -> np.ndarray:
    """Extended-chain placement from per-residue templates, in nm."""
    names = topology["names"]
    res_id = topology["res_id"]
    n_res = max(res_id) + 1
    pos = np.zeros((len(names), 3))
    rng = np.random.default_rng(0)
    for i, (name, ri) in enumerate(zip(names, res_id)):
        kind = "ACE" if ri == 0 else ("NME" if ri == n_res - 1 else "ALA")
        off = np.asarray(_EMBED_TEMPLATES[kind][name])
        pos[i] = off + np.asarray([0.35 * ri, 0.0, 0.0]) + rng.normal(0, 0.002, 3)
    return pos.reshape(-1)


def _minimize(target: ALPEnergy, x0: np.ndarray, steps: int = 4000) -> np.ndarray:
    """Adam energy minimization (optax's adam, lr 2e-3) on the CPU; a
    non-finite gradient entry counts as zero."""
    from pita_torch.train.optim import adam_init, adam_update

    x = torch.as_tensor(x0, dtype=torch.float32).clone()
    state = adam_init([x])
    for _ in range(steps):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(target.energy_kcal(xx[None])[0], xx)
        g = torch.where(torch.isfinite(g), g, 0.0)
        (u,), state = adam_update([g], state, 2e-3)
        x = x + u
    return x.numpy()
