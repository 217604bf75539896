"""Internal-coordinate marginal KLDs for peptides (numpy).

Counterpart of ``pita_tpu/metrics/internal_coords.py``: samples go to
internal coordinates taken from the peptide topology (bond lengths, angles
of adjacent bonds, the force field's torsion quads), each coordinate is
histogrammed, and the KL divergences of the generated against the
ground-truth marginals are reported (mean and median overall, mean per
class, maximum).
"""

from typing import Dict

import numpy as np


def _bond_lengths(x, bonds):
    a = x[:, [b[0] for b in bonds]]
    b = x[:, [b[1] for b in bonds]]
    return np.linalg.norm(a - b, axis=-1)  # (B, n_bonds)


def _angle_triples(bonds, n):
    adj = [[] for _ in range(n)]
    for a, b in bonds:
        adj[a].append(b)
        adj[b].append(a)
    triples = []
    for j in range(n):
        nb = sorted(adj[j])
        for ii in range(len(nb)):
            for kk in range(ii + 1, len(nb)):
                triples.append((nb[ii], j, nb[kk]))
    return triples


def _angles(x, triples):
    i = x[:, [t[0] for t in triples]]
    j = x[:, [t[1] for t in triples]]
    k = x[:, [t[2] for t in triples]]
    v1, v2 = i - j, k - j
    cos = np.sum(v1 * v2, axis=-1) / (
        np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-12)
    return np.arccos(np.clip(cos, -1.0, 1.0))


def _dihedrals(x, quads):
    p0, p1, p2, p3 = (x[:, [q[i] for q in quads]] for i in range(4))
    b0, b1, b2 = p1 - p0, p2 - p1, p3 - p2
    n1 = np.cross(b0, b1)
    n2 = np.cross(b1, b2)
    m1 = np.cross(n1, b1 / (np.linalg.norm(b1, axis=-1, keepdims=True) + 1e-12))
    return np.arctan2(np.sum(m1 * n2, axis=-1), np.sum(n1 * n2, axis=-1))


def _marginal_kld(gen: np.ndarray, data: np.ndarray, n_bins: int = 200,
                  periodic: bool = False) -> np.ndarray:
    """Per-column KL(data ‖ gen) over histograms."""
    klds = np.zeros(gen.shape[1])
    for c in range(gen.shape[1]):
        if periodic:
            lo, hi = -np.pi, np.pi
        else:
            lo = min(gen[:, c].min(), data[:, c].min())
            hi = max(gen[:, c].max(), data[:, c].max())
            if hi <= lo:
                hi = lo + 1e-6
        hg, _ = np.histogram(gen[:, c], bins=n_bins, range=(lo, hi), density=True)
        hd, _ = np.histogram(data[:, c], bins=n_bins, range=(lo, hi), density=True)
        hg, hd = hg + 1e-10, hd + 1e-10
        klds[c] = float(np.sum((hi - lo) / n_bins * hd * np.log(hd / hg)))
    return klds


def evaluate_internal_coords(target, samples, data, n_bins: int = 200,
                             prefix: str = "") -> Dict[str, float]:
    """Marginal KLDs over bonds, angles and torsions; samples and data are
    (B, dim) flat coordinates. An empty set (chirality correction can reject
    every generated sample early in training) gives no metrics."""
    if len(samples) == 0 or len(data) == 0:
        print("internal-coords KLD skipped: empty sample/data set")
        return {}
    x_g = np.asarray(samples).reshape(len(samples), -1, 3)
    x_d = np.asarray(data).reshape(len(data), -1, 3)
    # bins scale with the sample count, about 50 samples a bin
    n_bins = min(n_bins, max(min(len(x_g), len(x_d)) // 50, 10))
    bonds = target.topology["bonds"]
    triples = _angle_triples(bonds, x_g.shape[1])
    # one quad per torsion, however many periodicities it has
    quads = sorted({tuple(int(i) for i in q) for q in np.asarray(target.params.torsion_idx)})

    kld_b = _marginal_kld(_bond_lengths(x_g, bonds), _bond_lengths(x_d, bonds), n_bins)
    kld_a = _marginal_kld(_angles(x_g, triples), _angles(x_d, triples), n_bins)
    kld_t = _marginal_kld(_dihedrals(x_g, quads), _dihedrals(x_d, quads), n_bins, periodic=True)
    all_k = np.concatenate([kld_b, kld_a, kld_t])
    p = f"{prefix}/" if prefix else ""
    return {
        f"{p}kld_bonds_mean": float(kld_b.mean()),
        f"{p}kld_angles_mean": float(kld_a.mean()),
        f"{p}kld_torsions_mean": float(kld_t.mean()),
        f"{p}kld_mean": float(all_k.mean()),
        f"{p}kld_median": float(np.median(all_k)),
        f"{p}kld_max": float(all_k.max()),
    }
