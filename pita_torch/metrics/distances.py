"""Distribution distances (numpy, on the host).

Counterpart of ``pita_tpu/metrics/distances.py``: ``emd_1d_unequal`` (the
energy-W2 of the quality gate), ``energy_distances`` (the energy-histogram
W2/W1/mean gap and their variants cropped at |E| ≤ threshold) and
``interatomic_dist_w2``, which the trainer's evaluation and test report;
the exact W1/W2 by Hungarian assignment, the entropic Sinkhorn cost, the
torus Wasserstein of dihedral angles and ``compute_distribution_distances``
over a feature space, which the peptide evaluation reports. Inputs may be
tensors on any device or arrays.
"""

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64).ravel()


def emd2_1d(a, b) -> float:
    """Exact squared 1D W2 between equal-size empirical samples (a sort)."""
    return float(np.mean((np.sort(_host(a)) - np.sort(_host(b))) ** 2))


def wasserstein_1d(a, b) -> float:
    """Exact 1D W1 between equal-size empirical samples."""
    return float(np.mean(np.abs(np.sort(_host(a)) - np.sort(_host(b)))))


def emd_1d_unequal(a, b, p: int = 2) -> float:
    """Exact 1D EMD_p^p between empirical measures of different sizes.

    The optimal 1D coupling moves quantile mass in order: cut [0, 1] at every
    k/n and k/m; on each piece both quantile functions are constant.
    """
    a = np.sort(_host(a))
    b = np.sort(_host(b))
    n, m = len(a), len(b)
    q = np.union1d(np.arange(1, n + 1) / n, np.arange(1, m + 1) / m)
    edges = np.concatenate([[0.0], q])
    w = np.diff(edges)
    mid = (edges[:-1] + edges[1:]) / 2
    ia = np.minimum((mid * n).astype(np.int64), n - 1)
    ib = np.minimum((mid * m).astype(np.int64), m - 1)
    return float(np.sum(w * np.abs(a[ia] - b[ib]) ** p))


def energy_distances(generated_energies, data_energies, prefix: str = "val",
                     energy_threshold: float = 1000.0) -> dict:
    """Energy-histogram distances (distribution_distances.py:13-33): W2, W1
    and the mean gap over the first min(n, m) of each, and the cropped
    variants over |E| ≤ threshold in both sets by the unequal-size EMD."""
    g, d = _host(generated_energies), _host(data_energies)
    n = min(len(g), len(d))
    g, d = g[:n], d[:n]
    out = {
        f"{prefix}/energy_w2": float(np.sqrt(emd2_1d(g, d))),
        f"{prefix}/energy_w1": wasserstein_1d(g, d),
        f"{prefix}/energy_mean_gap": float(abs(g.mean() - d.mean())),
    }
    gm, dm = g[np.abs(g) <= energy_threshold], d[np.abs(d) <= energy_threshold]
    if len(gm) > 0 and len(dm) > 0:
        out[f"{prefix}/energy_w2_cropped"] = float(np.sqrt(emd_1d_unequal(gm, dm, p=2)))
        out[f"{prefix}/energy_w1_cropped"] = float(emd_1d_unequal(gm, dm, p=1))
        out[f"{prefix}/energy_mean_gap_cropped"] = float(abs(gm.mean() - dm.mean()))
    return out


def interatomic_dist_w2(target, generated, data) -> float:
    """sqrt(emd2_1d) over pooled interatomic distances (energytemp_module.py:1176-1191)."""
    dg = _host(target.interatomic_dist(torch.as_tensor(generated)))
    dd = _host(target.interatomic_dist(torch.as_tensor(data)))
    n = min(len(dg), len(dd))
    return float(np.sqrt(emd2_1d(dg[:n], dd[:n])))


def wasserstein2_exact(a, b) -> float:
    """Exact W2 between equal-size point clouds by Hungarian assignment."""
    from scipy.optimize import linear_sum_assignment

    a, b = np.asarray(a), np.asarray(b)
    cost = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    ri, ci = linear_sum_assignment(cost)
    return float(np.sqrt(cost[ri, ci].mean()))


def wasserstein1_exact(a, b) -> float:
    from scipy.optimize import linear_sum_assignment

    a, b = np.asarray(a), np.asarray(b)
    cost = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    ri, ci = linear_sum_assignment(cost)
    return float(cost[ri, ci].mean())


def sinkhorn_divergence(a: torch.Tensor, b: torch.Tensor, epsilon: float = 0.05,
                        num_iters: int = 200) -> torch.Tensor:
    """Entropic OT cost of the point clouds a (n, d) and b (m, d), on their
    device: log-domain Sinkhorn on the cost scaled to [0, 1]."""
    n, m = a.shape[0], b.shape[0]
    C = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    Cn = C / torch.clamp(C.max(), min=1e-12)
    loga = torch.full((n,), -float(np.log(n)), dtype=C.dtype, device=C.device)
    logb = torch.full((m,), -float(np.log(m)), dtype=C.dtype, device=C.device)
    f = torch.zeros(n, dtype=C.dtype, device=C.device)
    g = torch.zeros(m, dtype=C.dtype, device=C.device)
    for _ in range(num_iters):
        f = -epsilon * torch.logsumexp((g[None, :] - Cn) / epsilon + logb[None, :], dim=1)
        g = -epsilon * torch.logsumexp((f[:, None] - Cn) / epsilon + loga[:, None], dim=0)
    P = torch.exp((f[:, None] + g[None, :] - Cn) / epsilon + loga[:, None] + logb[None, :])
    return (P * C).sum()


def torus_wasserstein(angles_a, angles_b) -> float:
    """W2 on the torus (dihedral angles): squared geodesic distance per
    angle coordinate, exact assignment."""
    from scipy.optimize import linear_sum_assignment

    a, b = np.asarray(angles_a), np.asarray(angles_b)
    diff = np.abs(a[:, None, :] - b[None, :, :])
    diff = np.minimum(diff, 2 * np.pi - diff)
    cost = (diff ** 2).sum(-1)
    ri, ci = linear_sum_assignment(cost)
    return float(np.sqrt(cost[ri, ci].mean()))


def compute_distribution_distances(pred, true, prefix=None) -> dict:
    """Exact W1/W2, the RBF-mixture MMD (in float32, as pita_tpu computes
    it) and the mean and median gaps over a feature space, on the first
    min(n, m) rows of each (distribution_distances.py:44-90)."""
    from pita_torch.metrics.mmd import mix_rbf_mmd2

    pred, true = np.asarray(pred), np.asarray(true)
    n = min(len(pred), len(true))
    pred, true = pred[:n], true[:n]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    names = ["w1", "w2", "mmd_rbf", "mean_mse", "median_mse"]
    vals = [
        wasserstein1_exact(pred, true),
        wasserstein2_exact(pred, true),
        float(mix_rbf_mmd2(f32(pred), f32(true))),
        float(((pred.mean(0) - true.mean(0)) ** 2).mean()),
        float(((np.median(pred, 0) - np.median(true, 0)) ** 2).mean()),
    ]
    if prefix is not None:
        names = [f"{prefix}/{n}" for n in names]
    return dict(zip(names, vals))
