"""Distribution distances (numpy, on the host).

Counterpart of ``pita_tpu/metrics/distances.py:23-91,187-193``:
``emd_1d_unequal`` (the energy-W2 of the quality gate), ``energy_distances``
(the energy-histogram W2/W1/mean gap and their variants cropped at
|E| ≤ threshold) and ``interatomic_dist_w2``, which the trainer's
evaluation and test report. Inputs may be tensors on any device or arrays.
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
