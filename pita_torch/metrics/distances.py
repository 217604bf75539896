"""Distribution distances (numpy, on the host).

Counterpart of ``pita_tpu/metrics/distances.py:73-91`` (``emd_1d_unequal``,
the energy-W2 of the quality gate).
"""

import numpy as np


def emd_1d_unequal(a, b, p: int = 2) -> float:
    """Exact 1D EMD_p^p between empirical measures of different sizes.

    The optimal 1D coupling moves quantile mass in order: cut [0, 1] at every
    k/n and k/m; on each piece both quantile functions are constant.
    """
    a = np.sort(np.asarray(a, dtype=np.float64).ravel())
    b = np.sort(np.asarray(b, dtype=np.float64).ravel())
    n, m = len(a), len(b)
    q = np.union1d(np.arange(1, n + 1) / n, np.arange(1, m + 1) / m)
    edges = np.concatenate([[0.0], q])
    w = np.diff(edges)
    mid = (edges[:-1] + edges[1:]) / 2
    ia = np.minimum((mid * n).astype(np.int64), n - 1)
    ib = np.minimum((mid * m).astype(np.int64), m - 1)
    return float(np.sum(w * np.abs(a[ia] - b[ib]) ** p))
