"""Maximum mean discrepancy kernels.

Counterpart of ``pita_tpu/metrics/mmd.py``: linear, polynomial and
RBF-mixture MMD² (the biased estimator over a bandwidth ladder), on tensors
in their own dtype and device.
"""

import torch


def _sq_dists(x, y):
    xx = (x ** 2).sum(-1)
    yy = (y ** 2).sum(-1)
    return xx[:, None] + yy[None, :] - 2 * (x @ y.T)


def linear_mmd2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    delta = x.mean(0) - y.mean(0)
    return delta @ delta


def poly_mmd2(x, y, d: int = 2, alpha: float = 1.0, c: float = 2.0):
    K_xx = (alpha * x @ x.T + c) ** d
    K_yy = (alpha * y @ y.T + c) ** d
    K_xy = (alpha * x @ y.T + c) ** d
    return K_xx.mean() + K_yy.mean() - 2 * K_xy.mean()


def mix_rbf_mmd2(x, y, sigmas=(0.01, 0.1, 1.0, 10.0, 100.0)):
    """RBF-mixture MMD² over a bandwidth ladder."""
    d_xx, d_yy, d_xy = _sq_dists(x, x), _sq_dists(y, y), _sq_dists(x, y)
    total = 0.0
    for s in sigmas:
        gamma = 1.0 / (2 * s ** 2)
        total = total + (torch.exp(-gamma * d_xx).mean() + torch.exp(-gamma * d_yy).mean()
                         - 2 * torch.exp(-gamma * d_xy).mean())
    return total
