"""TICA (time-lagged independent component analysis).

Counterpart of ``pita_tpu/metrics/tica.py``: the generalized symmetric
eigenproblem ``C_τ v = λ C_0 v`` of the symmetrized lagged covariance,
solved by scipy's ``eigh``, on dihedral sin/cos and CA-distance features.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch


class TICAModel(NamedTuple):
    mean: np.ndarray
    components: np.ndarray  # (d, k) projection matrix
    eigenvalues: np.ndarray
    lagtime: int

    def transform(self, features: np.ndarray) -> np.ndarray:
        return (features - self.mean) @ self.components


def tica_fit(features: np.ndarray, lagtime: int = 10, dim: int = 2, eps: float = 1e-6):
    """Fit TICA on (T, d) time-ordered features."""
    from scipy.linalg import eigh

    X = np.asarray(features, np.float64)
    mean = X.mean(axis=0)
    X = X - mean
    T = X.shape[0]
    assert T > lagtime, "trajectory shorter than the lag time"
    X0, Xt = X[:-lagtime], X[lagtime:]
    C0 = (X0.T @ X0 + Xt.T @ Xt) / (2 * (T - lagtime))
    Ct = (X0.T @ Xt + Xt.T @ X0) / (2 * (T - lagtime))  # symmetrized
    C0 = C0 + eps * np.eye(C0.shape[0])
    w, v = eigh(Ct, C0)
    order = np.argsort(w)[::-1]
    w, v = w[order][:dim], v[:, order][:, :dim]
    return TICAModel(mean=mean, components=v, eigenvalues=w, lagtime=lagtime)


def tica_features(target, x: np.ndarray) -> np.ndarray:
    """Dihedral sin/cos + CA-distance features; x: (T, dim) nm, target an
    ALPEnergy-like object with ``dihedrals`` and ``topology``."""
    phi, psi = target.dihedrals(torch.as_tensor(np.asarray(x)))
    phi, psi = phi.cpu().numpy(), psi.cpu().numpy()
    feats = [np.sin(phi), np.cos(phi), np.sin(psi), np.cos(psi)]
    ca = [i for i, n in enumerate(target.topology["names"]) if n == "CA"]
    if len(ca) >= 2:
        xr = np.asarray(x).reshape(len(x), -1, 3)
        for i in range(len(ca)):
            for j in range(i + 1, len(ca)):
                feats.append(np.linalg.norm(xr[:, ca[i]] - xr[:, ca[j]], axis=-1)[:, None])
    return np.concatenate(feats, axis=-1)


def run_tica(target, data: np.ndarray, generated: Optional[np.ndarray] = None,
             lagtime: int = 10, dim: int = 2):
    """Fit on the data's features, project both sets."""
    f_data = tica_features(target, data)
    model = tica_fit(f_data, lagtime=lagtime, dim=dim)
    out = {"model": model, "data_proj": model.transform(f_data)}
    if generated is not None:
        out["generated_proj"] = model.transform(tica_features(target, generated))
    return out
