"""Data-set plumbing: download by URL with a checksum, the centre-of-mass
likelihood correction, importance weights and reweighted histograms.

Counterpart of ``pita_tpu/io/datamodule.py:22-157`` (the reference's
``base_datamodule.py``: ``prepare_data`` downloads the MD set by URL,
:63-83; ``energy`` adds the CoM correction for proposals that are not
mean-free, :186-205; ``get_dataset_fig`` draws distance and energy
histograms with the generated samples importance-reweighted, :362-491).
The download uses the standard library's ``urllib``.
"""

import hashlib
import math
import os
import urllib.error
import urllib.request
from typing import Optional

import numpy as np
import torch


def download_dataset(url: str, path: str, sha256: Optional[str] = None,
                     timeout: float = 300.0) -> str:
    """Fetch ``url`` to ``path`` unless the file is there, and check its
    SHA-256 when ``sha256`` is given. Without network, or for a bad URL, it
    raises a ``RuntimeError`` that says where to put the file instead."""
    if os.path.exists(path):
        if sha256 is not None:
            _verify_checksum(path, sha256)
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as response:
            content = response.read()
    except (urllib.error.URLError, OSError, ValueError) as e:
        raise RuntimeError(f"dataset download failed for {url} ({e}); place the file at "
                           f"{path} manually or use a generated dataset") from e
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(content)
    if sha256 is not None:
        try:
            _verify_checksum(tmp, sha256)
        except RuntimeError:
            os.remove(tmp)
            raise
    os.replace(tmp, path)
    return path


def _verify_checksum(path: str, sha256: str):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != sha256:
        raise RuntimeError(f"checksum mismatch for {path}: got {h.hexdigest()}, want {sha256}")


def com_energy_correction(x: torch.Tensor, n_particles: int, n_dim: int,
                          proposal_com_std: float) -> torch.Tensor:
    """The energy of the centre of mass under a proposal whose samples carry
    an isotropic Gaussian CoM of scale σ (base_datamodule.py:186-205), the
    negative log of the χ-distributed CoM norm:

        E_com = |com|²/(2σ²) − log(|com|² / (√2·σ³·Γ(3/2))).
    """
    com = x.reshape(x.shape[0], n_particles, n_dim).mean(1)
    com2 = (com ** 2).sum(-1)
    s = proposal_com_std
    return com2 / (2 * s ** 2) - torch.log(com2 / (math.sqrt(2.0) * s ** 3 * math.gamma(1.5)))


def importance_weights(target, samples: torch.Tensor, log_p_samples: torch.Tensor,
                       use_com_energy: bool = False,
                       proposal_com_std: Optional[float] = None) -> torch.Tensor:
    """Self-normalized weights softmax(−E(x) − log q(x))
    (base_datamodule.py:420-423), optionally with the CoM correction."""
    energy = -target.log_prob(samples)
    if use_com_energy:
        if proposal_com_std is None:
            raise ValueError("the CoM correction needs proposal_com_std")
        energy = energy + com_energy_correction(samples, target.n_particles,
                                                target.n_spatial_dim, proposal_com_std)
    logits = -energy.reshape(-1) - torch.as_tensor(log_p_samples).to(energy).reshape(-1)
    return torch.softmax(logits, 0)


def plot_reweighted_histograms(target, samples, log_p_samples, data, out_dir: str,
                               name: str = "reweighted_hist", use_com_energy: bool = False,
                               proposal_com_std: Optional[float] = None, bins: int = 100):
    """Interatomic-distance (molecules) and energy histograms of the data,
    the proposal's samples and the samples importance-reweighted against the
    target (get_dataset_fig, base_datamodule.py:362-491). Writes
    ``<out_dir>/<name>.png`` and returns its path. Needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    samples, data = torch.as_tensor(samples), torch.as_tensor(data)
    with torch.no_grad():
        w = importance_weights(target, samples, log_p_samples, use_com_energy=use_com_energy,
                               proposal_com_std=proposal_com_std).cpu().numpy()
        e_gen = (-target.log_prob(samples)).cpu().numpy()
        e_data = (-target.log_prob(data)).cpu().numpy()
    fig, axs = plt.subplots(1, 2, figsize=(12, 4))
    step = dict(bins=bins, density=True, histtype="step", linewidth=3)
    if getattr(target, "is_molecule", False):
        d_gen = target.interatomic_dist(samples).cpu().numpy()
        d_data = target.interatomic_dist(data).cpu().numpy()
        axs[0].hist(d_data.ravel(), label="True data", color="g", **step)
        axs[0].hist(d_gen.ravel(), label="Proposal", color="r", **step)
        w_dist = np.repeat(w, d_gen.shape[1]) / d_gen.shape[1]
        axs[0].hist(d_gen.ravel(), weights=w_dist, label="Reweighted", color="orange", **step)
        axs[0].set_xlabel("Interatomic distance")
        axs[0].legend()
    lo = float(min(e_data.min(), np.percentile(e_gen, 1)))
    hi = float(max(e_data.max(), np.percentile(e_gen, 99)))
    axs[1].hist(e_data, range=(lo, hi), label="True data", color="g", **step)
    axs[1].hist(e_gen, range=(lo, hi), label="Proposal", color="r", **step)
    axs[1].hist(e_gen, range=(lo, hi), weights=w, label="Reweighted", color="orange", **step)
    axs[1].set_xlabel("Energy")
    axs[1].legend()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.png")
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return path
