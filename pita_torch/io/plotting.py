"""The reference's evaluation figures, saved as PNGs.

Counterpart of ``pita_tpu/io/plotting.py``: generated-against-data energy
and interatomic-distance histograms with the not-resampled overlay, GMM
contours with the samples, Ramachandran φ/ψ free energies, TICA densities,
and the sampler diagnostics of every evaluation (per-step log-weights and
their spread, unique ancestors, MALA acceptance, SDE-term spreads, the
annealing γ(t) curve). Inputs may be tensors on any device or arrays; the
figures are drawn on the host with matplotlib, which is imported only when
a figure is made.
"""

import os

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _save(fig, out_dir, name):
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_energy_histograms(generated_energies, data_energies, out_dir, name="energy_hist",
                           not_resampled_energies=None, max_bins=100):
    """Generated-against-data energy histogram (base_molecule_energy_function.py:160-254)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    g = _np(generated_energies).ravel()
    d = _np(data_energies).ravel()
    lo = min(np.percentile(g, 1), np.percentile(d, 1))
    hi = max(np.percentile(g, 99), np.percentile(d, 99))
    bins = np.linspace(lo, hi, max_bins)
    ax.hist(d, bins=bins, density=True, alpha=0.5, label="data")
    ax.hist(g, bins=bins, density=True, alpha=0.5, label="generated")
    if not_resampled_energies is not None:
        ax.hist(_np(not_resampled_energies).ravel(), bins=bins, density=True,
                histtype="step", label="not resampled")
    ax.set_xlabel("energy")
    ax.legend()
    return _save(fig, out_dir, name)


def plot_interatomic_distances(target, generated, data, out_dir, name="dist_hist"):
    import matplotlib.pyplot as plt

    as_t = lambda x: x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    fig, ax = plt.subplots(figsize=(7, 4))
    dg = _np(target.interatomic_dist(as_t(generated))).ravel()
    dd = _np(target.interatomic_dist(as_t(data))).ravel()
    bins = np.linspace(0, np.percentile(dd, 99.5) * 1.2, 100)
    ax.hist(dd, bins=bins, density=True, alpha=0.5, label="data")
    ax.hist(dg, bins=bins, density=True, alpha=0.5, label="generated")
    ax.set_xlabel("interatomic distance")
    ax.legend()
    return _save(fig, out_dir, name)


def plot_gmm_contours(gmm, samples, out_dir, name="gmm_samples", bounds=(-56, 56),
                      grid_n=200, n_contours=50):
    """Contours of a 2-D log-density with the samples (gmm_energy.py:181-254)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    xs = np.linspace(*bounds, grid_n)
    gx, gy = np.meshgrid(xs, xs)
    grid = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1), dtype=torch.float32)
    lp = _np(gmm.log_prob(grid)).reshape(grid_n, grid_n)
    ax.contour(gx, gy, lp, levels=n_contours)
    s = np.clip(_np(samples), bounds[0], bounds[1])
    ax.scatter(s[:, 0], s[:, 1], s=2, alpha=0.4, c="red")
    ax.set_xlim(bounds)
    ax.set_ylim(bounds)
    return _save(fig, out_dir, name)


def plot_ramachandran(phi, psi, out_dir, name="ramachandran", temperature=None):
    """φ/ψ density with a free-energy colorbar (alp_energy.py:301-431)."""
    import matplotlib.pyplot as plt

    phi, psi = _np(phi).ravel(), _np(psi).ravel()
    fig, ax = plt.subplots(figsize=(5.5, 5))
    h, _, _ = np.histogram2d(phi, psi, bins=64, range=[[-np.pi, np.pi], [-np.pi, np.pi]],
                             density=True)
    free_energy = -np.log(h.T + 1e-9)
    free_energy -= free_energy.min()
    im = ax.imshow(free_energy, origin="lower", extent=[-np.pi, np.pi, -np.pi, np.pi],
                   aspect="auto", cmap="viridis")
    fig.colorbar(im, ax=ax, label="free energy [kT]")
    ax.set_xlabel(r"$\phi$")
    ax.set_ylabel(r"$\psi$")
    if temperature is not None:
        ax.set_title(f"T = {temperature:g} K")
    return _save(fig, out_dir, name)


def plot_tica_density(proj_data, out_dir, name="tica", proj_generated=None):
    """Density in the first two TICA components (tica.py:42-51)."""
    import matplotlib.pyplot as plt

    projs = [proj_data] + ([proj_generated] if proj_generated is not None else [])
    fig, axs = plt.subplots(1, len(projs), figsize=(5.5 * len(projs), 4.5), squeeze=False)
    for ax, proj, title in zip(axs[0], projs, ["data", "generated"]):
        p = _np(proj)
        ax.hist2d(p[:, 0], p[:, 1], bins=64, cmap="viridis")
        ax.set_xlabel("TIC 1")
        ax.set_ylabel("TIC 2")
        ax.set_title(title)
    return _save(fig, out_dir, name)


def plot_logweights(logweights, out_dir, name="logweights", n_show=15):
    """Per-step log-weight trajectories and their spread (energytemp_module.py:1100-1115)."""
    import matplotlib.pyplot as plt

    lw = _np(logweights)
    fig, axs = plt.subplots(1, 2, figsize=(12, 4))
    times = np.linspace(1, 0, lw.shape[0])
    idx = np.random.default_rng(0).integers(0, lw.shape[1], n_show)
    axs[0].plot(times, lw[:, idx])
    axs[0].set_xlabel("integration time")
    axs[0].set_title("log-weights")
    axs[1].plot(times, lw.std(axis=1))
    axs[1].set_xlabel("integration time")
    axs[1].set_title("std of log-weights")
    return _save(fig, out_dir, name)


def plot_num_unique(num_unique, out_dir, name="num_unique_idxs"):
    import matplotlib.pyplot as plt

    nu = _np(num_unique)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(np.linspace(1, 0, len(nu)), nu)
    ax.set_xlabel("integration time")
    ax.set_ylabel("# unique ancestors")
    return _save(fig, out_dir, name)


def plot_acceptance(acceptance_rates, out_dir, name="acceptance_rate"):
    """MALA acceptance by step; None when no MALA step ran."""
    import matplotlib.pyplot as plt

    a = _np(acceptance_rates)
    if a.size == 0:
        return None
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(a)
    ax.set_xlabel("MALA step")
    ax.set_ylabel("acceptance rate")
    return _save(fig, out_dir, name)


def plot_sde_term_stats(term_stats: dict, out_dir, name="sde_terms"):
    """Spread over the chains of each SDE term by step (:1132-1155); None
    when no term has a per-step curve."""
    import matplotlib.pyplot as plt

    keys = [k for k, v in term_stats.items() if _np(v).ndim == 1]
    if not keys:
        return None
    fig, axs = plt.subplots(1, len(keys), figsize=(5 * len(keys), 3.5), squeeze=False)
    for ax, k in zip(axs[0], keys):
        v = _np(term_stats[k])
        ax.plot(np.linspace(1, 0, len(v)), v)
        ax.set_xlabel("integration time")
        ax.set_title(f"std({k})")
    return _save(fig, out_dir, name)


def plot_annealing_schedule(annealing_schedule, num_steps, out_dir, name="annealing_factor"):
    import matplotlib.pyplot as plt

    t = np.linspace(1, 0, num_steps)
    g = _np(annealing_schedule.gamma(torch.as_tensor(t, dtype=torch.float32)))
    fig, ax = plt.subplots(figsize=(7, 3.5))
    ax.plot(t, g)
    ax.set_xlabel("integration time")
    ax.set_ylabel(r"$\gamma(t)$")
    return _save(fig, out_dir, name)
