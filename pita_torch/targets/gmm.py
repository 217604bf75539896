"""GMM-40, the 40-mode 2-D Gaussian mixture target, and its exact oracles.

Counterpart of ``pita_tpu/targets/gmm.py``: ``GMM40`` (mode locations from
the asset ``pita_tpu/assets/gmm40_locs.npy``, read by path; per-dimension
scale softplus(log_var_scaling); with ``normalized`` both divided by 50;
``log_prob = log p(x) / T``), ``noised_gmm_log_prob``, the exact oracles
``GMMScoreOracle`` and ``GMMEnergyOracle`` in the port's wrapper protocol
(no ``params`` argument), and the host-numpy ``gmm_product`` and
``gmm_power``, which build the exact GMM proportional to p(x)^β.

Draws come from a ``torch.Generator``: the data sets have pita_tpu's
distribution and sizes, not its ``jax.random`` numbers (set k of
``data_seed`` s is drawn from a generator seeded with 3·s + k).
"""

import math
import os

import numpy as np
import torch

from pita_torch.nets.precondition import bcast
from pita_torch.targets.base import Target

_ASSET = os.path.join(os.path.dirname(__file__), "..", "..", "pita_tpu", "assets",
                      "gmm40_locs.npy")


def _softplus(x):
    return math.log1p(math.exp(x))


def _component_log_probs(x, locs, scales, log_weights):
    """log w_k + log N(x; μ_k, diag s_k²) per component; x (..., D) → (..., K).
    ``scales`` may carry leading batch axes, (..., K, D)."""
    d = x.shape[-1]
    z = (x[..., None, :] - locs) / scales
    comp = (-0.5 * (z ** 2).sum(-1) - torch.log(scales).sum(-1)
            - 0.5 * d * math.log(2 * math.pi))
    return comp + torch.log_softmax(log_weights, -1)


class GMM40(Target):
    """40-mode GMM in 2D, modes ~ U(-40, 40)² (fab seed 0), σ ≈ 1.3133."""

    is_molecule = False
    name = "gmm"

    def __init__(self, dimensionality: int = 2, n_mixes: int = 40, loc_scaling: float = 40.0,
                 log_var_scaling: float = 1.0, temperature: float = 1.0, locs=None,
                 scales=None, log_weights=None, train_set_size: int = 100000,
                 val_set_size: int = 10000, test_set_size: int = 10000, data_seed: int = 0,
                 normalized: bool = False, data_normalization_factor: float = 50.0):
        self.dim = dimensionality
        self.n_spatial_dim = dimensionality
        self.temperature = float(temperature)
        if locs is None:
            locs = np.load(os.path.abspath(_ASSET))[:n_mixes]
            if locs.shape != (n_mixes, dimensionality):
                raise ValueError("the asset holds 40 modes in 2D")
        if scales is None:
            scales = np.full((n_mixes, dimensionality), _softplus(log_var_scaling))
        if normalized:
            locs = np.asarray(locs) / data_normalization_factor
            scales = np.asarray(scales) / data_normalization_factor
        self.normalized = normalized
        if log_weights is None:
            log_weights = np.zeros((n_mixes,))
        # float32 host copies, as pita_tpu stores them; moved to a device on use
        self.locs = torch.as_tensor(np.asarray(locs, np.float32))
        self.scales = torch.as_tensor(np.asarray(scales, np.float32))
        self.log_weights = torch.as_tensor(np.asarray(log_weights, np.float32))
        self.n_mixes = n_mixes
        self._set_sizes = dict(train=train_set_size, val=val_set_size, test=test_set_size)
        self._data_seed = data_seed

    def params_on(self, device):
        """(locs, scales, log_weights) on ``device``."""
        return tuple(p.to(device) for p in (self.locs, self.scales, self.log_weights))

    def log_prob(self, x):
        comp = _component_log_probs(x, *self.params_on(x.device))
        return torch.logsumexp(comp, -1) / self.temperature

    def sample(self, num_samples: int, generator):
        """``num_samples`` exact draws, on the generator's device."""
        locs, scales, logw = self.params_on(generator.device)
        comp = torch.multinomial(torch.softmax(logw, -1), num_samples, replacement=True,
                                 generator=generator)
        eps = torch.randn((num_samples, self.dim), generator=generator,
                          device=generator.device)
        return locs[comp] + scales[comp] * eps

    def _make_set(self, which, device):
        k = dict(train=0, val=1, test=2)[which]
        gen = torch.Generator(device or "cpu").manual_seed(3 * self._data_seed + k)
        return self.sample(self._set_sizes[which], gen).cpu().numpy()

    def setup_train_set(self, device=None):
        return self._make_set("train", device)

    def setup_val_set(self, device=None):
        return self._make_set("val", device)

    def setup_test_set(self, device=None):
        return self._make_set("test", device)


def noised_gmm_log_prob(gmm: GMM40, ht, x):
    """log density of the VE-noised GMM (gmm.py:113-132): convolving each
    component with N(0, h I) widens it to sqrt(s² + h). ht (B,), x (B, D);
    differentiable in both."""
    locs, scales, logw = gmm.params_on(x.device)
    ht = torch.as_tensor(ht, dtype=x.dtype, device=x.device).reshape(-1, 1, 1)
    s = torch.sqrt(scales[None] ** 2 + ht)  # (B, K, D)
    return torch.logsumexp(_component_log_probs(x, locs, s, logw), -1)


class GMMScoreOracle:
    """The exact noised-GMM score in ScoreWrapper's protocol. pita_tpu takes
    it by ``jax.grad``; here it is the closed form Σ_k r_k (μ_k − x)/(s_k²+h)
    with the responsibilities r, differentiable in x by plain autograd."""

    def __init__(self, gmm: GMM40):
        self.gmm = gmm

    def score(self, ht, xt, beta):
        locs, scales, logw = self.gmm.params_on(xt.device)
        var = scales[None] ** 2 + bcast(ht, xt.shape[0], xt)[:, None, None]  # (B, K, D)
        r = torch.softmax(_component_log_probs(xt, locs, var.sqrt(), logw), -1)
        return (r[..., None] * (locs - xt[:, None, :]) / var).sum(1)

    def denoiser(self, ht, xt, beta):
        return xt + bcast(ht, xt.shape[0], xt)[:, None] * self.score(ht, xt, beta)


class GMMEnergyOracle:
    """The exact noised-GMM energy −log p_h(x) in EnergyWrapper's protocol;
    the pinning arguments are taken and ignored, as in pita_tpu."""

    def __init__(self, gmm: GMM40):
        self.gmm = gmm

    def energy(self, ht, xt, beta, **kw):
        return -noised_gmm_log_prob(self.gmm, bcast(ht, xt.shape[0], xt), xt)


def gmm_product(a: GMM40, b: GMM40, prune: float = 1e-4) -> GMM40:
    """Exact product density of two GMMs over all component pairs, the
    negligible ones pruned (copy of pita_tpu/targets/gmm.py:161-193)."""
    mu1 = a.locs.numpy()[:, None, :]
    mu2 = b.locs.numpy()[None, :, :]
    v1 = a.scales.numpy()[:, None, :] ** 2
    v2 = b.scales.numpy()[None, :, :] ** 2
    logw = a.log_weights.numpy()[:, None] + b.log_weights.numpy()[None, :]

    denom = v1 + v2
    mu = (mu1 * v2 + mu2 * v1) / denom
    std = np.sqrt(v1 * v2 / denom)
    diff = mu1 - mu2
    logw = (logw - 0.5 * np.log(2 * math.pi * np.prod(denom, axis=-1))
            + np.sum(-(diff ** 2) / (2 * denom), axis=-1))

    D = mu.shape[-1]
    mu, std, logw = mu.reshape(-1, D), std.reshape(-1, D), logw.reshape(-1)
    w = np.exp(logw - logw.max())
    mask = w / w.sum() > prune
    return GMM40(dimensionality=a.dim, n_mixes=int(mask.sum()), locs=mu[mask],
                 scales=std[mask], log_weights=logw[mask])


def gmm_power(base: GMM40, beta: int) -> GMM40:
    """Exact GMM ∝ p(x)^β for integer β (gmm.py:196-202)."""
    if int(beta) != beta or beta < 1:
        raise ValueError(f"gmm_power takes an integer beta >= 1, got {beta}")
    out = base
    for _ in range(int(beta) - 1):
        out = gmm_product(base, out)
    return out
