"""Base Boltzmann target density.

Counterpart of ``pita_tpu/targets/base.py`` for what the trainer reads:
``log_prob(x)`` ``(..., D) -> (...,)``, ``log_prob_and_force(x)`` (force =
∇ₓ log_prob by autograd), ``at_temperature``, the train/val/test sets,
``interatomic_dist`` and the evaluation hook ``log_on_epoch_end``.
Temperature enters as ``-E(x)/T``.

A set is built on first use by ``setup_{which}_set(device)`` and kept as a
host array; ``sample_{which}_set`` draws rows uniformly with replacement
from a ``torch.Generator`` and returns them on the generator's device.
"""

import copy

import torch


class Target:
    """A (possibly tempered) Boltzmann density on R^dim."""

    dim: int
    n_particles: int = 1
    n_spatial_dim: int = 1
    is_molecule: bool = False
    temperature: float = 1.0
    name: str = "target"

    _train_set = None
    _val_set = None
    _test_set = None

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_prob_and_force(self, x: torch.Tensor):
        """(log_prob, force) with force = ∇ₓ log_prob."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            lp = self.log_prob(xx)
            (force,) = torch.autograd.grad(lp.sum(), xx)
        return lp.detach(), force

    def at_temperature(self, temperature: float) -> "Target":
        """A copy of this target at another temperature, with no data set
        cached (a set belongs to the temperature it was sampled at)."""
        new = copy.copy(self)
        new.temperature = float(temperature)
        new._train_set = new._val_set = new._test_set = None
        return new

    # ---- data sets ----

    def setup_train_set(self, device=None):
        return None

    def setup_val_set(self, device=None):
        return None

    def setup_test_set(self, device=None):
        return None

    def _sample_set(self, which: str, num: int, generator):
        data = getattr(self, f"_{which}_set")
        if data is None:
            data = getattr(self, f"setup_{which}_set")(generator.device)
            setattr(self, f"_{which}_set", data)
        if data is None:
            raise ValueError(f"{self.name} has no {which} set")
        idx = torch.randint(0, data.shape[0], (num,), generator=generator,
                            device=generator.device)
        return torch.as_tensor(data, device=generator.device)[idx]

    def sample_train_set(self, num: int, generator):
        return self._sample_set("train", num, generator)

    def sample_val_set(self, num: int, generator):
        return self._sample_set("val", num, generator)

    def sample_test_set(self, num: int, generator):
        return self._sample_set("test", num, generator)

    # ---- geometry (molecules) ----

    def interatomic_dist(self, x: torch.Tensor) -> torch.Tensor:
        """Upper-triangle pairwise distances, (B, n_pairs)
        (base_molecule_energy_function.py:104-118)."""
        B = x.shape[0]
        xr = x.reshape(B, self.n_particles, self.n_spatial_dim)
        d2 = ((xr[:, :, None, :] - xr[:, None, :, :]) ** 2).sum(-1)
        iu = torch.triu_indices(self.n_particles, self.n_particles, 1, device=x.device)
        return torch.sqrt(d2[:, iu[0], iu[1]])

    def log_on_epoch_end(self, samples, data, *, prefix: str = "val", out_dir=None,
                         samples_not_resampled=None, make_plots: bool = False) -> dict:
        """Target-specific evaluation hook of the trainer's ``evaluate`` and
        ``test`` (base.py:146-163): extra metrics, and figures under
        ``out_dir`` with ``make_plots``. A base target adds nothing."""
        return {}
