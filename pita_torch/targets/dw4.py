"""DW4: four particles in 2D with pairwise double-well interactions.

Counterpart of ``pita_tpu/targets/dw4.py``: the pair energy
``a·(d−d0)⁴ + b·(d−d0)² + c`` summed over ordered pairs and halved, the
diagonal masked before the square root, ``log_prob = −E/T``.

The data sets are generated as pita_tpu generates them (dw4.py:52-75): 256
MALA chains (``pita_torch.baselines.mcmc.mala_chain``) from N(0, 2²), a
warm-up of ``n_warmup_steps`` steps at dt 1e-3, then blocks of
``n_block_steps`` steps, each block's end state appended, until the set is
full; seeds 21, 22, 23 for train, val and test. The two step counts and the
set sizes are arguments, so that a short run can cut them.
"""

import numpy as np
import torch

from pita_torch.targets.base import Target


class DoubleWell4(Target):
    is_molecule = True
    name = "dw4"

    def __init__(self, n_particles: int = 4, n_spatial_dim: int = 2, a: float = 0.9,
                 b: float = -4.0, c: float = 0.0, offset: float = 4.0,
                 temperature: float = 1.0, train_set_size: int = 10000,
                 val_set_size: int = 2000, test_set_size: int = 2000,
                 n_warmup_steps: int = 2000, n_block_steps: int = 200):
        self.n_particles = n_particles
        self.n_spatial_dim = n_spatial_dim
        self.dim = n_particles * n_spatial_dim
        self.a, self.b, self.c, self.offset = a, b, c, offset
        self.temperature = float(temperature)
        self._set_sizes = dict(train=train_set_size, val=val_set_size, test=test_set_size)
        self.n_warmup_steps = n_warmup_steps
        self.n_block_steps = n_block_steps

    def energy(self, x):
        shape = x.shape[:-1]
        xr = x.reshape(*shape, self.n_particles, self.n_spatial_dim)
        diff = xr[..., :, None, :] - xr[..., None, :, :]
        d2 = (diff ** 2).sum(-1)
        eye = torch.eye(self.n_particles, dtype=torch.bool, device=x.device)
        d = torch.sqrt(torch.where(eye, torch.ones_like(d2), d2))
        dd = d - self.offset
        e_pair = self.a * dd ** 4 + self.b * dd ** 2 + self.c
        return 0.5 * torch.where(eye, torch.zeros_like(e_pair), e_pair).sum((-2, -1))

    def log_prob(self, x):
        return -self.energy(x) / self.temperature

    def _generate(self, which, device):
        from pita_torch.baselines.mcmc import mala_chain

        num_samples = self._set_sizes[which]
        gen = torch.Generator(device or "cpu").manual_seed(dict(train=21, val=22, test=23)[which])
        n_chains = min(num_samples, 256)
        x0 = torch.randn((n_chains, self.dim), generator=gen, device=gen.device) * 2.0
        x, _, dt = mala_chain(self.log_prob_and_force, x0, self.n_warmup_steps, dt=1e-3,
                              generator=gen)
        out = []
        for _ in range(int(np.ceil(num_samples / n_chains))):
            x, _, dt = mala_chain(self.log_prob_and_force, x, self.n_block_steps, dt=dt,
                                  generator=gen)
            out.append(x.cpu().numpy())
        return np.concatenate(out)[:num_samples]

    def setup_train_set(self, device=None):
        return self._generate("train", device)

    def setup_val_set(self, device=None):
        return self._generate("val", device)

    def setup_test_set(self, device=None):
        return self._generate("test", device)
