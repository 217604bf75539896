"""MLP backbone with sinusoidal coordinate, time and temperature embeddings.

Counterpart of ``pita_tpu/nets/mlp.py``: per-coordinate sinusoidal
embeddings (scale 25), a sinusoidal time embedding and an optional one of
β, residual GELU blocks with the time condition added, and a
zero-initialised last Dense. flax's ``nn.gelu`` is the tanh approximation,
so is this one. ``forward(t, x, beta) -> (B, out_dim)``.

The trainer's backbone protocol, as the DiT3D has it: ``route`` and
``sampler_route`` are always ``"autograd"`` (no kernel exists for the MLP in
either package; pita_tpu computes it in XLA), ``with_route`` returns a copy
with the same weights,
``reset_parameters`` draws flax's initial distributions. Weights are in
``nn.Linear``'s (out, in) layout; ``pita_torch.io.flax_params
.mlp_params_from_tree`` carries a flax tree across.
"""

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from pita_torch.nets.egnn import lecun_normal_


def sinusoidal_embedding(x: torch.Tensor, size: int, scale: float = 1.0) -> torch.Tensor:
    """(..., ) → (..., size): sin then cos of x·scale at the frequencies
    exp(k · −ln(10⁴)/(size/2 − 1)), k < size/2 (mlp.py:17-30)."""
    half = size // 2
    k = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(k * -(math.log(10000.0) / (half - 1)))
    args = (x * scale)[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def gelu(x):
    return F.gelu(x, approximate="tanh")


class MLPBackbone(nn.Module):
    """Residual MLP over flattened coordinates, conditioned on (t, β)."""

    route = "autograd"
    sampler_route = "autograd"

    def __init__(self, in_dim: int, out_dim: int, hidden_size: int = 128,
                 hidden_layers: int = 3, emb_size: int = 128, input_scale: float = 25.0,
                 condition_on_temperature: bool = True):
        super().__init__()
        self.emb_size = emb_size
        self.input_scale = input_scale
        self.condition_on_temperature = condition_on_temperature
        n_emb = in_dim + 1 + int(condition_on_temperature)
        self.inp = nn.Linear(n_emb * emb_size, hidden_size)
        self.t_cond = nn.Linear(emb_size, hidden_size)
        self.blocks = nn.ModuleList(nn.Linear(hidden_size, hidden_size)
                                    for _ in range(hidden_layers))
        self.out = nn.Linear(hidden_size, out_dim)

    def reset_parameters(self, generator=None):
        """flax's initial distributions: lecun-normal kernels and zero biases,
        the last Dense all zeros (mlp.py:70). Draws from ``generator`` on the
        weights' device."""
        with torch.no_grad():
            for mod in (self.inp, self.t_cond, *self.blocks):
                lecun_normal_(mod.weight.T, generator)  # fan-in = in_features
                mod.bias.zero_()
            self.out.weight.zero_()
            self.out.bias.zero_()
        return self

    def with_route(self, route: str) -> "MLPBackbone":
        """A copy holding these weights (the MLP has one route)."""
        return copy.deepcopy(self)

    def forward(self, t, x, beta):
        B = x.shape[0]
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1).expand(B)
        coord = sinusoidal_embedding(x, self.emb_size, self.input_scale).reshape(B, -1)
        t_emb = sinusoidal_embedding(t, self.emb_size)
        feats = [coord, t_emb]
        if self.condition_on_temperature:
            bb = torch.as_tensor(beta, dtype=x.dtype, device=x.device).reshape(-1).expand(B)
            feats.append(sinusoidal_embedding(bb, self.emb_size))
        h = gelu(self.inp(torch.cat(feats, dim=-1)))
        t_cond = self.t_cond(t_emb)
        for block in self.blocks:
            h = h + gelu(block(h)) + t_cond
        return self.out(h)
