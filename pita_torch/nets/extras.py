"""Auxiliary network components.

Counterpart of ``pita_tpu/nets/extras.py``, in the port's wrapper protocol
(wrappers hold their backbone; no ``params`` argument):

- ``SimpleDebugScore``: the exact denoiser toward a fixed data mean, to
  debug the sampler without training;
- ``ScalingWrapper``: fixed input and output scaling around a backbone;
- ``LambdaWeighter``: loss weights λ(h), "edm" (h+1)/h, "ones" or "basic";
- ``ScoreScaler``: σ-dependent score normalization;
- ``FlowWrapper``: a denoiser that is the raw backbone output, without EDM
  preconditioning;
- ``PISNet``: a drift head and a t-dependent Langevin-coefficient head that
  scales a given score (path-integral-sampler style); its flax Dense
  modules 0-4 map to ``drift0``, ``drift1``, ``drift_out``, ``coeff_out`` and
  ``coeff0``.
"""

import torch
from torch import nn

from pita_torch.nets.egnn import lecun_normal_
from pita_torch.nets.mlp import gelu, sinusoidal_embedding
from pita_torch.nets.precondition import bcast


class SimpleDebugScore:
    """ScoreWrapper protocol; the denoiser is the fixed ``data_mean``."""

    def __init__(self, data_mean: torch.Tensor):
        self.data_mean = data_mean

    def denoiser(self, ht, xt, beta, return_score: bool = False):
        D = self.data_mean.to(xt).expand(xt.shape)
        if return_score:
            return D, (D - xt) / bcast(ht, xt.shape[0], xt)[:, None]
        return D

    def score(self, ht, xt, beta):
        return (self.denoiser(ht, xt, beta) - xt) / bcast(ht, xt.shape[0], xt)[:, None]


class ScalingWrapper(nn.Module):
    """Affine input/output scaling around a backbone (scaling_wrapper.py:6-29)."""

    def __init__(self, backbone: nn.Module, input_scale: float = 1.0, output_scale: float = 1.0):
        super().__init__()
        self.backbone = backbone
        self.input_scale = input_scale
        self.output_scale = output_scale

    def forward(self, t, x, beta):
        return self.backbone(t, x * self.input_scale, beta) * self.output_scale


class LambdaWeighter:
    """λ(h) loss weights (lambda_weighter.py:8-25)."""

    def __init__(self, kind: str = "edm", epsilon: float = 1e-3):
        if kind not in ("edm", "ones", "basic"):
            raise ValueError(f"unknown weighting {kind!r}")
        self.kind = kind
        self.epsilon = epsilon

    def __call__(self, ht):
        if self.kind == "edm":
            return (ht + 1.0) / ht
        if self.kind == "ones":
            return torch.ones_like(ht)
        return 1.0 / (ht + self.epsilon)


class ScoreScaler:
    """σ-dependent score normalization (score_scaler.py:8-54)."""

    def __init__(self, noise_schedule, scale_by: str = "sigma"):
        self.noise_schedule = noise_schedule
        self.scale_by = scale_by

    def scale_target_score(self, score, ht):
        return score * torch.sqrt(ht)[:, None]

    def unscale_score(self, scaled, ht):
        return scaled / torch.sqrt(ht)[:, None]


class FlowWrapper:
    """Raw-backbone denoiser, no EDM preconditioning (score_net.py FlowNet)."""

    def __init__(self, backbone):
        self.backbone = backbone

    def denoiser(self, ht, xt, beta, return_score: bool = False):
        ht = bcast(ht, xt.shape[0], xt)
        D = self.backbone(ht, xt, beta)
        if return_score:
            return D, (D - xt) / ht[:, None]
        return D

    def score(self, ht, xt, beta):
        return (self.denoiser(ht, xt, beta) - xt) / bcast(ht, xt.shape[0], xt)[:, None]


class PISNet(nn.Module):
    """Path-integral-sampler net: drift + coeff(t) ⊙ score (pis_net.py:9-62)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_size: int = 64, emb_size: int = 32):
        super().__init__()
        self.emb_size = emb_size
        self.drift0 = nn.Linear(in_dim + emb_size, hidden_size)
        self.drift1 = nn.Linear(hidden_size, hidden_size)
        self.drift_out = nn.Linear(hidden_size, out_dim)
        self.coeff0 = nn.Linear(emb_size, hidden_size)
        self.coeff_out = nn.Linear(hidden_size, out_dim)

    def reset_parameters(self, generator=None):
        """flax's initial distributions; the drift's last Dense all zeros."""
        with torch.no_grad():
            for mod in (self.drift0, self.drift1, self.coeff0, self.coeff_out):
                lecun_normal_(mod.weight.T, generator)
                mod.bias.zero_()
            self.drift_out.weight.zero_()
            self.drift_out.bias.zero_()
        return self

    def forward(self, t, x, score):
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1).expand(x.shape[0])
        t_emb = sinusoidal_embedding(t, self.emb_size)
        h = gelu(self.drift1(gelu(self.drift0(torch.cat([x, t_emb], -1)))))
        coeff = self.coeff_out(gelu(self.coeff0(t_emb)))
        return self.drift_out(h) + coeff * score
