"""DiT3D, a non-equivariant diffusion transformer over particles as tokens.

Counterpart of ``pita_tpu/nets/dit.py`` (``TimestepEmbedder``, ``_rotary``,
``DDiTBlock``, ``DiT3DBackbone``): a linear embedding of each particle's
coordinates, sinusoidal embeddings of t and β summed into the adaLN
condition, rotary position embeddings on q and k (interleaved pairs, in
float32), blocks of adaLN-modulated attention and a tanh-GELU MLP, and a
zero-initialised final layer.

As in flax: LayerNorm with ε = 1e-6 and a scale but no bias; the block
stack's matmuls take ``compute_dtype`` inputs (bfloat16 by default; float32
is possible) while the layernorms, the modulation, the rotary embedding and
the softmax run in float32, with the casts where ``pita_tpu`` puts them.
Attention is an explicit einsum, softmax, einsum: the energy loss takes a
second derivative through it.

The trainer's backbone protocol: ``route`` and ``sampler_route`` are always
``"autograd"``,
``with_route`` returns a copy with the same weights, ``reset_parameters``
draws flax's initial distributions (lecun-normal kernels, zero biases, unit
LayerNorm scales, and zeros where flax zeroes). Weights are in
``nn.Linear``'s (out, in) layout; ``pita_torch.io.flax_params
.dit_params_from_tree`` carries a flax tree across. Each forward is a span
``dit.forward`` (``pita_torch/utils/tracing.py``) with its row count.
"""

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from pita_torch.nets.egnn import lecun_normal_
from pita_torch.utils.tracing import span


def _dtype(d) -> torch.dtype:
    """A torch dtype from a dtype or its name ("bfloat16", "float32")."""
    return getattr(torch, d) if isinstance(d, str) else d


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequency embedding → 2-layer SiLU MLP."""

    def __init__(self, cond_dim: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp0 = nn.Linear(freq_dim, cond_dim)
        self.mlp1 = nn.Linear(cond_dim, cond_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.freq_dim // 2
        k = torch.arange(half, dtype=torch.float32, device=t.device)
        freqs = torch.exp(-math.log(10000.0) * k / half)
        args = t[:, None].float() * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.mlp1(F.silu(self.mlp0(emb)))


def rotary(q: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embeddings over the token axis, pairs interleaved
    (dimensions 0::2 with 1::2); q: (B, S, H, Dh) float32."""
    B, S, H, Dh = q.shape
    half = Dh // 2
    inv_freq = 1.0 / (base ** (torch.arange(half, dtype=torch.float32, device=q.device) / half))
    freqs = torch.arange(S, dtype=torch.float32, device=q.device)[:, None] * inv_freq[None, :]
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    q1, q2 = q[..., 0::2], q[..., 1::2]
    return torch.stack([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1).reshape(B, S, H, Dh)


def _linear(h, layer, dtype):
    """flax Dense with ``dtype``: input, kernel and bias cast first."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(h.to(dtype), layer.weight.to(dtype), b)


class DDiTBlock(nn.Module):
    """adaLN-modulated attention + MLP block."""

    def __init__(self, dim: int, n_heads: int, cond_dim: int, mlp_ratio: int = 4,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.dim = dim
        self.n_heads = n_heads
        self.compute_dtype = _dtype(compute_dtype)
        self.ada = nn.Linear(cond_dim, 6 * dim)  # zero-initialised
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, bias=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.attn_out = nn.Linear(dim, dim, bias=False)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, bias=False)
        self.mlp_up = nn.Linear(dim, mlp_ratio * dim)
        self.mlp_down = nn.Linear(mlp_ratio * dim, dim)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            self.ada(c)[:, None].chunk(6, dim=-1))

        # attention: float32 layernorm, compute-dtype matmuls
        h = self.norm1(x.float())
        h = (h * (1 + scale_msa) + shift_msa).to(cd)
        B, S, _ = h.shape
        Dh = self.dim // self.n_heads
        qkv = _linear(h, self.qkv, cd).reshape(B, S, 3, self.n_heads, Dh)
        q = rotary(qkv[:, :, 0].float()).to(cd)
        k = rotary(qkv[:, :, 1].float()).to(cd)
        v = qkv[:, :, 2]
        attn = torch.einsum("bshd,bthd->bhst", q, k) * (1.0 / math.sqrt(Dh))
        attn = torch.softmax(attn.float(), dim=-1).to(cd)
        o = torch.einsum("bhst,bthd->bshd", attn, v).reshape(B, S, self.dim)
        x = x + gate_msa * _linear(o, self.attn_out, cd).to(x.dtype)

        # MLP
        h = self.norm2(x.float())
        h = (h * (1 + scale_mlp) + shift_mlp).to(cd)
        h = F.gelu(_linear(h, self.mlp_up, cd), approximate="tanh")
        return x + gate_mlp * _linear(h, self.mlp_down, cd).to(x.dtype)


class DiT3DBackbone(nn.Module):
    """forward(t, x, beta) -> (B, n_particles * n_spatial_dim)."""

    route = "autograd"
    sampler_route = "autograd"

    def __init__(self, n_particles: int, n_spatial_dim: int = 3, hidden_size: int = 128,
                 cond_dim: int = 128, n_heads: int = 8, n_blocks: int = 6,
                 condition_on_temperature: bool = True, compute_dtype=torch.bfloat16):
        super().__init__()
        self.n_particles = n_particles
        self.n_spatial_dim = n_spatial_dim
        self.condition_on_temperature = condition_on_temperature
        self.compute_dtype = _dtype(compute_dtype)
        self.embed = nn.Linear(n_spatial_dim, hidden_size)
        self.sigma_map = TimestepEmbedder(cond_dim)
        if condition_on_temperature:
            self.sigma_map_temp = TimestepEmbedder(cond_dim)
        self.blocks = nn.ModuleList(
            DDiTBlock(hidden_size, n_heads, cond_dim, compute_dtype=self.compute_dtype)
            for _ in range(n_blocks))
        self.final_ada = nn.Linear(cond_dim, 2 * hidden_size)  # zero-initialised
        self.final_norm = nn.LayerNorm(hidden_size, eps=1e-6, bias=False)
        self.final_out = nn.Linear(hidden_size, n_spatial_dim)  # zero-initialised
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's initial distributions (dit.py:23-148): lecun-normal kernels
        and zero biases; zeros for each block's modulation, the final
        modulation and the final Dense; unit LayerNorm scales. Draws from
        ``generator`` on the weights' device."""
        zeroed = {self.final_ada, self.final_out} | {b.ada for b in self.blocks}
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                if mod in zeroed:
                    mod.weight.zero_()
                else:
                    lecun_normal_(mod.weight.T, generator)  # fan-in = in_features
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
        return self

    def with_route(self, route: str) -> "DiT3DBackbone":
        """A copy holding these weights (the DiT has one route)."""
        return copy.deepcopy(self)

    def forward(self, t, x, beta):
        with span("dit.forward", rows=x.shape[0]):
            return self._forward(t, x, beta)

    def _forward(self, t, x, beta):
        B = x.shape[0]
        S, V = self.n_particles, self.n_spatial_dim
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(B)
        h = self.embed(x.reshape(B, S, V))
        c = self.sigma_map(t)
        if self.condition_on_temperature:
            beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device).reshape(-1)
            c = c + self.sigma_map_temp(beta.expand(B))
        c = F.silu(c)
        for block in self.blocks:
            h = block(h, c)
        shift, scale = self.final_ada(c)[:, None].chunk(2, dim=-1)
        hf = self.final_norm(h.float()) * (1 + scale) + shift
        return self.final_out(hf).reshape(B, S * V)
