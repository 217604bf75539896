"""TorchMD-ET-style equivariant transformer backbone, dense formulation.

Counterpart of ``pita_tpu/nets/torchmd_et.py``: scalar features x and
per-node vector features vec; per-edge dot-product attention modulated by
exp-normal radial basis functions of the distances and a cosine cutoff; a
value pathway split into scalar and vector channels with an SO(3)
cross-product term; (t, β) embedded and mixed into the node features;
atom-type one-hots for peptides; two gated equivariant blocks and a
mean-free vector output. 3-D only.

Edges are dense (B, N, N, H, D) tensors and the attention is explicit
``einsum``s, as in pita_tpu (no ``scaled_dot_product_attention``): the
energy loss differentiates it twice.

The trainer's backbone protocol: ``route`` and ``sampler_route`` are always
``"autograd"`` (no kernel exists for it in either package), ``with_route``
returns a copy,
``reset_parameters`` draws flax's initial distributions (lecun-normal
kernels, zero biases, unit LayerNorm scales). Weights are in ``nn.Linear``'s
(out, in) layout; ``pita_torch.io.flax_params.torchmd_et_params_from_tree``
carries a flax tree across. LayerNorms use flax's ε = 1e-6.
"""

import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pita_torch.nets.egnn import lecun_normal_


def exp_normal_smearing(dist, num_rbf: int = 32, cutoff_lower: float = 0.0,
                        cutoff_upper: float = 5.0):
    """Exp-normal radial basis (torchmd_et.py:24-38); dist (...) → (..., num_rbf)."""
    alpha = 5.0 / (cutoff_upper - cutoff_lower)
    start = math.exp(-cutoff_upper + cutoff_lower)
    means = torch.linspace(start, 1.0, num_rbf, device=dist.device)
    beta = (2.0 / num_rbf * (1.0 - start)) ** -2
    d = dist[..., None]
    return torch.exp(-beta * (torch.exp(alpha * (-d + cutoff_lower)) - means) ** 2)


def cosine_cutoff(dist, upper: float = 5.0):
    """(torchmd_et.py:41-44)."""
    c = 0.5 * (torch.cos(dist * math.pi / upper) + 1.0)
    return torch.where(dist < upper, c, torch.zeros_like(c))


def _layernorm(n):
    return nn.LayerNorm(n, eps=1e-6)


class EquivariantMHA(nn.Module):
    """Dense equivariant multi-head attention layer (torchmd_et.py:47-131)."""

    def __init__(self, hidden: int, num_heads: int, num_rbf: int, cutoff_upper: float,
                 qk_norm: bool = True, so3_equivariant: bool = True):
        super().__init__()
        Fh = hidden
        self.num_heads = num_heads
        self.cutoff_upper = cutoff_upper
        self.qk_norm = qk_norm
        self.so3 = so3_equivariant
        n_v = 3 + int(so3_equivariant)
        self.mix0 = nn.Linear(2 * Fh, Fh)
        self.mix1 = nn.Linear(Fh, Fh)
        self.norm_h = _layernorm(Fh)
        self.q = nn.Linear(Fh, Fh)
        self.k = nn.Linear(Fh, Fh)
        if qk_norm:
            self.norm_q = _layernorm(Fh)
            self.norm_k = _layernorm(Fh)
        self.v = nn.Linear(Fh, Fh * n_v)
        self.vec_proj = nn.Linear(Fh, 3 * Fh, bias=False)
        self.dk = nn.Linear(num_rbf, Fh)
        self.dv = nn.Linear(num_rbf, Fh * n_v)
        self.o = nn.Linear(Fh, 3 * Fh)

    def forward(self, x, vec, f_ij, r_ij, d_ij, node_attr, mask):
        """x (B,N,F), vec (B,N,3,F), f_ij (B,N,N,rbf), r_ij (B,N,N),
        d_ij (B,N,N,3), node_attr (B,N,F), mask (N,N)."""
        B, N, Fh = x.shape
        H = self.num_heads
        D = Fh // H
        n_v = 3 + int(self.so3)

        h = self.norm_h(self.mix1(F.silu(self.mix0(torch.cat([x, node_attr], -1)))))
        q, k = self.q(h), self.k(h)
        if self.qk_norm:
            q, k = self.norm_q(q), self.norm_k(k)
        v = self.v(h)
        vec1, vec2, vec3 = self.vec_proj(vec).split(Fh, -1)
        vec_dot = (vec1 * vec2).sum(-2)

        dk = F.silu(self.dk(f_ij)).reshape(B, N, N, H, D)
        dv = F.silu(self.dv(f_ij)).reshape(B, N, N, H, n_v * D)
        q = q.reshape(B, N, H, D)
        k = k.reshape(B, N, H, D)
        v = v.reshape(B, N, H, n_v * D)

        attn = torch.einsum("bihd,bjhd,bijhd->bijh", q, k, dk)
        attn = F.silu(attn) * cosine_cutoff(r_ij, self.cutoff_upper)[..., None]
        attn = attn * mask[None, :, :, None]

        v_j = v[:, None] * dv  # (B,N,N,H,n_v*D)
        splits = v_j.split(D, -1)
        xs, w1, w2 = splits[0], splits[1], splits[2]
        xs = xs * attn[..., None] * mask[None, :, :, None, None]
        vec_j = vec.reshape(B, 1, N, 3, H, D).expand(B, N, N, 3, H, D)
        vmsg = vec_j * w1[:, :, :, None] + w2[:, :, :, None] * d_ij[..., None, None]
        if self.so3:
            d_exp = d_ij[..., None, None].expand(B, N, N, 3, H, D)
            vmsg = vmsg + splits[3][:, :, :, None] * torch.linalg.cross(d_exp, vec_j, dim=3)
        vmsg = vmsg * mask[None, :, :, None, None, None]

        dx_agg = xs.sum(2).reshape(B, N, Fh)
        dvec_agg = vmsg.sum(2).reshape(B, N, 3, Fh)
        o1, o2, o3 = self.o(dx_agg).split(Fh, -1)
        dvec = vec3 * o1[:, :, None, :] + dvec_agg
        dx = vec_dot * o2 + o3
        return x + dx, vec + dvec


class GatedEquivariantBlock(nn.Module):
    """(torchmd_et.py:134-156)."""

    def __init__(self, in_channels: int, out_channels: int, vector_output: bool = False):
        super().__init__()
        self.vector_output = vector_output
        self.vec1 = nn.Linear(in_channels, out_channels, bias=False)
        self.vec2 = nn.Linear(in_channels, out_channels, bias=False)
        self.mix0 = nn.Linear(in_channels + out_channels, out_channels)
        self.mix1 = nn.Linear(out_channels, 2 * out_channels)

    def forward(self, x, vec):
        v1_norm = torch.linalg.vector_norm(self.vec1(vec), dim=-2)
        h = self.mix1(F.silu(self.mix0(torch.cat([x, v1_norm], -1))))
        xo, gate = h.chunk(2, -1)
        vec_out = self.vec2(vec) * gate[:, :, None, :]
        if not self.vector_output:
            xo = F.silu(xo)
        return xo, vec_out


class TorchMDETBackbone(nn.Module):
    """forward(t, x_flat, beta) -> mean-free displacement (B, N·3)."""

    route = "autograd"
    sampler_route = "autograd"

    def __init__(self, n_particles: int, n_spatial_dim: int = 3, hidden: int = 32,
                 n_layers: int = 6, num_heads: int = 1, num_rbf: int = 32,
                 cutoff_upper: float = 5.0, qk_norm: bool = True,
                 so3_equivariant: bool = True, condition_on_temperature: bool = True,
                 atom_types: Optional[tuple] = None):
        super().__init__()
        if n_spatial_dim != 3:
            raise ValueError("TorchMD-ET takes 3-D coordinates (its cross-product term)")
        self.n_particles = n_particles
        self.n_spatial_dim = 3
        self.num_rbf = num_rbf
        self.cutoff_upper = cutoff_upper
        self.condition_on_temperature = condition_on_temperature
        self.atom_types = None if atom_types is None else tuple(int(a) for a in atom_types)
        n_types = 1 if atom_types is None else max(self.atom_types) + 1
        self.embed = nn.Linear(n_types, hidden)
        self.attr = nn.Linear(1 + int(condition_on_temperature), hidden)
        self.layers = nn.ModuleList(
            EquivariantMHA(hidden, num_heads, num_rbf, cutoff_upper, qk_norm, so3_equivariant)
            for _ in range(n_layers))
        self.head = nn.ModuleList([GatedEquivariantBlock(hidden, hidden // 2),
                                   GatedEquivariantBlock(hidden // 2, 1, vector_output=True)])

    def reset_parameters(self, generator=None):
        """flax's initial distributions: lecun-normal kernels, zero biases,
        unit LayerNorm scales and zero offsets. Draws from ``generator`` on
        the weights' device."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    lecun_normal_(mod.weight.T, generator)  # fan-in = in_features
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
        return self

    def with_route(self, route: str) -> "TorchMDETBackbone":
        """A copy holding these weights (the backbone has one route)."""
        return copy.deepcopy(self)

    def forward(self, t, x, beta):
        B, N = x.shape[0], self.n_particles
        pos = x.reshape(B, N, 3)
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1).expand(B)
        eye = torch.eye(N, dtype=torch.bool, device=x.device)
        mask = (~eye).to(x.dtype)

        diff = pos[:, :, None, :] - pos[:, None, :, :]
        r2 = (diff ** 2).sum(-1)
        r_ij = torch.sqrt(torch.where(eye, torch.ones_like(r2), r2))
        d_ij = diff / (r_ij[..., None] + 1e-9)
        f_ij = exp_normal_smearing(r_ij, self.num_rbf, cutoff_upper=self.cutoff_upper)

        if self.atom_types is not None:
            types = torch.as_tensor(self.atom_types, device=x.device)
            h0 = F.one_hot(types, self.embed.in_features).to(x.dtype).expand(B, N, -1)
        else:
            h0 = torch.zeros(B, N, 1, dtype=x.dtype, device=x.device)
        xfeat = self.embed(h0)
        vec = torch.zeros(B, N, 3, xfeat.shape[-1], dtype=x.dtype, device=x.device)

        attrs = [t[:, None, None].expand(B, N, 1)]
        if self.condition_on_temperature:
            bb = torch.as_tensor(beta, dtype=x.dtype, device=x.device).reshape(-1).expand(B)
            attrs.append(bb[:, None, None].expand(B, N, 1))
        node_attr = self.attr(torch.cat(attrs, -1))

        for layer in self.layers:
            xfeat, vec = layer(xfeat, vec, f_ij, r_ij, d_ij, node_attr, mask)
        for block in self.head:
            xfeat, vec = block(xfeat, vec)
        out = vec[..., 0]
        out = out - out.mean(1, keepdim=True)
        return out.reshape(B, N * 3)
