"""E(3)-equivariant graph network (EGNN), dense formulation.

Counterpart of ``pita_tpu/nets/egnn.py`` (``EGCL``, ``EGNNBackbone``) as
computed by the fused Pallas path (``pita_tpu/ops/pallas/egnn_fwd.py``):
each layer is ``pita_torch.ops.egnn_layer.EGCLFunction`` (kernels K2/K3 on
CUDA, ``layer_step`` on the CPU). The node embedding (egnn_fwd.py:257-273),
the edge attribute (:306-308) and the mean-free output velocity (:495-498)
are plain torch outside the kernels, so the t-, β- and edge_attr→x gradients
flow through autograd as they do in JAX.

Weights keep the JAX (in, out) layout and are loaded from a flax checkpoint
through ``pita_torch.io.flax_params.egnn_params_from_tree``. The port is
inference-only so far: parameters are created with ``requires_grad=False``.
"""

import torch
from torch import nn

from pita_torch.io.flax_params import W_FIELDS
from pita_torch.ops.egnn_layer import EGCLFunction, pack_weights


def _shapes(F):
    return dict(
        w_src=(F, F), b_src=(F,), w_dst=(F, F), w_scal=(2, F), w_e2=(F, F), b_e2=(F,),
        w_att=(F, 1), b_att=(1,), w_c1=(F, F), b_c1=(F,), w_c2=(F, 1),
        w_n1=(2 * F, F), b_n1=(F,), w_n2=(F, F), b_n2=(F,),
    )


class EGCL(nn.Module):
    """One dense E_GCL layer; weights named as egnn_fwd.py:79-82 _W_FIELDS."""

    def __init__(self, hidden_nf: int, attention: bool = True, tanh: bool = True,
                 coords_range: float = 5.0, compute_dtype=torch.float32):
        super().__init__()
        for name, shape in _shapes(hidden_nf).items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape), requires_grad=False))
        self.cfg = dict(attention=attention, tanh=tanh, coords_range=coords_range,
                        cd=compute_dtype)
        self._packed = {}

    def weights(self) -> dict:
        return {f: getattr(self, f) for f in W_FIELDS}

    def packed(self, device) -> torch.Tensor:
        """The kernels' packed weight buffer on ``device``, rebuilt when a
        weight changes."""
        stamp = tuple((p.data_ptr(), p._version) for p in self.weights().values())
        hit = self._packed.get(device)
        if hit is None or hit[0] != stamp:
            buf = pack_weights(self.weights(), self.cfg["cd"]).to(device)
            hit = self._packed[device] = (stamp, buf)
        return hit[1]

    def forward(self, h, x, edge_attr):
        return EGCLFunction.apply(h, x, edge_attr, self)


class EGNNBackbone(nn.Module):
    """EGNN dynamics: forward(t, x_flat, beta) -> mean-free displacement."""

    def __init__(self, n_particles: int, n_spatial_dim: int = 3, hidden_nf: int = 32,
                 n_layers: int = 3, attention: bool = True, tanh: bool = True,
                 condition_on_temperature: bool = True, coords_range: float = 15.0,
                 compute_dtype=torch.float32):
        super().__init__()
        if n_spatial_dim != 3:
            raise ValueError("the EGCL kernels take 3D coordinates")
        self.n_particles = n_particles
        self.n_spatial_dim = n_spatial_dim
        self.hidden_nf = hidden_nf
        self.n_layers = n_layers
        self.attention = attention
        self.condition_on_temperature = condition_on_temperature
        n_in = 2 if condition_on_temperature else 1
        self.w_emb = nn.Parameter(torch.zeros(n_in, hidden_nf), requires_grad=False)
        self.b_emb = nn.Parameter(torch.zeros(hidden_nf), requires_grad=False)
        self.layers = nn.ModuleList(
            EGCL(hidden_nf, attention, tanh, coords_range / n_layers, compute_dtype)
            for _ in range(n_layers)
        )

    def embed(self, t, x, beta):
        """The node embedding h0 (B, N, F) of time and inverse temperature."""
        B, N = x.shape[0], self.n_particles
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1).expand(B)
        feats = [t[:, None, None].expand(B, N, 1)]
        if self.condition_on_temperature:
            bb = torch.as_tensor(beta, dtype=x.dtype, device=x.device).reshape(-1).expand(B)
            feats.append(bb[:, None, None].expand(B, N, 1))
        return torch.cat(feats, dim=-1) @ self.w_emb + self.b_emb

    def forward(self, t, x, beta):
        B = x.shape[0]
        N, D = self.n_particles, self.n_spatial_dim
        xs = x.reshape(B, N, D)
        h = self.embed(t, x, beta)

        diff0 = xs[:, :, None, :] - xs[:, None, :, :]
        edge_attr = (diff0 * diff0).sum(-1)  # (B, N, N)
        xc = xs
        for layer in self.layers:
            h, xc = layer(h.contiguous(), xc.contiguous(), edge_attr)
        vel = xc - xs
        vel = vel - vel.mean(dim=1, keepdim=True)
        return vel.reshape(B, N * D)
