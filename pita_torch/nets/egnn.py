"""E(3)-equivariant graph network (EGNN), dense formulation.

Counterpart of ``pita_tpu/nets/egnn.py`` (``EGCL``, ``EGNNBackbone``) as
computed by the fused Pallas path (``pita_tpu/ops/pallas/egnn_fwd.py``). The
node embedding (egnn_fwd.py:257-273), the edge attribute (:306-308) and the
mean-free output velocity (:495-498) are plain torch outside the layers, so
the t-, β- and edge_attr→x gradients flow through autograd as they do in JAX.

Each layer runs by one of two routes, which the caller chooses when it
builds the backbone (``route=``); nothing switches between them on its own:

- ``"kernels"`` (the sampler's): ``pita_torch.ops.egnn_layer.EGCLFunction``,
  kernels K2/K3 on CUDA and ``layer_step`` on the CPU. Its weights do not
  require grad, and it raises on weights that do: K3 gives no weight
  cotangents and its backward is not differentiable again.
- ``"autograd"`` (the trainer's): the plain ``layer_step`` under autograd on
  any device, with trainable weights. It gives the weight gradients and the
  second derivative in x and h that the energy losses need, as ``pita_tpu``
  trains through its flax EGNN on XLA and not through the Pallas kernels.

The kernels take 3-D coordinates only, as pita_tpu's Pallas kernels do
(egnn_fwd.py:125,414); pita_tpu's flax EGNN, and the plain ``layer_step``
here, take any D. So a backbone of another D (DW4's 2-D) is built on the
``"autograd"`` route only, and ``sampler_route`` names the route its sampler
uses, decided by shape: ``"kernels"`` in 3-D, ``"autograd"`` otherwise.

``atom_types`` (one integer per particle) appends their one-hot to the
node features before the embedding (pita_tpu/nets/egnn.py:133-140), so the
layers see the same F.

Weights keep the JAX (in, out) layout. They are loaded from a flax
checkpoint through ``pita_torch.io.flax_params.egnn_params_from_tree``, or
drawn from flax's initial distributions by ``reset_parameters``.
"""

import math

import torch
from torch import nn

from pita_torch.io.flax_params import W_FIELDS
from pita_torch.ops.egnn_layer import (EGCLFunction, layer_step, pack_weights, pack_weights_tc,
                                       pack_weights_tf32)

ROUTES = ("kernels", "autograd")


def _shapes(F):
    return dict(
        w_src=(F, F), b_src=(F,), w_dst=(F, F), w_scal=(2, F), w_e2=(F, F), b_e2=(F,),
        w_att=(F, 1), b_att=(1,), w_c1=(F, F), b_c1=(F,), w_c2=(F, 1),
        w_n1=(2 * F, F), b_n1=(F,), w_n2=(F, F), b_n2=(F,),
    )


def lecun_normal_(w, generator=None):
    """flax's default Dense kernel init: a normal truncated at ±2 standard
    deviations, scaled so that the variance is 1/fan_in."""
    std = math.sqrt(1.0 / w.shape[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def _init_layer(layer, generator=None):
    """The distributions of pita_tpu/nets/egnn.py:58-106: lecun-normal kernels
    and zero biases, the coordinate head ``w_c2`` from
    variance_scaling(0.001²·3, "fan_avg", "uniform") (:72-78)."""
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.startswith("b_"):
                p.zero_()
            elif name == "w_c2":
                fan_avg = (p.shape[0] + p.shape[1]) / 2
                limit = math.sqrt(3 * 0.001 ** 2 * 3.0 / fan_avg)
                nn.init.uniform_(p, -limit, limit, generator=generator)
            else:
                lecun_normal_(p, generator)


class EGCL(nn.Module):
    """One dense E_GCL layer; weights named as egnn_fwd.py:79-82 _W_FIELDS."""

    def __init__(self, hidden_nf: int, attention: bool = True, tanh: bool = True,
                 coords_range: float = 5.0, compute_dtype=torch.float32,
                 route: str = "kernels"):
        super().__init__()
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        self.route = route
        for name, shape in _shapes(hidden_nf).items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape), requires_grad=route == "autograd"))
        self.cfg = dict(attention=attention, tanh=tanh, coords_range=coords_range,
                        cd=compute_dtype)
        self._packed = {}

    def weights(self) -> dict:
        return {f: getattr(self, f) for f in W_FIELDS}

    def packed(self, device, tc: bool = False) -> torch.Tensor:
        """The kernels' packed weight buffer on ``device`` (with ``tc`` the
        tensor-core kernels' matrices: bf16 ones for a bf16 layer, TF32 hi + lo
        for an f32 one), rebuilt when a weight changes: an in-place update (an
        optimizer step, ``copy_``) bumps its version."""
        stamp = tuple((p.data_ptr(), p._version) for p in self.weights().values())
        hit = self._packed.get((device, tc))
        if hit is None or hit[0] != stamp:
            w = self.weights()
            if not tc:
                buf = pack_weights(w, self.cfg["cd"])
            elif self.cfg["cd"] == torch.bfloat16:
                buf = pack_weights_tc(w)
            else:
                buf = pack_weights_tf32(w)
            buf = buf.to(device)
            hit = self._packed[(device, tc)] = (stamp, buf)
        return hit[1]

    def forward(self, h, x, edge_attr):
        if self.route == "autograd":
            return layer_step(h, x, edge_attr, self.weights(), **self.cfg)
        return EGCLFunction.apply(h, x, edge_attr, self)


class EGNNBackbone(nn.Module):
    """EGNN dynamics: forward(t, x_flat, beta) -> mean-free displacement.

    Built with zero weights; ``reset_parameters`` draws flax's initial ones
    and ``load_state_dict`` takes a checkpoint's.
    """

    def __init__(self, n_particles: int, n_spatial_dim: int = 3, hidden_nf: int = 32,
                 n_layers: int = 3, attention: bool = True, tanh: bool = True,
                 condition_on_temperature: bool = True, coords_range: float = 15.0,
                 compute_dtype=torch.float32, route: str = "kernels", atom_types=None):
        super().__init__()
        if route == "kernels" and n_spatial_dim != 3:
            raise ValueError(
                f"the EGCL kernels take 3-D coordinates, not {n_spatial_dim}-D (as pita_tpu's "
                "Pallas kernels do); build a backbone of another D on the 'autograd' route, "
                "its sampler_route")
        self.sampler_route = "kernels" if n_spatial_dim == 3 else "autograd"
        self.atom_types = None if atom_types is None else tuple(int(a) for a in atom_types)
        self.n_particles = n_particles
        self.n_spatial_dim = n_spatial_dim
        self.hidden_nf = hidden_nf
        self.n_layers = n_layers
        self.attention = attention
        self.condition_on_temperature = condition_on_temperature
        self.route = route
        n_in = 2 if condition_on_temperature else 1
        if self.atom_types is not None:
            n_in += max(self.atom_types) + 1
        trainable = route == "autograd"
        self.w_emb = nn.Parameter(torch.zeros(n_in, hidden_nf), requires_grad=trainable)
        self.b_emb = nn.Parameter(torch.zeros(hidden_nf), requires_grad=trainable)
        self.layers = nn.ModuleList(
            EGCL(hidden_nf, attention, tanh, coords_range / n_layers, compute_dtype, route)
            for _ in range(n_layers)
        )
        self._args = dict(n_particles=n_particles, n_spatial_dim=n_spatial_dim,
                          hidden_nf=hidden_nf, n_layers=n_layers, attention=attention,
                          tanh=tanh, condition_on_temperature=condition_on_temperature,
                          coords_range=coords_range, compute_dtype=compute_dtype,
                          atom_types=self.atom_types)

    def reset_parameters(self, generator=None):
        """flax's initial distributions (pita_tpu/nets/egnn.py): the
        embedding Dense (:141) lecun-normal with a zero bias, each layer as
        ``_init_layer``. Draws from ``generator`` on the weights' device."""
        with torch.no_grad():
            lecun_normal_(self.w_emb, generator)
            self.b_emb.zero_()
        for layer in self.layers:
            _init_layer(layer, generator)
        return self

    def with_route(self, route: str) -> "EGNNBackbone":
        """A new backbone of the same shape on ``route``, holding a copy of
        these weights on their device."""
        new = EGNNBackbone(**self._args, route=route).to(self.w_emb.device)
        with torch.no_grad():
            for p, q in zip(new.parameters(), self.parameters()):
                p.copy_(q)
        return new

    def embed(self, t, x, beta):
        """The node embedding h0 (B, N, F) of time, inverse temperature and
        the atom types' one-hot."""
        B, N = x.shape[0], self.n_particles
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1).expand(B)
        feats = [t[:, None, None].expand(B, N, 1)]
        if self.condition_on_temperature:
            bb = torch.as_tensor(beta, dtype=x.dtype, device=x.device).reshape(-1).expand(B)
            feats.append(bb[:, None, None].expand(B, N, 1))
        if self.atom_types is not None:
            types = torch.as_tensor(self.atom_types, device=x.device)
            onehot = torch.nn.functional.one_hot(types, max(self.atom_types) + 1)
            feats.append(onehot.to(x.dtype).expand(B, N, -1))
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
