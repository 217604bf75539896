"""Plain PyTorch reference of PITA's alanine DiT3D and its exact trace.

The DiT3D of PITA's alanine experiments (arXiv 2506.16471, the paper's code
``configs/experiment/aldp.yaml``): the atoms are the tokens; each atom's
coordinates embedded by one linear map; sinusoidal embeddings of the
network's time input and of the inverse temperature, each through a
two-layer SiLU MLP, summed and passed through SiLU as the condition c;
blocks of adaLN-modulated self-attention with rotary position embeddings
and a tanh-GELU MLP, each residual path scaled by its gate; an
adaLN-modulated final layer to three numbers an atom. Written from that
description, with no import of the port or of the JAX package.

Departures from the published PyTorch DiT, each the convention of the
flax model that PITA trains and the port follows:

- LayerNorm with ε = 1e-6 and a scale but no bias;
- rotary embeddings on pairs of adjacent dimensions (2k, 2k + 1) of each
  head, in float32, positions the atom indices, base 10000;
- the GELU in its tanh form.

Precision (``rounder`` of ``perfbench/reference/egnn.py``): everything is
float32 under ``strict_f32``; the inputs of the block's products (q, k, v
projection, the two attention contractions, the output projection, the
two MLP maps) are rounded to the configuration's precision; the embedders,
the modulation and the final layer stay float32, as the port runs them.

Weights are a {name: tensor} dict in ``torch.nn.Linear``'s (out, in)
layout, under the names ``draw_weights`` gives. The preconditioned score
and energy are ``perfbench/reference/egnn.py``'s ``score`` and ``energy``,
which take any net (t, x, β); ``exact_div`` is the trace of the score's
Jacobian by D one-hot vector-Jacobian products of plain autograd.
"""

import math

import torch

from perfbench.reference import egnn as R


def shapes(n_spatial=3, hidden=128, cond=128, n_blocks=6, mlp_ratio=4, freq_dim=256,
           temperature=True):
    """{name: shape} of the net's weights."""
    out = {"embed.weight": (hidden, n_spatial), "embed.bias": (hidden,)}
    for emb in ("sigma_map",) + (("sigma_map_temp",) if temperature else ()):
        out.update({f"{emb}.mlp0.weight": (cond, freq_dim), f"{emb}.mlp0.bias": (cond,),
                    f"{emb}.mlp1.weight": (cond, cond), f"{emb}.mlp1.bias": (cond,)})
    for b in range(n_blocks):
        p = f"blocks.{b}."
        out.update({p + "ada.weight": (6 * hidden, cond), p + "ada.bias": (6 * hidden,),
                    p + "norm1.weight": (hidden,),
                    p + "qkv.weight": (3 * hidden, hidden),
                    p + "attn_out.weight": (hidden, hidden),
                    p + "norm2.weight": (hidden,),
                    p + "mlp_up.weight": (mlp_ratio * hidden, hidden),
                    p + "mlp_up.bias": (mlp_ratio * hidden,),
                    p + "mlp_down.weight": (hidden, mlp_ratio * hidden),
                    p + "mlp_down.bias": (hidden,)})
    out.update({"final_ada.weight": (2 * hidden, cond), "final_ada.bias": (2 * hidden,),
                "final_norm.weight": (hidden,),
                "final_out.weight": (n_spatial, hidden), "final_out.bias": (n_spatial,)})
    return out


def draw_weights(seed, scale=1.0, **kw):
    """One net's weights from ``seed`` on the CPU: every linear map's matrix
    lecun-normal (a normal truncated at ±2 standard deviations, variance
    1/fan_in) times ``scale``, biases 0, LayerNorm scales 1."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in shapes(**kw).items():
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape)
        elif len(shape) == 1:
            out[name] = torch.ones(shape)
        else:
            std = math.sqrt(1.0 / shape[1]) / 0.87962566103423978
            w = torch.empty(shape)
            torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
            out[name] = w * scale
    return out


def layer_norm(x, w, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w


def gelu_tanh(z):
    return 0.5 * z * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (z + 0.044715 * z ** 3)))


def rotate(q):
    """Rotary embedding of q (B, S, H, Dh) over the token axis S: each pair
    (q[2k], q[2k + 1]) as the complex number q[2k] + i·q[2k + 1], turned by
    the angle s·10000^(−2k/Dh) at position s."""
    B, S, H, Dh = q.shape
    k = torch.arange(Dh // 2, dtype=torch.float32, device=q.device)
    pos = torch.arange(S, dtype=torch.float32, device=q.device)
    angle = pos[:, None] * 10000.0 ** (-2 * k / Dh)
    turn = torch.polar(torch.ones_like(angle), angle)[None, :, None, :]
    z = torch.view_as_complex(q.float().reshape(B, S, H, Dh // 2, 2).contiguous())
    return torch.view_as_real(z * turn).reshape(B, S, H, Dh)


def frequency_embedding(t, freq_dim=256):
    half = freq_dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


class DiT3D:
    """DiT3D(N atoms, H heads, L blocks); ``net(t, x, beta)`` is (B, N·3)."""

    def __init__(self, weights, n_particles, n_heads=8, n_blocks=6, precision="f32",
                 temperature=True):
        self.w = weights
        self.N, self.H, self.L = n_particles, n_heads, n_blocks
        self.temperature = temperature
        rnd = R.rounder(precision)
        self.mm = lambda a, b: rnd(a) @ rnd(b)

    def linear(self, name, h):
        y = h @ self.w[name + ".weight"].T
        b = self.w.get(name + ".bias")
        return y if b is None else y + b

    def product(self, name, h):
        """A block's linear map: its inputs rounded."""
        y = self.mm(h, self.w[name + ".weight"].T)
        b = self.w.get(name + ".bias")
        return y if b is None else y + b

    def embedder(self, name, t):
        h = frequency_embedding(t)
        return self.linear(name + ".mlp1", R.silu(self.linear(name + ".mlp0", h)))

    def block(self, l, x, c):
        p = f"blocks.{l}."
        mod = self.linear(p + "ada", c)[:, None].chunk(6, -1)
        shift1, scale1, gate1, shift2, scale2, gate2 = mod
        B, S, F = x.shape
        Dh = F // self.H
        h = layer_norm(x, self.w[p + "norm1.weight"]) * (1 + scale1) + shift1
        q, k, v = self.product(p + "qkv", h).reshape(B, S, 3, self.H, Dh).unbind(2)
        q, k = rotate(q), rotate(k)
        logits = self.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(Dh)  # (B, H, S, S)
        o = self.mm(torch.softmax(logits, -1), v.transpose(1, 2))  # (B, H, S, Dh)
        o = o.transpose(1, 2).reshape(B, S, F)
        x = x + gate1 * self.product(p + "attn_out", o)
        h = layer_norm(x, self.w[p + "norm2.weight"]) * (1 + scale2) + shift2
        h = self.product(p + "mlp_down", gelu_tanh(self.product(p + "mlp_up", h)))
        return x + gate2 * h

    def __call__(self, t, x, beta):
        B = x.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(B)
        c = self.embedder("sigma_map", t)
        if self.temperature:
            beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device).reshape(-1)
            c = c + self.embedder("sigma_map_temp", beta.expand(B))
        c = R.silu(c)
        h = self.linear("embed", x.reshape(B, self.N, 3))
        for l in range(self.L):
            h = self.block(l, h, c)
        shift, scale = self.linear("final_ada", c)[:, None].chunk(2, -1)
        h = layer_norm(h, self.w["final_norm.weight"]) * (1 + scale) + shift
        return self.linear("final_out", h).reshape(B, self.N * 3)


def exact_div(score_net, sched, x, t, beta, block=128):
    """tr(∂s/∂x) of the preconditioned score s per chain, (B,): for each
    block of chains, the D one-hot cotangents e_d through one VJP of the
    score at the block repeated D times; the trace sums the d-th entry of
    the d-th row."""
    B, D = x.shape
    out = []
    for s in range(0, B, block):
        xs, ts = x[s:s + block], t[s:s + block]
        b = xs.shape[0]
        eye = torch.eye(D, dtype=x.dtype, device=x.device).repeat_interleave(b, 0)  # (D·b, D)
        with torch.enable_grad():
            xr = xs.detach().repeat(D, 1).requires_grad_(True)
            y = R.score(score_net, sched.h(ts.repeat(D)), xr, beta)
            (rows,) = torch.autograd.grad(y, xr, eye)
        out.append((rows * eye).sum(-1).reshape(D, b).sum(0))
    return torch.cat(out)
