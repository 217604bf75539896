"""Plain PyTorch reference of the LJ55 EGNN score/energy pair and its target.

Written from the published description (PITA, arXiv 2506.16471; the EGNN of
Satorras et al. with attention and a tanh coordinate head; EDM
preconditioning) and from the formulas the port documents, with no import
of the port or of the JAX package. Everything is float32 with TF32 off
(``strict_f32``); the products' inputs are rounded to the configuration's
precision by ``rounder`` and the rounding counts as the identity in the
derivatives (straight through), as the port's kernels count it:

- ``"f32"``: no rounding; ``"tf32"``: 10 mantissa bits, to nearest;
- ``"bf16"``: bfloat16; ``"fp8"``: float8 e4m3, saturated at ±448.

``"tf32"`` and ``"fp8"`` are the controls: the nearest precision below the
configuration's (f32 and bf16).

Layout: weights keep the (in, out) layout of the flax checkpoint, named as
``perfbench/frozen/msgpack.py:W_FIELDS``; coordinates are flat (B, N·3).
"""

import contextlib

import numpy as np
import torch

from perfbench.frozen.msgpack import W_FIELDS



@contextlib.contextmanager
def strict_f32():
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _tf32(a):
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


_ROUND = {
    "f32": None,
    "tf32": _tf32,
    "bf16": lambda a: a.to(torch.bfloat16).float(),
    "fp8": lambda a: a.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float(),
}


def rounder(precision):
    """a -> a rounded to ``precision`` in value, with an identity gradient."""
    if precision not in _ROUND:
        raise ValueError(f"unknown precision {precision!r}")
    fn = _ROUND[precision]
    if fn is None:
        return lambda a: a
    return lambda a: a + (fn(a.detach()) - a).detach()


def sigmoid(z):
    return torch.exp(torch.clamp(z, max=0.0)) / (1.0 + torch.exp(-z.abs()))


def silu(z):
    return z * sigmoid(z)


class EGNN:
    """EGNN(N particles, F wide, L layers) with attention and a tanh head,
    conditioned on time and inverse temperature; forward(t, x, beta) is the
    mean-free displacement of the coordinates after L layers."""

    def __init__(self, weights, n_particles=55, hidden=32, n_layers=3, coords_range=15.0,
                 precision="f32"):
        self.w = weights
        self.N, self.F, self.L = n_particles, hidden, n_layers
        self.coords_range = coords_range / n_layers
        self.rnd = rounder(precision)

    def mm(self, a, b):
        return self.rnd(a) @ self.rnd(b)

    def layer(self, l, h, x, edge_attr):
        w = {f: self.w[f"layers.{l}.{f}"] for f in W_FIELDS}
        N = x.shape[-2]
        mask = 1.0 - torch.eye(N, dtype=x.dtype, device=x.device)
        diff = x[:, :, None, :] - x[:, None, :, :]
        radial = (diff * diff).sum(-1)
        denom = torch.sqrt(radial + 1e-8) + 1.0
        src = self.mm(h, w["w_src"]) + w["b_src"]
        dst = self.mm(h, w["w_dst"])
        scal = radial[..., None] * w["w_scal"][0] + edge_attr[..., None] * w["w_scal"][1]
        z1 = src[:, :, None, :] + dst[:, None, :, :] + scal
        m_pre = silu(self.mm(silu(z1), w["w_e2"]) + w["b_e2"])
        att = sigmoid((m_pre * w["w_att"][:, 0]).sum(-1) + w["b_att"][0])
        m = m_pre * (att * mask)[..., None]
        cm = (silu(self.mm(m, w["w_c1"]) + w["b_c1"]) * w["w_c2"][:, 0]).sum(-1)
        a = torch.tanh(cm) * self.coords_range
        wgt = a * mask / denom
        x_out = x + x * wgt.sum(-1)[..., None] - wgt @ x
        nz = self.mm(torch.cat([h, m.sum(-2)], -1), w["w_n1"]) + w["b_n1"]
        h_out = h + self.mm(silu(nz), w["w_n2"]) + w["b_n2"]
        return h_out, x_out

    def __call__(self, t, x, beta):
        B, N = x.shape[0], self.N
        xs = x.reshape(B, N, 3)
        feats = torch.stack([t.expand(B), beta.expand(B)], -1)[:, None, :].expand(B, N, 2)
        h = feats @ self.w["w_emb"] + self.w["b_emb"]
        diff = xs[:, :, None, :] - xs[:, None, :, :]
        edge_attr = (diff * diff).sum(-1)
        xc = xs
        for l in range(self.L):
            h, xc = self.layer(l, h, xc, edge_attr)
        vel = xc - xs
        vel = vel - vel.mean(1, keepdim=True)
        return vel.reshape(B, N * 3)


def coeffs(ht):
    c_s = 1.0 / (1.0 + ht)
    c_in = (1.0 + ht) ** -0.5
    return c_s, c_in, ht ** 0.5 * c_in, 0.125 * torch.log(ht)


def score(net, ht, x, beta):
    """(D(x) − x)/h with the EDM denoiser D = c_s·x + c_out·F(c_noise, c_in·x, β)."""
    c_s, c_in, c_out, c_noise = coeffs(ht)
    D = c_s[:, None] * x + c_out[:, None] * net(c_noise, c_in[:, None] * x, beta)
    return (D - x) / ht[:, None]


def denoiser(net, ht, x, beta):
    c_s, c_in, c_out, c_noise = coeffs(ht)
    return c_s[:, None] * x + c_out[:, None] * net(c_noise, c_in[:, None] * x, beta)


def energy(net, ht, x, beta):
    """E_θ = (1 − c_s)/(2h)·‖x‖² − c_out/(c_in·h)·⟨F(c_noise, c_in·x, β), c_in·x⟩."""
    c_s, c_in, c_out, c_noise = coeffs(ht)
    x_in = c_in[:, None] * x
    U = (net(c_noise, x_in, beta) * x_in).sum(-1)
    return (1 - c_s) / (2 * ht) * (x ** 2).sum(-1) - c_out / (c_in * ht) * U


class Elucidating:
    """Karras ρ-schedule: h(t) = (σ_max^{1/ρ} + (1 − t)(σ_min^{1/ρ} − σ_max^{1/ρ}))^{2ρ}."""

    def __init__(self, sigma_min, sigma_max, rho, P_mean=-1.2, P_std=1.2):
        self.rho, self.P_mean, self.P_std = rho, P_mean, P_std
        self.a = sigma_max ** (1 / rho)
        self.b = sigma_min ** (1 / rho) - sigma_max ** (1 / rho)

    def h(self, t):
        return (self.a + (1 - t) * self.b) ** (2 * self.rho)

    def g(self, t):
        return (-2 * self.rho * (self.a + (1 - t) * self.b) ** (2 * self.rho - 1) * self.b) ** 0.5

    def dh_dt(self, t):
        return -2 * self.rho * self.b * (self.a + (1 - t) * self.b) ** (2 * self.rho - 1)


def lj_spline(eps=1.0, rm=1.0, range_min=0.65, range_max=2.0, n=1000):
    """The first segment of the cubic spline that smooths the pair energy
    below ``range_min`` (PITA's LJ target): (c0, c1, c2, c3, r_min) as f32."""
    from scipy.interpolate import CubicSpline

    xs = np.linspace(range_min, range_max, n)
    c = CubicSpline(xs, eps * ((rm / xs) ** 12 - 2 * (rm / xs) ** 6)).c.astype(np.float32)
    return tuple(float(v) for v in (c[0, 0], c[1, 0], c[2, 0], c[3, 0], np.float32(xs[0])))


def lj_log_prob(x, temperature, n_particles=55, spline=None):
    """log p = −E/T: pair energy (r_m/r)^12 − 2 (r_m/r)^6 over ordered pairs,
    the spline below r_min, and the CoM oscillator ½‖x − x̄‖²; in float64."""
    xr = x.double().reshape(x.shape[0], n_particles, 3)
    d2 = ((xr[:, :, None] - xr[:, None]) ** 2).sum(-1)
    eye = torch.eye(n_particles, dtype=torch.bool, device=x.device)
    r = torch.sqrt(torch.where(eye, torch.ones_like(d2), d2))
    s6 = r ** -6
    e = s6 * s6 - 2 * s6
    if spline is not None:
        c0, c1, c2, c3, r_min = spline
        dr = r - r_min
        e = torch.where(r < r_min, c0 * dr ** 3 + c1 * dr ** 2 + c2 * dr + c3, e)
    e = torch.where(eye, torch.zeros_like(e), e).sum((-2, -1))
    e = e + 0.5 * ((xr - xr.mean(1, keepdim=True)) ** 2).sum((-2, -1))
    return -e / temperature


def remove_mean(x, n_particles=55):
    xr = x.reshape(x.shape[0], n_particles, -1)
    return (xr - xr.mean(1, keepdim=True)).reshape(x.shape)
