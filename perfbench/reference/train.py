"""Plain PyTorch reference of PITA's training step for the LJ presets.

One optimizer step on a batch of buffer rows (PITA, arXiv 2506.16471, and
the port's documented loss): a Haar-random rotation of each configuration
(QR of a Gaussian 3×3, signs fixed so that R's diagonal is positive and
det = +1), the CoM removed from the configurations and the noise, a noise
level ln σ ~ N(P_mean, P_std²), x_t = x0 + σ·z, and with λ = (h + 1)/h:

- score matching: mean λ·‖D_s(x_t) − x0‖², D_s the score net's denoiser;
- energy-score distillation: mean λ·‖x_t − h·∇ₓE_θ(x_t) − D_s(x_t)‖², the
  score net's denoiser held fixed, differentiated through ∇ₓE_θ;
- energy matching: mean (−log p(x0) − E_θ(h(0), x0))² where −log p ≤ 1e3.

Then the global-norm clip (g·c/‖g‖ when ‖g‖ ≥ c), Adam (optax's form:
bias-corrected moments, ε outside the square root) and the EMA of both nets
with the warm-up decay min(d, (1 + n)/(10 + n)). The weights are dicts of
tensors named as ``perfbench/reference/egnn.py`` names them.
"""

import numpy as np
import torch

from perfbench.reference import egnn as R

B1, B2 = 0.9, 0.999  # Adam's moment decays


def rotations(normal):
    Q, Rm = torch.linalg.qr(normal)
    Q = Q * torch.sign(torch.diagonal(Rm, dim1=-2, dim2=-1))[:, None, :]
    d = torch.sign(torch.linalg.det(Q))
    return torch.cat([Q[:, :, :1] * d[:, None, None], Q[:, :, 1:]], dim=-1)


def rotate(x, normal, n_particles):
    B = x.shape[0]
    return torch.einsum("bij,bki->bkj", rotations(normal),
                        x.reshape(B, n_particles, 3)).reshape(B, -1)


def loss(nets, sched, x0, log_p0, beta, ln_draw, z, n_particles, energy_threshold=1e3):
    score_net, energy_net = nets
    ln_sigma = ln_draw * sched.P_std + sched.P_mean
    ht = torch.exp(2 * ln_sigma)
    h0 = sched.h(torch.zeros_like(ht))
    z = R.remove_mean(z, n_particles)
    x0 = R.remove_mean(x0, n_particles)
    xt = x0 + z * torch.sqrt(ht)[:, None]
    lam = (ht + 1.0) / ht
    D_s = R.denoiser(score_net, ht, xt, beta)
    score_loss = (lam * ((D_s - x0) ** 2).sum(-1) * (ht >= h0).float()).mean()
    x = xt.detach().requires_grad_(True)
    (gE,) = torch.autograd.grad(R.energy(energy_net, ht, x, beta).sum(), x, create_graph=True)
    D_e = xt - ht[:, None] * gE
    es_loss = (lam * ((D_e - D_s.detach()) ** 2).sum(-1)).mean()
    U0 = -log_p0
    em = ((U0 - R.energy(energy_net, h0, x0, beta)) ** 2 * (U0 <= energy_threshold)).mean()
    return es_loss + score_loss + em


class Step:
    """The training state: both nets' weights as leaves, Adam's moments and
    count, the EMA shadows and their count. Without ``state`` it is the
    start of training: zero moments, shadows equal to the weights; with it
    (``mu``, ``nu`` by leaf, ``count``, ``ema`` as two dicts, ``ema_count``)
    a state reached later."""

    def __init__(self, weights, cfg, precision, state=None):
        self.cfg, self.precision = cfg, precision
        self.w = [{k: v.clone() for k, v in w.items()} for w in weights]
        self.names = [(i, k) for i, w in enumerate(self.w) for k in w]
        if state is None:
            zeros = lambda: {n: torch.zeros_like(self.w[n[0]][n[1]]) for n in self.names}
            state = dict(mu=zeros(), nu=zeros(), count=0, ema=weights, ema_count=0)
        self.mu = {n: state["mu"][n].clone() for n in self.names}
        self.nu = {n: state["nu"][n].clone() for n in self.names}
        self.ema = [{k: v.clone() for k, v in w.items()} for w in state["ema"]]
        self.count, self.ema_count = state["count"], state["ema_count"]

    def nets(self, weights):
        c = self.cfg
        return [R.EGNN(w, c["n_particles"], c["hidden_nf"], c["n_layers"], c["coords_range"],
                       self.precision) for w in weights]

    def __call__(self, sched, x0, log_p0, beta, draws, lr, clip, ema_decay):
        """One step: the loss, its gradients, the global-norm clip, then
        ``apply``; returns (the loss, the clipped gradients by leaf)."""
        idx, rot, ln_draw, z = draws
        n_p = self.cfg["n_particles"]
        leaves = [{k: v.detach().requires_grad_(True) for k, v in w.items()} for w in self.w]
        xb = rotate(x0[idx], rot, n_p)
        L = loss(self.nets(leaves), sched, xb, log_p0[idx], beta, ln_draw, z, n_p)
        flat = [leaves[i][k] for i, k in self.names]
        grads = torch.autograd.grad(L, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if norm >= clip:
            grads = [g / norm * clip for g in grads]
        out = dict(zip(self.names, grads))
        self.apply(out, lr, ema_decay)
        return float(L.detach()), out

    def apply(self, grads, lr, ema_decay):
        """Adam's update with ``grads`` (by leaf, clipped), then the EMA."""
        self.count += 1
        for n in self.names:
            g = grads[n]
            self.mu[n] = B1 * self.mu[n] + (1 - B1) * g
            self.nu[n] = B2 * self.nu[n] + (1 - B2) * g * g
            self.w[n[0]][n[1]] = self.w[n[0]][n[1]] + update(self.mu[n], self.nu[n], self.count,
                                                               lr)
        self.ema_count += 1
        d, keep = ema_weights(self.ema_count, ema_decay)
        for e, w in zip(self.ema, self.w):
            for k in e:
                e[k] = e[k] * d + w[k] * keep


def update(mu, nu, count, lr):
    """Adam's update at step ``count`` (from 1) from the moments after it;
    the bias corrections in f32, as optax computes them."""
    f32 = lambda b: torch.tensor(b, dtype=torch.float32, device=mu.device)
    bc1, bc2 = 1 - f32(B1) ** count, 1 - f32(B2) ** count
    return -lr * (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)


def ema_weights(n, decay):
    """The EMA's (decay, 1 − decay) at update n, rounded to f32."""
    d = float(np.minimum(np.float32(decay), np.float32(1.0 + n) / np.float32(10.0 + n)))
    return d, float(np.float32(1.0) - np.float32(d))
