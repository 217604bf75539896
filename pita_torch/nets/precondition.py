"""EDM preconditioning wrappers: ScoreWrapper and EnergyWrapper.

Counterpart of ``pita_tpu/nets/precondition.py:28-134``:
``c_s = 1/(1+h)``, ``c_in = (1+h)^{-1/2}``, ``c_out = sqrt(h)·c_in``,
``c_noise = ln(h)/8``; denoiser ``D = c_s·x + c_out·F(c_noise, c_in·x, β)``,
score ``(D − x)/h``; scalar energy ``U_θ = <F(c_noise, c_in·x, β), c_in·x>``
and ``E_θ = (1−c_s)/(2h)·‖x‖² − c_out/(c_in·h)·U_θ``. The wrappers hold their
backbone module (its weights), so no ``params`` argument is passed. With
``pin`` the energy is pinned to the clamped true energy near t = 0:
``E ← w·clip(−log p(x), ±1e3) + (1−w)·E`` with ``w = (1−t)³``
(precondition.py:128-133).

``on_autograd_route`` gives a wrapper over a copy of the backbone on its
``"autograd"`` route (the wrapper itself when the backbone has no other):
what forward mode (Hutch++) and a second derivative in x (the exact
Laplacian) need, as pita_tpu runs them on its XLA backbone and not on the
Pallas one.

``EnergyWrapper.grad_x``, ``denoiser`` and ``denoiser_and_energy``
(precondition.py:136-160) take one joint gradient over (x, h) with
``create_graph=True`` by default, so that a loss can differentiate the
result again in the weights: that needs a backbone on the ``"autograd"``
route (``pita_torch.nets.egnn``), since the kernel route's backward is
differentiable once only.
"""

import torch


def coeffs(ht):
    c_s = 1.0 / (1.0 + ht)
    c_in = (1.0 + ht) ** -0.5
    c_out = ht ** 0.5 * c_in
    c_noise = 0.125 * torch.log(ht)
    return c_s, c_in, c_out, c_noise


def bcast(v, B, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(-1).expand(B)


class _Wrapper:
    def __init__(self, backbone, precondition_beta: bool = False):
        self.backbone = backbone
        self.precondition_beta = precondition_beta
        self._twin = None

    def on_autograd_route(self):
        """This wrapper over the backbone's ``"autograd"`` route: itself when
        the backbone is on it, else a copy, remade when a weight changes."""
        bb = self.backbone
        if getattr(bb, "route", "autograd") == "autograd":
            return self
        stamp = tuple((p.data_ptr(), p._version) for p in bb.parameters())
        if self._twin is None or self._twin[0] != stamp:
            self._twin = (stamp, type(self)(bb.with_route("autograd"), self.precondition_beta))
        return self._twin[1]


class ScoreWrapper(_Wrapper):
    """EDM-preconditioned denoiser/score over a vector backbone."""

    def denoiser(self, ht, xt, beta, return_score: bool = False):
        """D(x); with ``return_score`` also (D − x)/h, the score of the
        preconditioned denoiser (×β with β-preconditioning, :64-78)."""
        B = xt.shape[0]
        ht, beta = bcast(ht, B, xt), bcast(beta, B, xt)
        c_s, c_in, c_out, c_noise = coeffs(ht)
        F = self.backbone(c_noise, c_in[:, None] * xt, beta)
        D = c_s[:, None] * xt + c_out[:, None] * F
        score = (D - xt) / ht[:, None]
        if self.precondition_beta:
            D = D * beta[:, None] + (1 - beta[:, None]) * xt
            score = score * beta[:, None]
        if return_score:
            return D, score
        return D

    def score(self, ht, xt, beta):
        """(D(x) − x)/h, the score of the learned density."""
        ht = bcast(ht, xt.shape[0], xt)
        return (self.denoiser(ht, xt, beta) - xt) / ht[:, None]


class EnergyWrapper(_Wrapper):
    """Scalar-energy head over a vector backbone via the <F(x), x> trick."""

    def energy(self, ht, xt, beta, pin: bool = False, t=None, energy_function=None):
        """E_θ(h, x, β): (B,). Differentiable in ht and xt through autograd
        (the EGCL layers' backward is kernel K3 on CUDA). With ``pin``,
        blended with −``energy_function``(x) (the target's ``log_prob``) by
        (1−t)³ at the times ``t``."""
        B = xt.shape[0]
        ht, beta = bcast(ht, B, xt), bcast(beta, B, xt)
        c_s, c_in, c_out, c_noise = coeffs(ht)
        x_in = c_in[:, None] * xt
        U_theta = (self.backbone(c_noise, x_in, beta) * x_in).sum(-1)
        E = (1 - c_s) / (2 * ht) * (xt ** 2).sum(-1) - c_out / (c_in * ht) * U_theta
        if self.precondition_beta:
            E = E * beta
        if pin:
            if t is None or energy_function is None:
                raise ValueError("pinning needs the times t and the energy function")
            U0 = torch.clamp(-energy_function(xt), -1e3, 1e3)
            w = (1 - bcast(t, B, xt)) ** 3
            E = w * U0 + (1 - w) * E
        return E

    def grad_x(self, ht, xt, beta, create_graph: bool = True):
        """∇ₓE_θ (energy_net.py:51-62)."""
        with torch.enable_grad():
            x = xt.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.energy(ht, x, beta).sum(), x,
                                       create_graph=create_graph)
        return g

    def denoiser(self, ht, xt, beta, create_graph: bool = True):
        """x − h·∇ₓE_θ (energy_net.py:64-66)."""
        ht = bcast(ht, xt.shape[0], xt)
        return xt - ht[:, None] * self.grad_x(ht, xt, beta, create_graph)

    def denoiser_and_energy(self, ht, xt, beta, create_graph: bool = True):
        """(denoiser, dU/dh, U) from one joint gradient over (x, h)
        (energy_net.py:68-79). With ``create_graph`` all three stay
        differentiable in the backbone's weights."""
        ht = bcast(ht, xt.shape[0], xt)
        with torch.enable_grad():
            x = xt.detach().requires_grad_(True)
            h = ht.detach().requires_grad_(True)
            U = self.energy(h, x, beta)
            nabla_U, dU_dh = torch.autograd.grad(U.sum(), (x, h), create_graph=create_graph)
        return xt - ht[:, None] * nabla_U, dU_dh, U
