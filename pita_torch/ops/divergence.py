"""Divergence estimators for the Feynman–Kac weight drift.

Counterpart of ``pita_tpu/ops/divergence.py:99-108`` (``hutchinson_divergence``
only; the exact divergence is the next slice). The JAX version forms
εᵀ(Jε) with a JVP. Here it is (Jᵀε)·ε from one backward pass, the same
scalar up to reassociation, so the EGCL backward kernel (K3) carries it.
All probes go through one batched forward and one backward.
"""

import torch


def hutchinson_divergence(f, t: torch.Tensor, x: torch.Tensor,
                          probes: torch.Tensor) -> torch.Tensor:
    """Mean over probes of εᵀ J ε, J = ∂f/∂x; f maps (t (B,), x (B, D)) -> (B, D).

    probes: (P, B, D) Rademacher vectors. Returns (B,).
    """
    P, B, D = probes.shape
    with torch.enable_grad():
        xr = x.detach().repeat(P, 1).requires_grad_(True)
        y = f(t.repeat(P), xr)
        eps = probes.reshape(P * B, D)
        (jt_eps,) = torch.autograd.grad(y, xr, eps)
    return (jt_eps * eps).sum(-1).reshape(P, B).mean(0)
