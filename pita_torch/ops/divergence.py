"""Divergence estimators for the Feynman–Kac weight drift.

Counterpart of ``pita_tpu/ops/divergence.py``: ``exact_divergence`` (:36-81)
and ``hutchinson_divergence`` (:99-108). The JAX versions are forward mode
(``jax.linearize``, ``jax.jvp``). The EGCL layer of the port is a
``torch.autograd.Function`` whose backward is a kernel (K3) and is
differentiable once, so forward mode and double backward do not pass
through it: both estimators here are reverse mode. Hutchinson forms
(Jᵀε)·ε from one backward pass, the same scalar as εᵀ(Jε) up to
reassociation, with all probes in one batched forward and backward. The
exact trace takes the D rows of the Jacobian by D VJPs, batched in chunks.
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


def exact_divergence(f, t: torch.Tensor, x: torch.Tensor, chunk_size: int = None,
                     row_chunk: int = 16) -> torch.Tensor:
    """tr(∂f/∂x) per sample, (B,); f maps (t (B,), x (B, D)) -> (B, D).

    The generic exact trace: row d of each sample's Jacobian is the VJP with
    the one-hot cotangent e_d, and its d-th entry is the diagonal element.
    ``row_chunk`` rows go through one forward and one backward, the batch
    repeated once per row; ``chunk_size`` bounds the chains in flight.
    """
    B, D = x.shape
    if chunk_size is not None and B > chunk_size:
        return torch.cat([exact_divergence(f, t[s:s + chunk_size], x[s:s + chunk_size],
                                           None, row_chunk)
                          for s in range(0, B, chunk_size)])
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    trace = torch.zeros(B, dtype=x.dtype, device=x.device)
    for start in range(0, D, row_chunk):
        rows = eye[start:start + row_chunk]  # (R, D)
        R = rows.shape[0]
        cot = rows[:, None, :].expand(R, B, D).reshape(R * B, D)
        with torch.enable_grad():
            xr = x.detach().repeat(R, 1).requires_grad_(True)
            y = f(t.repeat(R), xr)
            (jt,) = torch.autograd.grad(y, xr, cot)
        trace = trace + (jt * cot).sum(-1).reshape(R, B).sum(0)
    return trace
