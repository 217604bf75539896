"""Divergence estimators for the Feynman–Kac weight drift.

Counterpart of ``pita_tpu/ops/divergence.py``: ``exact_divergence``
(:36-81), ``exact_laplacian`` (:84-96), ``hutchinson_divergence`` (:99-108)
and ``hutchpp_divergence`` (:111-146). The JAX versions are forward mode
(``jax.linearize``, ``jax.jvp``). The EGCL layer of the port's kernel route
is a ``torch.autograd.Function`` whose backward is a kernel (K3) and is
differentiable once, so forward mode and double backward do not pass
through it: Hutchinson and the exact trace here are reverse mode.
Hutchinson forms (Jᵀε)·ε from one backward pass, the same scalar as εᵀ(Jε)
up to reassociation, with all probes in one batched forward and backward.
The exact trace takes the D rows of the Jacobian by D VJPs: ``f`` runs once
(pita_tpu's primal of ``jax.linearize``) and its graph takes the one-hot
rows as batched cotangents, 16 a backward (``exact_divergence``). Where the
backward has no batching rule (the kernel route's K3), each block of rows
runs its own forward on the batch repeated once per row
(``exact_divergence_replicated``).

Hutch++ needs J·V itself (its sketch is the range of J), so it runs in
forward mode (``torch.autograd.forward_ad``) and its ``f`` must be
forward-differentiable: a backbone on the ``"autograd"`` route, as
pita_tpu runs it on its XLA backbone. The exact Laplacian is the exact
trace of ∇ₓU, reverse over reverse (pita_tpu: forward over reverse), and
also needs the ``"autograd"`` route.
"""

import torch
from torch.autograd import forward_ad

from pita_torch.utils.tracing import span


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
    ``f`` runs once at the B chains of a chunk (``torch.func.vjp``, the
    reverse-mode counterpart of pita_tpu's one ``jax.linearize``), and each
    block of ``row_chunk`` one-hot rows goes back through its graph as one
    backward with the rows as batched cotangents (``torch.func.vmap`` of the
    pullback; the older vmap behind ``autograd.grad(is_grads_batched=True)``
    loops over the rows in LayerNorm's, GELU's and softmax's backward).
    ``chunk_size`` bounds the chains in flight. Each batched backward is a
    span ``divergence.exact_pass`` (rows R·B, chains B); the forward lies
    outside them. ``f`` must pass through torch.func's transforms, so a
    ``torch.autograd.Function`` without their support (the EGNN's kernel
    route, whose backward is K3) takes ``exact_divergence_replicated``.
    """
    B, D = x.shape
    if chunk_size is not None and B > chunk_size:
        return torch.cat([exact_divergence(f, t[s:s + chunk_size], x[s:s + chunk_size],
                                           None, row_chunk)
                          for s in range(0, B, chunk_size)])
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    trace = torch.zeros(B, dtype=x.dtype, device=x.device)
    with torch.no_grad():  # the transforms differentiate in x; no graph to the weights
        _, pullback = torch.func.vjp(lambda xq: f(t, xq), x.detach())
        for start in range(0, D, row_chunk):
            rows = eye[start:start + row_chunk]  # (R, D)
            R = rows.shape[0]
            with span("divergence.exact_pass", rows=R * B, chains=B):
                cot = rows[:, None, :].expand(R, B, D)
                (jt,) = torch.func.vmap(pullback)(cot)
                trace = trace + (jt * cot).sum(-1).sum(0)
    return trace


def exact_divergence_replicated(f, t: torch.Tensor, x: torch.Tensor, chunk_size: int = None,
                                row_chunk: int = 16) -> torch.Tensor:
    """``exact_divergence`` for an ``f`` whose backward cannot be batched
    (the EGNN's kernel route, whose backward is K3): each block of
    ``row_chunk`` one-hot rows goes through its own forward and backward,
    the batch repeated once per row. Each such pass is a span
    ``divergence.exact_pass`` (rows R·B, chains B).
    """
    B, D = x.shape
    if chunk_size is not None and B > chunk_size:
        return torch.cat([exact_divergence_replicated(f, t[s:s + chunk_size],
                                                      x[s:s + chunk_size], None, row_chunk)
                          for s in range(0, B, chunk_size)])
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    trace = torch.zeros(B, dtype=x.dtype, device=x.device)
    for start in range(0, D, row_chunk):
        rows = eye[start:start + row_chunk]  # (R, D)
        R = rows.shape[0]
        with span("divergence.exact_pass", rows=R * B, chains=B):
            cot = rows[:, None, :].expand(R, B, D).reshape(R * B, D)
            with torch.enable_grad():
                xr = x.detach().repeat(R, 1).requires_grad_(True)
                y = f(t.repeat(R), xr)
                (jt,) = torch.autograd.grad(y, xr, cot)
            trace = trace + (jt * cot).sum(-1).reshape(R, B).sum(0)
    return trace


def exact_laplacian(u, t: torch.Tensor, x: torch.Tensor, chunk_size: int = None,
                    row_chunk: int = 16) -> torch.Tensor:
    """tr(∂²U/∂x²) per sample, (B,); u maps (t (B,), x (B, D)) -> (B,).

    The exact trace of the gradient field ∇ₓU: each VJP of ``exact_divergence``
    differentiates a gradient taken with ``create_graph``.
    """
    def grad_u(tq, xq):
        (g,) = torch.autograd.grad(u(tq, xq).sum(), xq, create_graph=True)
        return g

    return exact_divergence(grad_u, t, x, chunk_size, row_chunk)


def jvp_batch(f, t: torch.Tensor, x: torch.Tensor, V: torch.Tensor,
              tangent_chunk: int = 16) -> torch.Tensor:
    """J·v for each of the m tangents of V (m, B, D), J = ∂f/∂x at (t, x):
    forward mode, ``tangent_chunk`` tangents a pass with the batch repeated
    once per tangent. Returns (m, B, D)."""
    m, B, D = V.shape
    out = []
    with torch.no_grad(), forward_ad.dual_level():
        for s in range(0, m, tangent_chunk):
            v = V[s:s + tangent_chunk]
            R = v.shape[0]
            xd = forward_ad.make_dual(x.detach().repeat(R, 1), v.reshape(R * B, D))
            y = f(t.repeat(R), xd)
            out.append(forward_ad.unpack_dual(y).tangent.reshape(R, B, D))
    return torch.cat(out)


def orthonormal_columns(Y: torch.Tensor) -> torch.Tensor:
    """The Q factor of the reduced QR of each Y (B, D, k): (B, D, min(D, k)),
    by Householder reflections batched over B, as LAPACK forms it up to the
    signs of the columns (``torch.linalg.qr`` on CUDA forms Q by one solver
    call a matrix). Where Y is rank-deficient, Q is still orthonormal: a
    column with nothing left to reflect takes no reflection."""
    B, D, k = Y.shape
    R = Y.clone()
    V = []
    for j in range(min(D, k)):
        x = R[:, j:, j]
        norm = x.norm(dim=1)
        v = x.clone()
        # v = x − α e₁ with α = −sign(x₀)‖x‖
        v[:, 0] += torch.where(x[:, 0] >= 0, norm, -norm)
        v = v / v.norm(dim=1, keepdim=True).clamp_min(1e-30)
        R[:, j:, j:] -= 2 * v[:, :, None] * (v[:, None, :] @ R[:, j:, j:])
        V.append(v)
    Q = torch.eye(D, len(V), dtype=Y.dtype, device=Y.device).expand(B, D, len(V)).clone()
    for j in reversed(range(len(V))):  # Q = H₀ ⋯ H_{m−1} I[:, :m]
        v = V[j]
        Q[:, j:, :] -= 2 * v[:, :, None] * (v[:, None, :] @ Q[:, j:, :])
    return Q


def hutchpp_divergence(f, t: torch.Tensor, x: torch.Tensor, S: torch.Tensor,
                       G: torch.Tensor, tangent_chunk: int = 16) -> torch.Tensor:
    """Hutch++ trace estimate (Meyer et al. 2021): the trace on the span Q of
    the sketch J·S plus Hutchinson on the rest,

        tr(J) ≈ tr(Qᵀ J Q) + mean_g gᵀ (I−QQᵀ) J (I−QQᵀ) g,   Q = qr(J S),

    per sample. S: (rank, B, D) and G: (probes, B, D) Rademacher vectors.
    Q (``orthonormal_columns``) may differ in the signs of its columns from
    JAX's QR; the estimate does not depend on them. Returns (B,).
    """
    jv = lambda V: jvp_batch(f, t, x, V, tangent_chunk)
    Y = jv(S)  # (rank, B, D)
    Q = orthonormal_columns(Y.permute(1, 2, 0))  # (B, D, k)
    JQ = jv(Q.permute(2, 0, 1).contiguous())  # (k, B, D)
    tr_low = torch.einsum("ibd,bdi->b", JQ, Q)
    Gp = G - torch.einsum("mbr,bdr->mbd", torch.einsum("mbd,bdr->mbr", G, Q), Q)
    JGp = jv(Gp)
    JGpp = JGp - torch.einsum("mbr,bdr->mbd", torch.einsum("mbd,bdr->mbr", JGp, Q), Q)
    return tr_low + (Gp * JGpp).sum(-1).mean(0)
