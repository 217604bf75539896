"""Drift assembly for the annealed reverse-time VE SDE.

Counterpart of ``pita_tpu/sampler/terms.py:66-231`` for the debiased path
with a score network (plus the plain non-debiased drift). In debiased mode

    drift_X = γ·(−∇ₓU_θ)·g²/2 + γ·b_t,        b_t = s_θ·g²/2,
    drift_A = γ²·⟨−∇U, b_t⟩ + γ·div(b_t) + γ·∂U/∂t + (dγ/dt)·U,

with drift_A clamped at its batch 0.9 quantile. U_θ, ∇ₓU_θ and ∂U_θ/∂t come
from one energy forward and one backward (the EGCL backward kernel K3 on
CUDA). div(b_t) = div(s_θ)·g²/2 by ``divergence_mode``:

- ``"hutchinson"``: Rademacher probes through one VJP;
- ``"exact"``: the exact trace; an EGNN score backbone takes the
  edge-operator route of ``pita_torch/nets/egnn_fast.py``, with G
  materialized (default), through the G-operator kernel K5
  (``divergence_g_kernel``) or in forward mode through the layer tangent
  kernel K4 (``divergence_tangent_kernel``); any other backbone falls to
- ``"exact_generic"``: D VJPs through the score function, as batched
  cotangents through one forward (``exact_divergence``), or on the EGNN's
  kernel route, whose backward K3 cannot be batched, a forward and a
  backward per block of rows (``exact_divergence_replicated``);
- ``"hutchpp"``: Hutch++ in forward mode on the score net's ``"autograd"``
  route (``ScoreWrapper.on_autograd_route``).

With no score network b_t = −∇ₓU·g²/2 and div(b_t) = −ΔU·g²/2, the exact
Laplacian of the energy net's ``"autograd"`` route (terms.py:203-212). With
``pin_energy`` the energy is pinned to the target's ``energy_function``
(its ``log_prob``) by (1−t)³ at the step's time t (``pin_kw``, :115), in
every evaluation of U here: t enters the pin as a constant, as in pita_tpu.

With a ``group`` (``pita_torch.parallel``) the rows are one rank's share of
the chains and the quantile clamp is taken over all ranks' drift_A.
"""

from typing import NamedTuple, Optional

import torch

from pita_torch.nets.egnn_fast import score_divergence_fast, supports_fast_divergence
from pita_torch.nets.precondition import bcast
from pita_torch.ops.divergence import (exact_divergence, exact_divergence_replicated,
                                       exact_laplacian, hutchinson_divergence,
                                       hutchpp_divergence)
from pita_torch.utils.tracing import span


def _autograd_route(wrapper):
    """The wrapper on its backbone's ``"autograd"`` route; an oracle without
    a backbone is differentiable as it is."""
    return wrapper.on_autograd_route() if hasattr(wrapper, "on_autograd_route") else wrapper


class SDETerms(NamedTuple):
    drift_X: torch.Tensor  # (B, D)
    drift_A: torch.Tensor  # (B,)
    divergence: Optional[torch.Tensor] = None  # γ-free div(b_t), (B,)
    cross_term: Optional[torch.Tensor] = None  # ⟨−∇U, b_t⟩, (B,)
    dUt_dt: Optional[torch.Tensor] = None  # ∂U_θ/∂t, (B,)


def compute_sde_terms(score_wrapper, energy_wrapper, noise_schedule, annealing_schedule,
                      t, x, beta, *, debias: bool = True, compute_weights: bool = True,
                      clip_quantile: float = 0.9, divergence_mode: str = "exact",
                      divergence_chunk_size: Optional[int] = None,
                      divergence_tangent_chunk: Optional[int] = None,
                      divergence_g_kernel: bool = False,
                      divergence_tangent_kernel: bool = False,
                      kernel_tangent_chunk: int = 16,
                      probes=None,
                      div_bt_override: Optional[torch.Tensor] = None,
                      pin_energy: bool = False, energy_function=None,
                      group=None) -> SDETerms:
    """drift_X and drift_A at times t (B,) for chains x (B, D).

    ``probes``: the Rademacher vectors of the estimate, needed in the
    Hutchinson modes unless ``div_bt_override`` supplies div(b_t): (P, B, D)
    for ``"hutchinson"``, the pair (S (rank, B, D), G (P, B, D)) for
    ``"hutchpp"``.
    ``divergence_chunk_size`` chains and ``divergence_tangent_chunk`` tangents
    are in flight at a time in the exact modes; ``kernel_tangent_chunk``
    tangents go to one block of kernel K4.
    """
    B = x.shape[0]
    t = bcast(t, B, x).contiguous()
    gamma = annealing_schedule.gamma(t)
    g2 = noise_schedule.g(t) ** 2
    ht = noise_schedule.h(t)
    has_score = score_wrapper is not None

    if not debias:
        with span("sampler.score"), torch.no_grad():
            s_t = score_wrapper.score(ht, x, beta)
        return SDETerms(gamma[:, None] * s_t * g2[:, None], torch.zeros_like(t))

    pin_kw = dict(pin=True, t=t, energy_function=energy_function) if pin_energy else {}
    with span("sampler.energy_grad"):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            tt = t.detach().requires_grad_(True)
            U = energy_wrapper.energy(noise_schedule.h(tt), xx, beta, **pin_kw)
            nabla_U, dU_dt = torch.autograd.grad(U.sum(), (xx, tt))
        U = U.detach()

    with span("sampler.score"):
        if has_score:
            with torch.no_grad():
                bt = score_wrapper.score(ht, x, beta) * g2[:, None] / 2
        else:
            bt = -nabla_U * g2[:, None] / 2
    with span("sampler.weights"):
        drift_X = gamma[:, None] * (-nabla_U) * g2[:, None] / 2 + gamma[:, None] * bt

    if not compute_weights:
        return SDETerms(drift_X, torch.zeros_like(t))

    if div_bt_override is not None:
        div_bt = div_bt_override
    else:
        with span("sampler.divergence", mode=divergence_mode):
            if has_score and divergence_mode == "hutchinson":
                if probes is None:
                    raise ValueError("hutchinson divergence needs probes")
                score_fn = lambda tq, xq: score_wrapper.score(noise_schedule.h(tq), xq, beta)
                div_bt = hutchinson_divergence(score_fn, t, x, probes) * g2 / 2
            elif has_score and divergence_mode in ("exact", "exact_generic"):
                backbone = getattr(score_wrapper, "backbone", None)
                if divergence_mode == "exact" and supports_fast_divergence(backbone):
                    div_st = score_divergence_fast(
                        score_wrapper, ht, x, beta, tangent_chunk=divergence_tangent_chunk,
                        chain_chunk=divergence_chunk_size,
                        tangent_kernel=divergence_tangent_kernel,
                        kernel_tangent_chunk=kernel_tangent_chunk, g_kernel=divergence_g_kernel,
                    )
                else:
                    score_fn = lambda tq, xq: score_wrapper.score(noise_schedule.h(tq), xq, beta)
                    trace = (exact_divergence_replicated
                             if getattr(backbone, "route", "autograd") == "kernels"
                             else exact_divergence)
                    div_st = trace(score_fn, t, x, chunk_size=divergence_chunk_size)
                div_bt = div_st * g2 / 2
            elif has_score and divergence_mode == "hutchpp":
                if probes is None:
                    raise ValueError("hutchpp divergence needs probes (S, G)")
                twin = _autograd_route(score_wrapper)
                score_fn = lambda tq, xq: twin.score(noise_schedule.h(tq), xq, beta)
                div_bt = hutchpp_divergence(score_fn, t, x, *probes) * g2 / 2
            elif has_score:
                raise ValueError(f"unknown divergence_mode {divergence_mode!r}")
            else:
                twin = _autograd_route(energy_wrapper)
                U_fn = lambda tq, xq: twin.energy(noise_schedule.h(tq), xq, beta, **pin_kw)
                lap_U = exact_laplacian(U_fn, t, x, chunk_size=divergence_chunk_size)
                div_bt = -lap_U * g2 / 2

    with span("sampler.weights"):
        inner = (-nabla_U * bt).sum(-1)
        drift_A = (
            gamma * gamma * inner
            + gamma * div_bt
            + gamma * dU_dt
            + annealing_schedule.dgamma_dt(t) * U
        )
        if clip_quantile < 1.0:
            every = drift_A if group is None else group.gather_rows(drift_A)
            drift_A = torch.minimum(drift_A, torch.quantile(every, clip_quantile))
    return SDETerms(drift_X, drift_A, div_bt, inner, dU_dt)
