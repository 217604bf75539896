"""FAB: flow annealed importance sampling bootstrap, its losses and training
loops.

Counterpart of ``pita_tpu/fab/fab_model.py:44-235`` (fab's core.py:18-277
and train_with_prioritised_buffer.py). The flow is a ``FlowDistribution``,
AIS comes from ``pita_torch.fab.ais`` (to the minimum-variance target
g ∝ p^α q^{1−α}), the buffer is ``PrioritisedBuffer``, and the optimizer is
the port's global-norm clip + Adam (``pita_torch.train.optim``).

AIS runs with the flow's weights frozen: no gradient flows back through the
AIS chain, and its points and weights enter the losses detached. Each
random number comes from a draws object (``FabDraws``), so a test can
replay JAX's.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from pita_torch.fab.ais import AISConfig, FabDraws, annealed_importance_sampling
from pita_torch.train.buffer import (PrioritisedBuffer, prioritised_add, prioritised_init,
                                     prioritised_sample)
from pita_torch.train.optim import adam_init, adam_update, clip_by_global_norm

LOSS_TYPES = (
    "fab_alpha_div",
    "fab_ub_alpha_2_div",
    "forward_kl",
    "target_forward_kl",
    "flow_reverse_kl",
    "flow_alpha_2_div",
    "flow_alpha_2_div_unbiased",
    "flow_alpha_2_div_nis",
)


@dataclasses.dataclass(frozen=True)
class FABConfig:
    loss_type: str = "fab_alpha_div"
    alpha: float = 2.0
    batch_size: int = 128
    lr: float = 1e-4
    max_gradient_norm: float = 10.0
    n_intermediate_distributions: int = 4
    ais_spacing: str = "linear"
    transition: str = "hmc"
    # the prioritised-buffer loop (train_with_prioritised_buffer.py)
    buffer_capacity: int = 10000
    min_buffer_length: int = 256
    n_batches_buffer_sampling: int = 4
    max_adjust_w_clip: Optional[float] = 10.0


def _ais_cfg(cfg: FABConfig, min_is_target: bool) -> AISConfig:
    return AISConfig(
        n_intermediate_distributions=cfg.n_intermediate_distributions,
        distribution_spacing_type=cfg.ais_spacing,
        transition=cfg.transition,
        p_target=not min_is_target,
        alpha=cfg.alpha if min_is_target else None,
    )


def flow_ais(flow, target_log_prob: Callable, batch_size: int, cfg: AISConfig, draws):
    """AIS from the flow with its weights frozen; the result is detached."""
    with torch.no_grad():
        res = annealed_importance_sampling(
            lambda n, d: flow.sample_and_log_prob(n, eps=d.base((n, flow.dim))),
            flow.log_prob, target_log_prob, batch_size, cfg, draws)
    return res


def fab_loss(flow, target_log_prob: Callable, cfg: FABConfig, draws, data=None):
    """The FABModel loss of ``cfg.loss_type`` (core.py:120-190), with
    gradients to the flow's weights. ``draws``: a ``FabDraws`` (AIS's, or the
    base normals of a flow sample); ``data``: target samples for the
    forward-KL losses."""
    lt = cfg.loss_type
    B = cfg.batch_size
    if lt in ("fab_alpha_div", "fab_ub_alpha_2_div"):
        res = flow_ais(flow, target_log_prob, B, _ais_cfg(cfg, min_is_target=True), draws)
        x, log_w_ais = res.samples, res.log_w
        log_q = flow.log_prob(x)
        if lt == "fab_alpha_div":
            # −sign(α)·E_softmax(w_ais)[log q] (core.py:120-135)
            return -float(np.sign(cfg.alpha)) * (torch.softmax(log_w_ais, 0) * log_q).sum()
        # the upper-bound α = 2 loss: logsumexp(log w_ais + log p − log q) (:171-177)
        return torch.logsumexp(log_w_ais + target_log_prob(x) - log_q, 0)
    if lt.startswith("flow_"):
        x, log_q = flow.sample_and_log_prob(B, eps=draws.base((B, flow.dim)))
        if lt == "flow_reverse_kl":
            return log_q.mean() - target_log_prob(x).mean()
        if lt == "flow_alpha_2_div":
            return torch.logsumexp(2 * (target_log_prob(x) - log_q), 0)
        if lt == "flow_alpha_2_div_unbiased":
            return (torch.exp(2 * (target_log_prob(x) - log_q)) * log_q).mean()
        if lt == "flow_alpha_2_div_nis":
            w2 = torch.exp(2 * (target_log_prob(x) - log_q)).detach()
            return -(w2 * log_q).mean()
    if lt in ("forward_kl", "target_forward_kl"):
        if data is None:
            raise ValueError(f"{lt} needs target samples")
        return -flow.log_prob(data).mean()
    raise ValueError(f"unknown loss_type {lt}")


def _apply(params, grads, opt_state, cfg: FABConfig):
    """Clip + Adam on the flow's weights, in place; returns the new state."""
    grads, _ = clip_by_global_norm(list(grads), cfg.max_gradient_norm)
    updates, opt_state = adam_update(grads, opt_state, cfg.lr)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
    return opt_state


def train_fab(flow, target_log_prob: Callable, cfg: FABConfig, n_iterations: int, *,
              seed: int = 0, target_sampler: Optional[Callable] = None):
    """The plain FAB loop (fab/fab/train.py): one loss and one optimizer step
    per iteration, the draws from a generator seeded with ``seed``.
    ``target_sampler(n, generator)`` gives the forward-KL losses their data.
    The flow's weights are updated in place; returns the losses."""
    gen = torch.Generator(flow.device).manual_seed(seed)
    draws = FabDraws(gen)
    params = flow.parameters()
    opt_state = adam_init(params)
    losses = []
    for _ in range(n_iterations):
        data = (target_sampler(cfg.batch_size, gen)
                if cfg.loss_type in ("forward_kl", "target_forward_kl") else None)
        loss = fab_loss(flow, target_log_prob, cfg, draws, data=data)
        opt_state = _apply(params, torch.autograd.grad(loss, params), opt_state, cfg)
        losses.append(float(loss))
    return losses


def prioritised_loss(flow, buf: PrioritisedBuffer, cfg: FABConfig, gumbel):
    """The inner step's loss (:158-180): a batch drawn by Gumbel-top-k from
    ``gumbel`` (capacity,), then −E[w_adjust·log q] with w_adjust =
    min(exp((1−α)(log q − log q_old)), ``max_adjust_w_clip``) on the
    current log q (detached). Returns (loss, log w_adjust, log q, idx)."""
    x, _, log_q_old, idx = prioritised_sample(buf, cfg.batch_size, gumbel)
    log_q = flow.log_prob(x)
    log_w_adjust = (1 - cfg.alpha) * (log_q.detach() - log_q_old)
    w_adjust = torch.exp(log_w_adjust)
    if cfg.max_adjust_w_clip is not None:
        w_adjust = torch.clamp(w_adjust, max=cfg.max_adjust_w_clip)
    return -(w_adjust * log_q).mean(), log_w_adjust, log_q, idx


def prioritised_step(flow, buf: PrioritisedBuffer, opt_state, cfg: FABConfig, gumbel):
    """One inner step of the prioritised-buffer loop (:158-202):
    ``prioritised_loss``, clip + Adam, then the sampled rows' log w +=
    log w_adjust and log q ← log q. A non-finite loss or gradient norm
    skips the update and leaves the Adam state and the buffer as they were
    (:181-189). Returns (Adam state, buffer, loss, whether the update was
    applied)."""
    params = flow.parameters()
    loss, log_w_adjust, log_q, idx = prioritised_loss(flow, buf, cfg, gumbel)
    grads = torch.autograd.grad(loss, params)
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    ok = bool(torch.isfinite(loss) & torch.isfinite(g_norm))
    if ok:
        opt_state = _apply(params, grads, opt_state, cfg)
        buf.log_w.index_add_(0, idx, log_w_adjust)
        buf.log_q[idx] = log_q.detach()
    return opt_state, buf, loss.detach(), ok


def train_fab_with_prioritised_buffer(flow, target_log_prob: Callable, cfg: FABConfig,
                                      n_iterations: int, *, seed: int = 0, draws=None):
    """FAB with the prioritised replay buffer (train_with_prioritised_buffer.py:108-210):
    each outer iteration runs AIS once and stores (x, log w, log q); once the
    buffer holds ``min_buffer_length`` rows, ``n_batches_buffer_sampling``
    inner steps (``prioritised_step``) follow. The flow's weights are
    updated in place; returns (the buffer, one {loss, ess_ais} per iteration
    that trained)."""
    gen = torch.Generator(flow.device).manual_seed(seed)
    draws = draws if draws is not None else FabDraws(gen)
    opt_state = adam_init(flow.parameters())
    buf = prioritised_init(cfg.buffer_capacity, flow.dim, device=flow.device)
    ais_cfg = _ais_cfg(cfg, min_is_target=True)
    history = []
    for _ in range(n_iterations):
        res = flow_ais(flow, target_log_prob, cfg.batch_size, ais_cfg, draws)
        with torch.no_grad():
            log_q = flow.log_prob(res.samples)
        buf = prioritised_add(buf, res.samples, res.log_w, log_q)
        if buf.size >= cfg.min_buffer_length:
            for _ in range(cfg.n_batches_buffer_sampling):
                opt_state, buf, loss, _ = prioritised_step(
                    flow, buf, opt_state, cfg, draws.gumbel((cfg.buffer_capacity,)))
            history.append({"loss": float(loss), "ess_ais": float(res.ess_ais)})
    return buf, history
