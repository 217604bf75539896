"""Gradient clipping, Adam and the learning-rate schedules, in optax's form.

Counterpart of the optimizer that ``pita_tpu/train/trainer.py:316-337``
builds with optax: ``chain(clip_by_global_norm(grad_clip), adam(lr))`` over
the score and the energy parameters together, with a constant, cosine or
exponential schedule in optimizer steps. Written out rather than taken from
``torch.optim`` for two reasons:

- optax clips by ``max_norm / norm`` only when ``norm ≥ max_norm``, where
  ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``;
- the state is optax's (``count``, ``mu``, ``nu``), so a ``pita_tpu``
  checkpoint's optimizer state loads as it is.

Every function works on lists of tensors (one entry per parameter) and
updates the moments in place.
"""

import math
from typing import List, NamedTuple

import torch


class AdamState(NamedTuple):
    count: int  # updates so far
    mu: List[torch.Tensor]  # first moments
    nu: List[torch.Tensor]  # second moments


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: g·max_norm/‖g‖ when ‖g‖ ≥ max_norm, else g.
    Returns (clipped, ‖g‖) with no wait on the device."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads], norm


def adam_init(params) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def adam_update(grads, state: AdamState, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """optax.adam's update (scale_by_adam, then −lr): returns (updates,
    new state); the moments of ``state`` are updated in place."""
    count = state.count + 1
    dev = grads[0].device
    # bias corrections in f32, as optax computes them from an int32 count
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=dev) ** count
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=dev) ** count
    updates = []
    for g, m, v in zip(grads, state.mu, state.nu):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * (g * g))
        updates.append(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
    return updates, AdamState(count, state.mu, state.nu)


def make_lr_schedule(kind: str, lr: float, total_steps: int, steps_per_epoch: int,
                     decay_rate: float = 0.99, min_fraction: float = 0.1):
    """The learning rate at an optimizer step, as trainer.py:319-332 builds
    it: "constant", "cosine" (optax.cosine_decay_schedule to
    ``min_fraction``·lr over ``total_steps``) or "exponential"
    (optax.exponential_decay by ``decay_rate`` per epoch)."""
    if kind == "cosine":
        def sched(step):
            c = min(step, total_steps)
            return lr * ((1 - min_fraction) * 0.5 * (1 + math.cos(math.pi * c / total_steps))
                         + min_fraction)
        return sched
    if kind == "exponential":
        return lambda step: lr * decay_rate ** (step / steps_per_epoch)
    if kind == "constant":
        return lambda step: lr
    raise ValueError(f"unknown lr_schedule {kind!r}")
