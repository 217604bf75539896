"""Replay buffer: a ring of (x, log-prob, force) rows, one per ladder rung.

Counterpart of ``pita_tpu/train/buffer.py:28-251`` (``buffer_init``,
``buffer_add``, ``buffer_sample``, ``buffer_last_n``, the per-rung stack
``stack_buffers``/``buffer_view``/``buffer_set``, ``buffer_save`` and
``buffer_load``, and FAB's ``PrioritisedBuffer``). The ``energy`` field
holds log-probabilities, as in the reference.

Where JAX returns new arrays, the port writes in place: ``buffer_add``
writes its rows into the buffer's tensors (a ``buffer_view`` of a stack is
a view, so they land in the stack) and returns the buffer with its new
cursor. The cursor and fill count are host integers (the stack keeps them as
int64 CPU tensors), so sampling waits on nothing.
"""

from typing import NamedTuple

import numpy as np
import torch


class ReplayBuffer(NamedTuple):
    x: torch.Tensor  # (capacity, dim), or (rungs, capacity, dim) when stacked
    energy: torch.Tensor  # (capacity,): log-probabilities
    force: torch.Tensor  # (capacity, dim)
    pos: object  # next write index: int, or (rungs,) int64 CPU tensor when stacked
    size: object  # rows filled: int, or (rungs,) int64 CPU tensor when stacked


def buffer_init(capacity: int, dim: int, device=None, dtype=torch.float32) -> ReplayBuffer:
    return ReplayBuffer(
        x=torch.zeros((capacity, dim), dtype=dtype, device=device),
        energy=torch.zeros((capacity,), dtype=dtype, device=device),
        force=torch.zeros((capacity, dim), dtype=dtype, device=device),
        pos=0, size=0,
    )


def buffer_add(buf: ReplayBuffer, x, energy, force=None, mask=None) -> ReplayBuffer:
    """Append a batch, wrapping around (SimpleBuffer.add, :285-317). With
    ``mask`` (n,) only its rows are written, in order; the cursor moves past
    them alone."""
    if force is None:
        force = torch.zeros_like(x)
    if mask is not None:
        keep = torch.nonzero(mask).flatten()
        x, energy, force = x[keep], energy[keep], force[keep]
    n = x.shape[0]
    cap = buf.x.shape[0]
    if n > 0:
        idx = (buf.pos + torch.arange(n, device=buf.x.device)) % cap
        buf.x[idx] = x.to(buf.x)
        buf.energy[idx] = energy.to(buf.energy)
        buf.force[idx] = force.to(buf.force)
    return buf._replace(pos=(buf.pos + n) % cap, size=min(buf.size + n, cap))


def sample_indices(buf: ReplayBuffer, batch_size: int, prioritize: bool = False,
                   replacement: bool = False, generator=None):
    """The row indices of one ``buffer_sample`` (SimpleBuffer.sample, :335-370):

    - uniform with replacement (what configs/model/energytemp.yaml:37 sets);
    - uniform without replacement: a random subset, and past the fill level
      the excess drawn with replacement;
    - ``prioritize``: ∝ softmax of the stored log-probabilities, with
      replacement by a categorical draw, without by Gumbel-top-k.
    """
    dev = buf.x.device
    size = max(int(buf.size), 1)
    if prioritize:
        probs = torch.softmax(buf.energy[:size], dim=0)
        if replacement:
            return torch.multinomial(probs, batch_size, replacement=True, generator=generator)
        u = torch.rand(size, generator=generator, device=dev).clamp_min(1e-20)
        gumbel = buf.energy[:size] - torch.log(-torch.log(u))
        head = torch.topk(gumbel, min(batch_size, size)).indices
        rest = torch.multinomial(probs, batch_size - head.numel(), replacement=True,
                                 generator=generator) if batch_size > size else head[:0]
        return torch.cat([head, rest])
    if replacement:
        return torch.randint(0, size, (batch_size,), generator=generator, device=dev)
    head = torch.randperm(size, generator=generator, device=dev)[:batch_size]
    rest = torch.randint(0, size, (batch_size - head.numel(),), generator=generator, device=dev)
    return torch.cat([head, rest])


def buffer_sample(buf: ReplayBuffer, batch_size: int, prioritize: bool = False,
                  replacement: bool = False, generator=None, idx=None):
    """Returns (x, energy, force, idx); ``idx`` given skips the draw."""
    if idx is None:
        idx = sample_indices(buf, batch_size, prioritize, replacement, generator)
    idx = idx.to(buf.x.device)
    return buf.x[idx], buf.energy[idx], buf.force[idx], idx


def buffer_last_n(buf: ReplayBuffer, n: int):
    """The n rows inserted last, newest first (get_last_n_inserted, :319-333)."""
    cap = buf.x.shape[0]
    idx = (buf.pos - 1 - torch.arange(n, device=buf.x.device)) % cap
    return buf.x[idx], buf.energy[idx], buf.force[idx]


def stack_buffers(bufs) -> ReplayBuffer:
    """Per-rung buffers stacked along a leading rung axis (energytemp_module.py:189-191)."""
    return ReplayBuffer(
        x=torch.stack([b.x for b in bufs]),
        energy=torch.stack([b.energy for b in bufs]),
        force=torch.stack([b.force for b in bufs]),
        pos=torch.tensor([int(b.pos) for b in bufs], dtype=torch.int64),
        size=torch.tensor([int(b.size) for b in bufs], dtype=torch.int64),
    )


def buffer_view(bufs: ReplayBuffer, i: int) -> ReplayBuffer:
    """Rung ``i`` of a stack; its tensors are views into the stack."""
    return ReplayBuffer(bufs.x[i], bufs.energy[i], bufs.force[i], int(bufs.pos[i]),
                        int(bufs.size[i]))


def buffer_set(bufs: ReplayBuffer, i: int, buf: ReplayBuffer) -> ReplayBuffer:
    """Write rung ``i`` back into the stack (its rows, unless ``buf`` is a view
    of that rung already, and its cursor)."""
    for whole, part in ((bufs.x, buf.x), (bufs.energy, buf.energy), (bufs.force, buf.force)):
        if whole[i].data_ptr() != part.data_ptr():
            whole[i].copy_(part)
    bufs.pos[i] = int(buf.pos)
    bufs.size[i] = int(buf.size)
    return bufs


class PrioritisedBuffer(NamedTuple):
    """FAB's (x, log w, log q) ring (prioritised_replay_buffer.py:49-221),
    sampled ∝ exp(log w) without replacement by Gumbel-top-k (:36-46).
    Its only user is ``pita_torch.fab.fab_model``."""

    x: torch.Tensor  # (capacity, dim)
    log_w: torch.Tensor  # (capacity,), −∞ where empty
    log_q: torch.Tensor  # (capacity,)
    pos: int
    size: int


def prioritised_init(capacity: int, dim: int, device=None,
                     dtype=torch.float32) -> PrioritisedBuffer:
    return PrioritisedBuffer(
        x=torch.zeros((capacity, dim), dtype=dtype, device=device),
        log_w=torch.full((capacity,), -float("inf"), dtype=dtype, device=device),
        log_q=torch.zeros((capacity,), dtype=dtype, device=device),
        pos=0, size=0,
    )


def prioritised_add(buf: PrioritisedBuffer, x, log_w, log_q) -> PrioritisedBuffer:
    """Write a batch at the cursor, wrapping around (in place)."""
    n, cap = x.shape[0], buf.x.shape[0]
    idx = (buf.pos + torch.arange(n, device=buf.x.device)) % cap
    buf.x[idx] = x.to(buf.x)
    buf.log_w[idx] = log_w.to(buf.log_w)
    buf.log_q[idx] = log_q.to(buf.log_q)
    return buf._replace(pos=(buf.pos + n) % cap, size=min(buf.size + n, cap))


def prioritised_sample(buf: PrioritisedBuffer, batch_size: int, gumbel: torch.Tensor):
    """``batch_size`` distinct rows drawn ∝ exp(log w) among the filled ones:
    the top k of log w + ``gumbel``, (capacity,) standard Gumbel draws.
    Returns (x, log w, log q, idx)."""
    cap = buf.x.shape[0]
    valid = torch.arange(cap, device=buf.x.device) < buf.size
    logits = torch.where(valid, buf.log_w, -float("inf"))
    idx = torch.topk(logits + gumbel.to(logits), batch_size).indices
    return buf.x[idx], buf.log_w[idx], buf.log_q[idx], idx


def prioritised_adjust(buf: PrioritisedBuffer, log_q_new, idx=None) -> PrioritisedBuffer:
    """Re-weight after the proposal changed (:178-198): log w += log q_old −
    log q_new at ``idx`` (every row by default), −∞ where that is not
    finite, and log q ← log q_new (in place)."""
    if idx is None:
        idx = torch.arange(buf.x.shape[0], device=buf.x.device)
    log_w_new = buf.log_w[idx] + buf.log_q[idx] - log_q_new
    buf.log_w[idx] = torch.where(torch.isfinite(log_w_new), log_w_new, -float("inf"))
    buf.log_q[idx] = log_q_new.to(buf.log_q)
    return buf


def buffer_save(buf: ReplayBuffer, path: str):
    """Persist to .npz (SimpleBuffer.save, :389-399), in pita_tpu's layout."""
    np.savez(path, x=buf.x.cpu().numpy(), energy=buf.energy.cpu().numpy(),
             force=buf.force.cpu().numpy(), pos=int(buf.pos), size=int(buf.size))


def buffer_load(path: str, device=None) -> ReplayBuffer:
    z = np.load(path)
    t = lambda a: torch.as_tensor(a, device=device)
    return ReplayBuffer(t(z["x"]), t(z["energy"]), t(z["force"]), int(z["pos"]), int(z["size"]))
