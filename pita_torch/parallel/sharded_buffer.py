"""A replay buffer whose capacity axis is split over the ranks.

Counterpart of ``pita_tpu/parallel/sharded_buffer.py:27-89``. The reference
keeps a full copy of its replay buffers on every DDP rank
(``prioritised_replay_buffer.py:21-33``), which caps the capacity at one
device's memory. Here rank r holds rows [r·C/W, (r+1)·C/W) of a capacity C;
the cursor ``pos`` and the fill count ``size`` are host integers, the same
on every rank.

The ops give what ``pita_torch.train.buffer`` gives on one process:

- ``add`` writes each global row index on the rank that holds it;
- ``sample`` draws the global row indices as ``sample_indices`` does, from
  a generator every rank seeds alike (the prioritized modes read the
  gathered log-probabilities, C floats), and each rank contributes the rows
  it holds: one ``all_reduce`` of the batch, zeros elsewhere, returns the
  rows to every rank.
"""

import torch

from pita_torch.train.buffer import ReplayBuffer, sample_indices


class ShardedBufferOps:
    """Buffer ops with the capacity axis split over ``group``'s ranks.

    Usage::

        ops = ShardedBufferOps(group)
        buf = ops.place(buffer_init(capacity, dim))      # this rank's rows
        buf = ops.add(buf, x, energy, force)              # rows on their ranks
        x, e, f, idx = ops.sample(buf, 256, generator=g)  # the same on every rank
    """

    def __init__(self, group):
        self.group = group

    def place(self, buf: ReplayBuffer) -> ReplayBuffer:
        """This rank's rows of a whole buffer, on the rank's device."""
        cap = buf.x.shape[0]
        if cap % self.group.world_size:
            raise ValueError(f"buffer capacity {cap} does not divide over "
                             f"{self.group.world_size} ranks")
        mine = lambda t: self.group.shard(t).to(self.group.device, copy=True)
        return ReplayBuffer(mine(buf.x), mine(buf.energy), mine(buf.force), int(buf.pos),
                            int(buf.size))

    def capacity(self, buf: ReplayBuffer) -> int:
        return buf.x.shape[0] * self.group.world_size

    def rows_per_rank(self, buf: ReplayBuffer) -> int:
        return buf.x.shape[0]

    def _local(self, buf, idx):
        """(this rank holds row idx, its local index) for global indices."""
        start = self.group.rank * buf.x.shape[0]
        own = (idx >= start) & (idx < start + buf.x.shape[0])
        return own, (idx - start).clamp(0, buf.x.shape[0] - 1)

    def add(self, buf: ReplayBuffer, x, energy, force=None, mask=None) -> ReplayBuffer:
        """``buffer_add`` of rows that every rank passes alike."""
        if force is None:
            force = torch.zeros_like(x)
        if mask is not None:
            keep = torch.nonzero(mask).flatten()
            x, energy, force = x[keep], energy[keep], force[keep]
        n, cap = x.shape[0], self.capacity(buf)
        if n > 0:
            idx = (buf.pos + torch.arange(n, device=buf.x.device)) % cap
            own, local = self._local(buf, idx)
            rows = torch.nonzero(own).flatten()
            at = local[rows]
            buf.x[at] = x.to(buf.x)[rows]
            buf.energy[at] = energy.to(buf.energy)[rows]
            buf.force[at] = force.to(buf.force)[rows]
        return buf._replace(pos=(buf.pos + n) % cap, size=min(buf.size + n, cap))

    def sample(self, buf: ReplayBuffer, batch_size: int, prioritize: bool = False,
               replacement: bool = False, generator=None):
        """``buffer_sample``: (x, energy, force, idx), the same on every
        rank, from a ``generator`` on the rank's device seeded alike on
        every rank."""
        view = buf._replace(energy=self.group.gather_rows(buf.energy)) if prioritize else buf
        idx = sample_indices(view, batch_size, prioritize, replacement, generator)
        idx = idx.to(buf.x.device)
        own, local = self._local(buf, idx)
        D = buf.x.shape[1]
        rows = torch.cat([buf.x[local], buf.energy[local, None], buf.force[local]], dim=1)
        rows = self.group.sum(torch.where(own[:, None], rows, torch.zeros_like(rows)))
        return rows[:, :D], rows[:, D], rows[:, D + 1:], idx
