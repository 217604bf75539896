"""Process groups: which rank holds which rows, and the two collectives.

Counterpart of ``pita_tpu/parallel/mesh.py:23-37`` (``make_mesh``,
``chain_sharding``, ``replicated``). Where JAX names a device mesh and lets
XLA insert the collectives a sharded program needs, the port runs one
process per GPU under ``torch.distributed`` and calls them itself. A
``ChainGroup`` says which rows of a leading (chain or batch) axis a rank
holds: rank r holds rows [r·n/W, (r+1)·n/W) of n, so gathering the ranks'
rows in rank order gives the global tensor back. Everything else is
replicated: each rank holds the same copy.

Two collectives serve the sharded sampler, training step and buffer:
``gather_rows`` (``all_gather`` into a preallocated tensor) and ``sum``
(``all_reduce``). They run the same code on NCCL and gloo, and at world
size 1 too.
"""

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from pita_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ChainGroup:
    """The ranks of the default ``torch.distributed`` process group, seen
    from one of them: its rank, the world size and the rank's device."""

    rank: int
    world_size: int
    device: torch.device

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n`` (which W divides)."""
        if n % self.world_size:
            raise ValueError(f"{n} rows do not divide over {self.world_size} ranks")
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``t`` along ``dim``."""
        r = self.rows(t.shape[dim])
        return t.narrow(dim, r.start, r.stop - r.start)

    def gather_rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' equal shards of a tensor along ``dim``, concatenated in
        rank order: the global tensor on every rank."""
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.world_size * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src)
        return out.movedim(0, dim)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in a new tensor."""
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out


def make_group(init_method: Optional[str] = None, world_size: int = 1, rank: int = 0,
               device=None) -> ChainGroup:
    """This process's rank of a group of ``world_size`` processes.

    ``device`` defaults to ``cuda:<group rank mod GPUs>`` (raising without a
    GPU); the backend is NCCL on CUDA and gloo on the CPU. The default process
    group is made from ``init_method`` (``tcp://host:port`` or
    ``file://path``; nothing tells a process of a cluster) unless it exists
    already, in which case its rank and size are used.
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, world_size=world_size, rank=rank)
    if dev.type == "cuda":
        if device is None:
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return ChainGroup(dist.get_rank(), dist.get_world_size(), dev)
