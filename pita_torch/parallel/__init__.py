from pita_torch.parallel.mesh import ChainGroup, make_group
from pita_torch.parallel.sharded import (
    ShardedDraws,
    make_dp_train_step,
    shard_batch,
    sharded_integrate,
)
from pita_torch.parallel.sharded_buffer import ShardedBufferOps

__all__ = ["ChainGroup", "ShardedBufferOps", "ShardedDraws", "make_dp_train_step", "make_group",
           "shard_batch", "sharded_integrate"]
