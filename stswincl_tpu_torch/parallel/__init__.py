"""Data parallelism: the counterpart of `stswincl_tpu/parallel/`.

`distributed` joins torchrun's process group, `collectives` reduces and
gathers over it, and `mesh` cuts the batch, replicates and wraps modules
and syncs the BatchNorms, so that W ranks take the JAX package's
global-batch step.
"""
from stswincl_tpu_torch.parallel.collectives import (
    broadcast, cross_replica_batch_norm_stats, dist_collect, group_size,
    reduce_mean, reduce_sum)
from stswincl_tpu_torch.parallel.distributed import (
    barrier, host_count, initialize_distributed, initialized, launched, rank,
    shutdown, world_size)
from stswincl_tpu_torch.parallel.mesh import (
    data_parallel, is_data_parallel, max_param_difference, replicate,
    shard_batch, sync_batchnorm, unwrap)

__all__ = ["barrier", "broadcast", "cross_replica_batch_norm_stats",
           "data_parallel", "dist_collect", "group_size", "host_count",
           "initialize_distributed", "initialized", "is_data_parallel",
           "launched", "max_param_difference", "rank", "reduce_mean",
           "reduce_sum", "replicate", "shard_batch", "shutdown",
           "sync_batchnorm", "unwrap", "world_size"]
