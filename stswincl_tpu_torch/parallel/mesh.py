"""The data-parallel layout: a rank's shard of the batch, replicated
modules, the DDP wrap and synchronised BatchNorms.

Counterpart of `stswincl_tpu/parallel/mesh.py`. The JAX package runs one
jitted step over the global batch, sharded over a mesh of every chip with
the parameters replicated, so XLA makes the gradients, every train-mode
BatchNorm's statistics and every loss normaliser global. Here each rank is
a process that holds its contiguous 1/W of the batch:

  * `make_mesh`, `batch_sharding` and `replicated_sharding` have no
    PyTorch meaning: the process group (`distributed.py`) stands in for
    the mesh, `shard_batch` for the batch sharding, and `replicate` (DDP
    does it at construction) for the replicated sharding;
  * `data_parallel` wraps a module in DDP, whose mean all-reduce of the
    gradients is XLA's psum over the mesh; each loss the step computes is
    the global one (`ops/ohem.py`, `train/train_seg.py`,
    `ops/contrastive.py` reduce their sums and counts), so that mean is
    the gradient of the global-batch loss;
  * `sync_batchnorm` makes every train-mode `BatchNorm` normalise by the
    statistics of the global batch and move its running statistics by
    them, with flax's arithmetic. torch's `SyncBatchNorm` cannot stand
    in: it updates the running variance unbiased and normalises NCHW.

Where the reference's launchers differ, this follows the JAX package: the
reference runs stage 1 under `nn.DataParallel`, whose BatchNorms keep
per-GPU statistics (`seg18/train_swin.py:133`); its stage 2 runs DDP with
SyncBatchNorm (`PixPro_swin_v5.py:215-228`). Here both stages sync.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from stswincl_tpu_torch.parallel.distributed import (initialized, rank,
                                                     world_size)


def shard_batch(batch, shard_index: int = None, num_shards: int = None):
    """This rank's contiguous 1/num_shards of a global batch on dim 0 (a
    mapping of arrays or one array), as `data.loader.Loader` cuts it.
    The index and count default to this process's rank and world."""
    shard_index = rank() if shard_index is None else shard_index
    num_shards = world_size() if num_shards is None else num_shards
    if isinstance(batch, Mapping):
        return {k: shard_batch(v, shard_index, num_shards)
                for k, v in batch.items()}
    n = batch.shape[0]
    if n % num_shards:
        raise ValueError(f"batch of {n} does not split into {num_shards} "
                         "shards")
    per = n // num_shards
    return batch[shard_index * per:(shard_index + 1) * per]


@torch.no_grad()
def replicate(module: nn.Module, group=None, src: int = 0) -> nn.Module:
    """Broadcast `module`'s parameters and buffers from rank `src` in
    place; returns the module. Without a process group it is returned as
    it is."""
    if initialized():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src, group=group)
    return module


def is_data_parallel(module: nn.Module) -> bool:
    return isinstance(module, DistributedDataParallel)


def unwrap(module: nn.Module) -> nn.Module:
    """The module a DDP wrap holds, or `module` itself."""
    return module.module if is_data_parallel(module) else module


def data_parallel(module: nn.Module, device, group=None) -> nn.Module:
    """`module` in DDP over `group` (default: the whole world), or the
    module itself without a process group. The buffers are not broadcast
    at each forward: with synced BatchNorms (`sync_batchnorm`) they move
    by the same global statistics on every rank."""
    if not initialized():
        return module
    device = torch.device(device)
    return DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=group, broadcast_buffers=False)


def sync_batchnorm(model: nn.Module, group=None) -> nn.Module:
    """Set the process group of every `models.norm.BatchNorm` in `model`
    (default: the whole world) so that train mode reduces its statistics
    over the ranks; returns the model. Without a process group nothing
    changes. Apply after any `copy.deepcopy` of the model."""
    from stswincl_tpu_torch.models.norm import BatchNorm
    if initialized():
        pg = group if group is not None else dist.group.WORLD
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.process_group = pg
    return model


def max_param_difference(module: nn.Module) -> float:
    """The largest |difference| of any parameter or buffer element between
    this rank and rank 0 (0.0 without a process group): the replicas of a
    sound data-parallel step stay equal."""
    worst = 0.0
    for t in list(module.parameters()) + list(module.buffers()):
        ref = t.detach().clone()
        if initialized():
            dist.broadcast(ref, 0)
        worst = max(worst, float((t.detach().double()
                                  - ref.double()).abs().max()))
    if initialized():
        w = torch.tensor([worst], dtype=torch.float32,
                         device=next(module.parameters()).device)
        dist.all_reduce(w, op=dist.ReduceOp.MAX)
        worst = float(w[0])
    return worst

