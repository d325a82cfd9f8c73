"""Collectives over a process group.

Counterpart of `stswincl_tpu/parallel/collectives.py` (`:24-45`), with the
named mesh axis `axis_name` become a torch process group `group` (None:
the default group). With no process group each is the identity, as on one
rank. The reductions that sit inside a loss are differentiable: the
backward of an all-reduce is an all-reduce of the gradients
(`torch.distributed.nn.functional`), so a loss computed from globally
reduced sums carries, on each rank, W times that rank's share of the
global gradient, and DDP's mean over the W ranks leaves the gradient of
the global-batch loss.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from stswincl_tpu_torch.parallel.distributed import initialized


def group_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum all-reduce (`jax.lax.psum`), differentiable."""
    if not initialized():
        return x
    return dist_nn.all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """`reduce_sum` over `group`, or `x` itself when `group` is None: the
    sums and counts of a loss that runs on one rank or over the group of
    a data-parallel step."""
    return x if group is None else reduce_sum(x, group)


def reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean all-reduce (`jax.lax.pmean`; the reference's `reduce_tensor`,
    `contrast/util.py:61-65`), differentiable."""
    return reduce_sum(x, group) / group_size(group)


class _Collect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(group_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None


def dist_collect(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-gather concatenated on dim 0 in rank order (`jax.lax.all_gather
    (tiled=True)`; the reference's `dist_collect`, `contrast/util.py:
    47-58`). Every rank passes the same shape. Differentiable: the gradient
    of a rank's slice is the sum of the ranks' gradients of it."""
    if not initialized():
        return x
    return _Collect.apply(x.contiguous(), group)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """`x` as rank `src` holds it, on every rank (a copy)."""
    if not initialized():
        return x
    x = x.clone()
    dist.broadcast(x, src, group=group)
    return x


def cross_replica_batch_norm_stats(x: torch.Tensor, group=None):
    """(mean, var) over every axis but the last and over the ranks, in
    fp32, differentiably: the SyncBatchNorm primitive. The variance is
    flax's E[x^2] - E[x]^2 (not clipped here). The sums and the count are
    reduced, so ranks may hold different numbers of rows; the JAX form's
    mean of per-rank means equals it when they hold the same."""
    x = x.float()
    dims = tuple(range(x.dim() - 1))
    count = x.numel() // x.shape[-1]
    sums = torch.stack([x.sum(dims), (x * x).sum(dims),
                        x.new_full((x.shape[-1],), float(count))])
    s, s2, n = reduce_sum(sums, group)
    mean = s / n
    return mean, s2 / n - mean * mean
