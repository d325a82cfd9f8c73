"""Process groups of a data-parallel run, from torchrun's environment.

Counterpart of `stswincl_tpu/parallel/distributed.py`. The JAX package
calls `jax.distributed.initialize` once a host and lets XLA route every
collective; here one process runs a rank, started by

    torchrun --nproc_per_node=W -m stswincl_tpu_torch.cli train-seg ...

which sets `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`,
`MASTER_ADDR` and `MASTER_PORT`. `initialize_distributed` reads them and
joins the group: NCCL for a CUDA device, gloo for the CPU, or the backend
the caller names (gloo also takes CUDA tensors, which lets two ranks share
one card). Without those variables it does nothing, and every helper
below answers for a world of one.

A collective waits at most `timeout` for the other ranks before the
backend aborts the run (NCCL's default is 10 minutes). Rank 0 evaluates
alone while the other ranks wait in the IoU broadcast
(`pipelines/seg.py`), and the real EndoVis18 validation split holds it
about 9 minutes (host label decode), so the default here is an hour;
`STSWIN_DIST_TIMEOUT` (seconds) sets another for a deployment whose
evaluation runs longer.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 3600


def launched() -> bool:
    """True when a launcher (torchrun) set this process's rank and world."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def host_count() -> int:
    """The hosts of the run, `WORLD_SIZE // LOCAL_WORLD_SIZE`: the
    counterpart of `jax.process_count()`, which counts hosts, not chips
    (1 on one machine, whatever the ranks)."""
    if not launched():
        return 1
    world = int(os.environ["WORLD_SIZE"])
    return max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)


def collective_timeout() -> datetime.timedelta:
    """How long a collective waits for the other ranks:
    `STSWIN_DIST_TIMEOUT` seconds, else DEFAULT_TIMEOUT_S."""
    return datetime.timedelta(seconds=float(os.environ.get(
        "STSWIN_DIST_TIMEOUT", DEFAULT_TIMEOUT_S)))


def initialize_distributed(device="cuda",
                           backend: Optional[str] = None) -> torch.device:
    """Join torchrun's process group and return this rank's device.

    `device` 'cuda' becomes `cuda:LOCAL_RANK` (a device with an index is
    kept), made the current CUDA device. The backend is NCCL for a CUDA
    device and gloo for the CPU unless `backend` names another; its
    collectives wait `collective_timeout()`. In a single process (no
    launcher) the device is returned as given and no group is made; a
    group that already exists is kept."""
    device = torch.device(device)
    if not launched():
        return device
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device; "
                               "pass device='cpu' for gloo ranks on the CPU")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        torch.cuda.set_device(device)
    if not initialized():
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=collective_timeout())
    return device


def barrier() -> None:
    if initialized():
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if initialized():
        dist.destroy_process_group()
