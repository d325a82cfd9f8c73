"""Logging and metric sinks.

Counterpart of `stswincl_tpu/utils/logging.py` (after the reference's
`seg18/utils/summary.py:9-111` and `contrast/logger.py:31-94`): a logger
that writes to stdout on rank 0 and to a file per rank, an
`AverageMeter`, and a `MetricLogger` that writes JSONL scalars on rank 0
and TensorBoard events where `torch.utils.tensorboard` imports (the JAX
package's sink uses TensorFlow's writer the same way). The rank is
`parallel.distributed.rank()`: the process group's, else 0.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional

from stswincl_tpu_torch.parallel.distributed import rank


def setup_logger(log_dir: Optional[str] = None, name: str = "stswincl",
                 all_ranks_file: bool = True) -> logging.Logger:
    """Rank-aware logger: stdout on rank 0, a log file per rank."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s] %(levelname)s: %(message)s", "%H:%M:%S")
    main = rank() == 0
    if main:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if log_dir and (main or all_ranks_file):
        os.makedirs(log_dir, exist_ok=True)
        suffix = "" if main else f".rank{rank()}"
        fh = logging.FileHandler(os.path.join(log_dir, f"log.txt{suffix}"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    """Running average (`contrast/util.py:7-27`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricLogger:
    """Scalar sink: `metrics.jsonl` always, TensorBoard events where the
    writer imports; only rank 0 writes (`summary.py:44-48`)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.enabled = rank() == 0
        self._jsonl = None
        self._tb = None
        if self.enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is optional
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def log(self, step: int, scalars: Dict[str, float]):
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
