"""Profiling and tracing hooks.

Counterpart of `stswincl_tpu/utils/profiling.py`. The reference's only
instrumentation is wall-clock `time.perf_counter` around forwards
(`seg18/train_swin.py:152,178`, `test.py:152-160`); this module gives the
same step timing (`StepTimer`) plus `torch.profiler` traces of the host
and the card (`device_trace`), with named ranges (`annotate`), viewable in
TensorBoard or Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[profile]:
    """Trace the enclosed region with `torch.profiler` (CPU activities,
    and CUDA ones where a card is present) and write it to `log_dir` as a
    Chrome trace (`trace_<pid>_<n>.json`). Yields the profiler, whose
    `events()` / `key_averages()` the caller may read after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    """Wall-clock step timer with warmup skipping and summary stats.

    Used as `with timer: step()`. CUDA launches return before the card has
    done the work, so where CUDA is in use `__exit__` synchronises the
    current device before it reads the clock, and a step's time is the
    card's as well as the host's (the JAX user blocks on the step's result
    for the same reason)."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.times = []
        self._t0: Optional[float] = None
        self._seen = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip_first:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        return {
            "steps": len(ts),
            "mean_s": self.mean,
            "p50_s": ts[len(ts) // 2],
            "max_s": ts[-1],
            "steps_per_sec": 1.0 / self.mean if self.mean else 0.0,
        }


def annotate(name: str):
    """A named range in the trace (`torch.profiler.record_function`)."""
    return record_function(name)
