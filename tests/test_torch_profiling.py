"""The port's profiling hooks (`stswincl_tpu_torch/utils/profiling.py`)
on the CPU: `StepTimer` against the JAX package's on the same patched
clock (warmup skipping, mean, p50, max, steps/s, the empty summary), and
`device_trace` + `annotate`, which write a Chrome trace holding the
annotated ranges and the operators run inside them."""

import glob
import json
import time

import pytest
import torch

from stswincl_tpu.utils import profiling as jprofiling
from stswincl_tpu_torch.utils import profiling


def _clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("skip_first", [0, 2])
def test_step_timer_matches_jax(monkeypatch, skip_first):
    # step k lasts durations[k] seconds
    durations = [0.5, 0.25, 0.125, 0.375, 0.0625, 0.25]
    ticks = []
    t = 10.0
    for d in durations:
        ticks += [t, t + d]
        t += d + 1.0
    summaries = []
    for mod in (profiling, jprofiling):
        _clock(monkeypatch, ticks)
        timer = mod.StepTimer(skip_first=skip_first)
        assert timer.summary() == {"steps": 0}
        for _ in durations:
            with timer:
                pass
        summaries.append((timer.summary(), timer.mean, timer.times))
    assert summaries[0] == summaries[1]
    summary = summaries[0][0]
    assert summary["steps"] == len(durations) - skip_first
    assert summary["max_s"] == max(durations[skip_first:])


def test_device_trace_holds_the_annotated_ranges(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path)) as prof:
        for i in range(2):
            with profiling.annotate(f"step{i}"):
                y = x @ x
                y.relu_()
    names = {e.name for e in prof.events()}
    assert {"step0", "step1", "aten::mm"} <= names
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    traced = {e.get("name") for e in events}
    assert {"step0", "step1", "aten::mm"} <= traced
    # a second trace in the same directory gets its own file
    with profiling.device_trace(str(tmp_path)):
        x.sum()
    assert len(glob.glob(str(tmp_path / "trace_*.json"))) == 2
