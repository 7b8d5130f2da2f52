"""Profiling utilities (port of pulpo_tpu/utils/profiling.py).

- `trace(log_dir)`: a context manager around `torch.profiler.profile`
  (CPU, and CUDA where there is a card) that writes a Chrome trace
  (`trace.json`, for Perfetto or chrome://tracing) into `log_dir`.
- `StepTimer`: rolling step-time statistics with a one-line report;
  `toc(result)` synchronises the device the result lies on first, so the
  host clock measures the work and not its enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(result) -> None:
    """Wait for the CUDA devices that hold a tensor of `result` (nested
    tuples, lists and dicts)."""
    stack, devices = [result], set()
    while stack:
        r = stack.pop()
        if isinstance(r, torch.Tensor):
            if r.is_cuda:
                devices.add(r.device)
        elif isinstance(r, dict):
            stack.extend(r.values())
        elif isinstance(r, (list, tuple)):
            stack.extend(r)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._t = None
        self._n = 0

    def tic(self):
        self._t = time.perf_counter()

    def toc(self, result=None):
        if result is not None:
            _synchronize(result)
        dt = time.perf_counter() - self._t
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")

    def report(self, name: str = "step") -> str:
        if not self.times:
            return f"{name}: no timed steps"
        return (f"{name}: mean {self.mean*1e3:.1f} ms, p50 {self.p50*1e3:.1f} ms, "
                f"n={len(self.times)}")
