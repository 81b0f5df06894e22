"""Tracing and a step timer (counterpart of
``scanobjectnn_tpu/utils/profiling.py``).

``trace(log_dir)`` records CPU and, where a CUDA device is present, CUDA
activity with ``torch.profiler`` and writes it as a Chrome trace
(``log_dir/trace.json``: host operators and every CUDA kernel by name;
open it in Perfetto or chrome://tracing).  ``StepTimer`` is the JAX
package's, unchanged.
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["TRACE_FILE", "trace", "StepTimer"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on leaving it, write ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Rolling steps/sec + clouds/sec; negligible overhead (host clock only)."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self._times: list[float] = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0

    @property
    def clouds_per_sec(self) -> float:
        return self.steps_per_sec * self.batch_size
