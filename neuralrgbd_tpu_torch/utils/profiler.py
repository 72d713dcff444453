"""Profiling helpers: torch.profiler traces + per-step wall timing
(counterpart of ``neuralrgbd_tpu/utils/profiler.py``).

The reference had no profiling beyond cudnn.benchmark (SURVEY.md section
5); here tracing is first-class. ``StepTimer`` reads the host clock: for
the card's own time use ``utils/timing.py``'s CUDA events.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the body, host ops and (where
    the process sees a card) CUDA kernels, written to ``log_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json`` when the body ends: a Chrome trace
    that chrome://tracing, Perfetto and TensorBoard's PyTorch profiler
    plugin open (writing it needs no ``tensorboard`` package). Yields the
    profiler, for its ``key_averages()`` tables."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    """Rolling per-step timing with percentile summary."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        import numpy as np

        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p90_ms": float(np.percentile(t, 90) * 1e3),
            "n": len(t),
        }


def annotate(name: str):
    """Named trace region (a ``torch.profiler.record_function`` range:
    a row of its own in the trace and in ``key_averages()``)."""
    return torch.profiler.record_function(name)
