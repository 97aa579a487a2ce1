"""Profiling helpers (counterpart of stvd/utils/profiling.py): device
traces through ``torch.profiler`` and a step timer for the train log's
steps/sec.

``trace(logdir)`` (or ``start_trace``) records the host
and, on a CUDA device, the card's activity, and writes a Chrome trace
(``*.pt.trace.json``) into ``logdir``; view it with ui.perfetto.dev or
TensorBoard's profiler plugin.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch

def start_trace(logdir: str) -> "torch.profiler.profile":
    """Start recording a trace; the returned profiler's ``stop()`` ends it
    and writes it to ``logdir``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    return prof


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a trace of the enclosed block into ``logdir``."""
    prof = start_trace(logdir)
    try:
        yield
    finally:
        prof.stop()


class StepTimer:
    """Rolling steps/sec over a window of step() calls."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0: Optional[float] = None
        self._n = 0

    def tick(self) -> Optional[float]:
        """Count one step; returns steps/sec once per window, else None
        (the first call only starts the clock)."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            self._n = 0
            return None
        self._n += 1
        if self._n >= self.window:
            rate = self._n / (now - self._t0)
            self._t0 = now
            self._n = 0
            return rate
        return None
