"""Step timing (counterpart of ``StepTimer`` in stvd/utils/profiling.py).

The JAX module's trace helpers become ``torch.profiler`` with ROADMAP.md
Queue 1 item 10; ``fit`` raises for ``train.profile_dir`` until then.
"""

from __future__ import annotations

import time
from typing import Optional


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
