"""Profiling helpers (counterpart of stvd/utils/profiling.py): device
traces through ``torch.profiler``, the program's own spans in them, and a
step timer for the train log's steps/sec.

``trace(logdir)`` (or ``start_trace``) records the host
and, on a CUDA device, the card's activity, and writes a Chrome trace
(``*.pt.trace.json``) into ``logdir``; view it with ui.perfetto.dev or
TensorBoard's profiler plugin.

``span(name)`` marks a part of the program in such a trace: while a
profiler runs it is a profiler range (what ``record_function`` records),
so the part shows as a host range on the same clock as the card's
activity, inside the span it nests in on its thread.  Otherwise it is one
shared no-op context, at the cost of one flag read.  The spans are named
``stvd.<layer>[.<part>]``:

    stvd.request            one call of Captioner.caption / caption_batch
                            / caption_ids
    stvd.request.rows       the ids' bank rows and their upload
    stvd.request.copy       a chunk's tokens to the host
    stvd.request.detok      a chunk's ids to strings
    stvd.decode             one beam or greedy decode of a chunk
    stvd.decode.step        the decoder step and the logit tail
    stvd.decode.select      the beam merge, reorder and token write
    stvd.decode.sync        the early-exit read of the finished flags
    stvd.decode.best        the beam decode's length penalty and best beam
    stvd.kernel.<wrapper>   a kernel wrapper of model/kernel.py
    stvd.train.feed         gather_batch
    stvd.train.step         one train_step
    stvd.train.forward      the loss terms
    stvd.train.backward     the gradients
    stvd.train.allreduce    the flat all-reduce of a data mesh
    stvd.train.optimizer    norm, clipping, the update and its apply
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# the one context every span returns while no profiler runs
_NO_SPAN = contextlib.nullcontext()


def _tracing() -> bool:
    """A graph is being traced or captured: ``torch.compile`` or
    ``torch.export`` (``is_compiling`` holds for both) or CUDA-graph
    capture, none of which may hold a profiler op."""
    return (torch.compiler.is_compiling()
            or (torch.cuda.is_initialized()
                and torch.cuda.is_current_stream_capturing()))


def span(name: str):
    """A context that marks ``name`` in a running profiler's trace, and
    the shared no-op context when none runs or a graph is traced."""
    if not _autograd_profiler._is_profiler_enabled or _tracing():
        return _NO_SPAN
    # the profiler's C++ range: a host range in the trace as
    # ``record_function`` records one, without its dispatch through
    # ``torch.ops`` (a seventh of its host time a span)
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str) -> Callable[[Callable], Callable]:
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


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
    """Updates per second between two reads of the clock.  The caller
    reads it only where it has just waited for the device (a train
    record's loss read), so the rate counts finished updates, not updates
    queued."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0: Optional[float] = None
        self._n0 = 0

    def tick(self, count: int) -> Optional[float]:
        """The clock at ``count`` updates done: the first call starts it;
        a later one, once ``window`` updates have passed since the start,
        returns their rate and starts the clock again, else None."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0, self._n0 = now, count
            return None
        n = count - self._n0
        if n >= self.window:
            rate = n / (now - self._t0)
            self._t0, self._n0 = now, count
            return rate
        return None
