"""The program's own spans in a traced window, for the metrics that read
them: the host ranges of ``stvd_torch.utils.profiling.span``
(``stvd.<layer>[.<part>]``) and the CUDA runtime's blocking calls, both
among ``Trace.host`` (every host event of the profile). Only ranges whole
inside the window count. A program without the spans leaves none, and
each reader then returns None."""

from __future__ import annotations

import bisect
import re
from typing import Callable, List, Tuple

from gpubench import harness

Range = Tuple[float, float]

# runtime calls that hold the host until the device has caught up
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy"})
_VERSION = re.compile(r"_v\d+$")   # a versioned runtime entry's suffix


def ranges(trace, match) -> List[Range]:
    """(start_us, end_us) of the host events whose name is ``match`` (a
    name, or a test of one) whole inside the window, by start."""
    test: Callable[[str], bool] = (match if callable(match)
                                   else match.__eq__)
    return sorted((s, e) for n, s, e in trace.host
                  if s >= trace.start_us and e <= trace.end_us and test(n))


def blocking(trace) -> List[Range]:
    """The window's blocking runtime calls."""
    return ranges(trace, lambda n: _VERSION.sub("", n) in BLOCKING)


def outermost(rs: List[Range]) -> List[Range]:
    """The ranges of ``rs`` (by start) that lie in no other."""
    out: List[Range] = []
    for s, e in rs:
        if not out or s >= out[-1][1]:
            out.append((s, e))
    return out


def grouped(items: List[Range], outer: List[Range]) -> List[List[Range]]:
    """For each range of ``outer`` (by start, disjoint) the ``items`` that
    lie inside it."""
    starts = [s for s, _ in outer]
    out: List[List[Range]] = [[] for _ in outer]
    for s, e in items:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outer[i][1]:
            out[i].append((s, e))
    return out


def ms(rs: List[Range]) -> float:
    return sum(e - s for s, e in rs) / 1e3


def median_update_ms(r, name: str) -> float | None:
    """The median over the window's updates (``stvd.train.step``) of the
    summed milliseconds of their ``name`` ranges."""
    if r.trace is None:
        return None
    steps = outermost(ranges(r.trace, "stvd.train.step"))
    each = [ms(g) for g in grouped(ranges(r.trace, name), steps) if g]
    return harness.percentile(each, 50)
