"""Share of the decode steps of the traced window that ran as a CUDA
graph replay: the program's ``stvd.decode.step`` spans that hold a
``stvd.decode.replay`` span, over all of them. A window with no replay
span (a program that records none) reads nothing."""

from gpubench import spans


def read(r):
    if r.trace is None:
        return None
    replays = spans.ranges(r.trace, "stvd.decode.replay")
    steps = spans.outermost(spans.ranges(r.trace, "stvd.decode.step"))
    if not replays or not steps:
        return None
    held = spans.grouped(replays, steps)
    return 100.0 * sum(1 for g in held if g) / len(steps)
