"""Host milliseconds a decode step spends in the early-exit read of the
finished flags (the program's ``stvd.decode.sync`` spans) over the decode
steps (``stvd.decode.step``) of the traced window. Near 0 the host paces
the steps; near a step's device time the device does."""

from gpubench import spans


def read(r):
    if r.trace is None:
        return None
    steps = spans.ranges(r.trace, "stvd.decode.step")
    if not steps:
        return None
    return spans.ms(spans.ranges(r.trace, "stvd.decode.sync")) / len(steps)
