"""Host milliseconds to dispatch one decode step: the program's
``stvd.decode.step`` (the decoder step and the logit tail) and
``stvd.decode.select`` (the beam merge, reorder and token write) spans
over the decode steps of the traced window."""

from gpubench import spans


def read(r):
    if r.trace is None:
        return None
    steps = spans.ranges(r.trace, "stvd.decode.step")
    if not steps:
        return None
    select = spans.ranges(r.trace, "stvd.decode.select")
    return (spans.ms(steps) + spans.ms(select)) / len(steps)
