"""Host milliseconds the kernel wrappers take a decode step (route
choice, argument marshalling, the launch): the program's
``stvd.kernel.*`` spans inside its ``stvd.decode.step`` spans, over the
decode steps of the traced window."""

from gpubench import spans


def read(r):
    if r.trace is None:
        return None
    steps = spans.ranges(r.trace, "stvd.decode.step")
    if not steps:
        return None
    wrappers = spans.ranges(r.trace, lambda n: n.startswith("stvd.kernel."))
    inner = spans.grouped(wrappers, spans.outermost(steps))
    return sum(spans.ms(g) for g in inner) / len(steps)
