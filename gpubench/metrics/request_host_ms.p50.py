"""Median host milliseconds of a request outside its decodes: over the
traced window's requests (the program's outermost ``stvd.request``
spans), each one's time less its ``stvd.decode`` spans (the id lookup,
the row gather, the token copies and the strings)."""

from gpubench import harness, spans


def read(r):
    if r.trace is None:
        return None
    requests = spans.outermost(spans.ranges(r.trace, "stvd.request"))
    decodes = spans.grouped(spans.ranges(r.trace, "stvd.decode"), requests)
    return harness.percentile([spans.ms([q]) - spans.ms(d)
                               for q, d in zip(requests, decodes)], 50)
