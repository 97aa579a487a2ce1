"""Median host milliseconds of an update's feed (``gather_batch``: the
bank's rows gathered on the card, tokens and mask copied to it): the
program's ``stvd.train.feed`` spans of the traced window."""

from gpubench import harness, spans


def read(r):
    if r.trace is None:
        return None
    feeds = spans.ranges(r.trace, "stvd.train.feed")
    return harness.percentile([spans.ms([f]) for f in feeds], 50)
