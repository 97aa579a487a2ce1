"""Median host milliseconds of an update's backward (the gradients: the
hand VJP's reverse scan): the program's ``stvd.train.backward`` spans
inside each ``stvd.train.step`` of the traced window."""

from gpubench import spans


def read(r):
    return spans.median_update_ms(r, "stvd.train.backward")
