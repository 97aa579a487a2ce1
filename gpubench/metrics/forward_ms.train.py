"""Median host milliseconds of an update's forward (the loss terms: the
teacher-forced scan): the program's ``stvd.train.forward`` spans inside
each ``stvd.train.step`` of the traced window."""

from gpubench import spans


def read(r):
    return spans.median_update_ms(r, "stvd.train.forward")
