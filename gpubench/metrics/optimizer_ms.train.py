"""Median host milliseconds of an update's optimizer (global norm,
clipping, the update and its apply): the program's
``stvd.train.optimizer`` spans inside each ``stvd.train.step`` of the
traced window."""

from gpubench import spans


def read(r):
    return spans.median_update_ms(r, "stvd.train.optimizer")
