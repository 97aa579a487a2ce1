"""Share of the traced window in which no kernel or copy ran on the card
(the union of device intervals), serving cells; ``idle_share.train``
reads the training cells with this reader."""


def read(r):
    if r.trace is None or not r.trace.kernels:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
