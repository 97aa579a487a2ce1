"""Blocking CUDA runtime calls an update (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, synchronous
``cudaMemcpy``): those inside the program's ``stvd.train.feed`` and
``stvd.train.step`` spans of the traced window over its updates."""

from gpubench import spans


def read(r):
    if r.trace is None:
        return None
    steps = spans.outermost(spans.ranges(r.trace, "stvd.train.step"))
    if not steps:
        return None
    parts = spans.outermost(sorted(
        steps + spans.ranges(r.trace, "stvd.train.feed")))
    return sum(map(len, spans.grouped(spans.blocking(r.trace), parts))) \
        / len(steps)
