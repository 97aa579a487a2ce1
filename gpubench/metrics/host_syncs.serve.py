"""Blocking CUDA runtime calls a request (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, synchronous
``cudaMemcpy``): those inside the program's outermost ``stvd.request``
spans of the traced window over the requests."""

from gpubench import spans


def read(r):
    if r.trace is None:
        return None
    requests = spans.outermost(spans.ranges(r.trace, "stvd.request"))
    if not requests:
        return None
    calls = spans.grouped(spans.blocking(r.trace), requests)
    return sum(map(len, calls)) / len(requests)
