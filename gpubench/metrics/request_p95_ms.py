"""95th percentile of every request of the window, from the call to the
captions as strings (host clock)."""

from gpubench import harness


def read(r):
    return harness.percentile(r.spans.get("request_ms", []), 95)
