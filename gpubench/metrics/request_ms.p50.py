"""Median request latency over the window's requests before the traced
part (the benchmark's span around ``Captioner.caption_ids``)."""

from gpubench import harness


def read(r):
    return harness.percentile(r.spans.get("request_ms.untraced", []), 50)
