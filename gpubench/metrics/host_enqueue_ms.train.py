"""Median host milliseconds for one ``train_step`` call to return, before
the traced part (the benchmark's span; no synchronisation inside)."""

from gpubench import harness


def read(r):
    return harness.percentile(r.spans.get("train_step_ms", []), 50)
