"""Captions returned in the window over the window's seconds (host clock)."""


def read(r):
    if "captions" not in r.counts or not r.window_s:
        return None
    return r.counts["captions"] / r.window_s
