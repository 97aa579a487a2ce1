"""Window milliseconds over the updates completed: updates dispatched back
to back, the window ended by ``torch.cuda.synchronize()`` (host clock)."""


def read(r):
    n = r.counts.get("updates")
    return r.window_s * 1e3 / n if n else None
