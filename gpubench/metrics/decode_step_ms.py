"""Wall milliseconds a decode step: the untraced part of the window over
the decode steps in it (counted by wrapping ``Captioner.step_fn``)."""


def read(r):
    n = r.counts.get("untraced_steps")
    return r.counts["untraced_s"] * 1e3 / n if n else None
