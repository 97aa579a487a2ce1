"""``decode_graph_share`` on hand-made traces: the share of the window's
decode steps that hold a graph replay, with every step replayed, none,
half, and a window whose program records no replay at all."""

from __future__ import annotations

import pytest

from gpubench import harness


def readings(host, start=0.0, end=10_000.0):
    trace = harness.Trace(start, end, kernels=[], host=list(host))
    return harness.Readings(cell={}, config={}, traffic={}, trace=trace)


def steps(n, replayed, start=100.0):
    """``n`` decode steps of 100 us, the first ``replayed`` of them a
    replay (a step span holding a replay span, then the sync), the rest
    eager (a step span holding a kernel wrapper, a select, the sync)."""
    host = [("stvd.decode", start - 10, start + 100 * n + 10)]
    for i in range(n):
        s = start + 100 * i
        host.append(("stvd.decode.step", s, s + 60))
        if i < replayed:
            host.append(("stvd.decode.replay", s + 5, s + 55))
        else:
            host += [("stvd.kernel.logit_tail", s + 5, s + 20),
                     ("stvd.decode.select", s + 60, s + 80)]
        host.append(("stvd.decode.sync", s + 80, s + 100))
    return host


READ = harness.load_module("metrics", "decode_graph_share").read


@pytest.mark.parametrize("n,replayed,want", [
    (30, 30, 100.0), (30, 15, 50.0), (4, 1, 25.0)],
    ids=["all", "half", "quarter"])
def test_share_of_replayed_steps(n, replayed, want):
    assert READ(readings(steps(n, replayed))) == pytest.approx(want)


def test_none_replayed_reads_nothing():
    """Steps but no replay span: a program without graphs (the parent
    of the change that added them) reads nothing, as does no trace."""
    assert READ(readings(steps(30, 0))) is None
    assert READ(harness.Readings(cell={}, config={}, traffic={})) is None


def test_a_replay_outside_the_window_or_a_step_does_not_count():
    """Only steps whole inside the window count, and a replay counts
    for the step that holds it."""
    host = steps(10, 10)
    assert READ(readings(host, end=600.0)) == pytest.approx(100.0)
    host = steps(4, 0) + [("stvd.decode.replay", 5000, 5010)]
    assert READ(readings(host)) == 0.0
