"""On the card: each one-card cell runs a short window end to end, with
``correct`` true, every end-to-end metric in the plain run and every
per-layer metric in the traced one."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from gpubench import harness

BENCH = harness.benchmark()
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


def _run(cell: str, seed: int, trace: int) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", cell,
         "--seed", str(seed), "--seconds", "4", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_on_the_card(card, cell):
    line = _run(cell, 2**31 + 4242, 0)
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu"
    want = {m["name"] for m in harness.metrics_of(BENCH, cell, "end_to_end")}
    assert set(line["metrics"]) == want
    line = _run(cell, 2**31 + 4243, 1)
    assert line["correct"], line["compared"]
    want = {m["name"] for m in harness.metrics_of(BENCH, cell, "per_layer")}
    assert set(line["metrics"]) == want
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for m in line["metrics"]:
        if m.endswith("_roofline") or "mfu" in m:
            assert 0 < line["metrics"][m]["value"] <= 100
