"""The benchmark's files: every cell's configuration, mix, driver, limits
and metric files are found by name; an added configuration, mix and
metric are picked up with no edit to a file that exists; BENCHMARK.json
keeps the contract's shape."""

from __future__ import annotations

import copy
import json
import re

import pytest

from conftest import measure
from gpubench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = harness.cell(BENCH, cell)
    cfg = harness.config(w["config"])
    mix = harness.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    assert harness.load_module("drivers", mix["driver"]).run
    assert set(harness.limits(cell))
    for section in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(BENCH, cell, section):
            assert harness.load_module("metrics", m["name"]).read


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and 0 < len(c["why"]) <= 200
        assert 0 < len(c["source"]) <= 200
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        for cell in m.get("workloads", []):
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])
    for w in BENCH["workloads"]:
        e = harness.metrics_of(BENCH, w["name"], "end_to_end")
        assert "setup_s" in [m["name"] for m in e] and len(e) >= 2
        assert harness.metrics_of(BENCH, w["name"], "per_layer")
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_added_config_mix_and_metric_need_no_edit(tiny):
    """A new configuration, traffic mix, metric and cell are new files and
    new entries: the harness finds them by name."""
    cfg = json.loads((tiny / "configs" / "msvd.json").read_text())
    cfg["name"] = "msvd_small_vocab"
    cfg["model"]["n_words"] = 30
    (tiny / "configs" / "msvd_small_vocab.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny / "traffic" / "serve_bank.json").read_text())
    mix["request_videos"] = 3
    (tiny / "traffic" / "serve_bank_small.json").write_text(json.dumps(mix))
    (tiny / "metrics" / "requests_seen.py").write_text(
        "def read(r):\n    return r.counts.get('requests')\n")
    (tiny / "limits" / "extra.cell.json").write_text(
        (tiny / "limits" / "msvd.serve.bank.json").read_text())
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "msvd_small_vocab", "source": "x",
                             "file": "gpubench/configs/msvd_small_vocab.json",
                             "reduced": ["n_words"], "why": "test"})
    bench["workloads"].append({"name": "extra.cell",
                               "config": "msvd_small_vocab",
                               "traffic": "serve_bank_small", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "requests_seen", "unit": "requests",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["extra.cell"]})
    r, metrics, correct = measure(tiny, "extra.cell", bench=bench)
    assert metrics["requests_seen"]["value"] == r.counts["requests"] > 0
    assert correct
    assert "captions_per_s" not in metrics   # listed for the other cells
