"""Fixtures of the benchmark's tests: a copy of the benchmark's files at a
tiny size, run on the CPU, and the marker of the tests that need a card
(run there with ``python -m pytest -p no:cacheprovider -q gpubench/tests``;
on the CPU they skip, decided inside the ``card`` fixture)."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest

from gpubench import harness, run

TINY_MODEL = dict(n_words=40, dim_word=12, dim=16, ctx_dim=16, n_frames=5,
                  region_dim=8, n_regions=3, motion_dim=12,
                  compute_dtype="float32")
TINY_DECODE = dict(decode_batch=4, beam_size=3, maxlen=30)
TINY_DATA = dict(train_videos=20, test_videos=10, frames=[3, 7])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def shrink(here: Path, model=None) -> None:
    """The benchmark's configurations and mixes at a size the CPU runs in
    seconds, float32, in the copy ``here``."""
    for path in (here / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["model"].update(TINY_MODEL, **(model or {}))
        c["decode"].update(TINY_DECODE)
        c["dataset"].update(TINY_DATA)
        path.write_text(json.dumps(c))
    for path in (here / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if t["driver"] == "serve_bank":
            t.update(request_videos=6, check_videos=5, warmup_requests=1,
                     trace_seconds=0.3)
        else:
            t["train"].update(batch_size=8)
            t.update(captions_per_video=100, check_block=4,
                     trace_seconds=0.3)
        path.write_text(json.dumps(t))


@pytest.fixture
def tiny(tmp_path) -> Path:
    """A copy of the benchmark's data files (configurations, mixes,
    limits) with every configuration tiny; drivers and metrics are found
    in the benchmark's own folder."""
    here = tmp_path / "gb"
    for kind in ("configs", "traffic", "limits"):
        shutil.copytree(harness.HERE / kind, here / kind)
    (here / "metrics").mkdir()
    shrink(here)
    return here


def measure(here: Path, cell: str, seed: int = 2**31 + 77,
            seconds: float = 0.6, trace: bool = False, bench=None):
    """One run of ``cell`` on the CPU from the files in ``here``."""
    bench = bench or harness.benchmark()
    ctx = run.Context(harness.cell(bench, cell), seed, seconds, trace,
                      device="cpu", start=time.perf_counter(), here=here)
    return run.measure(ctx, bench)
