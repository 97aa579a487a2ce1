"""The readers of the program's spans (``gpubench/spans.py`` and the ten
metrics on it) on hand-made traces with known spans and runtime calls,
None where a trace holds no span; and a traced run of each tiny cell on
the CPU, whose program records the spans, reads every one of them."""

from __future__ import annotations

import pytest

from conftest import measure
from gpubench import harness

SERVE = ["decode_sync_ms_per_step", "decode_host_ms_per_step",
         "kernel_host_ms_per_step", "request_host_ms.p50",
         "host_syncs.serve"]
TRAIN = ["feed_ms.train", "forward_ms.train", "backward_ms.train",
         "optimizer_ms.train", "host_syncs.train"]


def readings(host, start=0.0, end=10_000.0):
    trace = harness.Trace(start, end, kernels=[], host=list(host))
    return harness.Readings(cell={}, config={}, traffic={}, trace=trace)


# Two requests: A with two decode steps, B (a caption holding its
# caption_batch: nested requests) with one; a step cut by the window's
# end; runtime calls inside and outside the requests.
SERVING = [
    ("stvd.request", 100, 1100), ("stvd.request.rows", 100, 110),
    ("cudaStreamSynchronize_v3020", 105, 108),
    ("stvd.decode", 200, 1000),
    ("stvd.decode.step", 210, 400), ("stvd.kernel.attention_core", 220, 240),
    ("stvd.kernel.logit_tail", 300, 310), ("cudaLaunchKernel", 301, 305),
    ("stvd.decode.select", 400, 450),
    ("stvd.decode.sync", 450, 500), ("cudaStreamSynchronize", 455, 495),
    ("stvd.decode.step", 500, 700), ("stvd.kernel.logit_tail", 520, 540),
    ("stvd.decode.select", 700, 760),
    ("stvd.decode.sync", 760, 990), ("cudaStreamSynchronize", 765, 985),
    ("cudaMemcpyAsync", 1005, 1008), ("stvd.request.copy", 1004, 1022),
    ("cudaStreamSynchronize", 1010, 1020),
    ("stvd.kernel.logit_tail", 1050, 1060),
    ("stvd.request", 2000, 2500), ("stvd.request", 2100, 2400),
    ("stvd.decode", 2150, 2350), ("stvd.decode.step", 2160, 2300),
    ("stvd.decode.select", 2300, 2320), ("stvd.decode.sync", 2320, 2340),
    ("cudaEventSynchronize", 2325, 2335),
    ("cudaDeviceSynchronize", 5000, 5010),
    ("stvd.decode.step", 9990, 10_010),
]

# Three updates, each a feed and a step; the third runs two forward
# ranges (microbatches); one blocking call outside both.
TRAINING = [
    ("stvd.train.feed", 0, 100), ("cudaStreamSynchronize", 10, 20),
    ("cudaStreamSynchronize", 40, 50), ("cudaStreamSynchronize", 70, 80),
    ("stvd.train.step", 110, 1110), ("stvd.train.forward", 120, 420),
    ("stvd.train.backward", 430, 930), ("cudaStreamSynchronize", 500, 510),
    ("stvd.train.optimizer", 940, 1100),
    ("cudaStreamSynchronize", 1500, 1510),
    ("stvd.train.feed", 2000, 2050), ("cudaStreamSynchronize", 2010, 2020),
    ("cudaStreamSynchronize", 2022, 2030), ("cudaMemcpy", 2031, 2040),
    ("stvd.train.step", 2060, 2860), ("stvd.train.forward", 2070, 2270),
    ("stvd.train.backward", 2280, 2680),
    ("stvd.train.optimizer", 2690, 2850),
    ("stvd.train.feed", 3000, 3200), ("cudaStreamSynchronize", 3010, 3020),
    ("cudaStreamSynchronize", 3030, 3040),
    ("cudaStreamSynchronize", 3050, 3060),
    ("stvd.train.step", 3210, 3810), ("stvd.train.forward", 3220, 3420),
    ("stvd.train.forward", 3430, 3530),
    ("stvd.train.backward", 3540, 3740),
    ("stvd.train.optimizer", 3750, 3800),
]


@pytest.mark.parametrize("name,host,want", [
    # syncs 50 + 230 + 20 us over 3 steps
    ("decode_sync_ms_per_step", SERVING, 0.300 / 3),
    # steps 190 + 200 + 140, selects 50 + 60 + 20
    ("decode_host_ms_per_step", SERVING, 0.660 / 3),
    # wrappers inside steps 20 + 10 + 20 (not the one outside)
    ("kernel_host_ms_per_step", SERVING, 0.050 / 3),
    # A 1000 - 800, B 500 - 200: the median of 0.2 and 0.3 ms
    ("request_host_ms.p50", SERVING, 0.25),
    # A 4 (a versioned entry among them), B 1
    ("host_syncs.serve", SERVING, 2.5),
    ("feed_ms.train", TRAINING, 0.1),                 # 100, 50, 200 us
    ("forward_ms.train", TRAINING, 0.3),              # 300, 200, 300
    ("backward_ms.train", TRAINING, 0.4),             # 500, 400, 200
    ("optimizer_ms.train", TRAINING, 0.16),           # 160, 160, 50
    ("host_syncs.train", TRAINING, 10 / 3),           # 3 + 1, 3, 3
])
def test_reader_on_known_spans(name, host, want):
    read = harness.load_module("metrics", name).read
    assert read(readings(host)) == pytest.approx(want)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_without_spans_reads_none(name):
    """No trace, or a trace of a program without the spans (only the
    benchmark's own and the runtime's), reads None."""
    read = harness.load_module("metrics", name).read
    assert read(harness.Readings(cell={}, config={}, traffic={})) is None
    bare = [(n, s, e) for n, s, e in SERVING + TRAINING
            if not n.startswith("stvd.")] + [("bench.request", 0, 9000)]
    assert read(readings(bare)) is None


def test_reader_leaves_out_ranges_past_the_window():
    """The window clips: a step that ends past it is not a step."""
    read = harness.load_module("metrics", "decode_host_ms_per_step").read
    assert read(readings(SERVING, end=9995.0)) == pytest.approx(0.660 / 3)
    assert read(readings(SERVING, start=2100.0)) == pytest.approx(0.160)


@pytest.mark.parametrize("cell,names", [
    ("msvd.serve.bank", SERVE), ("msrvtt.serve.bank", SERVE),
    ("msvd.train", TRAIN)])
def test_traced_cpu_run_reads_every_span_metric(tiny, cell, names):
    """A traced tiny run on the CPU (the plain step: no kernel wrapper
    and no CUDA runtime call) reads each of the cell's span metrics."""
    r, metrics, correct = measure(tiny, cell, trace=True)
    assert correct
    for name in names:
        assert name in metrics, name
        assert metrics[name]["value"] >= 0.0
    if cell == "msvd.train":
        assert metrics["forward_ms.train"]["value"] > 0
        assert metrics["host_syncs.train"]["value"] == 0
    else:
        assert metrics["decode_host_ms_per_step"]["value"] > 0
        assert metrics["host_syncs.serve"]["value"] == 0
