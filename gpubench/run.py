"""Run one cell of the benchmark and print its result line.

    python3 -m gpubench.run --workload msvd.serve.bank --seed 7 \
        --seconds 30 --trace 0

The cell, its configuration, traffic mix, driver, metrics and limits are
found by name (``harness``). The run needs the cards the cell asks for and
never falls back to the CPU. Its last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``compared`` last: each number the
check compared beside its limit); the same numbers end standard error.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from . import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Context:
    """What a driver gets: the cell, its files' contents, the run's
    arguments and the process's start time; ``device`` is the card, or the
    CPU in the tests that drive a run without one."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", start: float = PROCESS_START,
                 here=harness.HERE):
        self.cell = cell
        self.config = harness.config(cell["config"], here)
        self.traffic = harness.traffic(cell["traffic"], here)
        self.limits = harness.limits(cell["name"], here)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.start, self.here = device, start, here
        self.phases = harness.Phases(start)

    def readings(self) -> harness.Readings:
        return harness.Readings(cell=self.cell, config=self.config,
                                traffic=self.traffic,
                                chips=self.cell["chips"])


def measure(ctx: Context, bench: dict):
    """Drive the cell and read its metrics: (readings, metrics, correct)."""
    driver = harness.load_module("drivers", ctx.traffic["driver"], ctx.here)
    r = driver.run(ctx)
    section = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in harness.metrics_of(bench, ctx.cell["name"], section):
        value = harness.load_module("metrics", m["name"], ctx.here).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = bool(r.compared) and all(
        c["value"] <= c["limit"] for c in r.compared.values())
    return r, metrics, correct


def main(argv=None) -> int:
    args = parse(argv)
    harness.run_environment()
    import torch
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace))
    ctx.phases.mark("python, torch")
    if not torch.cuda.is_available():
        harness.say("no CUDA device: the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        harness.say(f"{args.workload} needs {cell['chips']} cards; "
                    f"{torch.cuda.device_count()} visible")
        return 2
    ctx.phases.mark("CUDA init")
    r, metrics, correct = measure(ctx, bench)
    bad = harness.forbidden_loaded()
    if bad:
        harness.say(f"modules of JAX or the JAX package loaded: {bad}")
        return 3
    line = harness.result_line(correct, r, metrics,
                               harness.device_info(cell["chips"]),
                               bool(args.trace))
    for name, c in r.compared.items():
        harness.say(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
