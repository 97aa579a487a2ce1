"""Readings that set a cell's limits: the program's numbers over many seeds
(the lower reading) beside those of the controls and of planted faults
(the upper reading), at the cell's own size, in one process.

    python3 -m gpubench.calibrate --workload msvd.serve.bank \
        --seeds 101-112 --control-seeds 101-103

The cell's driver reads them (``calibrate(ctx, program_seeds,
control_seeds)`` in ``drivers/<driver>.py``, which names its controls and
faults). Each reading is one JSON line; the last line sums them up
(largest program reading, smallest control and fault readings).
"""

from __future__ import annotations

import argparse
import sys

from gpubench import harness
from gpubench.run import Context


def seeds(spec: str):
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def summary(rows):
    """Per side, the largest program reading and the smallest control or
    fault reading of each compared number, and the seeds read."""
    names = [k for k in rows[0] if k.endswith("_gap")]
    out = {}
    for side in sorted({r["side"] for r in rows}):
        sel = [r for r in rows if r["side"] == side]
        pick = max if side == "program" else min
        out[side] = {n: pick(r[n] for r in sel) for n in names}
        out[side]["seeds"] = len(sel)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    harness.run_environment()
    import torch
    if not torch.cuda.is_available():
        harness.say("no CUDA device: calibration runs only on the card")
        return 2
    cell = harness.cell(harness.benchmark(), args.workload)
    ctx = Context(cell, 0, 0.0, False)
    driver = harness.load_module("drivers", ctx.traffic["driver"])
    rows = driver.calibrate(ctx, seeds(args.seeds),
                            seeds(args.control_seeds))
    harness.emit({"workload": args.workload,
                  "device": harness.device_info(cell["chips"]),
                  **summary(rows)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
