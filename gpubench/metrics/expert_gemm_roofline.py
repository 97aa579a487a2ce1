"""``expert_gemm_roofline``: the least time the routed experts' grouped
products of the traced window could take, over their device time (the
grouped GEMM kernels and the kernels that prepare their problem lists).

The program's expert counter gives, by phase (prefill, decode step) and
MoE layer, the rows routed and the experts the calls touched.  A call
reads its rows (hidden wide), the gate and up weights of each touched
expert (2 x moe_intermediate x hidden) and writes 2 x moe_intermediate a
row; then reads those rows' SwiGLU (moe_intermediate wide), each touched
expert's down weight and writes hidden a row; bf16.  Operations: 2 rows
x 3 x hidden x moe_intermediate.  The calls of one phase and layer route
as many rows each, so their bound is taken on their sums (no more than
the sum of each call's own bound)."""

import re

from gpubench import harness

KERNELS = re.compile(r"GroupProblemShape|prepare_grouped_gemm_data")


def bound_s(c: dict, rows: float, touched: float) -> float:
    h, i = c["hidden_size"], c["moe_intermediate_size"]
    n_bytes = 2 * (rows * (h + 2 * i) + touched * 2 * i * h
                   + rows * (i + h) + touched * i * h)
    return harness.bound_s(n_bytes, 2 * rows * 3 * h * i, "bf16")


def read(r):
    if r.trace is None or "expert_rows" not in r.trace.counts:
        return None
    spent = r.trace.device_s(lambda n: bool(KERNELS.search(n)))
    if not spent:
        return None
    least = sum(bound_s(r.config, sum(rows), touched)
                for phase, touched_by_layer in zip(
                    r.trace.counts["expert_rows"],
                    r.trace.counts["expert_touched"])
                for rows, touched in zip(phase, touched_by_layer))
    return 100.0 * least / spent
