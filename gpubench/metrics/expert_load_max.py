"""``expert_load_max``: the busiest routed expert's rows over the mean of
its layer's, in the MoE layer where that ratio is largest, over the
traced window (prefill and decode steps together; the program's expert
counter).  1 is an even load; the grouped products wait on the busiest
expert of each call."""


def read(r):
    if r.trace is None or "expert_rows" not in r.trace.counts:
        return None
    phases = r.trace.counts["expert_rows"]
    worst = None
    for layer in zip(*phases):
        rows = [sum(e) for e in zip(*layer)]
        if sum(rows):
            ratio = max(rows) * len(rows) / sum(rows)
            worst = ratio if worst is None else max(worst, ratio)
    return worst
