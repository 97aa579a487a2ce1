"""Kernel 2 (the fused logit tail of the decode step: vocabulary product,
top-k and log-sum-exp): the least time its call could take over its
device time a call (its tile pass and its merge), in the traced window.
Bytes and operations frozen from chip_smoke.py's phase_tail: in x (rows x
dim_word, bf16), W (dim_word x V, bf16), b (V, f32); out k values, k
int64 ids and the lse a row; 2 rows dim_word V operations at the bf16
peak."""

import re

from gpubench import harness

PASS = re.compile(r"\btail_(wgmma|tile)_kernel\b")
ANY = re.compile(r"\btail_(wgmma|tile|merge)_kernel\b")


def bound_s(m: dict, d: dict) -> float:
    rows = d["decode_batch"] * d["beam_size"]
    dw, v, k = m["dim_word"], m["n_words"], min(d["beam_size"], m["n_words"])
    n_bytes = 2 * rows * dw + 2 * dw * v + 4 * v + rows * (k * 12 + 4)
    return harness.bound_s(n_bytes, 2 * rows * dw * v, "bf16")


def read(r):
    if r.trace is None:
        return None
    calls = r.trace.calls(lambda n: bool(PASS.search(n)))
    if not calls:
        return None
    per_call = r.trace.device_s(lambda n: bool(ANY.search(n))) / calls
    return 100.0 * bound_s(r.config["model"], r.config["decode"]) / per_call
