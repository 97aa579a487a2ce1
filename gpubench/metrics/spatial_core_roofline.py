"""Kernel 4 (the spatial-attention core of the decode step): the least
time its call could take over its device time a call, in the traced
window. Bytes and operations frozen from chip_smoke.py's phase_spatial:
in h_satt (f32), pregion (f32), regions (compute dtype), u_s (f32); out
spat (compute dtype) and alpha_s (f32); per (row, frame, region) a
tanh-score over s and a weighted sum over Dr, at the float32 peak."""

import re

from gpubench import harness

KERNEL = re.compile(r"\bspatial_core_(tma|kernel)\b")


def bound_s(m: dict, d: dict) -> float:
    bc, nb = d["decode_batch"], d["beam_size"]
    k, r = m["n_frames"], m["n_regions"]
    s = dr = m["region_dim"]
    cd = 2 if m["compute_dtype"] == "bfloat16" else 4
    bs = bc * nb
    n_bytes = (4 * bs * s + 4 * bc * k * r * s + cd * bc * k * r * dr
               + 4 * s + bs * k * (cd * dr + 4 * r))
    return harness.bound_s(n_bytes, bs * k * r * (4 * s + 2 * dr), "f32")


def read(r):
    if r.trace is None or not r.config["model"].get("use_spatial"):
        return None
    match = lambda n: bool(KERNEL.search(n))
    calls = r.trace.calls(match)
    if not calls:
        return None
    per_call = r.trace.device_s(match) / calls
    return 100.0 * bound_s(r.config["model"], r.config["decode"]) / per_call
