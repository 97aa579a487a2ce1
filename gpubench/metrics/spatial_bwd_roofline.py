"""Kernel 5 (the spatial backward step of the hand-derived VJP): the least
time its call could take over its device time a call (the step kernel and
its two reductions), in the traced window. Bytes and operations frozen
from chip_smoke.py's phase_spatial_bwd: in h_satt, pregion, regions,
alpha_s, alpha_prev, dspat, u_s and the d(pregion) accumulator; out the
accumulator, dh_satt, du_s, dss and spat_prev; b K R (9 s + 4 Dr)
operations at the float32 peak."""

import re

from gpubench import harness

STEP = re.compile(r"\bspatial_bwd_kernel\b")
ANY = re.compile(r"\b(spatial_bwd_kernel|reduce_k_kernel|reduce_b_kernel)\b")


def bound_s(m: dict, rows: int) -> float:
    b, k, r = rows, m["n_frames"], m["n_regions"]
    s = dr = m["region_dim"]
    cd = 2 if m["compute_dtype"] == "bfloat16" else 4
    acc = 2 if (cd == 2 and m.get("spatial_wgrad_dtype", "bfloat16")
                == "bfloat16") else 4
    n_bytes = (4 * b * s + b * k * r * (s + dr) * cd
               + 4 * (2 * b * k * r + b * k * dr + s)
               + 2 * b * k * r * s * acc
               + 4 * (b * s + s + b * k * r) + b * k * dr * cd)
    return harness.bound_s(n_bytes, b * k * r * (9 * s + 4 * dr), "f32")


def read(r):
    if r.trace is None or not r.config["model"].get("use_spatial"):
        return None
    calls = r.trace.calls(lambda n: bool(STEP.search(n)))
    if not calls:
        return None
    rows = r.traffic["train"]["batch_size"] // r.chips
    per_call = r.trace.device_s(lambda n: bool(ANY.search(n))) / calls
    return 100.0 * bound_s(r.config["model"], rows) / per_call
