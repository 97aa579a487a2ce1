"""Device milliseconds a decode step spends in library GEMM kernels
(cuBLAS / CUTLASS names in the trace; the port's own kernels excluded)."""

import re

LIBRARY = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas", re.I)
OWN = re.compile(r"attn_core|spatial_core|gates_|tail_|spatial_bwd|dws_|"
                 r"reduce_[kb]_kernel|reduce_splits|tanh_kernel")


def is_library_gemm(name: str) -> bool:
    return bool(LIBRARY.search(name)) and not OWN.search(name)


def read(r):
    if r.trace is None or not r.trace.counts.get("steps"):
        return None
    s = r.trace.device_s(is_library_gemm)
    return s * 1e3 / r.trace.counts["steps"] if s else None
