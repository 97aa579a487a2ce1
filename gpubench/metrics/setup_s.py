"""Process start to the window's start: imports, CUDA context, the kernel
library, weights and features made on the card, the warm-up (host
clock)."""


def read(r):
    return r.setup_s or None
