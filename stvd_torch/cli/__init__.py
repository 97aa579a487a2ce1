"""The port's command-line entry points (counterparts of stvd/cli/)."""

import torch


def device(name: str) -> torch.device:
    """The ``--device`` of a command: the card by default, and an error
    that says so where there is none (no quiet run on the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")
    return dev
