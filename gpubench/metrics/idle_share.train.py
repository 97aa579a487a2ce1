"""Share of the traced window in which no kernel or copy ran on the card,
training cells: the reader of ``idle_share.serve``."""

from gpubench import harness

read = harness.load_module("metrics", "idle_share.serve").read
