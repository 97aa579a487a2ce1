"""Numeric-health aids (counterpart of stvd/utils/debug.py).

``enable_nan_debug`` switches on autograd's anomaly detection with its
NaN check, the port's nearest counterpart of ``jax_debug_nans``: a
backward operation that returns a NaN raises, naming the forward
operation that made its input.  ``grad_stats`` and ``report_bad_grads``
give the JAX package's per-parameter gradient statistics under the same
names.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch


def enable_nan_debug(enable: bool = True
                     ) -> torch.autograd.set_detect_anomaly:
    """Switch autograd's anomaly detection (with its NaN check) on or
    off for the whole process, as ``jax_debug_nans`` is switched.  The
    returned object, used as a context manager, restores the mode found
    when it exits."""
    return torch.autograd.set_detect_anomaly(enable, check_nan=True)


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, dict keys in sorted order as JAX
    flattens them; a name joins the keys and indices on its path with
    '/'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def grad_stats(grads: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-parameter gradient statistics, on the gradients' device: the
    float32 L2 norm (``l2``), the largest absolute entry (``absmax``)
    and whether any entry is NaN or infinite (``nan``)."""
    out = {}
    for name, g in _leaves(grads):
        g32 = g.detach().to(torch.float32)
        out[name] = {"l2": torch.sqrt(torch.sum(g32 * g32)),
                     "absmax": torch.max(torch.abs(g32)),
                     "nan": torch.isnan(g32).any() | torch.isinf(g32).any()}
    return out


def report_bad_grads(grads: Any) -> None:
    """Print a line for every parameter with a non-finite gradient entry
    (``[grad-nan] name: l2=... absmax=...``)."""
    bad = {k: v for k, v in grad_stats(grads).items() if bool(v["nan"])}
    for k, v in sorted(bad.items()):
        print(f"[grad-nan] {k}: l2={float(v['l2']):.4g} "
              f"absmax={float(v['absmax']):.4g}")
