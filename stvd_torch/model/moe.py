"""Sigmoid-routed mixture of experts with shared experts (DeepSeek-V3's
``noaux_tc`` routing, as Kimi-VL-A3B's language model has it).

A token's router scores are sigmoids of float32 logits.  The
``e_score_correction_bias`` is added only to choose its top-k experts;
the chosen experts' unbiased scores are divided by their sum (+1e-20)
and multiplied by ``routed_scaling_factor``.  Every token keeps its k
experts (no capacity, no dropping).  The shared experts are one SwiGLU
every token passes through.

The expert products run grouped over the experts: a token's k (token,
expert) slots are sorted by expert and each expert multiplies its
contiguous rows (``expert_mm``).  The routing keeps every count and
offset on the device (``index_add_``, ``cumsum``, a stable sort; no
``bincount``, ``nonzero`` or host read), so a decode step that holds it
is captured whole as a CUDA graph.  The slots come back to token order
by a permutation (no atomic adds), so a step's result does not depend on
the order the device ran it in.

``ExpertCounter`` counts, on the device, the rows routed to each expert
of each MoE layer and the experts each call touched, by phase (a
prompt's prefill or a decode step), for the benchmark's expert metrics.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned

# ---------------------------------------------------------------------------
# Expert products
# ---------------------------------------------------------------------------

EXPERT_MM_ROUTES = ("grouped", "loop")


def expert_mm_route(x: torch.Tensor) -> str:
    """'grouped' (one ``torch._grouped_mm`` over all experts) on a CUDA
    device, 'loop' (one product an expert, offsets read on the host:
    the plain version) on the CPU."""
    return "grouped" if x.is_cuda else "loop"


def _expert_mm_loop(x, w, offs):
    out = x.new_zeros((x.shape[0], w.shape[1]))
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e].t()
        start = end
    return out


@spanned("stvd.kernel.expert_mm")
def expert_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
              route: Optional[str] = None) -> torch.Tensor:
    """Rows ``x`` (n, K) sorted by expert times each expert's weight ``w``
    (E, N, K), nn.Linear's layout: rows ``offs[e-1]:offs[e]`` (``offs``:
    int32 running ends on x's device) by ``w[e]``, giving (n, N).  The
    private ``route`` forces a route."""
    route = route or expert_mm_route(x)
    if route == "grouped":
        out = torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
    else:
        out = _expert_mm_loop(x, w, offs)
    expert_mm.launches += 1
    expert_mm.launches_by_route[route] += 1
    return out


expert_mm.launches = 0
expert_mm.launches_by_route = dict.fromkeys(EXPERT_MM_ROUTES, 0)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def route(x: torch.Tensor, gate_w: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float, norm: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (n, top_k) float32, experts (n, top_k) int64) of tokens
    ``x`` (n, H): float32 router logits and sigmoid scores, the choice by
    ``scores + bias``, the chosen unbiased scores normalised to sum 1
    (``norm``) and scaled by ``scale``."""
    scores = F.linear(x.float(), gate_w.float()).sigmoid()
    idx = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    w = scores.gather(1, idx)
    if norm and top_k > 1:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * scale, idx


def swiglu(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor
           ) -> torch.Tensor:
    """A SwiGLU in nn.Linear's layout: ``w13`` is [gate; up] (2I, H),
    ``w2`` the down projection (H, I)."""
    gu = F.linear(x, w13)
    i = w2.shape[1]
    return F.linear(F.silu(gu[:, :i]) * gu[:, i:], w2)


class ExpertCounter:
    """Per phase (0 the prefill, 1 the decode steps): ``rows`` (2, L, E)
    routed rows by MoE layer and expert, ``touched`` (2, L) the sum over
    calls of the experts a call gave rows to; int64 on the device,
    added inside captured graphs too."""

    def __init__(self, n_layers: int, n_experts: int, device):
        self.rows = torch.zeros((2, n_layers, n_experts), dtype=torch.int64,
                                device=device)
        self.touched = torch.zeros((2, n_layers), dtype=torch.int64,
                                   device=device)

    def add(self, phase: int, layer: int, counts: torch.Tensor) -> None:
        self.rows[phase, layer].add_(counts)
        self.touched[phase, layer].add_((counts > 0).sum())

    def zero_(self) -> None:
        self.rows.zero_()
        self.touched.zero_()

    def read(self) -> Dict[str, list]:
        """The counts on the host (a device sync)."""
        return {"rows": self.rows.tolist(), "touched": self.touched.tolist()}


def moe(x: torch.Tensor, lw: Dict[str, torch.Tensor], top_k: int,
        scale: float, norm: bool = True,
        counter: Optional[ExpertCounter] = None, phase: int = 0,
        layer: int = 0, x_route: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """The MoE block of tokens ``x`` (n, H): the routed experts' weighted
    sum (float32, then x's dtype) plus the shared experts.  ``lw``: the
    router's ``gate`` (E, H) and ``bias`` (E,), the experts' ``w13`` (E,
    2I, H) and ``w2`` (E, H, I), the shared ``shared_w13`` and
    ``shared_w2``.  The router reads ``x_route`` (the same tokens before
    their rounding to x's dtype) when given, else x."""
    n, h = x.shape
    n_experts = lw["w13"].shape[0]
    w, idx = route(x if x_route is None else x_route, lw["gate"],
                   lw["bias"], top_k, scale, norm)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    if counter is not None:
        counter.add(phase, layer, counts)
    gu = expert_mm(x.index_select(0, order // top_k), lw["w13"], offs)
    i = lw["w2"].shape[2]
    y = expert_mm(F.silu(gu[:, :i]) * gu[:, i:], lw["w2"], offs)
    y = torch.empty_like(y).index_copy_(0, order, y)
    routed = (y.view(n, top_k, h).float() * w[..., None]).sum(dim=1)
    return routed.to(x.dtype) + swiglu(x, lw["shared_w13"], lw["shared_w2"])
