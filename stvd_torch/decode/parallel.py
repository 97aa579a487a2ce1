"""Tensor-parallel decode over a 2-D data x model mesh (counterpart of
stvd/decode/parallel.py).

The weights are placed per ``train.parallel.TP_RULES`` (row-sharded gates
and projection weights, the vocab product column-sharded), the batch
is split over the data axis and replicated over the model axis, so the
whole beam state is replicated on the ranks of a model group and the
decode loop runs unchanged on each; the products run row- or
vocab-parallel inside ``tp.model_axis`` (``model.tp``).

The fused logit tail (kernel 2: vocab product, logsumexp and exact top-k)
runs per vocab shard, as the JAX package's ``shard_map`` island: each
rank runs it on its ``(dw, V / M)`` column slice of ``ff_logit_W`` with
its slice of the bias, the ids are offset to the global vocab, and one
``all_gather`` brings every shard's (vals, ids, lse) to every rank, which
merges them itself: a top-k of the union (each row's global top-k is in
the union of its per-shard top-k; shards concatenate in rank order and
each lists equal values lowest id first, so ties go to the lowest global
id, as ``lax.top_k``'s) and ``lse = m + log sum_s exp(lse_s - m)`` in
shard order.  Every rank of a model group so derives the same bits, the
same beams and the same early exit.

Kernels 1 and 4 (attention and spatial cores) run whole on every rank
over the replicated activations; kernel 3 (gates + LSTM) is refused under
a model axis (``tp.check_options``), as the JAX package's TP decode runs
its plain step; so does an int8 decode (``step._int8_gates_sharded``:
the whole stack's scales, the int32 partial sums reduced as int32).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..model import step as step_mod
from ..model import tp
from ..train import parallel as tparallel
from .beam import BeamOut, beam_decode


def shard_decode_params(params: Dict[str, torch.Tensor], mesh
                        ) -> Dict[str, torch.Tensor]:
    """This rank's share of a full parameter dict per ``TP_RULES`` (the
    training rules: ``train.parallel.shard_state`` keys off the names)."""
    return tparallel.shard_state(params, mesh)


def merge_shards(parts: torch.Tensor, k_sel: int):
    """The exact cross-shard merge of the tail: ``parts`` (rows, M, 2k+1)
    float64 holds each shard's (vals, global ids, lse) in rank order;
    returns (vals (rows, k) float32, ids (rows, k) int64, lse (rows,))."""
    rows, m, _ = parts.shape
    vals = parts[..., :k_sel].reshape(rows, m * k_sel).float()
    ids = parts[..., k_sel:2 * k_sel].reshape(rows, m * k_sel).long()
    lse_s = parts[..., 2 * k_sel].float()
    v2, pos = step_mod.topk_rows(vals, k_sel)
    mx = lse_s.amax(dim=1, keepdim=True)
    lse = mx[:, 0] + torch.log(torch.exp(lse_s - mx).sum(dim=1))
    return v2, torch.gather(ids, 1, pos), lse


def _tp_tail_factory(mesh):
    """A ``make_logit_tail``-compatible factory whose tails run kernel 2
    on this rank's vocab slice and merge exactly over the model axis
    (``merge_shards``, from one ``all_gather``).  Its ``mk(w, b, k_sel)``
    takes the rank's (dw, V / M) slice of ``ff_logit_W`` and (V / M,)
    of ``ff_logit_b`` and is called inside ``tp.model_axis``, which gives
    the full vocab V.  It returns ``None`` (the caller takes the gathered
    logits) when the model axis does not divide V, where ``TP_RULES``
    replicates ``ff_logit_W``, when a shard holds fewer than ``k_sel``
    words, or when ``k_sel > 8``, which the kernel does not take (as
    ``kernel.make_logit_tail``)."""
    from ..model import kernel as kmod

    m = tparallel.model_axis_size(mesh)

    def mk(w, b, k_sel: int):
        axis = tp.current()
        if axis is None or axis.n_words % m or w.shape[1] == axis.n_words:
            return None
        vloc = w.shape[1]
        if vloc < k_sel or k_sel > 8:
            return None
        b32 = b.to(torch.float32)
        base = axis.rank * vloc

        def tail(act):
            vals, idx, lse = kmod.logit_tail(act, w, b32, k_sel)
            mine = torch.cat([vals.double(), (idx + base).double(),
                              lse.double()[:, None]], dim=1)
            parts = tp.gather(mine[:, None, :], axis, 1)
            return merge_shards(parts, k_sel)

        return tail

    return mk


def make_tp_step(mesh, step_fn=None):
    """The decode step under the model axis (``step_fn``, default the
    plain step; ``kernel.step_kernels`` runs kernels 1 and 4 on every
    rank) carrying the per-shard kernel-2 tail as its
    ``make_logit_tail``, which the decode loops pick up
    (``beam.beam_decode``, ``greedy.greedy_decode``).  The loops also
    project the context and the logits outside the step, so they run
    inside ``tp.model_axis(mesh, cfg)``; ``make_tp_beam_decode`` and
    ``train.evaluate.generate_captions`` do that."""
    inner = step_fn or step_mod.step

    def tp_step(params, cfg, state, sc, emb_t, x_pre=None):
        return inner(params, cfg, state, sc, emb_t, x_pre)

    tp_step.make_logit_tail = _tp_tail_factory(mesh)
    return tp_step


def _use_island(tail: str, device: torch.device) -> bool:
    if tail not in ("auto", "tp", "off"):
        raise ValueError(f"unknown tail {tail!r}")
    return tail == "tp" or (tail == "auto" and device.type == "cuda")


def make_tp_beam_decode(cfg, mesh, beam_size: int = 5, maxlen: int = 30,
                        length_norm: float = 0.6, norm_mode: str = "gnmt",
                        tail: str = "auto", step_fn=None
                        ) -> Callable[[Dict, Dict], BeamOut]:
    """A TP beam decode ``fn(params, batch) -> BeamOut`` that every rank
    of ``mesh`` calls: ``params`` this rank's share
    (``shard_decode_params``), ``batch`` its data slice
    (``train.parallel.shard_batch``; its rows divide the data axis), and
    the result the rows of that slice, the same on every rank of a model
    group.  ``tail``: 'tp' forces the per-shard kernel-2 tail, 'off' the
    gathered logits, 'auto' the tail for CUDA tensors and the gathered
    logits on the CPU (the JAX package's 'auto' takes the island only on
    a TPU).  ``step_fn`` is the step (default: the kernel step for CUDA
    tensors, the plain step on the CPU)."""
    from ..model.kernel import get_step_fn

    def run(params, batch):
        dev = batch["frames"].device
        inner = step_fn or get_step_fn(None, dev)
        step = make_tp_step(mesh, inner)
        if not _use_island(tail, dev):
            step.make_logit_tail = None
        with tp.model_axis(mesh, cfg):
            return beam_decode(params, cfg, batch, beam_size=beam_size,
                               maxlen=maxlen, length_norm=length_norm,
                               norm_mode=norm_mode, step_fn=step)

    return run


def tp_decode_step(mesh, step_fn: Optional[Callable]):
    """The step that ``generate_captions`` and ``fit`` decode with: on a
    mesh with a model axis ``step_fn`` (default the plain step) with the
    per-shard tail when ``step_fn`` carries a fused tail (the kernel
    step), else with the gathered logits; elsewhere ``step_fn`` itself."""
    if not tparallel.has_model_axis(mesh):
        return step_fn
    step = make_tp_step(mesh, step_fn)
    if getattr(step_fn, "make_logit_tail", None) is None:
        step.make_logit_tail = None
    return step
