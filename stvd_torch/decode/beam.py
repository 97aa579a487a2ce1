"""Batched beam search (counterpart of stvd/decode/beam.py).

The whole batch x beam state stays on the device; each step is the
decoder step, a two-stage top-k (per beam over the vocab, then a merge
over k*ki candidates), EOS retirement by masks and a reorder of the
recurrent state and token prefixes by parent beam.  Only the default
lowerings of the JAX package are ported: the flat row gather of the
state (``beam_gather='flat'``) and the reordered prefix buffer
(``beam_buf='reorder'``).

Invariant (tested): ``beam_decode(k=1)`` emits exactly the greedy tokens.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..data.text import EOS_ID
from ..model import step as step_mod
from ..model.decoder import StepFn, encode_context
from ..model.step import (StepState, init_state, logit_activation,
                          logits_from_states, precompute, topk_rows)
from ..utils.profiling import span, spanned

_NEG = -1.0e30


class BeamOut(NamedTuple):
    tokens: torch.Tensor       # (B, maxlen) best beam, EOS-terminated
    scores: torch.Tensor       # (B,) raw log-prob of best beam
    norm_scores: torch.Tensor  # (B,) length-normalized score used for selection
    lengths: torch.Tensor      # (B,) tokens incl. EOS of best beam
    all_tokens: torch.Tensor   # (B, k, maxlen)
    all_scores: torch.Tensor   # (B, k) RAW log-probs (not length-normalized)
    all_norm_scores: torch.Tensor  # (B, k) length-normalized: ranking by
    # this column agrees with the best-beam choice


def _length_penalty(lengths: torch.Tensor, alpha: float, mode: str
                    ) -> torch.Tensor:
    """lp(l): 'gnmt' = ((5+l)/6)^alpha; 'linear' = l; 'none' = 1."""
    lf = lengths.to(torch.float32).clamp_min(1.0)
    if mode == "linear":
        return lf
    if mode == "gnmt" and alpha > 0.0:
        return ((5.0 + lf) / 6.0) ** alpha
    return torch.ones_like(lf)


@spanned("stvd.decode")
def beam_decode(params, cfg, batch: Dict[str, torch.Tensor],
                beam_size: int = 5, maxlen: int = 30,
                length_norm: float = 0.6, norm_mode: str = "gnmt",
                step_fn: Optional[StepFn] = None,
                topk_chunks: int = 1) -> BeamOut:
    """Batched beam search (the JAX package's parameters).
    ``topk_chunks`` picks a TPU lowering of the beam's top-k there; the
    port has one top-k, so it is accepted and not read."""
    del topk_chunks
    step_fn = step_fn or step_mod.step
    params = step_mod.cast_params(params, cfg)
    k = beam_size
    frames = batch["frames"]
    dev = frames.device
    B = frames.shape[0]
    ki = min(k, cfg.n_words)

    mk_tail = getattr(step_fn, "make_logit_tail", None)
    tail = (mk_tail(params["ff_logit_W"], params["ff_logit_b"], ki)
            if mk_tail is not None else None)

    ctx = encode_context(params, cfg, frames, batch.get("motion"))
    sc = precompute(params, cfg, ctx, batch["frame_mask"],
                    batch.get("regions"))
    state0 = init_state(params, cfg, sc)
    h = state0.h.repeat_interleave(k, dim=0)
    c = state0.c.repeat_interleave(k, dim=0)

    # beam 0 starts live, beams 1..k-1 dead: at t=0 all beams are equal
    scores = torch.full((B, k), _NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((B, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, k), dtype=torch.int64, device=dev)
    prev = torch.zeros((B, k), dtype=torch.int64, device=dev)
    buf = torch.zeros((B, k, maxlen), dtype=torch.int64, device=dev)
    # a finished beam may only extend with EOS, at zero cost
    eos_vals = torch.full((ki,), _NEG, dtype=torch.float32, device=dev)
    eos_vals[0] = 0.0
    eos_idx = torch.arange(ki, dtype=torch.int64, device=dev)
    eos_idx[0] = EOS_ID
    row_base = torch.arange(B, device=dev)[:, None] * k

    for t in range(maxlen):
        with span("stvd.decode.step"):
            if t == 0:
                emb_t = torch.zeros((B * k, cfg.dim_word),
                                    dtype=params["Wemb"].dtype, device=dev)
            else:
                emb_t = params["Wemb"][prev.reshape(B * k)]
            out = step_fn(params, cfg, StepState(h, c), sc, emb_t)
            if tail is not None:
                # fused path: the (B*k, V) logits never reach memory
                act = logit_activation(params, cfg, out.h, out.ctx_t, emb_t)
                vals, idx, lse = tail(act)
                pb_vals = (vals - lse[:, None]).reshape(B, k, ki)
                pb_idx = idx.reshape(B, k, ki)
            else:
                logits = logits_from_states(params, cfg, out.h, out.ctx_t,
                                            emb_t)
                logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
                pb_vals, pb_idx = topk_rows(logp, ki)
                pb_vals = pb_vals.reshape(B, k, ki)
                pb_idx = pb_idx.reshape(B, k, ki)

        with span("stvd.decode.select"):
            pb_vals = torch.where(finished[..., None], eos_vals, pb_vals)
            pb_idx = torch.where(finished[..., None], eos_idx, pb_idx)
            cand = (scores[..., None] + pb_vals).reshape(B, k * ki)
            scores, merge_idx = topk_rows(cand, k)        # (B, k)
            parent = merge_idx // ki
            word = torch.gather(pb_idx.reshape(B, k * ki), 1, merge_idx)

            par_finished = torch.gather(finished, 1, parent)
            finished = par_finished | (word == EOS_ID)
            lengths = (torch.gather(lengths, 1, parent)
                       + (~par_finished).long())

            rows = (row_base + parent).reshape(B * k)
            h, c = out.h[rows], out.c[rows]
            buf = buf.reshape(B * k, maxlen)[rows].reshape(B, k, maxlen)
            buf[:, :, t] = torch.where(par_finished, EOS_ID, word)
            prev = word
        # early exit: one host sync per step reads the finished flags;
        # an exported graph runs all maxlen steps (a finished row only
        # extends with EOS at no cost, so its result is the same)
        if not torch.compiler.is_exporting():
            with span("stvd.decode.sync"):
                done = bool(finished.all())
            if done:
                break

    with span("stvd.decode.best"):
        lp = _length_penalty(lengths, length_norm, norm_mode)
        norm = scores / lp
        best = torch.argmax(norm, dim=1)                # first max on ties
        bi = best[:, None]
        return BeamOut(
            tokens=torch.gather(buf, 1,
                                bi[..., None].expand(B, 1, maxlen))[:, 0],
            scores=torch.gather(scores, 1, bi)[:, 0],
            norm_scores=torch.gather(norm, 1, bi)[:, 0],
            lengths=torch.gather(lengths, 1, bi)[:, 0],
            all_tokens=buf,
            all_scores=scores,
            all_norm_scores=norm,
        )
