"""Batched greedy decoding (counterpart of stvd/decode/greedy.py)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..data.text import EOS_ID
from ..model import step as step_mod
from ..model.decoder import StepFn, encode_context
from ..model.step import (StepState, init_state, logit_activation,
                          logits_from_states, precompute)
from ..utils.profiling import span, spanned


class GreedyOut(NamedTuple):
    tokens: torch.Tensor    # (B, maxlen) int64, EOS-terminated, 0-padded
    scores: torch.Tensor    # (B,) total log-prob of the emitted sequence
    lengths: torch.Tensor   # (B,) emitted tokens incl. EOS
    alphas: Optional[torch.Tensor] = None  # (B, maxlen, K) temporal attention


@spanned("stvd.decode")
def greedy_decode(params, cfg, batch: Dict[str, torch.Tensor],
                  maxlen: int = 30, step_fn: Optional[StepFn] = None,
                  return_alphas: bool = False) -> GreedyOut:
    """Greedy argmax decode of a batch (frames (B,K,D), frame_mask (B,K)
    [, regions (B,K,R,Dr)]) with an early exit once every sequence has
    emitted EOS.  ``return_alphas`` also records each step's temporal
    attention weights (zeros past the exit)."""
    step_fn = step_fn or step_mod.step
    params = step_mod.cast_params(params, cfg)
    frames = batch["frames"]
    dev = frames.device
    B = frames.shape[0]
    mk_tail = getattr(step_fn, "make_logit_tail", None)
    tail = (mk_tail(params["ff_logit_W"], params["ff_logit_b"], 1)
            if mk_tail is not None else None)
    ctx = encode_context(params, cfg, frames, batch.get("motion"))
    sc = precompute(params, cfg, ctx, batch["frame_mask"],
                    batch.get("regions"))
    state = init_state(params, cfg, sc)

    prev = torch.zeros((B,), dtype=torch.int64, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    score = torch.zeros((B,), dtype=torch.float32, device=dev)
    length = torch.zeros((B,), dtype=torch.int64, device=dev)
    buf = torch.zeros((B, maxlen), dtype=torch.int64, device=dev)
    abuf = (torch.zeros((B, maxlen, batch["frame_mask"].shape[1]),
                        dtype=torch.float32, device=dev)
            if return_alphas else None)
    for t in range(maxlen):
        with span("stvd.decode.step"):
            if t == 0:
                emb_t = torch.zeros((B, cfg.dim_word),
                                    dtype=params["Wemb"].dtype, device=dev)
            else:
                emb_t = params["Wemb"][prev]
            out = step_fn(params, cfg, state, sc, emb_t)
            if tail is not None:
                act = logit_activation(params, cfg, out.h, out.ctx_t, emb_t)
                vals, idx, lse = tail(act)
                nxt = idx[:, 0]
                tok_logp = vals[:, 0] - lse
            else:
                logits = logits_from_states(params, cfg, out.h, out.ctx_t,
                                            emb_t)
                logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
                nxt = torch.argmax(logp, dim=-1)       # first max on ties
                tok_logp = torch.gather(logp, 1, nxt[:, None])[:, 0]
        with span("stvd.decode.select"):
            alive = ~finished
            score = score + torch.where(alive, tok_logp, 0.0)
            length = length + alive.long()
            emit = torch.where(alive, nxt, EOS_ID)
            finished = finished | (nxt == EOS_ID)
            buf[:, t] = emit
            if abuf is not None:
                abuf[:, t] = out.alpha.to(torch.float32)
            state = StepState(out.h, out.c)
            prev = emit
        # early exit: one host sync per step reads the finished flags;
        # an exported graph runs all maxlen steps (a finished row only
        # extends with EOS at no cost, so its result is the same)
        if not torch.compiler.is_exporting():
            with span("stvd.decode.sync"):
                done = bool(finished.all())
            if done:
                break
    return GreedyOut(tokens=buf, scores=score, lengths=length, alphas=abuf)
