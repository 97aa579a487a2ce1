"""Batched stochastic sampling (counterpart of stvd/decode/sample.py).

``n_samples`` captions per video are drawn by ancestral sampling, the
whole batch at once, with an early exit once every sample has emitted
EOS.  Draws come from a ``torch.Generator`` on the decode device (the
JAX package folds the step into a key, so the two packages draw
different samples from the same distribution).

  * ``temperature`` divides the logits before the draw; ``0`` is greedy
    argmax.
  * ``top_k`` draws among the k most likely words.  Greedy and top-k at
    k <= 8 take the step function's fused logit tail (kernel 2) when it
    has one, so the (rows, V) logits never reach memory; larger k and
    full-vocabulary sampling take the materialized logits.

Scores are log-probs under the untempered model, so they compare with
greedy and beam scores.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..data.text import EOS_ID
from ..model import step as step_mod
from ..model.decoder import StepFn, encode_context
from ..model.step import (StepState, init_state, logit_activation,
                          logits_from_states, precompute, topk_rows)


class SampleOut(NamedTuple):
    tokens: torch.Tensor    # (B, n_samples, maxlen) int64, EOS-terminated
    scores: torch.Tensor    # (B, n_samples) total log-prob under the model
    lengths: torch.Tensor   # (B, n_samples) emitted tokens incl. EOS


def _draw(weights: torch.Tensor, generator: torch.Generator
          ) -> torch.Tensor:
    """One column index per row, drawn in proportion to ``weights``."""
    return torch.multinomial(weights, 1, generator=generator)[:, 0]


def sample_decode(params, cfg, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  maxlen: int = 30, temperature: float = 1.0,
                  top_k: int = 0, n_samples: int = 1,
                  step_fn: Optional[StepFn] = None) -> SampleOut:
    """Draw ``n_samples`` captions per video (frames (B,K,D), frame_mask
    (B,K) [, regions]).  The samples of a video ride the beam-broadcast
    rows: state rows are (B * n,) against context rows (B,), so the
    context is not copied.  ``generator`` must live on the batch's device
    (``None``: the device's default generator)."""
    if temperature < 0.0:
        raise ValueError("temperature must be >= 0")
    step_fn = step_fn or step_mod.step
    params = step_mod.cast_params(params, cfg)
    frames = batch["frames"]
    dev = frames.device
    B = frames.shape[0]
    n = n_samples
    greedy = temperature == 0.0
    use_topk = 0 < top_k < cfg.n_words
    ki = 1 if greedy else (top_k if use_topk else 0)
    inv_t = 0.0 if greedy else 1.0 / temperature

    mk_tail = getattr(step_fn, "make_logit_tail", None)
    tail = (mk_tail(params["ff_logit_W"], params["ff_logit_b"], ki)
            if mk_tail is not None and ki > 0 else None)

    ctx = encode_context(params, cfg, frames, batch.get("motion"))
    sc = precompute(params, cfg, ctx, batch["frame_mask"],
                    batch.get("regions"))
    state0 = init_state(params, cfg, sc)
    state = StepState(state0.h.repeat_interleave(n, dim=0),
                      state0.c.repeat_interleave(n, dim=0))
    rows = B * n

    prev = torch.zeros((rows,), dtype=torch.int64, device=dev)
    finished = torch.zeros((rows,), dtype=torch.bool, device=dev)
    score = torch.zeros((rows,), dtype=torch.float32, device=dev)
    length = torch.zeros((rows,), dtype=torch.int64, device=dev)
    buf = torch.zeros((rows, maxlen), dtype=torch.int64, device=dev)
    for t in range(maxlen):
        if t == 0:
            emb_t = torch.zeros((rows, cfg.dim_word),
                                dtype=params["Wemb"].dtype, device=dev)
        else:
            emb_t = params["Wemb"][prev]
        out = step_fn(params, cfg, state, sc, emb_t)
        if tail is not None:
            act = logit_activation(params, cfg, out.h, out.ctx_t, emb_t)
            vals, idx, lse = tail(act)          # exact top-ki
            if greedy:
                pick = torch.zeros((rows,), dtype=torch.int64, device=dev)
            else:
                pick = _draw(torch.softmax(vals * inv_t, dim=-1), generator)
            nxt = torch.gather(idx, 1, pick[:, None])[:, 0]
            tok_logp = torch.gather(vals, 1, pick[:, None])[:, 0] - lse
        else:
            logits = logits_from_states(params, cfg, out.h, out.ctx_t,
                                        emb_t).to(torch.float32)
            logp = torch.log_softmax(logits, dim=-1)
            if greedy:
                nxt = torch.argmax(logp, dim=-1)       # first max on ties
            else:
                samp = logits * inv_t
                if use_topk:
                    kth = topk_rows(samp, top_k)[0][:, -1:]
                    samp = samp.masked_fill(samp < kth, -torch.inf)
                nxt = _draw(torch.softmax(samp, dim=-1), generator)
            tok_logp = torch.gather(logp, 1, nxt[:, None])[:, 0]
        alive = ~finished
        score = score + torch.where(alive, tok_logp, 0.0)
        length = length + alive.long()
        emit = torch.where(alive, nxt, EOS_ID)
        finished = finished | (nxt == EOS_ID)
        buf[:, t] = emit
        state = StepState(out.h, out.c)
        prev = emit
        # early exit: one host sync per step reads the finished flags
        if bool(finished.all()):
            break
    return SampleOut(tokens=buf.reshape(B, n, maxlen),
                     scores=score.reshape(B, n),
                     lengths=length.reshape(B, n))
