"""Batched beam search (counterpart of stvd/decode/beam.py).

The whole batch x beam state stays on the device; each step is the
decoder step, a two-stage top-k (per beam over the vocab, then a merge
over k*ki candidates), EOS retirement by masks and a reorder of the
recurrent state and token prefixes by parent beam.  Only the default
lowerings of the JAX package are ported: the flat row gather of the
state (``beam_gather='flat'``) and the reordered prefix buffer
(``beam_buf='reorder'``).

Invariant (tested): ``beam_decode(k=1)`` emits exactly the greedy tokens.

Given a graph set (``graphs=``, ``decode/graphs.py``; the ``Captioner``
passes its own on the serving paths), the first chunk of a shape decodes
eagerly and the chain is then captured as CUDA graphs: the prologue as
one graph and each step t (the decoder step, the logit tail and the
select) as one.  Later chunks replay them with the early-exit read
between the steps, and the best beam is chosen eagerly after the last
replay.  The graphs hold the kernels and
library calls the eager loop launches, on the same operands in the same
order, so the tokens and scores are the eager ones bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..data.text import EOS_ID
from ..model import step as step_mod
from ..model.decoder import StepFn, encode_context
from ..model.step import (StepContext, StepState, init_state,
                          logit_activation, logits_from_states, precompute,
                          topk_rows)
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




class _Fixed(NamedTuple):
    """What the prologue makes for every step of a chunk: the model's own
    (``BeamModel.prologue``) and the select's constants."""
    model: object
    eos_vals: torch.Tensor
    eos_idx: torch.Tensor
    row_base: torch.Tensor
    B: int
    k: int
    ki: int
    maxlen: int


class _Beams(NamedTuple):
    """The beam loop's state after a step: the model's row-indexed state
    (a tuple of tensors of B*k rows, reordered by parent beam at each
    select) and the select's."""
    state: tuple
    scores: torch.Tensor
    finished: torch.Tensor
    lengths: torch.Tensor
    prev: torch.Tensor
    buf: torch.Tensor


class BeamModel:
    """What a model gives the beam loop: ``prologue(params, cfg, batch,
    k, maxlen, step_fn) -> (fixed, state, ki)`` (what every step reads,
    the row-indexed state before step 0 and the candidates a beam keeps)
    and ``step(fixed, cfg, step_fn, t, state, prev, B, k, ki) ->
    (vals, idx, state)`` (each beam's ki best log-probabilities and
    their words, (B, k, ki), and the state before the reorder).
    ``prologue_span`` names a span around the prologue, eager or
    replayed (None: no span)."""

    prologue_span: Optional[str] = None

    def prologue(self, params, cfg, batch, k, maxlen, step_fn):
        raise NotImplementedError

    def step(self, fixed, cfg, step_fn, t, state, prev, B, k, ki):
        raise NotImplementedError


def tail_candidates(tail, act: torch.Tensor, B: int, k: int, ki: int):
    """Each beam's ki best log-probabilities and words, (B, k, ki), from
    the fused logit tail (the (B*k, V) logits never reach memory)."""
    vals, idx, lse = tail(act)
    return ((vals - lse[:, None]).reshape(B, k, ki),
            idx.reshape(B, k, ki))


class _LSTMFixed(NamedTuple):
    """The attention LSTM's weights in the compute dtype, its fused logit
    tail (None: the plain logits) and its step context."""
    params: Dict[str, torch.Tensor]
    tail: Optional[Callable]
    sc: StepContext


class _LSTM(BeamModel):
    """The attention LSTM: the context, its precomputed projections and
    the initial (h, c) in the prologue; the decoder step and the logit
    tail a step."""

    def prologue(self, params, cfg, batch, k, maxlen, step_fn):
        params = step_mod.cast_params(params, cfg)
        ki = min(k, cfg.n_words)
        mk_tail = getattr(step_fn, "make_logit_tail", None)
        tail = (mk_tail(params["ff_logit_W"], params["ff_logit_b"], ki)
                if mk_tail is not None else None)

        ctx = encode_context(params, cfg, batch["frames"],
                             batch.get("motion"))
        sc = precompute(params, cfg, ctx, batch["frame_mask"],
                        batch.get("regions"))
        state0 = init_state(params, cfg, sc)
        h = state0.h.repeat_interleave(k, dim=0)
        c = state0.c.repeat_interleave(k, dim=0)
        return _LSTMFixed(params, tail, sc), (h, c), ki

    def step(self, fixed, cfg, step_fn, t, state, prev, B, k, ki):
        params = fixed.params
        h, c = state
        if t == 0:
            emb_t = torch.zeros((B * k, cfg.dim_word),
                                dtype=params["Wemb"].dtype, device=h.device)
        else:
            emb_t = params["Wemb"][prev.reshape(B * k)]
        out = step_fn(params, cfg, StepState(h, c), fixed.sc, emb_t)
        if fixed.tail is not None:
            act = logit_activation(params, cfg, out.h, out.ctx_t, emb_t)
            pb_vals, pb_idx = tail_candidates(fixed.tail, act, B, k, ki)
        else:
            logits = logits_from_states(params, cfg, out.h, out.ctx_t,
                                        emb_t)
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            pb_vals, pb_idx = topk_rows(logp, ki)
            pb_vals = pb_vals.reshape(B, k, ki)
            pb_idx = pb_idx.reshape(B, k, ki)
        return pb_vals, pb_idx, (out.h, out.c)


LSTM = _LSTM()


def _prologue_span(model: BeamModel):
    return (span(model.prologue_span) if model.prologue_span
            else contextlib.nullcontext())


def _prologue(model: BeamModel, params, cfg,
              batch: Dict[str, torch.Tensor], k: int, maxlen: int,
              step_fn):
    """(``_Fixed``, the state before step 0) of a chunk."""
    frames = batch["frames"]
    dev = frames.device
    B = frames.shape[0]
    mf, state, ki = model.prologue(params, cfg, batch, k, maxlen, step_fn)

    # beam 0 starts live, beams 1..k-1 dead: at t=0 all beams are equal
    scores = torch.full((B, k), _NEG, dtype=torch.float32, device=dev)
    scores[:, 0].fill_(0.0)
    finished = torch.zeros((B, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, k), dtype=torch.int64, device=dev)
    prev = torch.zeros((B, k), dtype=torch.int64, device=dev)
    buf = torch.zeros((B, k, maxlen), dtype=torch.int64, device=dev)
    # a finished beam may only extend with EOS, at zero cost; device
    # fills, not writes of a host scalar (which wait for the stream)
    eos_vals = torch.full((ki,), _NEG, dtype=torch.float32, device=dev)
    eos_vals[:1].fill_(0.0)
    eos_idx = torch.arange(ki, dtype=torch.int64, device=dev)
    eos_idx[:1].fill_(EOS_ID)
    row_base = torch.arange(B, device=dev)[:, None] * k
    return (_Fixed(mf, eos_vals, eos_idx, row_base, B, k, ki, maxlen),
            _Beams(state, scores, finished, lengths, prev, buf))


def _step(model: BeamModel, fx: _Fixed, cfg, step_fn, t: int,
          st: _Beams) -> _Beams:
    """Step t of the beam loop: the model's step and its logit tail, then
    the select (the merge, the reorder and the token write)."""
    B, k, ki, maxlen = fx.B, fx.k, fx.ki, fx.maxlen
    with span("stvd.decode.step"):
        pb_vals, pb_idx, state = model.step(fx.model, cfg, step_fn, t,
                                            st.state, st.prev, B, k, ki)

    with span("stvd.decode.select"):
        finished = st.finished
        pb_vals = torch.where(finished[..., None], fx.eos_vals, pb_vals)
        pb_idx = torch.where(finished[..., None], fx.eos_idx, pb_idx)
        cand = (st.scores[..., None] + pb_vals).reshape(B, k * ki)
        scores, merge_idx = topk_rows(cand, k)        # (B, k)
        parent = merge_idx // ki
        word = torch.gather(pb_idx.reshape(B, k * ki), 1, merge_idx)

        par_finished = torch.gather(finished, 1, parent)
        finished = par_finished | (word == EOS_ID)
        lengths = (torch.gather(st.lengths, 1, parent)
                   + (~par_finished).long())

        rows = (fx.row_base + parent).reshape(B * k)
        state = tuple(s[rows] for s in state)
        buf = st.buf.reshape(B * k, maxlen)[rows].reshape(B, k, maxlen)
        buf[:, :, t] = torch.where(par_finished, EOS_ID, word)
    return _Beams(state, scores, finished, lengths, word, buf)


def _best(st: _Beams, length_norm: float, norm_mode: str) -> BeamOut:
    """The best beam of each row by length-normalized score."""
    B, _, maxlen = st.buf.shape
    lp = _length_penalty(st.lengths, length_norm, norm_mode)
    norm = st.scores / lp
    best = torch.argmax(norm, dim=1)                # first max on ties
    bi = best[:, None]
    return BeamOut(
        tokens=torch.gather(st.buf, 1,
                            bi[..., None].expand(B, 1, maxlen))[:, 0],
        scores=torch.gather(st.scores, 1, bi)[:, 0],
        norm_scores=torch.gather(norm, 1, bi)[:, 0],
        lengths=torch.gather(st.lengths, 1, bi)[:, 0],
        all_tokens=st.buf,
        all_scores=st.scores,
        all_norm_scores=norm,
    )


class _Chain(NamedTuple):
    """A chunk shape's captured chain: the prologue's graph and its
    outputs (which the steps read), each step's graph, its finished-flags
    reduction and the state the best beam is read from."""
    prologue: object
    fixed: _Fixed
    steps: list
    done: list
    ends: list


def _capture_chain(graphs, model: BeamModel, params, cfg,
                   inputs: Dict[str, torch.Tensor], k: int, maxlen: int,
                   step_fn) -> _Chain:
    """The prologue and each step t captured as a graph.  A step's
    outputs are the next one's inputs: each graph's recurrent state is
    let go once the next graph is captured, so the pool reuses it, and
    only the small tensors the best beam reads are kept per step."""
    prologue, (fx, st) = graphs.capture(
        lambda: _prologue(model, params, cfg, inputs, k, maxlen, step_fn))
    steps, done, ends = [], [], []
    for t in range(maxlen):
        def one(t=t, st=st):
            nxt = _step(model, fx, cfg, step_fn, t, st)
            return nxt, nxt.finished.all()
        graph, (st, flag) = graphs.capture(one)
        steps.append(graph)
        done.append(flag)
        ends.append(_Beams(None, st.scores, None, st.lengths, None,
                           st.buf))
    return _Chain(prologue, fx, steps, done, ends)


def _replay(graphs, model: BeamModel, chain: _Chain, length_norm: float,
            norm_mode: str) -> BeamOut:
    """A chunk, already in the static inputs, through its captured
    chain: the prologue, the steps with the early-exit read after each,
    the best beam eagerly, and the beams cloned out of the graphs'
    memory, which the next chunk's replay overwrites."""
    with _prologue_span(model):
        chain.prologue.replay()
    for t, graph in enumerate(chain.steps):
        with span("stvd.decode.step"):
            with span("stvd.decode.replay"):
                graph.replay()
        graphs.replayed += 1
        with span("stvd.decode.sync"):
            done = bool(chain.done[t])
        if done:
            break
    with span("stvd.decode.best"):
        out = _best(chain.ends[t], length_norm, norm_mode)
        return out._replace(all_tokens=out.all_tokens.clone(),
                            all_scores=out.all_scores.clone())


@spanned("stvd.decode")
def beam_decode(params, cfg, batch: Dict[str, torch.Tensor],
                beam_size: int = 5, maxlen: int = 30,
                length_norm: float = 0.6, norm_mode: str = "gnmt",
                step_fn: Optional[StepFn] = None,
                topk_chunks: int = 1, *, graphs=None,
                model: Optional[BeamModel] = None) -> BeamOut:
    """Batched beam search (the JAX package's parameters).
    ``topk_chunks`` picks a TPU lowering of the beam's top-k there; the
    port has one top-k, so it is accepted and not read.  ``graphs``, a
    ``DecodeGraphs`` of ``params`` and ``step_fn``, replays the
    chunk's CUDA graphs where the set engages (CUDA tensors, no export,
    compile or capture, no model axis), once the first chunk of its
    shape has decoded eagerly and the capture did not fail; otherwise,
    and without one, the loop runs eagerly.  ``model`` (a
    ``BeamModel``) supplies the prologue and the step; by default the
    attention LSTM's (``LSTM``), through ``step_fn``."""
    del topk_chunks
    model = model or LSTM
    step_fn = step_fn or step_mod.step
    k = beam_size
    if (graphs is not None and maxlen > 0
            and graphs.engages(params, step_fn, batch)):
        # the first chunk of a shape decodes eagerly, which warms what
        # the capture then records; later chunks replay
        chain, first = graphs.chain(
            ("beam", model, cfg, k, maxlen), batch,
            lambda inputs: _decode(model, params, cfg, inputs, k, maxlen,
                                   length_norm, norm_mode, step_fn),
            lambda inputs: _capture_chain(graphs, model, params, cfg,
                                          inputs, k, maxlen, step_fn))
        if first is not None:
            return first
        if chain is not None:
            return _replay(graphs, model, chain, length_norm, norm_mode)
    return _decode(model, params, cfg, batch, k, maxlen, length_norm,
                   norm_mode, step_fn)


def _decode(model: BeamModel, params, cfg, batch: Dict[str, torch.Tensor],
            k: int, maxlen: int, length_norm: float, norm_mode: str,
            step_fn) -> BeamOut:
    """The eager beam loop."""
    with _prologue_span(model):
        fx, st = _prologue(model, params, cfg, batch, k, maxlen, step_fn)
    for t in range(maxlen):
        st = _step(model, fx, cfg, step_fn, t, st)
        # early exit: one host sync per step reads the finished flags;
        # an exported graph runs all maxlen steps (a finished row only
        # extends with EOS at no cost, so its result is the same)
        if not torch.compiler.is_exporting():
            with span("stvd.decode.sync"):
                done = bool(st.finished.all())
            if done:
                break

    with span("stvd.decode.best"):
        return _best(st, length_norm, norm_mode)
