"""Parameter init, input fusion and the teacher-forced training forward
(counterpart of stvd/model/decoder.py).

Parameter names, shapes and scales are those of the JAX package's
``init_params``; the random numbers differ (a torch generator is not a
JAX key), so parity tests share weights through ``convert`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from . import step as step_mod
from .step import Params, StepOut

# (params, cfg, state, step_context, emb_t, x_pre=None) -> StepOut
StepFn = Callable[..., StepOut]


def _norm(g: torch.Generator, shape, device, scale: float = 0.01
          ) -> torch.Tensor:
    return scale * torch.randn(shape, generator=g, device=device)


def _ortho_stack(g: torch.Generator, nin: int, nblocks: int, device
                 ) -> torch.Tensor:
    """(nin, nin * nblocks) from independent orthogonal (nin, nin) blocks
    (the LSTM recurrent weights)."""
    blocks = [torch.nn.init.orthogonal_(torch.empty(nin, nin, device=device),
                                        generator=g)
              for _ in range(nblocks)]
    return torch.cat(blocks, dim=1)


def init_params(cfg, generator: torch.Generator,
                device: torch.device | str = "cuda") -> Params:
    """The full parameter dict, float32, on ``device``.  ``generator``
    must live on the same device."""
    d, dw, dc, da = cfg.dim, cfg.dim_word, cfg.ctx_dim, cfg.attn_dim
    g = generator

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def norm(*shape, scale=0.01):
        return _norm(g, shape, device, scale)

    p: Params = {}
    p["Wemb"] = norm(cfg.n_words, dw)
    if cfg.use_motion:
        p["W_app"] = norm(dc, dc, scale=1.0 / (dc ** 0.5))
        p["W_mot"] = norm(cfg.motion_dim, dc,
                          scale=1.0 / (cfg.motion_dim ** 0.5))
        p["b_fuse"] = zeros(dc)
    p["ff_state_W"] = norm(dc, d)
    p["ff_state_b"] = zeros(d)
    p["ff_memory_W"] = norm(dc, d)
    p["ff_memory_b"] = zeros(d)
    p["W"] = norm(dw, 4 * d)
    p["b"] = zeros(4 * d)
    p["U"] = _ortho_stack(g, d, 4, device)
    p["Wc"] = norm(dc, 4 * d)
    p["Wc_att"] = norm(dc, da)
    p["b_att"] = zeros(da)
    p["Wd_att"] = norm(d, da)
    p["U_att"] = norm(da)
    p["c_att"] = zeros()
    p["W_sel"] = norm(d)
    p["b_sel"] = zeros()
    if cfg.use_spatial:
        dr = cfg.region_dim
        p["Ws_att"] = norm(dr, dr)
        p["bs_att"] = zeros(dr)
        p["Wsd_att"] = norm(d, dr)
        p["Us_att"] = norm(dr)
        p["cs_att"] = zeros()
        p["W_spat_fuse"] = norm(dr, dc)
    if cfg.encoder == "lstm":
        p["enc_W"] = norm(dc, 4 * dc)
        p["enc_U"] = _ortho_stack(g, dc, 4, device)
        p["enc_b"] = zeros(4 * dc)
    p["ff_logit_lstm_W"] = norm(d, dw)
    p["ff_logit_lstm_b"] = zeros(dw)
    p["ff_logit_ctx_W"] = norm(dc, dw)
    p["ff_logit_W"] = norm(dw, cfg.n_words)
    p["ff_logit_b"] = zeros(cfg.n_words)
    return p


def encode_context(params: Params, cfg, frames: torch.Tensor,
                   motion: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fuse the input feature streams to the (B, K, ctx_dim) context.

    Single stream (MSVD): the frames themselves.  Dual stream (MSR-VTT,
    preset 4): the linear fusion ``frames @ W_app + motion @ W_mot +
    b_fuse``, float32 (the products accumulate in float32 and the bias
    is float32, as in the JAX package; it is not cast back to the
    compute dtype).  With ``encoder='lstm'`` the frame-level LSTM's
    states are added as a residual."""
    cdtype = step_mod.compute_dtype(cfg)
    if not cfg.use_motion:
        ctx = frames
    else:
        if motion is None:
            raise ValueError("use_motion=True but no motion features given")
        ctx = (step_mod._dot(frames, params["W_app"], cdtype)
               + step_mod._dot(motion, params["W_mot"], cdtype)
               + params["b_fuse"])
    if cfg.encoder == "lstm":
        # masked frames are excluded downstream by the attention mask
        ctx = ctx + _frame_lstm(params, cfg, ctx)
    return ctx


def _frame_lstm(params: Params, cfg, ctx: torch.Tensor) -> torch.Tensor:
    """Frame-level LSTM over the K frames (gates i, f, o, g; zero initial
    state): one input product over all frames, then the K-step
    recurrence.  Returns the (B, K, ctx_dim) float32 states."""
    cdtype = step_mod.compute_dtype(cfg)
    dc = cfg.ctx_dim
    x_pre = step_mod._dot(ctx, params["enc_W"], cdtype) + params["enc_b"]
    h = torch.zeros((ctx.shape[0], dc), dtype=torch.float32,
                    device=ctx.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(ctx.shape[1]):
        preact = x_pre[:, t] + step_mod._dot(h, params["enc_U"], cdtype)
        i = torch.sigmoid(preact[:, 0 * dc: 1 * dc])
        f = torch.sigmoid(preact[:, 1 * dc: 2 * dc])
        o = torch.sigmoid(preact[:, 2 * dc: 3 * dc])
        g = torch.tanh(preact[:, 3 * dc: 4 * dc])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


class ForwardOut(NamedTuple):
    logits: torch.Tensor          # (B, T, n_words) float32
    alphas: torch.Tensor          # (B, T, K) temporal attention maps
    nll_per_example: torch.Tensor  # (B,)


def _ss_coins(generator: torch.Generator, ss_prob: float, batch: int,
              steps: int, device) -> torch.Tensor:
    """(T, B) bool: each True with probability ``ss_prob``, drawn from
    ``generator``.  Step t > 0 of the scheduled-sampling scan feeds row
    b the model's own previous prediction where entry (t, b) is True (the
    counterpart of JAX's per-step ``bernoulli`` draws; the CPU tests
    replace this function with those draws)."""
    return step_mod.rand_rows((steps, batch), 1, generator,
                              device) < ss_prob


def _scan(body, carry, xs, remat: bool):
    """Run ``body(*carry, *x_t) -> (*carry, *y_t)`` over the steps of
    ``xs`` (tensors with a leading T axis, or None) and stack each
    ``y`` along axis 1.  With ``remat`` each step runs under
    ``torch.utils.checkpoint``: only its inputs and outputs are kept, and
    the backward runs its forward again.  Every random draw of a step is
    in ``xs``, made before the scan: the recomputation restores no
    explicit ``torch.Generator``."""
    n = len(carry)
    ys = []
    for t in range(len(xs[0])):
        x_t = [None if x is None else x[t] for x in xs]
        out = (torch.utils.checkpoint.checkpoint(
            body, *carry, *x_t, use_reentrant=False) if remat
            else body(*carry, *x_t))
        carry = out[:n]
        ys.append(out[n:])
    return [torch.stack(y, dim=1) for y in zip(*ys)]


def forward_train(params: Params, cfg, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  train: bool = True, ss_prob: float = 0.0,
                  step_fn: Optional[StepFn] = None) -> ForwardOut:
    """The training forward over a batch (frames (B, K, D), frame_mask
    (B, K), tokens (B, T), token_mask (B, T), regions (B, K, R, Dr) for
    the spatial model, motion (B, K, Dm) for the dual-stream one).
    ``generator`` draws the train dropout (and the scheduled-sampling
    coins; without one they come from a generator seeded 0, as JAX's
    default key) and must live on the batch's device.  Training never
    quantizes: ``decode_quant`` is forced to 'none'.

    Teacher forcing (``ss_prob == 0``): step t sees gold word t-1 (zeros
    at t = 0), the input projection runs once for all steps, and the
    vocab projection once over all (B, T) states.  With
    ``cfg.fused_seq_grad`` (the default) the scan is the hand-derived
    sequence VJP of ``seqgrad``, which has its own step body: ``step_fn``
    is not consulted there, as in the JAX package.  Without it the scan
    calls ``step_fn`` (default the plain step) with each step's ``x_pre``
    and autograd differentiates it.

    Scheduled sampling (``ss_prob > 0``): at step t > 0 each row feeds
    the embedding of the model's own previous prediction (the first
    argmax of its logits) with probability ``ss_prob``, else the gold
    one; each step runs ``step_fn`` without ``x_pre`` and takes its own
    logits, dropout included.  ``cfg.remat`` recomputes each step's
    forward in the backward (``torch.utils.checkpoint``) on both
    autograd scans; the coins and dropout masks are drawn before the
    scan."""
    step_fn = step_fn or step_mod.step
    if cfg.decode_quant != "none":
        cfg = dataclasses.replace(cfg, decode_quant="none")
    params = step_mod.cast_params(params, cfg)
    cdtype = step_mod.compute_dtype(cfg)
    tokens = batch["tokens"]
    b, t_len = tokens.shape
    teacher = ss_prob == 0.0
    ctx = encode_context(params, cfg, batch["frames"], batch.get("motion"))
    sc = step_mod.precompute(params, cfg, ctx, batch["frame_mask"],
                             batch.get("regions"), train=teacher)
    state0 = step_mod.init_state(params, cfg, sc)
    emb_all = params["Wemb"][tokens]                      # (B, T, dw)
    # step t sees gold word t-1, zeros at t = 0
    emb_in = torch.cat([torch.zeros_like(emb_all[:, :1]), emb_all[:, :-1]],
                       dim=1)
    remat = cfg.remat and train

    if teacher:
        x_pre_all = step_mod._dot(emb_in, params["W"], cdtype) + params["b"]
        if cfg.fused_seq_grad:
            from . import seqgrad
            run = seqgrad.run_spatial if cfg.use_spatial else seqgrad.run
            hs, ctxs, alphas = run(params, cfg, sc, state0,
                                   x_pre_all.transpose(0, 1))
            hs, ctxs, alphas = (hs.transpose(0, 1), ctxs.transpose(0, 1),
                                alphas.transpose(0, 1))
        else:
            def body(h, c, emb_t, x_pre_t):
                out = step_fn(params, cfg, step_mod.StepState(h, c), sc,
                              emb_t, x_pre_t)
                return out.h, out.c, out.h, out.ctx_t, out.alpha

            hs, ctxs, alphas = _scan(
                body, state0, (emb_in.transpose(0, 1),
                               x_pre_all.transpose(0, 1)), remat)
        logits = step_mod.logits_from_states(params, cfg, hs, ctxs, emb_in,
                                             generator, train)
    else:
        dev = tokens.device
        if generator is None:
            if cfg.use_dropout and train:
                raise ValueError("train dropout requires a generator")
            generator = torch.Generator(device=dev).manual_seed(0)
        coins = _ss_coins(generator, ss_prob, b, t_len, dev)
        use_model = coins & (torch.arange(t_len, device=dev) > 0)[:, None]
        keep = (step_mod.dropout_keep(cfg, (t_len, b, cfg.dim_word),
                                      generator, dev, batch_axis=1)
                if cfg.use_dropout and train else None)
        wemb = params["Wemb"]

        def body(h, c, prev, emb_gold_t, use_model_t, keep_t):
            emb_t = torch.where(use_model_t[:, None], wemb[prev],
                                emb_gold_t)
            out = step_fn(params, cfg, step_mod.StepState(h, c), sc, emb_t)
            logit_t = step_mod.logits_from_states(
                params, cfg, out.h, out.ctx_t, emb_t, train=train,
                keep=keep_t)
            pred = logit_t.detach().argmax(dim=-1)   # first index on ties
            return out.h, out.c, pred, logit_t, out.alpha

        prev0 = torch.zeros(b, dtype=torch.long, device=dev)
        logits, alphas = _scan(body, (*state0, prev0),
                               (emb_in.transpose(0, 1), use_model, keep),
                               remat)
    nll = sequence_nll(logits, tokens, batch["token_mask"])
    return ForwardOut(logits=logits, alphas=alphas, nll_per_example=nll)


def sequence_nll(logits: torch.Tensor, tokens: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Per-example summed negative log-likelihood of the gold tokens."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = torch.gather(logp, -1, tokens[..., None].long())[..., 0]
    return -(gold * mask).sum(dim=-1)
