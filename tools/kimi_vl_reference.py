"""Plain float32 reference of Kimi-VL-A3B's language model as a video
captioner, in PyTorch alone (it imports nothing of the port).

The language model follows DeepSeek-V3's published code (the design of
Kimi-VL-A3B's ``config.json``): RMSNorm in float32, multi-head latent
attention without a query LoRA (DeepSeek-V2, arXiv:2405.04434), DeepSeek's
interleaved RoPE, layer 0 a dense SwiGLU and the others a mixture of
sigmoid-routed experts whose choice adds ``e_score_correction_bias``
(``noaux_tc``, one group; DeepSeek-V3, arXiv:2412.19437) beside shared
experts, a final norm and an untied head.  Everything is computed the
plain way: one full causal forward of the prompt and the caption, the
keys and values expanded from the latent, the experts as a loop over the
experts, with no cache and no batching of beams.  TF32 is off.

Departures from the published model, all of them in what surrounds the
language model:

- no vision tower: a video's visual tokens are given as they would leave
  the tower's projector (2048 wide), and a padded token is left out of
  the attention;
- the prompt is synthetic ids around the visual tokens, and a caption's
  words are synthetic ids;
- the head may carry a bias (``logit_bias``), which the published head
  has not: the benchmark suppresses EOS with it.

Weights are a callable ``weights(name) -> float32 tensor`` of the
published names (``model.layers.{i}.self_attn.q_proj.weight`` ...), so a
caller may make each layer's weights when they are asked for and free
them after (``forward`` asks for one layer at a time).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

EOS_ID = 0

Weights = Callable[[str], torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps):
    x = x.float()
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(x, pos, dim, theta):
    """DeepSeek's RoPE over the last dim of x (..., S, [heads,] dim) at
    positions ``pos`` (S,): pairs (2i, 2i+1) de-interleaved into halves,
    then rotated by rotate_half."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=x.device).float()
                           / dim))
    f = torch.outer(pos.float(), inv)
    emb = torch.cat((f, f), dim=-1)
    cos, sin = emb.cos(), emb.sin()
    if x.dim() == 4:                      # (B, S, heads, dim)
        cos, sin = cos[:, None], sin[:, None]
    x = x.unflatten(-1, (dim // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat((-x[..., dim // 2:], x[..., :dim // 2]), dim=-1)
    return x * cos + rot * sin


def attention(x, w: Weights, p: str, m: dict, valid):
    """Causal multi-head latent attention of x (B, S, H), keys and values
    expanded from the latent; ``valid`` (B, S) bool leaves out padding."""
    b, s, _ = x.shape
    nh, dn, dr, dv, r = (m["num_attention_heads"], m["qk_nope_head_dim"],
                         m["qk_rope_head_dim"], m["v_head_dim"],
                         m["kv_lora_rank"])
    pos = torch.arange(s, device=x.device)
    q = (x @ w(p + "q_proj.weight").t()).view(b, s, nh, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c, k_pe = (x @ w(p + "kv_a_proj_with_mqa.weight").t()).split([r, dr], -1)
    c = rms_norm(c, w(p + "kv_a_layernorm.weight"), m["rms_norm_eps"])
    kv = (c @ w(p + "kv_b_proj.weight").t()).view(b, s, nh, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe = rope(q_pe, pos, dr, m["rope_theta"])
    k_pe = rope(k_pe, pos, dr, m["rope_theta"])
    q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)             # b nh s d
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, nh, dr)],
                  -1).transpose(1, 2)
    v = v.transpose(1, 2)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    out = torch.empty((b, nh, s, dv), device=x.device)
    for i in range(b):                    # one video's scores at a time
        sc = (q[i] @ k[i].transpose(-1, -2)) / math.sqrt(dn + dr)
        sc = sc.masked_fill(~(causal & valid[i][None]), float("-inf"))
        out[i] = torch.softmax(sc, dim=-1) @ v[i]
    out = out.transpose(1, 2).reshape(b, s, nh * dv)
    return out @ w(p + "o_proj.weight").t()


def swiglu(x, w: Weights, p: str):
    g = x @ w(p + "gate_proj.weight").t()
    u = x @ w(p + "up_proj.weight").t()
    return (F.silu(g) * u) @ w(p + "down_proj.weight").t()


def moe(x, w: Weights, p: str, m: dict):
    """Sigmoid routing with the selection bias, each chosen expert in a
    loop over the experts, the shared experts beside them; x (N, H)."""
    scores = (x @ w(p + "gate.weight").t()).sigmoid()
    choice = scores + w(p + "gate.e_score_correction_bias")
    idx = torch.topk(choice, m["num_experts_per_tok"], dim=-1).indices
    weight = scores.gather(1, idx)
    if m["norm_topk_prob"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * m["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(m["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], w, f"{p}experts.{e}.")
            y.index_add_(0, tok, out * weight[tok, slot, None])
    return y + swiglu(x, w, p + "shared_experts.")


def forward(w: Weights, m: dict, x, valid, logit_bias=None,
            positions: Optional[slice] = None):
    """The logits (B, S', V) float32 of embeddings ``x`` (B, S, H) at
    ``positions`` (a slice of S; all by default), a layer at a time."""
    b, s, h = x.shape
    x = x.float()
    for i in range(m["num_hidden_layers"]):
        p = f"model.layers.{i}."
        eps = m["rms_norm_eps"]
        x = x + attention(rms_norm(x, w(p + "input_layernorm.weight"), eps),
                          w, p + "self_attn.", m, valid)
        y = rms_norm(x, w(p + "post_attention_layernorm.weight"),
                     eps).view(b * s, h)
        if i >= m["first_k_dense_replace"]:
            y = moe(y, w, p + "mlp.", m)
        else:
            y = swiglu(y, w, p + "mlp.")
        x = x + y.view(b, s, h)
    x = rms_norm(x[:, positions or slice(None)], w("model.norm.weight"),
                 m["rms_norm_eps"])
    logits = x @ w("lm_head.weight").t()
    return logits if logit_bias is None else logits + logit_bias


def prompt(w: Weights, m: dict, frames, frame_mask, before, after):
    """(embeddings (B, P, H), valid (B, P)) of [before | frames | after]:
    ``frames`` (B, Nv, H) the visual tokens, ``before``/``after`` ids."""
    b = frames.shape[0]
    emb = w("model.embed_tokens.weight")
    dev = frames.device

    def ids(t):
        return emb[torch.as_tensor(list(t), dtype=torch.long,
                                   device=dev)][None].expand(b, -1, -1)

    x = torch.cat([ids(before), frames.float(), ids(after)], dim=1)
    ones = torch.ones((b, len(before)), dtype=torch.bool, device=dev)
    valid = torch.cat([ones, frame_mask > 0,
                       torch.ones((b, len(after)), dtype=torch.bool,
                                  device=dev)], dim=1)
    return x, valid


def teacher_logp(w: Weights, m: dict, frames, frame_mask, before, after,
                 tokens, logit_bias=None):
    """Log-probabilities (B, T, V) of each caption position given the
    prompt and the caption's tokens ``tokens`` (B, T) before it: one
    forward of [prompt | tokens[:, :-1]]."""
    x, valid = prompt(w, m, frames, frame_mask, before, after)
    n = x.shape[1]
    t = tokens.shape[1]
    words = w("model.embed_tokens.weight")[tokens[:, :-1]]
    x = torch.cat([x, words], dim=1)
    valid = torch.cat([valid, torch.ones(tokens[:, :-1].shape,
                                         dtype=torch.bool,
                                         device=valid.device)], dim=1)
    logits = forward(w, m, x, valid, logit_bias, slice(n - 1, n - 1 + t))
    return torch.log_softmax(logits, dim=-1)


def length_penalty(n: int, alpha: float) -> float:
    return ((5.0 + max(n, 1)) / 6.0) ** alpha if alpha > 0 else 1.0


def beam_search(w: Weights, m: dict, frames, frame_mask, before, after,
                beam: int, maxlen: int, alpha: float, logit_bias=None):
    """Beam search by full forwards (no cache): beam 0 starts live, a
    finished beam extends only with EOS at no cost, the k best of each
    beam's k words are merged, the best beam is the first largest score
    over the GNMT penalty of its length.  (tokens (B, maxlen),
    normalised scores (B,))."""
    b = frames.shape[0]
    dev = frames.device
    x0, valid0 = prompt(w, m, frames, frame_mask, before, after)
    emb = w("model.embed_tokens.weight")
    scores = torch.full((b, beam), -1.0e30, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, beam), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, beam), dtype=torch.long, device=dev)
    toks = torch.zeros((b, beam, 0), dtype=torch.long, device=dev)
    for t in range(maxlen):
        rows = toks.reshape(b * beam, t)
        x = torch.cat([x0.repeat_interleave(beam, 0), emb[rows]], dim=1)
        valid = torch.cat([valid0.repeat_interleave(beam, 0),
                           torch.ones(rows.shape, dtype=torch.bool,
                                      device=dev)], dim=1)
        logits = forward(w, m, x, valid, logit_bias, slice(-1, None))[:, 0]
        v, i = torch.topk(torch.log_softmax(logits, -1), beam, dim=-1)
        v, i = v.view(b, beam, beam), i.view(b, beam, beam)
        v = torch.where(finished[..., None],
                        torch.tensor([0.0] + [-1.0e30] * (beam - 1),
                                     device=dev), v)
        i = torch.where(finished[..., None], torch.full_like(i, EOS_ID), i)
        new, pick = torch.topk((scores[..., None] + v).view(b, -1), beam,
                               dim=-1)
        parent = pick // beam
        word = i.view(b, -1).gather(1, pick)
        pf = finished.gather(1, parent)
        lengths = lengths.gather(1, parent) + (~pf).long()
        finished = pf | (word == EOS_ID)
        toks = torch.cat([toks.gather(1, parent[..., None].expand_as(toks)),
                          torch.where(pf, EOS_ID, word)[..., None]], dim=2)
        scores = new
    lp = torch.tensor([[length_penalty(int(n), alpha) for n in row]
                       for row in lengths.tolist()], device=dev)
    norm = scores / lp
    best = norm.argmax(dim=1)
    return (toks[torch.arange(b, device=dev), best],
            norm[torch.arange(b, device=dev), best])
