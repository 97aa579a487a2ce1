"""Multi-head latent attention (DeepSeek-V2/V3's MLA, as Kimi-VL-A3B's
language model has it, with no query LoRA).

A head's query is 128 dims without position and 64 with RoPE.  Keys and
values come from one 512-wide latent per position (``kv_a_proj_with_mqa``
then ``kv_a_layernorm``) and a 64-wide RoPE key that every head shares;
``kv_b_proj`` expands the latent to each head's 128-dim key part and
128-dim value.  A cached position is [latent | RoPE key], 576 wide.

``mla_prefill`` runs a prompt causally through the expanded keys and
values and returns the cache.  ``mla_decode`` runs new tokens in the
absorbed form: the query's position-free part is taken through ``W_UK``
into the latent space and scored against the cached latents, and the
latent-space output is taken through ``W_UV``.  A video's prefix cache
is read once for all of its beams and heads: its k beams x heads query
rows meet its one prefix in a single product, with no copy per beam;
each beam's own suffix (the caption so far) is read beside it.

RoPE is DeepSeek's: each query and key's pairs (2i, 2i+1) are first
de-interleaved into halves, then rotated by ``rotate_half``; computed in
float32.  Softmax scale (q_nope + q_rope dims)^-0.5 (no mscale: the
model's ``rope_scaling`` is null).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             f32: bool = False) -> torch.Tensor:
    """DeepSeek's RMSNorm: normalised in float32, then rounded to the
    weight's dtype and scaled by it; with ``f32``, scaled in float32 and
    left there."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return w.float() * xf if f32 else w * xf.to(w.dtype)


def rope_tables(n_pos: int, dim: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (n_pos, dim) float32, of positions 0..n_pos-1."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device).float()
                           / dim))
    freqs = torch.outer(torch.arange(n_pos, device=device,
                                     dtype=torch.float32), inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """DeepSeek's interleaved RoPE over the last dim of ``x``; ``cos`` and
    ``sin`` broadcast against it.  float32 inside, x's dtype out."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat((-xf[..., d // 2:], xf[..., :d // 2]), dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def _latent(x: torch.Tensor, aw: Dict[str, torch.Tensor], cfg,
            cos: torch.Tensor, sin: torch.Tensor):
    """The queries' two parts and the cache rows of tokens ``x`` (..., H):
    (q_nope (..., nh, dn), q_pe (..., nh, dr) after RoPE, c (..., r) after
    its norm, k_pe (..., dr) after RoPE); ``cos``/``sin`` broadcast
    against (..., dr)."""
    nh, dn, dr = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                  cfg.qk_rope_head_dim)
    q = F.linear(x, aw["q_proj"]).unflatten(-1, (nh, dn + dr))
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c, k_pe = F.linear(x, aw["kv_a_proj_with_mqa"]).split(
        [cfg.kv_lora_rank, dr], dim=-1)
    c = rms_norm(c, aw["kv_a_layernorm"], cfg.rms_norm_eps)
    q_pe = apply_rope(q_pe, cos.unsqueeze(-2), sin.unsqueeze(-2))
    return q_nope, q_pe, c, apply_rope(k_pe, cos, sin)


def mla_prefill(x: torch.Tensor, aw: Dict[str, torch.Tensor], cfg,
                cos: torch.Tensor, sin: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention of a prompt ``x`` (B, S, H) at positions 0..S-1
    (``cos``/``sin`` (S, dr)): (output (B, S, H), cache (B, S, r + dr)).
    ``mask`` (B, 1, S, S) bool, True where a query may attend, also
    leaves out padded keys; without it the attention is causal alone."""
    b, s, _ = x.shape
    nh, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                      cfg.qk_rope_head_dim, cfg.v_head_dim)
    q_nope, q_pe, c, k_pe = _latent(x, aw, cfg, cos, sin)
    k_nope, v = F.linear(c, aw["kv_b_proj"]).unflatten(
        -1, (nh, dn + dv)).split([dn, dv], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2).contiguous()
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, s, nh, dr)],
                  dim=-1).transpose(1, 2).contiguous()
    o = F.scaled_dot_product_attention(
        q, k, v.transpose(1, 2).contiguous(), attn_mask=mask,
        is_causal=mask is None, scale=(dn + dr) ** -0.5)
    o = F.linear(o.transpose(1, 2).reshape(b, s, nh * dv), aw["o_proj"])
    return o, torch.cat([c, k_pe], dim=-1)


def mla_decode(x: torch.Tensor, aw: Dict[str, torch.Tensor], cfg,
               cos: torch.Tensor, sin: torch.Tensor, prefix: torch.Tensor,
               prefix_bias: Optional[torch.Tensor], suffix: torch.Tensor,
               t: int) -> torch.Tensor:
    """Attention of one new token a beam row, ``x`` (B*k, H), in the
    absorbed form, over its video's prefix cache ``prefix`` (B, P, r + dr)
    (``prefix_bias`` (B, P) float32: 0, or -inf at a padded position;
    None: none padded) and its own suffix ``suffix`` (B*k, T, r + dr),
    whose slot t this token's cache row is written to and whose slots
    0..t it reads.  ``cos``/``sin``: the token's position, (dr,)."""
    rows = x.shape[0]
    b, p, width = prefix.shape
    nh, r = cfg.num_attention_heads, cfg.kv_lora_rank
    k = rows // b
    q_nope, q_pe, c, k_pe = _latent(x, aw, cfg, cos, sin)
    suffix[:, t] = torch.cat([c, k_pe], dim=-1)
    mine = suffix[:, :t + 1]
    q_lat = torch.bmm(q_nope.transpose(0, 1), aw["w_uk"]).transpose(0, 1)
    q = torch.cat([q_lat, q_pe], dim=-1)                  # (B*k, nh, r+dr)
    s_pre = torch.bmm(q.view(b, k * nh, width), prefix.transpose(1, 2))
    s_suf = torch.bmm(q, mine.transpose(1, 2)).view(b, k * nh, t + 1)
    s_pre = s_pre.float()
    if prefix_bias is not None:
        s_pre = s_pre + prefix_bias[:, None]
    prob = torch.softmax(torch.cat([s_pre, s_suf.float()], dim=-1)
                         * (cfg.qk_head_dim ** -0.5), dim=-1).to(x.dtype)
    o_pre = torch.bmm(prob[..., :p], prefix[..., :r])     # (B, k*nh, r)
    o_suf = torch.bmm(prob[..., p:].reshape(rows, nh, t + 1),
                      mine[..., :r])                      # (B*k, nh, r)
    o_lat = (o_pre.float().view(rows, nh, r) + o_suf.float()).to(x.dtype)
    o = torch.bmm(o_lat.transpose(0, 1), aw["w_uv"].transpose(1, 2))
    return F.linear(o.transpose(0, 1).reshape(rows, -1), aw["o_proj"])
