"""Kimi-VL-A3B's language model as a video captioner (the DeepSeek-V3
design: DeepSeek-V2, arXiv:2405.04434, for latent attention; DeepSeek-V3,
arXiv:2412.19437, for sigmoid routing with a selection bias).

The weights carry the published names and shapes (``param_shapes``;
nn.Linear's (out, in)); ``pack`` lays one layer at a time out for the
decode, in the compute dtype: the experts of a layer stacked for the
grouped products, each expert's gate and up projections as one, the
latent attention's ``kv_b_proj`` also split into the absorbed decode's
``W_UK`` and ``W_UV``, the untied head transposed for the fused logit
tail (kernel 2), and the prompt ids' embeddings.

A layer is ``x + attn(input_layernorm(x))``, then ``+ mlp(
post_attention_layernorm(x))``; layer 0's MLP is a dense SwiGLU, the
others' the MoE of ``model/moe.py``.  A final norm and the head follow.
The residual stream is kept in float32 (each layer's products run in the
compute dtype), and the router reads the normalised stream in float32,
before its rounding: the published code routes on the bf16 norm, whose
rounding alone moves a token's 6th and 7th experts.

A video's prompt is [prompt_before | its visual tokens | prompt_after]:
the visual tokens are the vision tower's projected output, read from the
bank as they are (the tower runs offline, as the other models' features
do).  ``KimiBeam`` is the model's side of the shared beam loop
(``decode/beam.py``): its prologue (span ``stvd.decode.prefill``) runs
the prompt but its last token through every layer at once and keeps each
layer's latent cache of it, one per video; step t runs one token a beam
row through every layer in the absorbed form, at position P - 1 + t:
the prompt's last token at step 0, the beam's previous word after.  Step
t writes its cache row to slot t of the beam's own suffix cache, which
the select reorders with the beams; the prefix cache is never reordered.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..decode.beam import BeamModel, tail_candidates
from . import kernel
from .kimi_config import KimiVLConfig
from .mla import mla_decode, mla_prefill, rms_norm, rope_tables
from .moe import ExpertCounter, moe, swiglu

PREFILL, DECODE = 0, 1           # the phases of ``ExpertCounter``


def param_shapes(cfg: KimiVLConfig) -> Dict[str, Tuple[int, ...]]:
    """Every weight's published name and shape."""
    h, v = cfg.hidden_size, cfg.vocab_size
    nh = cfg.num_attention_heads
    out = {"model.embed_tokens.weight": (v, h)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = (h,)
        out[p + "post_attention_layernorm.weight"] = (h,)
        a = p + "self_attn."
        out[a + "q_proj.weight"] = (nh * cfg.qk_head_dim, h)
        out[a + "kv_a_proj_with_mqa.weight"] = (cfg.latent_dim, h)
        out[a + "kv_a_layernorm.weight"] = (cfg.kv_lora_rank,)
        out[a + "kv_b_proj.weight"] = (
            nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank)
        out[a + "o_proj.weight"] = (h, nh * cfg.v_head_dim)
        m = p + "mlp."
        if not cfg.is_moe(i):
            out[m + "gate_proj.weight"] = (cfg.intermediate_size, h)
            out[m + "up_proj.weight"] = (cfg.intermediate_size, h)
            out[m + "down_proj.weight"] = (h, cfg.intermediate_size)
            continue
        out[m + "gate.weight"] = (cfg.n_routed_experts, h)
        out[m + "gate.e_score_correction_bias"] = (cfg.n_routed_experts,)
        for e in range(cfg.n_routed_experts):
            x = f"{m}experts.{e}."
            out[x + "gate_proj.weight"] = (cfg.moe_intermediate_size, h)
            out[x + "up_proj.weight"] = (cfg.moe_intermediate_size, h)
            out[x + "down_proj.weight"] = (h, cfg.moe_intermediate_size)
        shared = cfg.moe_intermediate_size * cfg.n_shared_experts
        x = m + "shared_experts."
        out[x + "gate_proj.weight"] = (shared, h)
        out[x + "up_proj.weight"] = (shared, h)
        out[x + "down_proj.weight"] = (h, shared)
    out["model.norm.weight"] = (h,)
    out["lm_head.weight"] = (v, h)
    return out


def pack_layer(lp: Dict[str, torch.Tensor], cfg: KimiVLConfig, i: int,
               dtype: torch.dtype, device) -> dict:
    """Layer ``i``'s published weights ``lp`` (its names with the
    ``model.layers.{i}.`` prefix) laid out for the decode in ``dtype``;
    the router's correction bias stays float32."""
    p = f"model.layers.{i}."

    def get(name, dt=dtype):
        return lp[p + name].to(device=device, dtype=dt)

    nh, dn, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                  cfg.v_head_dim)
    kv_b = get("self_attn.kv_b_proj.weight")
    heads = kv_b.view(nh, dn + dv, cfg.kv_lora_rank)
    attn = {"q_proj": get("self_attn.q_proj.weight"),
            "kv_a_proj_with_mqa": get("self_attn.kv_a_proj_with_mqa.weight"),
            "kv_a_layernorm": get("self_attn.kv_a_layernorm.weight"),
            "kv_b_proj": kv_b,
            "w_uk": heads[:, :dn].contiguous(),
            "w_uv": heads[:, dn:].contiguous(),
            "o_proj": get("self_attn.o_proj.weight")}
    out = {"input_layernorm": get("input_layernorm.weight"),
           "post_attention_layernorm": get("post_attention_layernorm.weight"),
           "attn": attn}

    def w13(prefix):
        return torch.cat([get(prefix + "gate_proj.weight"),
                          get(prefix + "up_proj.weight")])

    if not cfg.is_moe(i):
        out["mlp"] = {"w13": w13("mlp."), "w2": get("mlp.down_proj.weight")}
        return out
    experts = range(cfg.n_routed_experts)
    e13 = torch.empty((cfg.n_routed_experts, 2 * cfg.moe_intermediate_size,
                       cfg.hidden_size), dtype=dtype, device=device)
    e2 = torch.empty((cfg.n_routed_experts, cfg.hidden_size,
                      cfg.moe_intermediate_size), dtype=dtype, device=device)
    for e in experts:
        e13[e] = w13(f"mlp.experts.{e}.")
        e2[e] = get(f"mlp.experts.{e}.down_proj.weight")
    out["mlp"] = {"gate": get("mlp.gate.weight"),
                  "bias": get("mlp.gate.e_score_correction_bias",
                              torch.float32),
                  "w13": e13, "w2": e2,
                  "shared_w13": w13("mlp.shared_experts."),
                  "shared_w2": get("mlp.shared_experts.down_proj.weight")}
    return out


def pack_outer(params: Dict[str, torch.Tensor], cfg: KimiVLConfig,
               dtype: torch.dtype, device,
               logit_bias: Optional[torch.Tensor] = None) -> dict:
    """The weights outside the layers: the embedding, the prompt's
    embeddings, the final norm, the head transposed to (H, V) for kernel
    2 and its bias (float32; the published head has none, so zeros unless
    ``logit_bias`` is given)."""
    embed = params["model.embed_tokens.weight"].to(device=device,
                                                   dtype=dtype)
    ids = {k: torch.tensor(getattr(cfg, k), dtype=torch.int64,
                           device=device)
           for k in ("prompt_before", "prompt_after")}
    bias = (torch.zeros(cfg.vocab_size, device=device)
            if logit_bias is None else
            logit_bias.to(device=device, dtype=torch.float32))
    return {"embed": embed,
            "prompt_before": embed[ids["prompt_before"]],
            "prompt_after": embed[ids["prompt_after"]],
            "norm": params["model.norm.weight"].to(device=device,
                                                   dtype=dtype),
            "lm_head_t": params["lm_head.weight"].to(
                device=device, dtype=dtype).t().contiguous(),
            "logit_bias": bias}


def pack(params: Dict[str, torch.Tensor], cfg: KimiVLConfig, device,
         logit_bias: Optional[torch.Tensor] = None) -> dict:
    """The published weights ``params`` laid out for the decode in the
    compute dtype (``pack_outer`` and a ``pack_layer`` a layer)."""
    dtype = getattr(torch, cfg.compute_dtype)
    out = pack_outer(params, cfg, dtype, device, logit_bias)
    out["layers"] = [pack_layer(params, cfg, i, dtype, device)
                     for i in range(cfg.num_hidden_layers)]
    return out


def mlp(x: torch.Tensor, lw: dict, cfg: KimiVLConfig,
        counter: Optional[ExpertCounter], phase: int, layer: int
        ) -> torch.Tensor:
    """Layer ``layer``'s MLP branch of the float32 stream ``x`` (n, H):
    ``post_attention_layernorm``, then the dense SwiGLU or the MoE, whose
    router reads the normalised stream in float32 (``counter`` counts its
    routing at its index among the MoE layers)."""
    w = lw["mlp"]
    norm_w, eps = lw["post_attention_layernorm"], cfg.rms_norm_eps
    y = rms_norm(x, norm_w, eps)
    if "gate" not in w:
        return swiglu(y, w["w13"], w["w2"])
    return moe(y, w, cfg.num_experts_per_tok, cfg.routed_scaling_factor,
               cfg.norm_topk_prob, counter, phase,
               layer - cfg.first_k_dense_replace,
               x_route=rms_norm(x, norm_w, eps, f32=True))


def prompt_embeddings(packed: dict, frames: torch.Tensor) -> torch.Tensor:
    """[prompt_before | visual tokens | prompt_after] of each video, (B,
    P, H), from the visual tokens ``frames`` (B, Nv, H)."""
    b = frames.shape[0]
    parts = [packed["prompt_before"], None, packed["prompt_after"]]
    return torch.cat([frames if x is None else
                      x[None].expand(b, -1, -1).to(frames.dtype)
                      for x in parts], dim=1)


def prompt_valid(cfg: KimiVLConfig, frame_mask: torch.Tensor
                 ) -> torch.Tensor:
    """(B, P) bool: the prompt's positions that are not padding."""
    b = frame_mask.shape[0]
    dev = frame_mask.device
    return torch.cat([
        torch.ones((b, len(cfg.prompt_before)), dtype=torch.bool,
                   device=dev), frame_mask > 0,
        torch.ones((b, len(cfg.prompt_after)), dtype=torch.bool,
                   device=dev)], dim=1)


def prefill(packed: dict, cfg: KimiVLConfig, x: torch.Tensor,
            cos: torch.Tensor, sin: torch.Tensor,
            mask: Optional[torch.Tensor],
            counter: Optional[ExpertCounter] = None) -> torch.Tensor:
    """Every layer's cache (L, B, S, r + dr), in the weights' dtype, of
    prompts ``x`` (B, S, H) at positions 0..S-1 (``mask``: as
    ``mla_prefill``'s).  The residual stream is kept in float32."""
    b, s, h = x.shape
    x = x.float()
    caches = x.new_empty((cfg.num_hidden_layers, b, s, cfg.latent_dim),
                         dtype=packed["norm"].dtype)
    for i, lw in enumerate(packed["layers"]):
        a, caches[i] = mla_prefill(
            rms_norm(x, lw["input_layernorm"], cfg.rms_norm_eps),
            lw["attn"], cfg, cos, sin, mask)
        x = x + a
        x = x + mlp(x.view(b * s, h), lw, cfg, counter, PREFILL,
                    i).view(b, s, h)
    return caches


class KimiFixed(NamedTuple):
    """What every step of a chunk reads: the weights, the fused tail,
    each layer's prefix cache (L, B, P - 1, r + dr), its padding bias
    (None: none padded), the RoPE tables, the prompt's last embedding a
    beam row and the prefix's length."""
    packed: dict
    tail: object
    prefix: torch.Tensor
    prefix_bias: Optional[torch.Tensor]
    cos: torch.Tensor
    sin: torch.Tensor
    first: torch.Tensor
    n_prefix: int


class KimiBeam(BeamModel):
    """The model's side of the beam loop.  ``dense``: every visual token
    of every video is valid (the caller knows it, e.g. from the bank),
    so the prefill's attention is causal alone; otherwise the frame mask
    leaves out padded tokens.  ``counter`` counts the MoE routing."""

    prologue_span = "stvd.decode.prefill"

    def __init__(self, dense: bool = False,
                 counter: Optional[ExpertCounter] = None):
        self.dense = dense
        self.counter = counter

    def position(self, fx: KimiFixed, t: int) -> int:
        """Step t's position: the prompt's last one at step 0."""
        return fx.n_prefix + t

    def prologue(self, params, cfg, batch, k, maxlen, step_fn):
        frames = batch["frames"]
        b = frames.shape[0]
        ki = min(k, cfg.vocab_size)
        tail = kernel.make_logit_tail(params["lm_head_t"],
                                      params["logit_bias"], ki)
        x = prompt_embeddings(params, frames)
        n = x.shape[1] - 1
        cos, sin = rope_tables(n + maxlen, cfg.qk_rope_head_dim,
                               cfg.rope_theta, frames.device)
        mask = bias = None
        if not self.dense:
            valid = prompt_valid(cfg, batch["frame_mask"])[:, :n]
            causal = torch.ones((n, n), dtype=torch.bool,
                                device=frames.device).tril()
            mask = causal[None, None] & valid[:, None, None, :]
            bias = torch.zeros(valid.shape, device=frames.device
                               ).masked_fill(~valid, float("-inf"))
        prefix = prefill(params, cfg, x[:, :n], cos[:n], sin[:n], mask,
                         self.counter)
        first = x[:, n].float().repeat_interleave(k, dim=0)
        suffix = prefix.new_zeros((b * k, cfg.num_hidden_layers, maxlen,
                                   cfg.latent_dim))
        return (KimiFixed(params, tail, prefix, bias, cos, sin, first, n),
                (suffix,), ki)

    def activation(self, fixed: KimiFixed, cfg, t: int,
                   suffix: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The head's input (rows, H) for tokens ``x`` (rows, H) at step
        t, through every layer over the prefix and ``suffix`` (rows, L,
        T, r + dr), whose slot t it writes; the residual stream in
        float32."""
        pos = self.position(fixed, t)
        cos, sin = fixed.cos[pos], fixed.sin[pos]
        eps = cfg.rms_norm_eps
        for i, lw in enumerate(fixed.packed["layers"]):
            x = x + mla_decode(rms_norm(x, lw["input_layernorm"], eps),
                               lw["attn"], cfg, cos, sin, fixed.prefix[i],
                               fixed.prefix_bias, suffix[:, i], t)
            x = x + mlp(x, lw, cfg, self.counter, DECODE, i)
        return rms_norm(x, fixed.packed["norm"], eps)

    def step(self, fixed, cfg, step_fn, t, state, prev, B, k, ki):
        (suffix,) = state
        x = (fixed.first if t == 0
             else fixed.packed["embed"][prev.reshape(B * k)].float())
        act = self.activation(fixed, cfg, t, suffix, x)
        vals, idx = tail_candidates(fixed.tail, act, B, k, ki)
        return vals, idx, (suffix,)
