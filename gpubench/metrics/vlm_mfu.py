"""``vlm_mfu``: the model operations of the video-language cell's requests
served before the traced part, counted from the configuration's shapes
whatever implements them, over those seconds times the bf16 tensor-core
peak (989 TFLOP/s) times the cards.

A video's prompt of P tokens runs its first P - 1 through every layer at
once (the prefill: each layer's linear maps, the latent expanded to keys
and values, causal attention over the positions before each), and then
each beam row one token a step (the prompt's last token, then its words),
in the absorbed form: the query into the latent space, scores against the
576-wide cache of every position so far, the output out of it, and the
head.  A multiply-add counts two operations; the softmax, norms and
element-wise work are left out."""

from gpubench import harness


def prompt_tokens(c: dict) -> int:
    m, ds = c["model"], c["dataset"]
    return (len(m["prompt_before"]) + len(m["prompt_after"])
            + ds["frames_per_video"] * ds["tokens_per_frame"])


def mlp_flops(c: dict) -> float:
    """A token's MLP operations summed over the layers: the dense
    SwiGLUs, and in each MoE layer the router, its k experts and the
    shared experts."""
    h, n = c["hidden_size"], c["num_hidden_layers"]
    dense = c["first_k_dense_replace"]
    moe = (2 * h * c["n_routed_experts"]
           + c["num_experts_per_tok"] * 6 * h * c["moe_intermediate_size"]
           + 6 * h * c["moe_intermediate_size"] * c["n_shared_experts"])
    return dense * 6 * h * c["intermediate_size"] + (n - dense) * moe


def proj_flops(c: dict, absorbed: bool) -> float:
    """A token's attention projections in one layer: the query, the
    latent and RoPE key, and the output; the latent's expansion to keys
    and values (prefill) or the query's and output's maps through W_UK
    and W_UV (absorbed decode)."""
    h, nh, r = (c["hidden_size"], c["num_attention_heads"],
                c["kv_lora_rank"])
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    f = 2 * h * nh * (dn + dr) + 2 * h * (r + dr) + 2 * nh * dv * h
    return f + (2 * r * nh * (dn + dv) if not absorbed
                else 2 * nh * dn * r + 2 * nh * r * dv)


def prefill_flops(c: dict) -> float:
    n = prompt_tokens(c) - 1
    nh = c["num_attention_heads"]
    width = c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"]
    attn = 2 * nh * width * n * (n + 1) / 2
    return (n * (mlp_flops(c) + c["num_hidden_layers"] * proj_flops(c, False))
            + c["num_hidden_layers"] * attn)


def step_flops(c: dict, t: int) -> float:
    """One beam row's step t, over the n + t + 1 cached positions."""
    seen = prompt_tokens(c) + t
    nh, r, dr = (c["num_attention_heads"], c["kv_lora_rank"],
                 c["qk_rope_head_dim"])
    attn = 2 * nh * (r + dr) * seen + 2 * nh * r * seen
    return (mlp_flops(c) + c["num_hidden_layers"] * (proj_flops(c, True)
                                                     + attn)
            + 2 * c["hidden_size"] * c["vocab_size"])


def request_flops(c: dict, videos: int) -> float:
    d = c["decode"]
    steps = sum(step_flops(c, t) for t in range(d["maxlen"]))
    return videos * (prefill_flops(c) + d["beam_size"] * steps)


def read(r):
    n, secs = r.counts.get("untraced_captions"), r.counts.get("untraced_s")
    if not n or not secs:
        return None
    return 100.0 * request_flops(r.config, n) / (
        secs * harness.PEAK_OPS_PER_S["bf16"] * r.chips)
