"""The whole decode's share of the card's peak: the model operations of
the requests served before the traced part, counted from the
configuration's shapes whatever implements them, over those seconds
times the bf16 tensor-core peak (989 TFLOP/s) times the cards."""

from gpubench import harness


def video_flops(m: dict) -> float:
    """Operations a video needs once a request: the fused context, the
    attention and region projections and the initial state."""
    k, dc, d = m["n_frames"], m["ctx_dim"], m["dim"]
    f = 2 * k * dc * dc + 2 * dc * d * 2          # pctx; h0 and c0
    if m.get("use_motion"):
        f += 2 * k * (dc + m["motion_dim"]) * dc
    if m.get("use_spatial"):
        f += 2 * k * m["n_regions"] * m["region_dim"] ** 2
    return f


def row_step_flops(m: dict) -> float:
    """Operations of one decode step of one beam row (a tanh, an exp or a
    multiply-add's two halves each count as one)."""
    k, dc, d, dw, v = (m["n_frames"], m["ctx_dim"], m["dim"], m["dim_word"],
                       m["n_words"])
    a = dc
    s = m["region_dim"] if m.get("use_spatial") else 0
    f = 2 * d * (a + 1 + s)                       # h-projection
    if m.get("use_spatial"):
        r, dr = m["n_regions"], m["region_dim"]
        f += k * r * (4 * s + 2 * dr)             # spatial core
        f += 2 * k * dr * dc + 2 * k * dr * a     # fused context and its pctx
    f += 4 * k * a + 2 * k * dc                   # temporal attention
    f += 2 * (dw + d + dc) * 4 * d                # gates
    f += 2 * d * dw + 2 * dc * dw + 2 * dw * v    # logit stack
    return f


def request_flops(m: dict, d: dict, videos: int) -> float:
    rows = videos * d["beam_size"]
    return (videos * video_flops(m)
            + rows * d["maxlen"] * row_step_flops(m))


def read(r):
    n, secs = r.counts.get("untraced_captions"), r.counts.get("untraced_s")
    if not n or not secs:
        return None
    flops = request_flops(r.config["model"], r.config["decode"], n)
    return 100.0 * flops / (secs * harness.PEAK_OPS_PER_S["bf16"] * r.chips)
