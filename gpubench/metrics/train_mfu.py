"""The whole update's share of the card's peak: the model operations of
the updates before the traced part, counted from the configuration's
shapes (forward, and a backward of twice the forward except where a
product's input is data), over those seconds times the bf16 tensor-core
peak (989 TFLOP/s) times the cards."""

from gpubench import harness


def caption_flops(m: dict, steps: int) -> float:
    k, dc, d, dw, v = (m["n_frames"], m["ctx_dim"], m["dim"], m["dim_word"],
                       m["n_words"])
    a = dc
    s = m["region_dim"] if m.get("use_spatial") else 0
    step = 2 * dw * 4 * d                        # input projection
    step += 2 * d * (4 * d + a + 1 + s)          # h-projection
    if m.get("use_spatial"):
        r, dr = m["n_regions"], m["region_dim"]
        step += k * r * (4 * s + 2 * dr) + 2 * k * dr * (dc + a)
    step += 4 * k * a + 2 * k * dc + 2 * dc * 4 * d
    step += 2 * d * dw + 2 * dc * dw + 2 * dw * v
    # products of data: weight gradient only
    once = 2 * k * dc * a + 2 * dc * d * 2
    if m.get("use_motion"):
        once += 2 * k * (dc + m["motion_dim"]) * dc
    if m.get("use_spatial"):
        once += 2 * k * m["n_regions"] * m["region_dim"] ** 2
    return 3 * steps * step + 2 * once


def read(r):
    n = r.counts.get("untraced_updates")
    secs = r.counts.get("untraced_s")
    if not n or not secs:
        return None
    rows = r.traffic["train"]["batch_size"]
    m = r.config["model"]
    flops = sum(rows * caption_flops(m, int(t))
                for t in r.spans["update_lengths"][:int(n)])
    return 100.0 * flops / (secs * harness.PEAK_OPS_PER_S["bf16"] * r.chips)
