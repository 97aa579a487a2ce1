"""A plain reference of the spatial-temporal attention captioner.

Written from the model's equations (Yao et al. 2015, "Describing Videos by
Exploiting Temporal Structure", with the region-level spatial attention and
the motion stream of the MSVD / MSR-VTT recipes), in plain PyTorch, float32
with TF32 off. It imports nothing of the program under test: the harness
hands both sides the same weights and features, and this module works out
everything else again (the fused context, the region projection, the
initial state, beam search, the loss and the optimizer).

``Precision`` rounds the two operands of every contraction: ``float32``
leaves them alone (the reference), ``bfloat16`` and ``float8`` (e4m3 with
one scale a tensor) give the lower-precision controls of the comparison.
Element-wise functions and every sum stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

EOS_ID = 0
_F8_MAX = 448.0


def param_specs(m: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of every weight of the model config ``m`` (the
    recipe's ``model`` section), in the program's parameter names. The
    scales give unit-sized pre-activations (1/sqrt(fan-in)), attention
    scores and logits of a few units, as a trained model has, so that
    decoding follows its inputs; std 0 is a zero tensor."""
    d, dw, dc, v = m["dim"], m["dim_word"], m["ctx_dim"], m["n_words"]
    a = dc
    inv = lambda n: 1.0 / math.sqrt(n)
    out = [("Wemb", (v, dw), 0.5)]
    if m.get("use_motion"):
        dm = m["motion_dim"]
        out += [("W_app", (dc, dc), inv(dc)), ("W_mot", (dm, dc), inv(dm)),
                ("b_fuse", (dc,), 0.1)]
    out += [("ff_state_W", (dc, d), inv(dc)), ("ff_state_b", (d,), 0.1),
            ("ff_memory_W", (dc, d), inv(dc)), ("ff_memory_b", (d,), 0.1),
            ("W", (dw, 4 * d), inv(dw)), ("b", (4 * d,), 0.1),
            ("U", (d, 4 * d), inv(d)), ("Wc", (dc, 4 * d), inv(dc)),
            ("Wc_att", (dc, a), inv(dc)), ("b_att", (a,), 0.1),
            ("Wd_att", (d, a), inv(d)), ("U_att", (a,), 2 * inv(a)),
            ("c_att", (), 0.0), ("W_sel", (d,), inv(d)), ("b_sel", (), 0.0)]
    if m.get("use_spatial"):
        dr = s = m["region_dim"]
        out += [("Ws_att", (dr, s), inv(dr)), ("bs_att", (s,), 0.1),
                ("Wsd_att", (d, s), inv(d)), ("Us_att", (s,), 2 * inv(s)),
                ("cs_att", (), 0.0), ("W_spat_fuse", (dr, dc), inv(dr))]
    out += [("ff_logit_lstm_W", (d, dw), inv(d)),
            ("ff_logit_lstm_b", (dw,), 0.1),
            ("ff_logit_ctx_W", (dc, dw), inv(dc)),
            ("ff_logit_W", (dw, v), 3 * inv(dw)), ("ff_logit_b", (v,), 0.5)]
    return out


def no_tf32():
    """Float32 products in float32 (TF32 off), as the reference needs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """Rounding of contraction operands: 'float32' (none), 'bfloat16' or
    'float8' (e4m3, scaled by the tensor's largest magnitude). The rounding
    passes gradients straight through."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "float32":
            return x
        if self.kind == "bfloat16":
            r = x.detach().to(torch.bfloat16).float()
        else:
            s = x.detach().abs().amax().clamp_min(1e-30) / _F8_MAX
            r = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
        return x + (r - x.detach())

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


class Prepared(NamedTuple):
    ctx: torch.Tensor        # (B, K, ctx_dim) fused context
    pctx: torch.Tensor       # (B, K, attn) ctx @ Wc_att + b_att
    mask: torch.Tensor       # (B, K)
    regions: Optional[torch.Tensor]   # (B, K, R, Dr)
    pregion: Optional[torch.Tensor]   # (B, K, R, s)


class Model:
    """The captioner's equations over a dict of float32 weights ``p`` and
    the recipe's ``model`` section ``m``."""

    def __init__(self, p: Dict[str, torch.Tensor], m: dict,
                 prec: Precision = Precision()):
        self.p, self.m, self.prec = p, m, prec

    def prepare(self, frames, mask, regions=None, motion=None) -> Prepared:
        p, m, pr = self.p, self.m, self.prec
        frames = frames.float()
        if m.get("use_motion"):
            ctx = (pr.dot(frames, p["W_app"]) + pr.dot(motion.float(),
                                                       p["W_mot"])
                   + p["b_fuse"])
        else:
            ctx = frames
        pctx = pr.dot(ctx, p["Wc_att"]) + p["b_att"]
        pregion = None
        if m.get("use_spatial"):
            regions = regions.float()
            pregion = pr.dot(regions, p["Ws_att"]) + p["bs_att"]
        return Prepared(ctx, pctx, mask.float(), regions, pregion)

    def init_state(self, prep: Prepared):
        p, pr = self.p, self.prec
        mask = prep.mask
        mean = ((prep.ctx * mask[..., None]).sum(1)
                / mask.sum(1, keepdim=True).clamp_min(1.0))
        h = torch.tanh(pr.dot(mean, p["ff_state_W"]) + p["ff_state_b"])
        c = torch.tanh(pr.dot(mean, p["ff_memory_W"]) + p["ff_memory_b"])
        return h, c

    def step(self, prep: Prepared, h, c, emb):
        """One step for ``h`` of nb rows a video (video-major): returns
        (h, c, ctx_t)."""
        p, m, pr = self.p, self.m, self.prec
        bc, k = prep.mask.shape
        bs = h.shape[0]
        nb = bs // bc
        if m.get("use_spatial"):
            hs = pr.dot(h, p["Wsd_att"]).view(bc, nb, 1, 1, -1)
            e_s = torch.tanh(prep.pregion[:, None] + hs)
            sc = pr.einsum("bjkrd,d->bjkr", e_s, p["Us_att"]) + p["cs_att"]
            a_s = torch.softmax(sc, dim=-1)
            spat = pr.einsum("bjkr,bkrd->bjkd", a_s, prep.regions)
            ctx_k = prep.ctx[:, None] + pr.dot(spat, p["W_spat_fuse"])
            pctx_k = pr.dot(ctx_k, p["Wc_att"]) + p["b_att"]
        else:
            ctx_k = prep.ctx[:, None].expand(bc, nb, k, prep.ctx.shape[-1])
            pctx_k = prep.pctx[:, None]
        ha = pr.dot(h, p["Wd_att"]).view(bc, nb, 1, -1)
        e = torch.tanh(pctx_k + ha)
        sc = pr.einsum("bjka,a->bjk", e, p["U_att"]) + p["c_att"]
        sc = sc.masked_fill(prep.mask[:, None] <= 0, float("-inf"))
        alpha = torch.softmax(sc, dim=-1)
        ctx_t = pr.einsum("bjk,bjkd->bjd", alpha, ctx_k).reshape(bs, -1)
        beta = torch.sigmoid(pr.dot(h, p["W_sel"][:, None])[:, 0]
                             + p["b_sel"])
        ctx_t = ctx_t * beta[:, None]
        pre = (pr.dot(emb, p["W"]) + pr.dot(h, p["U"])
               + pr.dot(ctx_t, p["Wc"]) + p["b"])
        d = pre.shape[1] // 4
        i, f = torch.sigmoid(pre[:, :d]), torch.sigmoid(pre[:, d:2 * d])
        o, g = torch.sigmoid(pre[:, 2 * d:3 * d]), torch.tanh(pre[:, 3 * d:])
        c = f * c + i * g
        return o * torch.tanh(c), c, ctx_t

    def logits(self, h, ctx_t, emb, keep=None):
        """Vocabulary logits from the state; ``keep`` is the train
        dropout's keep mask (inverted dropout at the recipe's rate)."""
        p, m, pr = self.p, self.m, self.prec
        act = (pr.dot(h, p["ff_logit_lstm_W"])
               + pr.dot(ctx_t, p["ff_logit_ctx_W"]) + p["ff_logit_lstm_b"])
        if m.get("prev_word_logit", True):
            act = act + emb
        act = torch.tanh(act)
        if keep is not None:
            rate = m["dropout_rate"]
            act = torch.where(keep, act / (1.0 - rate),
                              torch.zeros_like(act))
        return pr.dot(act, p["ff_logit_W"]) + p["ff_logit_b"]

    def embed(self, tokens):
        return self.prec.q(self.p["Wemb"])[tokens]

    # ---- decoding -------------------------------------------------------

    def beam_search(self, batch, beam: int, maxlen: int, alpha: float,
                    skip: int = 0):
        """Beam search as the recipes decode: beam 0 live at t = 0,
        per-beam top-k of the log-softmax, a merge over k*k candidates
        (ties to the lower index), finished beams extended by EOS at no
        cost, GNMT length normalisation ((5 + l) / 6)^alpha at the end.
        ``skip`` > 0 plants a selection fault: each beam's ``skip`` best
        candidates are left out of its top-k, the next ones taken instead.
        Returns (tokens (B, maxlen), normalised score (B,))."""
        prep = self.prepare(batch["frames"], batch["frame_mask"],
                            batch.get("regions"), batch.get("motion"))
        h, c = self.init_state(prep)
        b, dev = prep.mask.shape[0], prep.mask.device
        k = beam
        h, c = h.repeat_interleave(k, 0), c.repeat_interleave(k, 0)
        scores = torch.full((b, k), -1e30, device=dev)
        scores[:, 0] = 0.0
        fin = torch.zeros((b, k), dtype=torch.bool, device=dev)
        lens = torch.zeros((b, k), dtype=torch.long, device=dev)
        buf = torch.zeros((b, k, maxlen), dtype=torch.long, device=dev)
        prev = None
        dw = self.p["Wemb"].shape[1]
        for t in range(maxlen):
            emb = (torch.zeros((b * k, dw), device=dev) if prev is None
                   else self.embed(prev.reshape(-1)))
            h, c, ctx_t = self.step(prep, h, c, emb)
            logp = torch.log_softmax(self.logits(h, ctx_t, emb), -1)
            vals, idx = _topk(logp, k + skip)
            vals = vals[:, skip:].reshape(b, k, k)
            idx = idx[:, skip:].reshape(b, k, k)
            eos_v = torch.full((k,), -1e30, device=dev)
            eos_v[0] = 0.0
            eos_i = torch.zeros(k, dtype=torch.long, device=dev)
            vals = torch.where(fin[..., None], eos_v, vals)
            idx = torch.where(fin[..., None], eos_i, idx)
            scores, pick = _topk((scores[..., None] + vals).view(b, -1), k)
            parent = pick // k
            word = torch.gather(idx.view(b, -1), 1, pick)
            pfin = torch.gather(fin, 1, parent)
            fin = pfin | (word == EOS_ID)
            lens = torch.gather(lens, 1, parent) + (~pfin).long()
            rows = (torch.arange(b, device=dev)[:, None] * k
                    + parent).reshape(-1)
            h, c = h[rows], c[rows]
            buf = torch.gather(buf, 1, parent[..., None].expand_as(buf))
            buf[:, :, t] = torch.where(pfin, torch.zeros_like(word), word)
            prev = word
        lp = ((5.0 + lens.float().clamp_min(1.0)) / 6.0) ** alpha
        norm = scores / lp
        best = norm.argmax(1)
        return (buf[torch.arange(b, device=dev), best],
                norm[torch.arange(b, device=dev), best])

    def teacher_logp(self, batch, tokens):
        """(B, T, V) log-probabilities of each position given the tokens
        before it."""
        prep = self.prepare(batch["frames"], batch["frame_mask"],
                            batch.get("regions"), batch.get("motion"))
        h, c = self.init_state(prep)
        out = []
        emb = torch.zeros((tokens.shape[0], self.p["Wemb"].shape[1]),
                          device=tokens.device)
        for t in range(tokens.shape[1]):
            h, c, ctx_t = self.step(prep, h, c, emb)
            out.append(torch.log_softmax(self.logits(h, ctx_t, emb), -1))
            emb = self.embed(tokens[:, t])
        return torch.stack(out, 1)

    # ---- training -------------------------------------------------------

    def nll_sum(self, batch, keep):
        """The summed, example-weighted NLL of a teacher-forced batch
        under the dropout keep mask ``keep`` (B, T, dim_word)."""
        tokens, tmask = batch["tokens"], batch["token_mask"].float()
        prep = self.prepare(batch["frames"], batch["frame_mask"],
                            batch.get("regions"), batch.get("motion"))
        h, c = self.init_state(prep)
        emb = torch.zeros((tokens.shape[0], self.p["Wemb"].shape[1]),
                          device=tokens.device)
        total = 0.0
        for t in range(tokens.shape[1]):
            h, c, ctx_t = self.step(prep, h, c, emb)
            logp = torch.log_softmax(self.logits(h, ctx_t, emb, keep[:, t]),
                                     -1)
            gold = logp.gather(1, tokens[:, t:t + 1])[:, 0]
            total = total - (gold * tmask[:, t] * batch["weight"]).sum()
            emb = self.embed(tokens[:, t])
        return total


def _topk(x, k):
    """Row-wise top-k by value, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def length_penalty(length: int, alpha: float) -> float:
    return ((5.0 + max(length, 1)) / 6.0) ** alpha


def train_steps(params: Dict[str, torch.Tensor], m: dict, t: dict,
                batches: List[dict], keeps: List[torch.Tensor],
                prec: Precision = Precision(), block: int = 64,
                rows: Optional[slice] = None):
    """Follow ``len(batches)`` updates of the recipe's job from the float32
    weights ``params`` (left unchanged): the teacher-forced loss (summed
    NLL over the summed example weight), its gradient by autograd in row
    blocks of ``block``, global-norm clipping at ``clip_c`` (scaled by
    clip / norm once the norm reaches it) and adadelta (rho 0.9, eps 1e-6,
    learning rate ``lr``) with its two slots stored in ``opt_slot_dtype``.
    ``rows`` keeps only those rows of every batch (a fault to plant).
    Returns (losses, first clipped gradient, weights after the updates)."""
    if t["optimizer"] != "adadelta":
        raise ValueError("the reference follows adadelta only")
    slot = getattr(torch, t.get("opt_slot_dtype", "float32"))
    rho, eps, lr, clip = 0.9, 1e-6, t["lr"], t["clip_c"]
    p = {k: v.detach().clone().float() for k, v in params.items()}
    e_g = {k: torch.zeros_like(v, dtype=slot) for k, v in p.items()}
    e_x = {k: torch.zeros_like(v, dtype=slot) for k, v in p.items()}
    losses, first = [], None
    for batch, keep in zip(batches, keeps):
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
            keep = keep[rows]
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        model = Model(leaves, m, prec)
        n = batch["tokens"].shape[0]
        den = float(batch["weight"].sum().clamp_min(1.0))
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        total = 0.0
        for s in range(0, n, block):
            part = {k: v[s:s + block] for k, v in batch.items()}
            obj = model.nll_sum(part, keep[s:s + block]) / den
            gs = torch.autograd.grad(obj, list(leaves.values()),
                                     allow_unused=True)
            for k, g in zip(leaves, gs):
                if g is not None:
                    grads[k] += g
            total += float(obj.detach())
        losses.append(total)
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        if float(norm) >= clip:
            grads = {k: g / norm.float() * clip for k, g in grads.items()}
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                a = (1 - rho) * g * g + rho * e_g[k].float()
                u = torch.sqrt(e_x[k].float() + eps) / torch.sqrt(a + eps) * g
                d = (1 - rho) * u * u + rho * e_x[k].float()
                p[k] -= lr * u
                e_g[k], e_x[k] = a.to(slot), d.to(slot)
    return losses, first, p
