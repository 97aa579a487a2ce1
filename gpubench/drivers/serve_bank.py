"""Closed-loop id requests against a feature bank resident on the card.

One client sends requests of ``request_videos`` distinct video ids drawn
from the seed to ``Captioner.caption_ids`` (the port's serving mode for
features that are offline artifacts, as ``cli.serve --bank`` runs it) and
waits for the captions as strings before it sends the next. Only row
indices cross from the host, so the step, its kernels and the beam loop do
the work. With ``eos_suppressed`` the EOS logit's bias is -1e9, so every
caption runs all ``maxlen`` steps whatever the weights and the seed.

The check: once the window has closed, a sample of the served captions
(drawn from the seed, the longest among them) goes to the float32
reference, which scores each served caption token by token, with the
normalised score that the decode returned for it (read from the timed
path's own result, ``Captioner._run``). ``token_gap`` is the widest gap by
which a served token's log-probability lies below the reference's
beam-th best at its position (each token of a beam is among its parent's
beam best); ``score_gap`` the widest gap between the score the decode
gave a served caption and the reference's score of the same tokens.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np

from gpubench import harness
from gpubench.reference import model as ref


class Served:
    """The program's side of a run: weights, bank, Captioner, counters."""

    def __init__(self, ctx, quant: Optional[str] = None, seed=None):
        import torch
        from stvd_torch.api import Captioner
        from stvd_torch.config import Config, DecodeConfig, ModelConfig
        from stvd_torch.data.bank import FeatureBank
        from stvd_torch.data.text import Vocab

        phases = ctx.phases
        phases.mark("imports")
        seed = ctx.seed if seed is None else seed
        m, mix = dict(ctx.config["model"]), ctx.traffic
        if quant is not None:
            m["decode_quant"] = quant
        self.m, self.mix = m, mix
        self.decode = ctx.config["decode"]
        self.dev = torch.device(ctx.device)
        self.rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        params = harness.make_params(ref.param_specs(m), gen, self.dev)
        if mix["eos_suppressed"]:
            params["ff_logit_b"][ref.EOS_ID] = -1e9
        # the reference's own copy of the weights and of the features
        self.ref_params = {k: v.to("cpu", copy=True)
                           for k, v in params.items()}
        phases.mark("weights")
        self.n = ctx.config["dataset"][mix["split"] + "_videos"]
        counts = harness.frame_counts(self.n, *ctx.config["dataset"]["frames"],
                                      self.rng)
        bank = harness.make_bank(m, self.n, counts, gen, self.dev,
                                 torch.bfloat16)
        phases.mark("bank")
        # the port's bank takes host arrays: float16 ones in pinned memory,
        # filled straight from the card, which the reference reads too
        self.host = {k: harness.pinned_host(v) for k, v in bank.items()}
        del bank
        phases.mark("host copy")
        self.ids = [f"v{i}" for i in range(self.n)]
        self.words = harness.vocab_words(m["n_words"])
        cfg = Config(model=ModelConfig(**m), decode=DecodeConfig(**self.decode))
        self.cap = Captioner(params, cfg, Vocab(self.words), device=self.dev)
        self.cap.attach_bank(FeatureBank(
            ids=self.ids, frames=self.host["frames"],
            frame_mask=self.host["frame_mask"],
            regions=self.host.get("regions"), motion=self.host.get("motion")))
        phases.mark("attach_bank")
        self.steps = 0
        self.label_steps = False
        inner = self.cap.step_fn

        def counted(*args, **kw):
            self.steps += 1
            if self.label_steps:
                with torch.profiler.record_function("bench.decode_step"):
                    return inner(*args, **kw)
            return inner(*args, **kw)

        if hasattr(inner, "make_logit_tail"):
            counted.make_logit_tail = inner.make_logit_tail
        self.cap.step_fn = counted
        # the score of each decoded chunk's best beam, as the timed path
        # returns it with the tokens (kept on the device)
        self.scores: List = []
        run = self.cap._run

        def scored(params, batch):
            toks, scores = run(params, batch)
            self.scores.append(scores)
            return toks, scores

        self.cap._run = scored

    def request(self) -> np.ndarray:
        return self.rng.choice(self.n, self.mix["request_videos"],
                               replace=False)

    def call(self, rows: np.ndarray) -> List[str]:
        return self.cap.caption_ids([self.ids[i] for i in rows])

    def served(self, rows: np.ndarray, out: List[str]) -> tuple:
        """(rows, captions, scores of the decode) of a request just served:
        its chunks' scores are the last ones the decode returned (left on
        the device)."""
        import torch
        chunks = -(-len(rows) // self.decode["decode_batch"])
        scores = torch.cat(self.scores[-chunks:])
        del self.scores[:]
        return rows[:len(out)], out, scores

    def close(self) -> None:
        self.cap = None


def sample(rng, served: List[tuple], size: int) -> List[tuple]:
    """``size`` served (row, caption, score) entries of distinct videos
    from the ``served`` requests, drawn from ``rng``, the longest caption
    first; scores on the host."""
    by_row: Dict[int, tuple] = {}
    for rows, texts, scores in served:
        for i, (row, text) in enumerate(zip(rows, texts)):
            by_row.setdefault(int(row), (text, scores, i))
    rows = sorted(by_row)
    longest = max(rows, key=lambda r: len(by_row[r][0].split()))
    rest = [r for r in rows if r != longest]
    pick = [longest] + [rest[i] for i in rng.permutation(len(rest))[
        :max(0, size - 1)]]
    return [(r, by_row[r][0], float(by_row[r][1][by_row[r][2]]))
            for r in pick]


def reference_served(s: Served, rows, prec, block: int = 16,
                     skip: int = 0) -> List[tuple]:
    """The reference rounded by ``prec`` put in the program's place: its
    own beam search over ``rows`` (``skip``: a selection fault planted in
    it), as (row, caption, score) entries."""
    import torch
    ref.no_tf32()
    d = s.decode
    params = {k: v.to(s.dev) for k, v in s.ref_params.items()}
    model = ref.Model(params, s.m, prec)
    words = {i: w for w, i in s.words.items()}
    out = []
    with torch.no_grad():
        for b0 in range(0, len(rows), block):
            part = np.asarray(rows[b0:b0 + block])
            batch = {k: torch.from_numpy(v[part]).to(s.dev)
                     for k, v in s.host.items()}
            toks, best = model.beam_search(batch, d["beam_size"],
                                           d["maxlen"], d["length_norm"],
                                           skip=skip)
            for i, r in enumerate(part):
                ids = []
                for t in toks[i].tolist():
                    if t == ref.EOS_ID:
                        break
                    ids.append(words.get(t, "UNK"))
                out.append((int(r), " ".join(ids), float(best[i])))
    return out


def compare(s: Served, served: List[tuple], block: int = 16
            ) -> Dict[str, float]:
    """The numbers compared for the served (row, caption, score) entries,
    against the float32 reference: ``token_gap`` and ``score_gap``."""
    import torch
    ref.no_tf32()
    dev = s.dev
    d = s.decode
    beam, maxlen, alpha = d["beam_size"], d["maxlen"], d["length_norm"]
    params = {k: v.to(dev) for k, v in s.ref_params.items()}
    model = ref.Model(params, s.m)
    token_gap = score_gap = 0.0
    with torch.no_grad():
        for b0 in range(0, len(served), block):
            part = served[b0:b0 + block]
            rows = np.asarray([r for r, _, _ in part])
            batch = {k: torch.from_numpy(v[rows]).to(dev)
                     for k, v in s.host.items()}
            toks = [harness.caption_ids(t, s.words, maxlen)
                    for _, t, _ in part]
            tt = torch.zeros((len(part), maxlen), dtype=torch.long,
                             device=dev)
            for i, t in enumerate(toks):
                tt[i, :len(t)] = torch.tensor(t, device=dev)
            logp = model.teacher_logp(batch, tt)
            kth = torch.topk(logp, beam, dim=-1).values[..., -1]
            got = logp.gather(2, tt[..., None])[..., 0]
            for i, (n, (_, _, score)) in enumerate(zip(map(len, toks),
                                                       part)):
                token_gap = max(token_gap,
                                float((kth[i, :n] - got[i, :n]).max()))
                norm = float(got[i, :n].sum()) / ref.length_penalty(n, alpha)
                score_gap = max(score_gap, abs(score - norm))
            del logp, batch
    return {"token_gap": max(0.0, token_gap), "score_gap": score_gap}


def run(ctx) -> harness.Readings:
    import torch
    r = ctx.readings()
    s = Served(ctx)
    mix = ctx.traffic
    for _ in range(mix["warmup_requests"]):
        s.call(s.request())
    if ctx.trace:
        harness.warm_profiler(s.dev)
    harness.sync(s.dev)
    ctx.phases.mark("warm-up")
    s.steps = 0
    served, lat, lat_traced = [], [], []
    prof = None
    stack = contextlib.ExitStack()
    t_start = time.perf_counter()
    r.setup_s = t_start - ctx.start
    deadline = t_start + ctx.seconds
    trace_from = deadline - min(mix["trace_seconds"], ctx.seconds / 2)
    mark = {"steps": 0, "t": None, "captions": 0}
    requested = captions = 0
    while True:
        now = time.perf_counter()
        if now >= deadline and (prof is not None or not ctx.trace):
            break
        if ctx.trace and prof is None and now >= trace_from:
            mark = {"steps": s.steps, "t": now, "captions": captions}
            prof = harness.start_trace(stack, s.dev)
            s.label_steps = True
        rows = s.request()
        requested += len(rows)
        t0 = time.perf_counter()
        with (torch.profiler.record_function("bench.request")
              if prof is not None else contextlib.nullcontext()):
            out = s.call(rows)
        t1 = time.perf_counter()
        (lat_traced if prof is not None else lat).append((t1 - t0) * 1e3)
        r.failed += len(rows) - len(out)
        served.append(s.served(rows, out))
        captions += len(out)
    harness.sync(s.dev)
    t_end = time.perf_counter()
    s.label_steps = False
    stack.close()
    r.window_s = t_end - t_start
    untraced_end = mark["t"] if mark["t"] is not None else t_end
    r.counts = {"captions": captions, "steps": s.steps,
                "requests": len(lat) + len(lat_traced),
                "untraced_s": untraced_end - t_start,
                "untraced_captions": (captions if mark["t"] is None
                                      else mark["captions"]),
                "untraced_steps": (s.steps if mark["t"] is None
                                   else mark["steps"])}
    r.spans = {"request_ms": lat + lat_traced, "request_ms.untraced": lat}
    r.attempted = requested
    if s.dev.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(s.dev)
    if prof is not None:
        r.trace = harness.reduce_profile(prof, {
            "steps": s.steps - mark["steps"],
            "captions": captions - mark["captions"]})
        del prof
    s.close()
    if s.dev.type == "cuda":
        torch.cuda.empty_cache()
    got = compare(s, sample(s.rng, served, mix["check_videos"]))
    r.compared = {k: {"value": v, "limit": ctx.limits[k]}
                  for k, v in got.items() if k in ctx.limits}
    return r


def calibrate(ctx, program_seeds, control_seeds) -> List[dict]:
    """Readings that set the limits (``gpubench.calibrate``): on each
    program seed the numbers of the timed path's own captions, and on each
    control seed those of the controls and faults in the program's place:
    the reference rounded to float8, the program's W8A8 gates path
    (``decode_quant='int8'``), and the reference's beam search with a
    selection fault (each beam's best candidate left out, ``drop_best``;
    its k best left out, ``shift_k``)."""
    import torch
    beam = ctx.config["decode"]["beam_size"]

    def served(seed, quant=None):
        s = Served(ctx, quant=quant, seed=seed)
        got = None
        for _ in range(ctx.traffic["warmup_requests"] + 1):
            rq = s.request()
            got = s.served(rq, s.call(rq))
        s.close()
        if s.dev.type == "cuda":
            torch.cuda.empty_cache()
        return s, sample(s.rng, [got], ctx.traffic["check_videos"])

    rows = []
    for seed in sorted(set(program_seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        s, pick = served(seed)
        sides = {}
        if seed in program_seeds:
            sides["program"] = pick
        if seed in control_seeds:
            videos = [r for r, _, _ in pick]
            f32 = ref.Precision()
            sides["float8"] = reference_served(s, videos,
                                               ref.Precision("float8"))
            sides["drop_best"] = reference_served(s, videos, f32, skip=1)
            sides["shift_k"] = reference_served(s, videos, f32, skip=beam)
            sides["int8"] = served(seed, "int8")[1]
        for side, entries in sides.items():
            rows.append({"seed": seed, "side": side, **compare(s, entries),
                         "seconds": time.perf_counter() - t0})
            harness.emit(rows[-1])
        del s
    return rows
