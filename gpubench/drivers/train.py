"""A training job: teacher-forced updates of the recipe back to back.

Set-up builds one training state (the seed's weights, the optimizer's
slots, the dropout generator), the train step of ``make_train_step`` and
a feature bank of the split's videos on the card, with captions whose
lengths follow the mix's fixed histogram (the same multiset for every
seed; the seed draws the words, the videos and the order). Batches go to
the length buckets of the job, in one fixed pattern of buckets for every
seed, each filled with the bucket's captions in the seed's order.

The first updates (one batch of each bucket: every shape the window runs)
are the set-up's; the window then dispatches updates on the same state
through the same call and feed, with no host read, and ends in
``torch.cuda.synchronize()``.

The check: the float32 reference follows the set-up's updates from the
same weights, batches and dropout masks (drawn from a generator seeded as
the program's, in the program's order) and compares the first update's
loss, the norm of each leaf's first gradient as the optimizer got it
(from the program's first adadelta slot after one update) and the norm of
each leaf's change over the updates (``loss_gap``, ``grad_gap``,
``change_gap``; leaves whose reference gradient is under a thousandth of
the median leaf's are left out).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np

from gpubench import harness
from gpubench.reference import model as ref

RHO = 0.9   # adadelta's decay: the first slot after one update is 0.1 g^2


def captions(mix: dict, n_videos: int, n_words: int, rng):
    """(video row, tokens, mask) of every caption: lengths (words + EOS)
    from the mix's histogram, scaled to ``captions_per_video`` a video and
    shuffled; words uniform over the vocabulary past EOS and UNK."""
    total = mix["captions_per_video"] * n_videos
    hist = {int(k): float(v) for k, v in mix["length_share"].items()}
    share = np.asarray(list(hist.values()))
    exact = share / share.sum() * total
    counts = np.floor(exact).astype(np.int64)
    extra = np.argsort(-(exact - counts), kind="stable")
    counts[extra[:total - counts.sum()]] += 1
    lens = rng.permutation(np.repeat(list(hist), counts))
    maxlen = mix["train"]["maxlen"]
    tokens = rng.integers(2, n_words, size=(total, maxlen)).astype(np.int32)
    cols = np.arange(maxlen)[None]
    tokens[cols >= lens[:, None] - 1] = 0
    mask = (cols < lens[:, None]).astype(np.float32)
    video = rng.integers(0, n_videos, size=total).astype(np.int32)
    return video, tokens, mask, lens


def pattern(per_epoch: Dict[int, int]) -> List[int]:
    """One epoch's bucket order: each bucket's batches spread evenly."""
    total = sum(per_epoch.values())
    slots = []
    for t, n in per_epoch.items():
        slots += [((i + 0.5) / n, t) for i in range(n)]
    out = [t for _, t in sorted(slots)]
    assert len(out) == total
    return out


class Feed:
    """Batches of caption indices per bucket: each bucket's captions in the
    seed's order, taken ``batch`` at a time and drawn again when used up."""

    def __init__(self, lens: np.ndarray, buckets, batch: int, rng):
        edges = np.asarray(buckets)
        assign = edges[np.searchsorted(edges, lens)]
        self.pools = {int(t): np.flatnonzero(assign == t) for t in edges
                      if np.any(assign == t)}
        self.batch, self.rng = batch, rng
        self.order = {t: rng.permutation(p) for t, p in self.pools.items()}
        self.pos = dict.fromkeys(self.pools, 0)
        self.epoch = pattern({t: -(-len(p) // batch)
                              for t, p in self.pools.items()})

    def take(self, t: int) -> np.ndarray:
        out = []
        need = self.batch
        while need:
            o, p = self.order[t], self.pos[t]
            part = o[p:p + need]
            out.append(part)
            need -= len(part)
            self.pos[t] = p + len(part)
            if self.pos[t] >= len(o):
                self.order[t] = self.rng.permutation(self.pools[t])
                self.pos[t] = 0
        return np.concatenate(out).astype(np.int32)


class Job:
    """The program's side: state, train step, bank, captions, feed."""

    def __init__(self, ctx, seed: Optional[int] = None):
        import torch
        from stvd_torch.config import ModelConfig, TrainConfig
        from stvd_torch.data.batching import CaptionSet
        from stvd_torch.train.loop import make_optimizer, make_train_step

        phases = self.phases = ctx.phases
        phases.mark("imports")
        seed = ctx.seed if seed is None else seed
        self.m, self.mix = ctx.config["model"], ctx.traffic
        self.t = self.mix["train"]
        self.dev = torch.device(ctx.device)
        self.rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        params = harness.make_params(ref.param_specs(self.m), gen, self.dev)
        self.params0 = {k: v.detach().to("cpu", copy=True)
                        for k, v in params.items()}
        phases.mark("weights")
        n = ctx.config["dataset"][self.mix["split"] + "_videos"]
        counts = harness.frame_counts(n, *ctx.config["dataset"]["frames"],
                                      self.rng)
        # the benchmark's bank: the program gathers its batches from it
        # and the reference reads the same rows after the window
        self.bank = harness.make_bank(self.m, n, counts, gen, self.dev,
                                      torch.bfloat16)
        phases.mark("bank")
        video, tokens, mask, lens = captions(self.mix, n, self.m["n_words"],
                                             self.rng)
        self.caps = CaptionSet(video_idx=video, tokens=tokens, mask=mask)
        self.feed = Feed(lens, self.mix["buckets"], self.t["batch_size"],
                         self.rng)
        self.drop_seed = seed + 1
        mcfg, tcfg = ModelConfig(**self.m), TrainConfig(**self.t)
        for p in params.values():
            p.requires_grad_(True)
        self.state = {
            "params": params, "opt_state": make_optimizer(tcfg).init(params),
            "step": 0,
            "generator": torch.Generator(device=self.dev).manual_seed(
                self.drop_seed)}
        self.step = make_train_step(mcfg, tcfg)
        phases.mark("captions, state")

    def batch(self, idx: np.ndarray, t: int) -> dict:
        import torch
        from stvd_torch.data.batching import gather_batch
        b = gather_batch(self.bank, self.caps, idx, seq_len=t)
        b["weight"] = torch.ones(len(idx), device=self.dev)
        return b

    def update(self, idx: np.ndarray, t: int):
        self.state, metrics = self.step(self.state, self.batch(idx, t))
        return metrics

    def setup_updates(self):
        """The set-up's updates, one batch of each bucket: their losses,
        the first adadelta slot after the first, the weights after the
        last (copied to the host), and the batches' (indices, length)."""
        import torch
        done, losses = [], []
        eg = None
        for t in self.mix["setup_buckets"]:
            idx = self.feed.take(t)
            metrics = self.update(idx, t)
            losses.append(metrics["loss"])
            done.append((idx, t))
            if eg is None:
                eg = {k: v.detach().to("cpu", torch.float32, copy=True)
                      for k, v in self.state["opt_state"][1][0].items()}
        after = {k: v.detach().to("cpu", copy=True) for k, v in
                 self.state["params"].items()}
        self.phases.mark("set-up updates")
        return ([float(x) for x in losses], eg, after, done)

    def close(self) -> None:
        self.state = None
        self.step = None


def reference_batches(job: Job, done) -> tuple:
    """The set-up's batches gathered from the benchmark's bank, and their
    dropout keep masks drawn as the program draws them."""
    import torch
    gen = torch.Generator(device=job.dev).manual_seed(job.drop_seed)
    rate = job.m["dropout_rate"]
    batches, keeps = [], []
    for idx, t in done:
        rows = torch.from_numpy(job.caps.video_idx[idx].astype(np.int64)
                                ).to(job.dev)
        b = {k: v.index_select(0, rows).float() for k, v in job.bank.items()}
        b["tokens"] = torch.from_numpy(job.caps.tokens[idx, :t].astype(
            np.int64)).to(job.dev)
        b["token_mask"] = torch.from_numpy(np.ascontiguousarray(
            job.caps.mask[idx, :t])).to(job.dev)
        b["weight"] = torch.ones(len(idx), device=job.dev)
        keeps.append(torch.rand((len(idx), t, job.m["dim_word"]),
                                generator=gen, device=job.dev) < 1 - rate)
        batches.append(b)
    return batches, keeps


def leaf_norms(tensors: Dict[str, "torch.Tensor"]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def gaps(params0, prog: dict, refr: dict, worst: Optional[dict] = None
         ) -> Dict[str, float]:
    """The three numbers compared. ``prog`` and ``refr`` each hold
    ``losses``, ``grad`` (leaf -> norm of the first gradient as the
    optimizer got it) and ``after`` (leaf -> weights after the updates).
    ``worst`` receives the leaf that sets each leaf-wise number."""
    # the first update's loss: a later update's loss moves with rounding
    # alone far more on some seeds (the reference rounded to bf16 reads
    # as the program does there)
    a, b = prog["losses"][0], refr["losses"][0]
    loss_gap = abs(a - b) / max(abs(b), 1e-30)
    g_r = refr["grad"]
    med = float(np.median(list(g_r.values())))
    keep = [k for k, v in g_r.items() if v >= 1e-3 * med]
    grad_gap = max(abs(prog["grad"][k] - g_r[k]) / max(g_r[k], med)
                   for k in keep)
    d_r = {k: float((refr["after"][k].detach().double()
                     - params0[k].double()).norm()) for k in keep}
    d_p = {k: float((prog["after"][k].double()
                     - params0[k].double()).norm()) for k in keep}
    med_d = float(np.median(list(d_r.values())))
    change_gap = max(abs(d_p[k] - d_r[k]) / max(d_r[k], med_d)
                     for k in keep)
    if worst is not None:
        worst["grad"] = max(keep, key=lambda k: abs(prog["grad"][k] - g_r[k])
                            / max(g_r[k], med))
        worst["change"] = max(keep, key=lambda k: abs(d_p[k] - d_r[k])
                              / max(d_r[k], med_d))
        worst["left_out"] = sorted(set(g_r) - set(keep))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def program_side(losses, eg, after) -> dict:
    grad = {k: float(np.sqrt(v.double().sum().item() / (1 - RHO)))
            for k, v in eg.items()}
    return {"losses": losses, "grad": grad, "after": after}


def reference_side(job: Job, done, prec=None, rows=None) -> dict:
    """The reference's three readings for the set-up's updates (``prec``
    rounds it to a lower precision; ``rows`` keeps only those rows)."""
    ref.no_tf32()
    batches, keeps = reference_batches(job, done)
    params = {k: v.to(job.dev) for k, v in job.params0.items()}
    losses, first, after = ref.train_steps(
        params, job.m, job.t, batches, keeps, prec or ref.Precision(),
        block=job.mix["check_block"], rows=rows)
    return {"losses": losses, "grad": leaf_norms(first),
            "after": {k: v.cpu() for k, v in after.items()}}


def run(ctx) -> harness.Readings:
    import torch
    r = ctx.readings()
    job = Job(ctx)
    losses, eg, after, done = job.setup_updates()
    if ctx.trace:
        harness.warm_profiler(job.dev)
    harness.sync(job.dev)
    ctx.phases.mark("sync")
    spans, ts = [], []
    prof, stack = None, contextlib.ExitStack()
    epoch = job.feed.epoch
    t_start = time.perf_counter()
    r.setup_s = t_start - ctx.start
    deadline = t_start + ctx.seconds
    trace_from = deadline - min(job.mix["trace_seconds"], ctx.seconds / 2)
    mark = None
    i = 0
    while True:
        now = time.perf_counter()
        if now >= deadline and (prof is not None or not ctx.trace):
            break
        if ctx.trace and prof is None and now >= trace_from:
            harness.sync(job.dev)
            mark = (time.perf_counter(), len(ts))
            prof = harness.start_trace(stack, job.dev)
        t = epoch[i % len(epoch)]
        i += 1
        idx = job.feed.take(t)
        t0 = time.perf_counter()
        with (torch.profiler.record_function("bench.train_step")
              if prof is not None else contextlib.nullcontext()):
            job.update(idx, t)
        spans.append((time.perf_counter() - t0) * 1e3)
        ts.append(t)
    harness.sync(job.dev)
    t_end = time.perf_counter()
    stack.close()
    r.window_s = t_end - t_start
    untraced_end, n_untraced = mark if mark is not None else (t_end,
                                                               len(ts))
    r.counts = {"updates": len(ts), "untraced_s": untraced_end - t_start,
                "untraced_updates": n_untraced}
    r.spans = {"update_lengths": [float(x) for x in ts],
               "train_step_ms": spans[:n_untraced]}
    r.attempted = len(ts) + len(done)
    if job.dev.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(job.dev)
    if prof is not None:
        r.trace = harness.reduce_profile(prof, {"updates": len(ts)
                                                - n_untraced})
        del prof
    job.close()
    if job.dev.type == "cuda":
        torch.cuda.empty_cache()
    got = gaps(job.params0, program_side(losses, eg, after),
               reference_side(job, done))
    r.compared = {k: {"value": v, "limit": ctx.limits[k]}
                  for k, v in got.items()}
    return r



def calibrate(ctx, program_seeds, control_seeds) -> List[dict]:
    """Readings that set the limits (``gpubench.calibrate``): on each
    program seed the numbers of the set-up's own updates, and on each
    control seed those of the reference rounded to float8 and to bf16 (a
    witness of how far rounding alone moves them) and of a planted fault,
    the reference over half of each batch with its mean over those rows,
    each in the program's place. A row also names the leaf that set each
    leaf-wise number and the losses of both sides."""
    import torch
    rows = []
    for seed in sorted(set(program_seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        job = Job(ctx, seed=seed)
        losses, eg, after, done = job.setup_updates()
        job.close()
        if job.dev.type == "cuda":
            torch.cuda.empty_cache()
        base = reference_side(job, done)
        sides = {}
        if seed in program_seeds:
            sides["program"] = program_side(losses, eg, after)
        if seed in control_seeds:
            sides["float8"] = reference_side(job, done,
                                             ref.Precision("float8"))
            sides["bfloat16"] = reference_side(job, done,
                                               ref.Precision("bfloat16"))
            b = job.t["batch_size"]
            sides["half_batch"] = reference_side(job, done,
                                                 rows=slice(0, b // 2))
        for side, got in sides.items():
            worst = {}
            rows.append({"seed": seed, "side": side,
                         **gaps(job.params0, got, base, worst),
                         "seconds": time.perf_counter() - t0,
                         "worst": worst, "losses": got["losses"],
                         "reference": base["losses"]})
            harness.emit(rows[-1])
        del job, base, sides
    return rows
