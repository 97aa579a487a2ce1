"""Closed-loop id requests of a video-language model's beam-search captions
against visual tokens resident on the card (``KimiCaptioner.caption_ids``).

One client sends requests of ``request_videos`` distinct video ids drawn
from the seed and waits for the captions as strings before it sends the
next.  A video's tokens are the vision tower's projected output, held in
the bank; a request runs, for its chunk of videos, the prompt's prefill
through every layer and then ``maxlen`` beam steps (each step t replayed
as a CUDA graph, as the LSTM cells' steps are).  With ``eos_suppressed``
the head's bias at EOS is -1e9, so every caption runs all ``maxlen``
steps.

The weights are made from the seed a layer at a time on the card, in
float32, and laid out in bf16 for the program; the reference makes the
same float32 layer again when it needs it (``Weights``), so no host copy
of the 16-billion-parameter model is kept.  The traced part of a run
zeroes the program's expert counter when it starts and reads it once it
has ended (``trace.counts``: ``expert_rows`` (phase, MoE layer, expert)
and ``expert_touched`` (phase, MoE layer)).

The check: once the window has closed and the program's weights are
freed, the float32 reference (``reference/kimi_vl.py``) scores a sample
of served captions of distinct videos by one causal forward each of
[prompt | caption].  ``mean_score_gap`` is the mean over the sample of
each caption's gap between the decode's normalised score and the
reference's; ``score_gap`` (the largest such gap) and ``token_gap`` (a
served token's log-probability below the reference's beam-th best
there) are ``serve_bank``'s.  Random-weight routing flips between a
token's 6th and 7th expert on bf16 rounding, each moving one caption,
where a lower precision or a fault moves them all: so the mean tells the
program from them, and the largest does not.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional

import numpy as np

from gpubench import harness
from gpubench.drivers.serve_bank import sample
from gpubench.reference import kimi_vl as ref

# the projections that end a residual branch
BRANCH_ENDS = ("o_proj.weight", "down_proj.weight")


def reference_config(c: dict) -> dict:
    """The model's published keys as the reference reads them: the
    configuration's top level, then its ``model`` section."""
    return {**{k: v for k, v in c.items() if not isinstance(v, dict)},
            **c["model"]}


def model_config(c: dict):
    from stvd_torch.model.kimi_config import KimiVLConfig
    return KimiVLConfig.from_dict(reference_config(c))


def init_tensor(name: str, shape, gen, dev, init: dict):
    """One weight from ``gen``, float32 holding a bf16 value (the model is
    published in bf16; the router's correction bias, published in float32,
    stays float32): matrices 1/sqrt(fan-in) (the queries' times
    ``query_scale``, those that end a residual branch times
    ``branch_scale``), norms near 1, the correction bias at ``bias_std``,
    unit-scale embedding rows, the head at ``head_scale``/sqrt(hidden)."""
    import torch
    x = torch.randn(shape, generator=gen, device=dev)
    if name.endswith("e_score_correction_bias"):
        return x.mul_(init["bias_std"])
    if name.endswith("norm.weight"):
        x.mul_(init["norm_std"]).add_(1.0)
    elif name != "model.embed_tokens.weight":
        scale = (init["head_scale"] if name == "lm_head.weight" else
                 init["branch_scale"] if name.endswith(BRANCH_ENDS) else
                 init["query_scale"] if name.endswith("q_proj.weight")
                 else 1.0)
        x.mul_(scale / math.sqrt(shape[1]))
    return x.bfloat16().float()


class Weights:
    """The model's float32 weights from the seed, by published name, a
    group at a time (a layer, or the weights outside the layers), each
    group from its own generator on ``dev``, so any group is made again
    bit for bit.  Calling it with a name keeps that name's group (and the
    outer weights) until another layer is asked for."""

    def __init__(self, seed: int, cfg, dev, init: dict):
        from stvd_torch.model import kimi_vl
        self.seed, self.dev, self.init = seed, dev, init
        self.shapes = kimi_vl.param_shapes(cfg)
        self._layer: Optional[int] = None
        self._cache: Dict[str, object] = {}
        self._outer: Optional[dict] = None

    @staticmethod
    def group_of(name: str) -> int:
        return (int(name.split(".")[2]) if name.startswith("model.layers.")
                else -1)

    def group(self, i: int) -> dict:
        import torch
        gen = torch.Generator(device=self.dev).manual_seed(
            (self.seed * 1_000_003 + i + 7) % (1 << 63))
        return {n: init_tensor(n, s, gen, self.dev, self.init)
                for n, s in self.shapes.items() if self.group_of(n) == i}

    def __call__(self, name: str):
        i = self.group_of(name)
        if i < 0:
            if self._outer is None:
                self._outer = self.group(-1)
            return self._outer[name]
        if i != self._layer:
            self._cache = {}
            self._cache, self._layer = self.group(i), i
        return self._cache[name]

    def free(self) -> None:
        self._cache, self._layer, self._outer = {}, None, None


def make_tokens(n: int, nv: int, h: int, gen, dev, signature: float):
    """(n, nv, h) bf16 visual tokens on ``dev``, unit scale: each video a
    signature (``signature`` of each token's standard deviation) plus
    per-token noise."""
    import torch
    noise_std = math.sqrt(1.0 - signature * signature)
    out = torch.empty((n, nv, h), dtype=torch.bfloat16, device=dev)
    step = max(1, (1 << 28) // (nv * h))
    for s in range(0, n, step):
        e = min(n, s + step)
        base = torch.randn((e - s, 1, h), generator=gen, device=dev)
        noise = torch.randn((e - s, nv, h), generator=gen, device=dev)
        out[s:e] = (signature * base + noise_std * noise).to(torch.bfloat16)
    return out


class Served:
    """The program's side of a run: weights, bank, captioner, counters."""

    def __init__(self, ctx, seed=None, videos: Optional[int] = None):
        import torch
        from stvd_torch.config import DecodeConfig
        from stvd_torch.data.bank import FeatureBank
        from stvd_torch.data.text import EOS_ID, Vocab
        from stvd_torch.kimi_api import KimiCaptioner
        from stvd_torch.model import kimi_vl
        from stvd_torch.model.kimi_config import KimiServeConfig

        phases = ctx.phases
        phases.mark("imports")
        seed = ctx.seed if seed is None else seed
        c, mix = ctx.config, ctx.traffic
        self.mix, self.decode = mix, c["decode"]
        self.m = model_config(c)
        self.ref_m = reference_config(c)
        self.dev = torch.device(ctx.device)
        self.rng = np.random.default_rng(seed)
        self.weights = Weights(seed, self.m, self.dev, c["init"])
        dtype = getattr(torch, self.m.compute_dtype)
        self.logit_bias = torch.zeros(self.m.vocab_size, device=self.dev)
        if mix["eos_suppressed"]:
            self.logit_bias[EOS_ID] = -1e9
        packed = kimi_vl.pack_outer(self.weights.group(-1), self.m, dtype,
                                    self.dev, self.logit_bias)
        packed["layers"] = [
            kimi_vl.pack_layer(self.weights.group(i), self.m, i, dtype,
                               self.dev)
            for i in range(self.m.num_hidden_layers)]
        phases.mark("weights")
        ds = c["dataset"]
        self.n = videos or ds[mix["split"] + "_videos"]
        nv = ds["frames_per_video"] * ds["tokens_per_frame"]
        gen = torch.Generator(device=self.dev).manual_seed(
            (seed * 1_000_003 + 3) % (1 << 63))
        tokens = make_tokens(self.n, nv, self.m.hidden_size, gen, self.dev,
                             ds["token_signature"])
        phases.mark("bank")
        # the port's bank takes host arrays: float16 in pinned memory,
        # filled straight from the card, which the reference reads too
        self.frames = harness.pinned_host(tokens)
        self.mask = np.ones((self.n, nv), np.float32)
        del tokens
        phases.mark("host copy")
        self.ids = [f"v{i}" for i in range(self.n)]
        self.words = harness.vocab_words(self.m.vocab_size)
        cfg = KimiServeConfig(model=self.m, decode=DecodeConfig(**self.decode))
        self.cap = KimiCaptioner(None, cfg, Vocab(self.words), device=self.dev,
                                 packed=packed)
        self.cap.attach_bank(FeatureBank(ids=self.ids, frames=self.frames,
                                         frame_mask=self.mask))
        phases.mark("attach_bank")
        # the score of each decoded chunk's best beam, as the timed path
        # returns it with the tokens (kept on the device)
        self.scores: List = []
        run = self.cap._run

        def scored(params, batch, dense=False):
            toks, scores = run(params, batch, dense)
            self.scores.append(scores)
            return toks, scores

        self.cap._run = scored

    def request(self) -> np.ndarray:
        return self.rng.choice(self.n, self.mix["request_videos"],
                               replace=False)

    def call(self, rows: np.ndarray) -> List[str]:
        return self.cap.caption_ids([self.ids[i] for i in rows])

    def served(self, rows: np.ndarray, out: List[str]) -> tuple:
        """(rows, captions, scores of the decode) of a request just
        served."""
        import torch
        chunks = -(-len(rows) // self.decode["decode_batch"])
        scores = torch.cat(self.scores[-chunks:])
        del self.scores[:]
        return rows[:len(out)], out, scores

    def close(self) -> None:
        """Let the program's weights, bank and graphs go (the wrapper of
        ``_run`` holds the captioner, so it goes first)."""
        if self.cap is not None:
            del self.cap._run
            self.cap = None


def compare(s: Served, served: List[tuple], block: int = 16
            ) -> Dict[str, object]:
    """``token_gap``, ``score_gap`` and ``mean_score_gap`` of the served
    (row, caption, score) entries against the float32 reference, and
    ``score_gaps``, each caption's gap."""
    import torch
    ref.no_tf32()
    d = s.decode
    beam, maxlen, alpha = d["beam_size"], d["maxlen"], d["length_norm"]
    m = s.m
    token_gap = 0.0
    gaps: List[float] = []
    with torch.no_grad():
        for b0 in range(0, len(served), block):
            part = served[b0:b0 + block]
            rows = np.asarray([r for r, _, _ in part])
            frames = torch.from_numpy(s.frames[rows]).to(s.dev)
            mask = torch.from_numpy(s.mask[rows]).to(s.dev)
            toks = [harness.caption_ids(t, s.words, maxlen)
                    for _, t, _ in part]
            tt = torch.zeros((len(part), maxlen), dtype=torch.long,
                             device=s.dev)
            for i, t in enumerate(toks):
                tt[i, :len(t)] = torch.tensor(t, device=s.dev)
            logp = ref.teacher_logp(s.weights, s.ref_m, frames, mask,
                                    m.prompt_before, m.prompt_after, tt,
                                    s.logit_bias)
            kth = torch.topk(logp, beam, dim=-1).values[..., -1]
            got = logp.gather(2, tt[..., None])[..., 0]
            for i, (n, (_, _, score)) in enumerate(zip(map(len, toks),
                                                       part)):
                token_gap = max(token_gap,
                                float((kth[i, :n] - got[i, :n]).max()))
                norm = float(got[i, :n].sum()) / ref.length_penalty(n, alpha)
                gaps.append(abs(float(score) - norm))
            del logp
    s.weights.free()
    return {"token_gap": max(0.0, token_gap), "score_gap": max(gaps),
            "mean_score_gap": sum(gaps) / len(gaps), "score_gaps": gaps}


def expert_counts(s: Served) -> Dict[str, list]:
    got = s.cap.counter.read()
    return {"expert_rows": got["rows"], "expert_touched": got["touched"]}


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
    served, lat, lat_traced = [], [], []
    prof = None
    stack = contextlib.ExitStack()
    t_start = time.perf_counter()
    r.setup_s = t_start - ctx.start
    deadline = t_start + ctx.seconds
    trace_from = deadline - min(mix["trace_seconds"], ctx.seconds / 2)
    mark = {"t": None, "captions": 0}
    requested = captions = 0
    while True:
        now = time.perf_counter()
        if now >= deadline and (prof is not None or not ctx.trace):
            break
        if ctx.trace and prof is None and now >= trace_from:
            mark = {"t": now, "captions": captions}
            s.cap.counter.zero_()
            prof = harness.start_trace(stack, s.dev)
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
    stack.close()
    r.window_s = t_end - t_start
    untraced_end = mark["t"] if mark["t"] is not None else t_end
    r.counts = {"captions": captions,
                "requests": len(lat) + len(lat_traced),
                "untraced_s": untraced_end - t_start,
                "untraced_captions": (captions if mark["t"] is None
                                      else mark["captions"])}
    r.spans = {"request_ms": lat + lat_traced, "request_ms.untraced": lat}
    r.attempted = requested
    if s.dev.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(s.dev)
    if prof is not None:
        r.trace = harness.reduce_profile(prof, {
            "captions": captions - mark["captions"], **expert_counts(s)})
        del prof
    s.close()
    if s.dev.type == "cuda":
        torch.cuda.empty_cache()
    got = compare(s, sample(s.rng, served, mix["check_videos"]))
    del got["score_gaps"]
    r.compared = {k: {"value": v, "limit": ctx.limits[k]}
                  for k, v in got.items() if k in ctx.limits}
    for k, v in got.items():
        if k not in ctx.limits:
            harness.say(f"read {k} {v!r} (no limit)")
    return r


# ---------------------------------------------------------------------------
# Calibration: the program's readings beside those of a control and of
# planted faults in the program's place
# ---------------------------------------------------------------------------

FAULTS = ("no_bias", "no_norm", "no_scale", "no_reorder", "rope_off")


def _fault_beam(fault: str):
    """The model's beam side with ``fault`` planted: the beams' suffix
    caches not reordered at the select, or every decode position one
    past its place."""
    from stvd_torch.model import kimi_vl
    from stvd_torch.model.mla import rope_tables

    class NotReordered(kimi_vl.KimiBeam):
        def prologue(self, params, cfg, batch, k, maxlen, step_fn):
            fixed, (self.suffix,), ki = super().prologue(
                params, cfg, batch, k, maxlen, step_fn)
            return fixed, (), ki

        def step(self, fixed, cfg, step_fn, t, state, prev, B, k, ki):
            vals, idx, _ = super().step(fixed, cfg, step_fn, t,
                                        (self.suffix,), prev, B, k, ki)
            return vals, idx, ()

    class RopeOff(kimi_vl.KimiBeam):
        def prologue(self, params, cfg, batch, k, maxlen, step_fn):
            fixed, state, ki = super().prologue(params, cfg, batch, k,
                                                maxlen, step_fn)
            cos, sin = rope_tables(fixed.n_prefix + maxlen + 1,
                                   cfg.qk_rope_head_dim, cfg.rope_theta,
                                   fixed.cos.device)
            return fixed._replace(cos=cos, sin=sin), state, ki

        def position(self, fixed, t):
            return fixed.n_prefix + t + 1

    return {"no_reorder": NotReordered, "rope_off": RopeOff}[fault]


@contextlib.contextmanager
def planted(s: Served, fault: str):
    """The program with ``fault`` planted while the block runs: routing
    without the correction bias, top-k weights not normalised or not
    scaled, or a beam side from ``_fault_beam``; the graphs are captured
    anew on entry and on exit."""
    from stvd_torch.model import moe
    cap = s.cap
    route, beams, step_fn = moe.route, cap._beams, cap.step_fn
    if fault in ("no_bias", "no_norm", "no_scale"):
        def faulty(x, gate_w, bias, top_k, scale, norm):
            return route(x, gate_w, bias * (fault != "no_bias"), top_k,
                         1.0 if fault == "no_scale" else scale,
                         norm and fault != "no_norm")
        moe.route = faulty
    else:
        cls = _fault_beam(fault)
        cap._beams = {d: cls(d, cap.counter) for d in (False, True)}
        cap.step_fn = cap._beams[False]
    cap._graphs = None
    try:
        yield
    finally:
        moe.route, cap._beams, cap.step_fn = route, beams, step_fn
        cap._graphs = None


def float8_weights(s: Served) -> None:
    """Every weight matrix of the program rounded to float8 (e4m3, one
    scale a matrix or an expert's matrix) and back: the control."""
    import torch

    def q(t):
        if t.dim() < 2 or not t.is_floating_point():
            return t
        amax = t.float().abs().amax(dim=tuple(range(t.dim() - 2, t.dim())),
                                    keepdim=True).clamp_min(1e-12)
        scale = amax / 448.0
        return ((t.float() / scale).to(torch.float8_e4m3fn).float()
                * scale).to(t.dtype)

    p = s.cap.params
    for k in ("embed", "lm_head_t", "prompt_before", "prompt_after"):
        p[k] = q(p[k])
    for lw in p["layers"]:
        for part in ("attn", "mlp"):
            for k, v in lw[part].items():
                lw[part][k] = q(v)
    s.cap._graphs = None


def calibrate(ctx, program_seeds, control_seeds) -> List[dict]:
    """On each program seed the numbers of the program's own captions
    (the second request, replayed from the graphs); on each control seed
    those of every planted fault and of float8 weights in the program's
    place.  A bank of ``calibration_videos`` videos."""
    import torch
    mix = ctx.traffic

    def one(s):
        s.call(s.request())
        rq = s.request()
        return sample(s.rng, [s.served(rq, s.call(rq))], mix["check_videos"])

    rows = []
    for seed in sorted(set(program_seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        s = Served(ctx, seed=seed, videos=mix["calibration_videos"])
        sides = {}
        if seed in program_seeds:
            sides["program"] = one(s)
        if seed in control_seeds:
            for fault in FAULTS:
                with planted(s, fault):
                    sides[fault] = one(s)
            float8_weights(s)
            sides["float8"] = one(s)
        s.close()
        if s.dev.type == "cuda":
            torch.cuda.empty_cache()
        for side, entries in sides.items():
            rows.append({"seed": seed, "side": side, **compare(s, entries),
                         "seconds": time.perf_counter() - t0})
            harness.emit(rows[-1])
        del s
    return rows
